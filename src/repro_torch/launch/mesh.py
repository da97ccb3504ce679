"""Mesh builders (the port of ``repro.launch.mesh``).

Meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects over the
current process group, with the reference's dim names.  They are built by
functions (never at import), on the card unless ``device="cpu"`` asks for
the CPU, and each needs a process group of exactly its size: the mesh's
shape is the world's, not a choice of devices out of it.

Single pod: (16, 16) = (data, model), 256 ranks.
Multi-pod:  (2, 16, 16) = (pod, data, model), 512 ranks; the "pod" axis is
the slow tier, used for data parallelism or pipeline stages so that
bandwidth-hungry collectives stay inside a pod (the paper's locality
domains, one tier up).

The reference obtains 256 or 512 placeholder devices from ``XLA_FLAGS``.
The port's counterpart is ``fake_world``: PyTorch's fake process group
(``torch.testing._internal.distributed.fake_pg``, backend ``"fake"``),
whose collectives move nothing, so one process can build the production
mesh and trace shapes over it.  Use it in a process of its own: it holds
the default process group while it is open.
"""
from __future__ import annotations

import contextlib

from .._device import resolve_device


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    size = 1
    for n in shape:
        size *= n
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs an initialised torch.distributed "
                           f"process group of {size} ranks (or fake_world({size}))")
    if dist.get_world_size() != size:
        raise ValueError(f"a {shape} mesh needs a world of {size} ranks; this "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device=None):
    """Small mesh for in-repo integration tests (8 ranks by default)."""
    return _mesh((n_data, n_model), ("data", "model"), device)


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks for this process (rank 0),
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
