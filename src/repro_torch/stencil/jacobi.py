"""The paper's blocked Jacobi solver on PyTorch (counterpart of
``repro.stencil.jacobi``).

``run_runtime_sweep`` is the port's main path: one whole-lattice sweep cut
into slabs of ``di`` rows, each slab update one ``runtime.Task`` homed on a
locality domain (contiguous slabs per domain, the paper's parallel first
touch), drained by the port's copy of the locality-queue ``Executor``.
Each slab task launches the Hopper sweep kernel (K1) once, on the whole
lattice with the slab's row range: the kernel reads the halo planes from
the lattice and takes zeros past its edges.

Not ported yet (ROADMAP): the ``spec=`` path, which waits for the port of
``repro.spec``, and the shard_map sweeps ``make_contiguous_sweep`` /
``make_scattered_sweep``, which wait for the torch.distributed slice (A3).
The lattice reshapes they use are here already.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .._device import resolve_device
from ..kernels.jacobi.ops import jacobi_sweep
from ..runtime import Executor, RuntimeStats, StealGovernor


@dataclasses.dataclass(frozen=True)
class JacobiGridConfig:
    ni: int = 240
    nj: int = 60
    nk: int = 64
    di: int = 10
    dj: int = 10
    dtype: str = "float32"
    axis: str = "data"          # mesh axis the i-axis is sharded over


def reassemble_scattered(out: torch.Tensor, n_dev: int, blocks_per_dev: int) -> torch.Tensor:
    """Map the scattered sweep's device-major row order back to lattice order.

    Device d's local output stacks its slabs [d, d+D, d+2D, ...]; lattice
    order interleaves them back.
    """
    si = out.shape[0] // (n_dev * blocks_per_dev)
    x = out.reshape(n_dev, blocks_per_dev, si, *out.shape[1:])
    x = x.transpose(0, 1)                          # (bpd, n, si, ...)
    return x.reshape(n_dev * blocks_per_dev * si, *out.shape[1:])


def scatter_lattice(f: torch.Tensor, n_dev: int, blocks_per_dev: int) -> torch.Tensor:
    """Inverse of reassemble_scattered: lattice order -> device-major order."""
    si = f.shape[0] // (n_dev * blocks_per_dev)
    x = f.reshape(blocks_per_dev, n_dev, si, *f.shape[1:])
    x = x.transpose(0, 1)
    return x.reshape(n_dev * blocks_per_dev * si, *f.shape[1:])


def run_runtime_sweep(f, c: float = 1.0 / 6.0, di: int = 10,
                      num_domains: int = 4, workers_per_domain: int = 1,
                      steal_order: str = "cyclic",
                      governor: StealGovernor | None = None,
                      pool_cap: int = 256,
                      seed: int = 0,
                      trace=None,
                      spec=None,
                      device: str | torch.device | None = None,
                      ) -> tuple[torch.Tensor, RuntimeStats]:
    """One whole-lattice sweep executed as online runtime tasks.

    ``f`` is a (Ni, Nj, Nk) float32 array or tensor; it is moved to
    ``device`` (``cuda`` unless the caller passes another, e.g. ``"cpu"``).
    A Jacobi sweep reads only the *old* lattice, so tasks commute and any
    schedule yields the whole-lattice sweep — the scheduling policy changes
    the local/steal statistics, never the physics.  The executor is the
    port's copy of the reference's, so for the same arguments the stats and
    the event stream equal the reference's.  Returns
    ``(new_lattice, runtime_stats)``, the lattice on ``device``.

    ``trace`` takes any recorder with ``.attach(executor)`` (for example
    ``repro.trace.TraceRecorder``, whose replay re-drives the slab schedule).
    ``spec`` is not ported yet and raises ``NotImplementedError``.
    """
    dev = resolve_device(device)
    f = torch.as_tensor(f, device=dev).contiguous()
    ni, nj, _ = f.shape
    if ni % di != 0:
        raise ValueError(f"i extent {ni} not divisible by slab size {di}")
    if spec is not None:
        raise NotImplementedError(
            "run_runtime_sweep(spec=...) waits for the port of repro.spec "
            "(ROADMAP, Slice A: the spec= path of run_runtime_sweep); "
            "pass the scheduling kwargs instead")
    nslabs = ni // di
    out = torch.empty_like(f)

    def update_slab(task, worker):
        # Rows i0 .. i0 + di of the whole-lattice sweep, straight into
        # ``out``: the halo planes are f's own rows, or zeros past the
        # lattice's edges, so the rows equal the whole-lattice sweep.
        i0 = task.payload * di
        jacobi_sweep(f, c, di=di, dj=nj, out=out[i0:i0 + di], rows=(i0, i0 + di))

    ex = Executor(num_domains, [d for d in range(num_domains)
                                for _ in range(workers_per_domain)],
                  handler=update_slab, steal_order=steal_order,
                  governor=governor, pool_cap=pool_cap, seed=seed)
    if trace is not None:
        trace.attach(ex)
    for s in range(nslabs):
        home = s * num_domains // nslabs       # contiguous slabs per domain
        ex.submit(ex.make_task(payload=s, home=home))
    ex.run_until_drained()
    return out, ex.stats


@functools.lru_cache(maxsize=None)
def paper_flops_per_site() -> int:
    return 6  # five adds + one multiply (paper: 8/3 bytes per flop at 16 B/site)
