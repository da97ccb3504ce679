"""Logical-axis sharding rules over a ``DeviceMesh``, as DTensor placements.

The port of ``repro.distributed.sharding``.  Model code annotates
activations and weights with *logical* axis names ("batch", "seq",
"heads", "ffn", "experts", ...); a ``ShardingRules`` table maps those to
the mesh's named dims.  Outside ``use_rules`` every annotation is a no-op,
so the same model code runs unsharded on one device and sharded over a
``torch.distributed.device_mesh.DeviceMesh``.

The table is the reference's (``make_rules``):
  batch   -> (pod, data)      data parallelism (+ pod axis when multi-pod)
  heads/ffn/experts/vocab -> model   tensor/expert parallelism
  seq_q   -> model            sequence parallelism for attention when the
                              head count does not divide the model axis
  kv_seq  -> model            sequence-sharded KV caches (decode)
  fsdp    -> data             weight sharding over the data axis (FSDP)

``spec(*logical)`` is the reference's ``PartitionSpec`` as a tuple: one
entry per tensor dim, a mesh dim name, a tuple of names or ``None``.
``sharding(*logical)`` is what DTensor takes: one placement per *mesh*
dim, ``Shard(i)`` where tensor dim i names that mesh dim, else
``Replicate()``.  A logical dim mapped to a tuple (``batch -> ("pod",
"data")``) shards over both mesh dims, the first named first, as JAX
splits it.  DTensor cannot shard two tensor dims over one mesh dim; the
rules never ask for it (``seq_q`` and ``heads`` exclude each other), and
``sharding`` raises ``ValueError`` if they do.

``shard(x, *logical)`` is the counterpart of ``with_sharding_constraint``:
a DTensor is redistributed to the rule's placements; a plain tensor under
rules is a replicated value (the same on every rank) and is returned as it
is.  ``use_rules`` with a mesh also enters DTensor's
``implicit_replication()``: the masks, positions and constants that model
code builds as plain tensors then meet DTensor activations as replicated
values.  Without it DTensor refuses an op that mixes the two.

``on_local_shards`` runs a function on each rank's local shards (the
counterpart of the reference's ``shard_map``): the hand-written kernels
read raw device pointers, which a DTensor does not have, so their call
sites go through it under a mesh (``models/attention.py``,
``models/rwkv.py``, ``models/rglru.py``).  Redistribution, ``to_local``
and ``from_local`` carry autograd, so a kernel's backward runs on the same
shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional, Sequence

import torch

Axis = Optional[tuple[str, ...] | str]


def _names(entry: Axis) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Sequence[Axis]) -> list:
    """DTensor placements on ``mesh`` for a per-tensor-dim ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, entry in enumerate(spec) if name in _names(entry)]
        if len(dims) > 1:
            raise ValueError(f"tensor dims {dims} of spec {tuple(spec)} both shard "
                             f"over mesh dim {name!r}; DTensor cannot express that")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def spec_of(mesh, placements_: Sequence, ndim: int) -> tuple:
    """The inverse of ``placements``: a per-tensor-dim spec, a single mesh
    dim as its name, several as a tuple in mesh order."""
    from torch.distributed.tensor import Shard

    dims: list[list[str]] = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements_):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d)) for d in dims)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                     # torch.distributed.device_mesh.DeviceMesh
    rules: dict[str, Axis]

    def spec(self, *logical: Optional[str]) -> tuple:
        return tuple(None if name is None else self.rules.get(name, None)
                     for name in logical)

    def sharding(self, *logical: Optional[str]) -> list:
        return placements(self.mesh, self.spec(*logical))

    def axis_size(self, axis: Axis) -> int:
        """The number of shards over mesh dim(s) ``axis`` (1 for ``None``)."""
        size = 1
        for name in _names(axis):
            size *= self.mesh.shape[self.mesh.mesh_dim_names.index(name)]
        return size

    def coordinate(self, axis: str) -> int:
        """This rank's index along mesh dim ``axis``."""
        return self.mesh.get_local_rank(axis)


def make_rules(mesh, fsdp: bool = False, shard_heads: bool = True) -> ShardingRules:
    """Build the rule table for a (pod?, data, model) mesh."""
    axes = mesh.mesh_dim_names
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    batch = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    model = "model" if "model" in axes else None
    rules: dict[str, Axis] = {
        "batch": batch,
        "seq": None,                    # activations not seq-sharded by default
        # sequence-parallel attention only when heads cannot shard (both map
        # to the model axis, so exactly one of them may be active)
        "seq_q": None if shard_heads else model,
        "kv_seq": model,                # sequence-sharded KV cache (decode)
        "heads": model if shard_heads else None,
        "kv_heads": None,               # replicated (kv_heads < model axis)
        "ffn": model,
        "experts": model,
        "vocab": model,
        "lru": model,
        "lru_blocks": model,
        "qheads": model if shard_heads else None,
        "rwkv_ffn": model,
        "zero": ("data" if "data" in axes else None),
        "embed": None,                  # d_model replicated on activations
        "fsdp": ("data" if (fsdp and "data" in axes) else None),
    }
    return ShardingRules(mesh=mesh, rules=rules)


_STATE = threading.local()
# DTensor's implicit replication is one process-wide flag that its context
# manager sets and then clears, however deeply entered; use_rules nests
# (a layer's recomputation re-enters the rules, on autograd's own thread
# for CUDA tensors), so the flag is held while any use_rules with a mesh is
# open, in any thread
_IMPLICIT = {"depth": 0, "ctx": None}
_IMPLICIT_LOCK = threading.Lock()


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor.experimental import implicit_replication

    with _IMPLICIT_LOCK:
        _IMPLICIT["depth"] += 1
        if _IMPLICIT["depth"] == 1:
            _IMPLICIT["ctx"] = implicit_replication()
            _IMPLICIT["ctx"].__enter__()
    try:
        yield
    finally:
        with _IMPLICIT_LOCK:
            _IMPLICIT["depth"] -= 1
            if _IMPLICIT["depth"] == 0:
                _IMPLICIT.pop("ctx").__exit__(None, None, None)
                _IMPLICIT["ctx"] = None


def current_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        if rules is not None:
            with _implicit_replication():
                yield
        else:
            yield
    finally:
        _STATE.rules = prev


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate an intermediate with logical axes; no-op without rules."""
    rules = current_rules()
    if rules is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"rank {x.ndim} vs logical {logical}")
    if is_dtensor(x):
        want = rules.sharding(*logical)
        if tuple(x.placements) != tuple(want):
            x = x.redistribute(x.device_mesh, want)
    return x


def as_dtensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as the same
    on every rank (replicated); nothing is sent."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def on_local_shards(fn: Callable, args: Sequence[tuple[Any, tuple]],
                    out_logical: Sequence[tuple] | tuple,
                    rules: Optional[ShardingRules] = None):
    """``fn`` on each rank's local shards: ``args`` are ``(tensor, logical
    axes)`` pairs (a ``None`` tensor passes through), ``out_logical`` the
    logical axes of ``fn``'s result, or a list of them for a tuple result.
    Returns DTensors under the rules' placements.

    An input replicated over a mesh dim that the result is sharded over is
    read whole by every rank for a different part of the result, so its
    gradient is a partial sum over that dim (``Partial``), as the
    transpose of the reference's ``shard_map`` sums it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    rules = rules or current_rules()
    if rules is None:
        raise ValueError("on_local_shards needs sharding rules (use_rules)")
    outs = list(out_logical) if isinstance(out_logical, list) else [out_logical]
    split = {m for lg in outs for m, pl in enumerate(rules.sharding(*lg))
             if isinstance(pl, Shard)}
    local = []
    for x, logical in args:
        if x is None:
            local.append(None)
            continue
        if x.ndim != len(logical):
            raise ValueError(f"rank {x.ndim} vs logical {logical}")
        want = rules.sharding(*logical)
        grad = [Partial() if isinstance(pl, Replicate) and m in split else pl
                for m, pl in enumerate(want)]
        local.append(as_dtensor(x, rules.mesh).redistribute(rules.mesh, want)
                     .to_local(grad_placements=grad))
    res = fn(*local)
    res = list(res) if isinstance(res, tuple) else [res]
    res = [None if o is None else
           DTensor.from_local(o, rules.mesh, rules.sharding(*lg), run_check=False)
           for o, lg in zip(res, outs)]
    return tuple(res) if isinstance(out_logical, list) else res[0]
