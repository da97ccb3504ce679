"""Per-rank cost of eager PyTorch code, counted op by op as it runs.

The port's counterpart of ``repro/roofline/hlo_cost.py``.  The reference
walks partitioned XLA HLO text; eager PyTorch has no such text, so this
module counts the **local aten ops** that one rank runs, as the dispatcher
hands them over, with the reference's rules:

  * products (``mm``, ``bmm``, ``addmm``, ``baddbmm``; ``matmul``,
    ``linear`` and ``einsum`` reach the dispatcher as these) count
    2 x prod(result) x K, plus one per result element for the added term;
  * elementwise ops and reductions count one per result element, the
    transcendental ones (``exp``, ``tanh``, ``log``, ``rsqrt``, ``sqrt``,
    ``pow``, ``sigmoid``, ``sin``, ``cos``, ``expm1``, ``log1p``) four; a
    fused aten op (``_softmax``, ``silu``, ``native_layer_norm``, their
    backwards) counts about what the ops XLA emits for it would;
  * bytes: an op reads its operands and writes its results.  Eager PyTorch
    does not fuse, so every op is a kernel boundary and its bytes count in
    full (XLA counts bytes only at fusion boundaries, so the two differ on
    bytes, not on operations).  Views are free; gathers (``index``,
    ``gather``, ``index_select``, ``embedding``) count 2 x result, updates
    (``index_put_``, ``scatter``, ``index_add_``, ``copy_`` into a slice)
    2 x the update;
  * collectives count wire bytes per device by the reference's kind names
    and weights (``_COLLECTIVES``), and their results as bytes.

Loops need no trip counts: eager code runs every iteration, which is what
the reference's loop multiplier reconstructs.

Under a ``DeviceMesh`` the counter returns ``NotImplemented`` for DTensor
types, so DTensor unwraps the op and the counter sees the local op on each
rank's shard, and the collectives DTensor issues.  DTensor derives each
output's global shape by running the op once on ``FakeTensor``s of the
global shapes (its sharding propagation); ops that touch a ``FakeTensor``
are not counted.  The same pass tracks the rank's live bytes: the storages
of the arguments and of every op's results, each freed when its last
reference dies, and their peak.

A hand-written kernel reached through ``ctypes`` does not pass the
dispatcher, so the counter cannot see it: its wrapper reports each launch
with :func:`kernel_launch` (what it reads and writes, each once, and its
operations), so that a step that runs the kernels is counted with the
kernels' own bytes.  Every kernel's wrapper reports, forward and backward:
K1 and K2 (``kernels/jacobi``), K3, K4 and K5.  The counters in
``_ACTIVE`` are the process's, not a thread's, so a launch on another
thread (autograd's backward, the runtime's workers) is counted too; its
aten ops are not, a dispatch mode being the entering thread's.

``count(fn, *args)`` is the entry point; ``measure`` also returns ``fn``'s
result and the counter (memory, and with ``record=True`` one ``OpRecord``
per op for ``top_ops`` and ``analysis.collective_bytes``).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import defaultdict
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op -> (kind, which tensors carry the bytes, weight): "result", "operand",
# or the index of the argument (c10d's in-place ops write into args[0])
_COLLECTIVES: dict[str, tuple[str, Any, float]] = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "result", 1.0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "result", 1.0),
    "c10d._allgather_base_": ("all-gather", 0, 1.0),
    "c10d.allgather_": ("all-gather", 0, 1.0),
    "_c10d_functional.all_reduce": ("all-reduce", "operand", 2.0),
    "_c10d_functional.all_reduce_": ("all-reduce", "operand", 2.0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "operand", 2.0),
    "c10d.allreduce_": ("all-reduce", 0, 2.0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "operand", 1.0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", "operand", 1.0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1, 1.0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1, 1.0),
    "_c10d_functional.all_to_all_single": ("all-to-all", "operand", 1.0),
    "c10d.alltoall_base_": ("all-to-all", 1, 1.0),
    "c10d.alltoall_": ("all-to-all", 1, 1.0),
    # the GPipe ring's isend/irecv: each stage sends its operand once
    "c10d.send": ("collective-permute", 0, 1.0),
}
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "ragged-all-to-all")

_TRANSCENDENTAL = {"exp", "exp2", "tanh", "log", "log2", "rsqrt", "sqrt", "pow",
                   "sigmoid", "sin", "cos", "expm1", "log1p", "erf"}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum",
    "max", "min", "amax", "amin", "sum", "mean", "prod", "where", "eq", "ne",
    "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "clamp", "clamp_min", "clamp_max", "_to_copy", "masked_fill", "sign",
    "reciprocal", "floor", "ceil", "round", "trunc", "remainder", "fmod",
    "argmax", "argmin", "cumsum", "tril", "triu", "threshold_backward",
    "nll_loss_forward", "nll_loss_backward", "linalg_vector_norm",
}
# fused aten ops: the per-element count of the ops XLA emits for them
_FUSED = {
    "_softmax": 8, "_log_softmax": 12, "_softmax_backward_data": 3,
    "_log_softmax_backward_data": 7, "silu": 5, "silu_backward": 8,
    "gelu": 11, "gelu_backward": 16, "sigmoid_backward": 2, "tanh_backward": 2,
    "native_layer_norm": 8, "native_layer_norm_backward": 12, "addcmul": 2,
    "addcdiv": 2, "lerp": 3, "softplus": 9, "softplus_backward": 6,
}
FLOPS_PER_ELEMENT = {**{n: 1 for n in _ELEMENTWISE},
                     **{n: 4 for n in _TRANSCENDENTAL}, **_FUSED}

_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "slice", "select", "unsqueeze", "squeeze", "alias",
    "detach", "as_strided", "split", "split_with_sizes", "chunk", "unbind",
    "narrow", "diagonal", "unfold", "view_as_real", "view_as_complex",
    "movedim", "expand_as", "view_as", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "wait_tensor", "_wrap_tensor_autograd", "set_", "resize_", "_conj",
    "_neg_view", "is_same_size", "_has_compatible_shallow_copy_type",
    "c10d.recv_", "c10d.broadcast_", "c10d.barrier",
}
_GATHERS = {"index", "gather", "index_select", "embedding", "narrow_copy",
            "slice_copy", "select_copy", "take", "masked_select"}
# op -> the position of its update
_UPDATES = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
            "scatter_reduce": 3, "scatter_reduce_": 3, "index_add": 3,
            "index_add_": 3, "index_copy": 3, "index_copy_": 3, "copy_": 1,
            "slice_scatter": 1, "select_scatter": 1, "masked_scatter": 2,
            "masked_scatter_": 2}
_WRITES_ONLY = {"zero_", "fill_", "zeros", "ones", "full", "zeros_like",
                "ones_like", "full_like", "arange", "scalar_tensor", "randn",
                "rand", "randint", "normal_", "uniform_", "bernoulli_"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(default_factory=lambda: defaultdict(float))

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.coll.items():
            self.coll[k] += v * mult


class OpRecord(NamedTuple):
    op: str                 # "aten.mm", "_c10d_functional.all_reduce", ...
    flops: float
    bytes: float
    operand_bytes: float    # the bytes a collective's weight reads
    result_bytes: float


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_name(func) -> tuple[str, str]:
    """("aten.mm", "mm") for an OpOverload."""
    packet = func.overloadpacket.__name__
    ns = func.namespace
    return f"{ns}.{packet}", packet


def _product_flops(name: str, args: tuple, out: torch.Tensor) -> float:
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addbmm"):
        return 2.0 * out.numel() * args[1].shape[-1] + out.numel()
    if name in ("mv", "dot"):
        return 2.0 * args[0].numel()
    if name == "convolution":
        w = args[1]
        k = w.shape[1] * (w[0, 0].numel() if w.ndim > 2 else 1)
        return 2.0 * out.numel() * k
    return 0.0


_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot", "convolution"}


def op_cost(func, args: tuple, kwargs: dict, out: Any) -> OpRecord:
    """One local op's cost under the rules above."""
    full, name = _op_name(func)
    results = _tensors(out)
    result_bytes = float(sum(_nbytes(t) for t in results))
    if full in _COLLECTIVES:
        _, side, _ = _COLLECTIVES[full]
        if side == "result":
            operand = result_bytes
        elif side == "operand":
            operand = float(sum(_nbytes(t) for t in _tensors(args)))
        else:
            operand = float(sum(_nbytes(t) for t in _tensors(args[side])))
        return OpRecord(full, 0.0, result_bytes, operand, result_bytes)
    if name in _FREE or full in _FREE:
        return OpRecord(full, 0.0, 0.0, 0.0, result_bytes)

    flops = 0.0
    first = results[0] if results else None
    if name in _PRODUCTS:
        flops = _product_flops(name, args, first)
    elif first is not None:
        per = FLOPS_PER_ELEMENT.get(name, 0)
        if name == "pow" and len(args) > 1 and isinstance(args[1], (int, float)) \
                and args[1] == 2:
            per = 1                     # x ** 2 is a product (jnp.square)
        flops = float(per * first.numel())

    if name in _GATHERS:
        nbytes = 2.0 * result_bytes
    elif name in _UPDATES:
        pos = _UPDATES[name]
        upd = args[pos] if len(args) > pos else None
        if isinstance(upd, (list, tuple)) or upd is None:
            upd = kwargs.get("values", kwargs.get("src"))
        if isinstance(upd, torch.Tensor):
            nbytes = 2.0 * _nbytes(upd)
        else:                           # a scalar written at each index
            idx = next((t for t in _tensors(args[1:]) if not t.is_floating_point()), None)
            nbytes = 2.0 * (idx.numel() if idx is not None else 1) * args[0].element_size()
    elif name in _WRITES_ONLY:
        nbytes = result_bytes
    else:
        seen, operand = set(), 0
        for t in _tensors(args) + _tensors(kwargs):
            if id(t) not in seen:
                seen.add(id(t))
                operand += _nbytes(t)
        nbytes = operand + result_bytes
    return OpRecord(full, flops, nbytes, 0.0, result_bytes)


def wire_bytes(rec: OpRecord) -> tuple[str, float] | None:
    """(kind, wire bytes per device) of a collective's record, else None."""
    entry = _COLLECTIVES.get(rec.op)
    if entry is None:
        return None
    kind, _, weight = entry
    return kind, rec.operand_bytes * weight


# the counters entered and not yet left, for :func:`kernel_launch` (a list
# of the process, not of a thread: autograd runs a CUDA backward on a
# thread of its own, the runtime's slab tasks run on its workers)
_ACTIVE: list["OpCounter"] = []


class OpCounter(TorchDispatchMode):
    """Counts every local op run under it (see the module docstring) and
    tracks the live bytes of the storages it has seen.  Its totals are
    updated under a lock: kernels report from other threads."""

    def __init__(self, record: bool = False):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        super().__init__()
        self._fake, self._dtensor = FakeTensor, DTensor
        self.cost = Cost()
        self.records: list[OpRecord] | None = [] if record else None
        self.live = 0
        self.peak = 0
        self._storages: dict[int, tuple[weakref.ref, int]] = {}
        # re-entrant: a storage's weakref callback may fire inside an update
        self.lock = threading.RLock()

    # -- memory -------------------------------------------------------------
    def _locals(self, tree: Any) -> list[torch.Tensor]:
        """``tree``'s tensors, a DTensor as its local shard."""
        return [t._local_tensor if isinstance(t, self._dtensor) else t
                for t in _tensors(tree)]

    def track(self, tree: Any) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live; returns the bytes newly tracked."""
        return sum(self._track_storage(t) for t in self._locals(tree))

    def _track_storage(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        with self.lock:
            if key in self._storages:
                return 0
            n = st.nbytes()
            self._storages[key] = (weakref.ref(st, lambda _r, k=key: self._free(k)), n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return n

    def _free(self, key: int) -> None:
        with self.lock:
            entry = self._storages.pop(key, None)
            if entry is not None:
                self.live -= entry[1]

    def storage_ids(self, tree: Any) -> dict[int, int]:
        """{storage id: bytes} of ``tree``'s tensors (local shards)."""
        return {id(st): st.nbytes() for st in
                (t.untyped_storage() for t in self._locals(tree))}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- dispatch ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented       # let DTensor hand over the local op
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, self._fake) for t in outs) or \
                any(isinstance(t, self._fake) for t in _tensors(args)):
            return out                  # DTensor's sharding propagation
        rec = op_cost(func, args, kwargs, out)
        wire = wire_bytes(rec)
        with self.lock:
            self.cost.flops += rec.flops
            self.cost.bytes += rec.bytes
            if wire is not None:
                self.cost.coll[wire[0]] += wire[1]
            if self.records is not None:
                self.records.append(rec)
            for t in outs:
                self._track_storage(t)
        return out


def kernel_launch(name: str, reads, writes, flops: float) -> None:
    """Count one launch of a hand-written kernel in every active counter:
    each tensor of ``reads`` read once and each of ``writes`` written once
    (a tensor updated in place is in both), ``flops`` as given, the
    storages of ``writes`` as live.  Costs nothing when no counter is
    active; safe from any thread."""
    if not _ACTIVE:
        return

    def once(tensors):
        return {id(t): _nbytes(t) for t in _tensors(list(tensors))}
    result_bytes = float(sum(once(writes).values()))
    nbytes = float(sum(once(reads).values())) + result_bytes
    for counter in list(_ACTIVE):
        with counter.lock:
            counter.cost.flops += flops
            counter.cost.bytes += nbytes
            if counter.records is not None:
                counter.records.append(OpRecord(f"kernel.{name}", float(flops),
                                                float(nbytes), 0.0, result_bytes))
            for t in _tensors(list(writes)):
                counter._track_storage(t)


def measure(fn: Callable, *args, record: bool = False, **kwargs):
    """``(fn(*args, **kwargs), counter)``: the result and the ``OpCounter``
    that ran it, with ``args`` tracked as live from the start."""
    counter = OpCounter(record=record)
    counter.track((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


def count(fn: Callable, *args, **kwargs) -> Cost:
    """The per-rank cost of ``fn(*args, **kwargs)``."""
    return measure(fn, *args, **kwargs)[1].cost


def top_ops(records: list[OpRecord], n: int = 20):
    """Debug: the heaviest ops by bytes, summed by op name, as rows of
    (bytes, flops, calls, op) (the counterpart of ``top_instructions``)."""
    by_op: dict[str, list[float]] = defaultdict(lambda: [0.0, 0.0, 0])
    for r in records:
        row = by_op[r.op]
        row[0] += r.bytes
        row[1] += r.flops
        row[2] += 1
    rows = sorted(((b, f, c, op) for op, (b, f, c) in by_op.items()), reverse=True)
    return rows[:n]
