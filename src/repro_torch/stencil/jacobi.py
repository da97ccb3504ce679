"""The paper's blocked Jacobi solver on PyTorch (counterpart of
``repro.stencil.jacobi``).

The lattice's i-axis is cut into slabs, and the *block -> rank assignment*
plays the role of page placement:

  * ``make_contiguous_sweep`` (the paper's parallel first touch + locality
    queues): each rank owns one contiguous slab, and a sweep exchanges two
    boundary planes with its neighbours (``batch_isend_irecv``);
  * ``make_scattered_sweep`` (dynamic scheduling with no locality control):
    slabs are strided over ranks, so every slab boundary crosses a rank
    boundary, and one all-gather hands each rank every slab's boundary
    planes — about ``ranks x blocks_per_dev`` times the contiguous bytes.

Both run on ``torch.distributed`` (NCCL on the card, gloo on the CPU), one
process per rank; the process group stands in for the reference's mesh
axis.  Each owned slab, padded with its two halo planes, is one launch of
the Hopper sweep kernel (K1).

``run_runtime_sweep`` is the online path: one whole-lattice sweep cut into
slabs of ``di`` rows, each slab update one ``runtime.Task`` homed on a
locality domain (contiguous slabs per domain), drained by the port's copy
of the locality-queue ``Executor``.  Each slab task launches K1 once, on
the whole lattice with the slab's row range: the kernel reads the halo
planes from the lattice and takes zeros past its edges.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..kernels.jacobi.ops import jacobi_sweep
from ..runtime import Executor, RuntimeStats, StealGovernor

# a lost peer fails the exchange after this long instead of hanging it
EXCHANGE_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class JacobiGridConfig:
    ni: int = 240
    nj: int = 60
    nk: int = 64
    di: int = 10
    dj: int = 10
    dtype: str = "float32"
    axis: str = "data"          # mesh axis the i-axis is sharded over


def _halo_exchange(local: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fetch the previous rank's last plane and the next rank's first plane.

    Contiguous slab ownership: one send to each neighbour, one receive from
    each (the locality-optimal schedule).  The edge ranks take zero planes
    (Dirichlet); the reference's ring also sends the wrap pair and masks it
    on arrival, so it is not sent here.
    """
    n, r = dist.get_world_size(group), dist.get_rank(group)
    up, down = torch.zeros_like(local[0]), torch.zeros_like(local[0])
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, local[0], group=group, group_peer=r - 1),
                dist.P2POp(dist.irecv, up, group=group, group_peer=r - 1)]
    if r < n - 1:
        ops += [dist.P2POp(dist.isend, local[-1], group=group, group_peer=r + 1),
                dist.P2POp(dist.irecv, down, group=group, group_peer=r + 1)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait(timeout=EXCHANGE_TIMEOUT)
    return up, down


def _sweep_padded(up, slab, down, use_kernel, out=None) -> torch.Tensor:
    """Rows of ``slab`` after one sweep, with ``up``/``down`` as its halo
    planes: one launch of K1 (with ``use_kernel`` on a CUDA tensor) on the
    padded slab, writing only its interior rows.  ``di``/``dj`` are the
    padded slab's own extents: the kernel path only checks that they divide."""
    padded = torch.cat([up[None], slab, down[None]])
    si, nj = slab.shape[0], slab.shape[1]
    return jacobi_sweep(padded, 1.0 / 6.0, di=si + 2, dj=nj, use_kernel=use_kernel,
                        out=out, rows=(1, si + 1))


def make_contiguous_sweep(cfg: JacobiGridConfig, use_kernel: bool = True, *, group=None):
    """Sweep with contiguous slab ownership (the locality schedule).

    Returns ``sweep(f_local, c)``, called on every rank of ``group`` (the
    default group unless given; it stands in for ``cfg.axis``) with that
    rank's contiguous slab of ``cfg.ni // ranks`` rows, in rank order; each
    rank gets its rows of the whole-lattice sweep back.  ``c`` is ignored
    and the sweep uses 1/6, as the reference's does (its quirk R2).  Unlike
    the reference, which never reaches its kernel here, ``use_kernel``
    reaches K1: the same sum in the same order, so the result is the same.
    """

    def sweep(f_local: torch.Tensor, c) -> torch.Tensor:
        up, down = _halo_exchange(f_local, group)
        return _sweep_padded(up, f_local, down, use_kernel)

    return sweep


def make_scattered_sweep(cfg: JacobiGridConfig, blocks_per_dev: int, *,
                         use_kernel: bool = True, group=None):
    """Sweep under a locality-oblivious (strided) block -> rank assignment.

    Rank d owns i-slabs {d, d+n, d+2n, ...}: every slab boundary is a rank
    boundary, so the halo for *each* owned slab comes from another rank.
    One all-gather of every slab's two boundary planes stands for it: the
    honest communication cost of scattering.  ``sweep(f_local, c)`` takes
    rank d's slabs stacked in that order (``scatter_lattice``'s rows for
    rank d) and returns them swept, one K1 launch per slab; ``c`` is
    ignored as in the reference (1/6).
    """

    def sweep(f_local: torch.Tensor, c) -> torch.Tensor:
        n, d = dist.get_world_size(group), dist.get_rank(group)
        si = f_local.shape[0] // blocks_per_dev     # rows per slab
        slabs = f_local.reshape(blocks_per_dev, si, *f_local.shape[1:])
        bounds = torch.stack([slabs[:, 0], slabs[:, -1]], dim=1)   # (bpd, 2, nj, nk)
        gathered = bounds.new_empty((n, *bounds.shape))
        dist.all_gather(list(gathered.unbind(0)), bounds, group=group,
                        async_op=True).wait(timeout=EXCHANGE_TIMEOUT)
        total = n * blocks_per_dev
        zero = torch.zeros_like(f_local[0])

        def plane(g, which):
            # global slab g is owned by rank g % n as its (g // n)-th slab
            return gathered[g % n, g // n, which] if 0 <= g < total else zero

        out = torch.empty_like(f_local)
        for b in range(blocks_per_dev):
            g = d + b * n                      # strided ownership
            _sweep_padded(plane(g - 1, 1), slabs[b], plane(g + 1, 0), use_kernel,
                          out=out[b * si:(b + 1) * si])
        return out

    return sweep


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

    ``trace`` takes any recorder with ``.attach(executor)``, such as the
    port's ``repro_torch.trace.TraceRecorder``: the slab-task schedule is
    then recorded for offline analysis and deterministic replay
    (``repro_torch.trace.replay`` re-drives the same slab arrivals under any
    policy with placeholder payloads: it studies the *schedule*).

    ``spec`` takes a ``repro_torch.spec.RuntimeSpec`` and builds the
    executor from it (the scheduling-policy kwargs above are then ignored,
    and a recorded trace embeds the spec, so ``replay(trace)`` rebuilds the
    schedule with no factory).  A spec that declares its own recording
    raises ``SpecError``: this function returns no recorder.
    """
    dev = resolve_device(device)
    f = torch.as_tensor(f, device=dev).contiguous()
    ni, nj, _ = f.shape
    if ni % di != 0:
        raise ValueError(f"i extent {ni} not divisible by slab size {di}")
    nslabs = ni // di
    out = torch.empty_like(f)

    def update_slab(task, worker):
        # Rows i0 .. i0 + di of the whole-lattice sweep, straight into
        # ``out``: the halo planes are f's own rows, or zeros past the
        # lattice's edges, so the rows equal the whole-lattice sweep.
        i0 = task.payload * di
        jacobi_sweep(f, c, di=di, dj=nj, out=out[i0:i0 + di], rows=(i0, i0 + di))

    if spec is not None:
        if spec.trace.record:
            from ..spec import SpecError
            raise SpecError(
                "run_runtime_sweep returns only (lattice, stats) and cannot "
                "hand back a spec-declared recorder; record via the trace= "
                "kwarg (and TraceSpec(record=False)) instead")
        num_domains = spec.num_domains
        ex = spec.build(handler=update_slab).executor
    else:
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
