"""The paper's toy model as a distributed PyTorch application (the twin of
``stencil_locality.py``).

Runs the blocked Jacobi solver over ``--ranks`` processes under the two
block→rank schedules (locality/contiguous vs scattered/round-robin),
verifies both give the physics of the whole-lattice sweep, and compares the
bytes each rank hands to ``torch.distributed``: the paper's
local-vs-nonlocal access measurement, one tier up.

    PYTHONPATH=src python examples/torch_stencil_locality.py --device cpu [--ranks 8]

On the CPU the ranks are gloo processes this script starts; with
``--device cuda`` (the default) they are NCCL ranks, one a card, and asking
for more ranks than cards raises.  ``--ranks 1`` runs its one rank in this
process.  On the card each owned slab is one launch of K1, the hand-written
Hopper Jacobi kernel.

The reference counts collective bytes in compiled XLA HLO on 8 host
devices.  Here each rank counts what it hands over: the sends of the
contiguous halo exchange, and the gathered result of the scattered
all-gather (what XLA's cost model counts for the reference's all-gather).
The contiguous exchange sends no wrap-around pair (the reference's ring
sends one and masks it), so the ratio is not the reference's.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import build_assignment
from repro_torch.kernels.jacobi.ops import jacobi_sweep
from repro_torch.kernels.jacobi.ref import jacobi_sweep_ref
from repro_torch.stencil.jacobi import (JacobiGridConfig, make_contiguous_sweep,
                                        make_scattered_sweep, reassemble_scattered,
                                        run_runtime_sweep, scatter_lattice)

BLOCKS_PER_RANK = 2
TIME_LIMIT_S = 300


def lattice(cfg):
    rng = np.random.default_rng(0)
    return rng.standard_normal((cfg.ni, cfg.nj, cfg.nk)).astype(np.float32)


def rank_main(rank, world, init, outdir, device):
    """One rank: both sweeps on its own rows; writes its results and the
    bytes it handed to ``torch.distributed`` to ``outdir``."""
    import datetime

    import torch.distributed as dist
    from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda

    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIME_LIMIT_S))
    handed = {}
    batch, gather = dist.batch_isend_irecv, dist.all_gather

    def counted_batch(ops):
        for op in ops:
            if op.op is dist.isend:
                handed["sent"] = handed.get("sent", 0) + op.tensor.numel() * op.tensor.element_size()
        return batch(ops)

    def counted_gather(tensor_list, tensor, *args, **kw):
        handed["gathered"] = sum(t.numel() * t.element_size() for t in tensor_list)
        return gather(tensor_list, tensor, *args, **kw)

    dist.batch_isend_irecv, dist.all_gather = counted_batch, counted_gather
    cfg = JacobiGridConfig(ni=160, nj=48, nk=64)
    f = torch.from_numpy(lattice(cfg)).to(device)
    rows = cfg.ni // world
    res, nbytes, launches = {}, {}, {}
    try:
        runs = {"contiguous": (make_contiguous_sweep(cfg), f),
                "scattered": (make_scattered_sweep(cfg, BLOCKS_PER_RANK),
                              scatter_lattice(f, world, BLOCKS_PER_RANK))}
        for name, (sweep, src) in runs.items():
            handed.clear()
            jacobi_sweep_cuda.launches = 0
            res[name] = sweep(src[rank * rows:(rank + 1) * rows].contiguous(), 1 / 6).cpu()
            nbytes[name] = dict(handed)
            launches[name] = jacobi_sweep_cuda.launches
    finally:
        dist.batch_isend_irecv, dist.all_gather = batch, gather
        dist.destroy_process_group()
    torch.save(res, pathlib.Path(outdir) / f"rank{rank}.pt")
    (pathlib.Path(outdir) / f"rank{rank}.json").write_text(
        json.dumps({"bytes": nbytes, "k1_launches": launches}))


def run_ranks(world, device, outdir):
    init = f"file://{pathlib.Path(outdir) / 'rendezvous'}"
    if world == 1:
        rank_main(0, 1, init, outdir, device)
        return
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "rank", str(r),
                               str(world), init, str(outdir), device])
             for r in range(world)]
    deadline = time.monotonic() + TIME_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError(f"a rank ran past {TIME_LIMIT_S} s and was killed")
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        raise RuntimeError(f"rank processes failed with exit codes {bad}")


def main(ranks=8, device=None):
    device = resolve_device(device).type
    if device == "cuda" and ranks > torch.cuda.device_count():
        raise RuntimeError(f"--ranks {ranks} needs {ranks} cards (one NCCL rank a "
                           f"card); this host has {torch.cuda.device_count()}")
    cfg = JacobiGridConfig(ni=160, nj=48, nk=64)
    f = torch.from_numpy(lattice(cfg)).to(device)

    # the schedule builder chooses contiguous slabs given block homes
    homes = np.repeat(np.arange(ranks), 160 // 10 // ranks)
    assign = build_assignment(homes, np.ones(len(homes)), ranks)
    print(f"schedule: locality={assign.locality_fraction:.0%} "
          f"imbalance={assign.imbalance:.1%} moved={assign.moved}")

    with tempfile.TemporaryDirectory(prefix="repro-torch-stencil-") as d:
        run_ranks(ranks, device, d)
        out = [torch.load(pathlib.Path(d) / f"rank{r}.pt") for r in range(ranks)]
        meta = [json.loads((pathlib.Path(d) / f"rank{r}.json").read_text())
                for r in range(ranks)]
    ref = jacobi_sweep_ref(f).cpu()
    # K1 on the card (one launch over the whole lattice), the plain sweep elsewhere
    whole = jacobi_sweep(f, di=cfg.ni, dj=cfg.nj).cpu()
    contig = torch.cat([o["contiguous"] for o in out])
    scat = reassemble_scattered(torch.cat([o["scattered"] for o in out]), ranks,
                                BLOCKS_PER_RANK)
    err_c = float((contig - ref).abs().max())
    err_s = float((scat - ref).abs().max())
    coll_c = max(m["bytes"]["contiguous"].get("sent", 0) for m in meta)
    coll_s = max(m["bytes"]["scattered"].get("gathered", 0) for m in meta)

    # the same sweep as *online* runtime tasks: slabs homed contiguously on
    # 4 domains, scheduled by the paper's locality queues (repro_torch.runtime)
    out_rt, rt = run_runtime_sweep(f, di=10, num_domains=4, workers_per_domain=2,
                                   device=device)
    err_r = float((out_rt.cpu() - ref).abs().max())

    print(f"contiguous (locality) : err={err_c:.1e} "
          f"collective={coll_c/1024:.0f} KiB/dev")
    print(f"scattered (oblivious) : err={err_s:.1e} "
          f"collective={coll_s/1024:.0f} KiB/dev")
    print(f"runtime    (online)   : err={err_r:.1e} "
          f"local={rt.local_fraction:.0%} steals={rt.stolen}")
    print(f"bytes handed to torch.distributed per rank: contiguous "
          f"{[m['bytes']['contiguous'].get('sent', 0) for m in meta]}, scattered "
          f"{[m['bytes']['scattered'].get('gathered', 0) for m in meta]}")
    print(f"-> locality schedule moves {coll_s/max(coll_c,1):.0f}x fewer "
          f"bytes across domains for the same answer")
    assert coll_c < coll_s, (coll_c, coll_s)
    return {"ranks": ranks, "device": device, "err": [err_c, err_s, err_r],
            "unequal_to_whole_sweep": [int((contig != whole).sum()),
                                       int((scat != whole).sum())],
            "bytes": [m["bytes"] for m in meta],
            "k1_launches": [m["k1_launches"] for m in meta],
            "runtime": {"local_fraction": rt.local_fraction, "stolen": rt.stolen}}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "rank":
        r, w, i, d, dev = sys.argv[2:7]
        rank_main(int(r), int(w), i, d, dev)
    else:
        ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
        ap.add_argument("--ranks", type=int, default=8)
        ap.add_argument("--device", default=None,
                        help="torch device (default: cuda; pass cpu for the CPU)")
        args = ap.parse_args()
        main(args.ranks, args.device)
