"""The port's SPMD sweeps (``make_contiguous_sweep``, ``make_scattered_sweep``
of ``repro_torch.stencil.jacobi``) on ``torch.distributed``, held against
the JAX package.

Each world size runs as that many processes of this file (``python
tests/test_torch_spmd.py rank ...``) on the gloo backend, joined through a
file under ``tmp_path``; the JAX package's own shard_map sweeps run in one
more process with four host devices (``python tests/test_torch_spmd.py
jax ...``), as ``tests/test_distributed.py`` runs them.  Every process is
waited for with a time limit and killed on overrun.  The lattices come from
a numpy seed, and each rank's slab is its rows of the same array.

Tolerance: the plain sweep sums the six neighbours in the reference's order
in f32, so any gap is reassociation by the backend (atol 1e-6, rtol 0, as
``tests/test_torch_jacobi.py`` states for plain against JAX).

The bytes each rank hands to ``torch.distributed`` are counted by wrapping
``batch_isend_irecv`` and ``all_gather`` in the rank processes: the sends
of the contiguous exchange, and the all-gather's gathered result (what
XLA's cost model counts for the reference's collectives).
"""
import datetime
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
SCHEDULES = ("contiguous", "scattered")
TIME_LIMIT_S = 120


def _cases(n):
    """(name, lattice shape, blocks per rank) for ``n`` ranks: each rank's
    contiguous slab is ``shape[0] // n`` rows; the scattered schedule cuts
    it into ``bpd`` slabs (odd extents in the second case)."""
    return [("even", (8 * n, 6, 8), 2), ("odd", (12 * n, 5, 7), 4)]


def _lattice(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _local(f, n, rank, schedule, bpd, scatter):
    """Rank ``rank``'s rows of ``f``: its contiguous slab, or its strided
    slabs in ``scatter_lattice``'s order."""
    rows = f.shape[0] // n
    src = f if schedule == "contiguous" else scatter(f, n, bpd)
    return src[rank * rows:(rank + 1) * rows]


# -- the processes ---------------------------------------------------------

def _rank_main(backend, rank, world, init, out):
    """One rank: run both sweeps on every case, write the results and the
    bytes handed to each call to ``out``."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
    from repro_torch.stencil import jacobi as port

    dev = torch.device("cuda" if backend == "nccl" else "cpu")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIME_LIMIT_S))
    handed = {}
    batch, gather = dist.batch_isend_irecv, dist.all_gather

    def counted_batch(ops):
        for op in ops:
            key = "p2p_sent" if op.op is dist.isend else "p2p_received"
            handed[key] = handed.get(key, 0) + op.tensor.numel() * op.tensor.element_size()
        return batch(ops)

    def counted_gather(tensor_list, tensor, *args, **kw):
        handed["all_gather_in"] = tensor.numel() * tensor.element_size()
        handed["all_gather_out"] = sum(t.numel() * t.element_size() for t in tensor_list)
        return gather(tensor_list, tensor, *args, **kw)

    dist.batch_isend_irecv, dist.all_gather = counted_batch, counted_gather
    results, nbytes, launches = {}, {}, {}
    try:
        for name, shape, bpd in _cases(world):
            f = torch.from_numpy(_lattice(shape)).to(dev)
            cfg = port.JacobiGridConfig(ni=shape[0], nj=shape[1], nk=shape[2])
            sweeps = {"contiguous": lambda **kw: port.make_contiguous_sweep(cfg, **kw),
                      "scattered": lambda **kw: port.make_scattered_sweep(cfg, bpd, **kw)}
            for schedule, make in sweeps.items():
                local = _local(f, world, rank, schedule, bpd, port.scatter_lattice)
                local = local.contiguous()
                key = f"{name}-{schedule}"
                handed.clear()
                jacobi_sweep_cuda.launches = 0
                results[key] = make()(local, 1 / 6)
                launches[key] = jacobi_sweep_cuda.launches
                nbytes[key] = dict(handed)
                results[f"{key}-c0.25"] = make()(local, 0.25)
                results[f"{key}-plain"] = make(use_kernel=False)(local, 1 / 6)
    finally:
        dist.batch_isend_irecv, dist.all_gather = batch, gather
        dist.destroy_process_group()
    np.savez(pathlib.Path(out) / f"rank{rank}.npz",
             **{k: v.cpu().numpy() for k, v in results.items()})
    (pathlib.Path(out) / f"rank{rank}.json").write_text(
        json.dumps({"bytes": nbytes, "launches": launches}))


def _jax_main(out):
    """The JAX package's SPMD sweeps at every world size, on host devices."""
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={max(WORLDS)}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.stencil.jacobi import (JacobiGridConfig, make_contiguous_sweep,
                                      make_scattered_sweep, reassemble_scattered,
                                      scatter_lattice)

    res = {}
    for n in WORLDS:
        mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n],
                             axis_types=(jax.sharding.AxisType.Auto,))
        for name, shape, bpd in _cases(n):
            cfg = JacobiGridConfig(ni=shape[0], nj=shape[1], nk=shape[2])
            f = jnp.asarray(_lattice(shape))
            c = jnp.float32(1 / 6)
            with jax.set_mesh(mesh):
                fs = jax.device_put(f, NamedSharding(mesh, P("data", None, None)))
                res[f"{n}-{name}-contiguous"] = jax.jit(make_contiguous_sweep(cfg))(fs, c)
                fs2 = jax.device_put(scatter_lattice(f, n, bpd),
                                     NamedSharding(mesh, P("data", None, None)))
                out2 = jax.jit(make_scattered_sweep(cfg, bpd))(fs2, c)
                res[f"{n}-{name}-scattered"] = reassemble_scattered(out2, n, bpd)
    np.savez(pathlib.Path(out) / "jax.npz", **{k: np.asarray(v) for k, v in res.items()})


# -- the tests ---------------------------------------------------------------

def _spawn(args, env):
    return subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()), *args],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _join(procs, deadline):
    """Wait for every process until ``deadline``; kill them all and fail on
    overrun or on a non-zero exit."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a process ran past {TIME_LIMIT_S} s and was killed")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _run_world(backend, world, tmp, env, deadline):
    """Run ``world`` ranks; return (per-rank npz results, per-rank json)."""
    d = tmp / f"{backend}{world}"
    d.mkdir()
    init = f"file://{d / 'rendezvous'}"
    _join([_spawn(["rank", backend, str(r), str(world), init, str(d)], env)
           for r in range(world)], deadline)
    return ([dict(np.load(d / f"rank{r}.npz")) for r in range(world)],
            [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def _assemble(ranks, key, n, bpd, schedule):
    from repro_torch.stencil.jacobi import reassemble_scattered

    out = np.concatenate([r[key] for r in ranks])
    if schedule == "scattered":
        out = reassemble_scattered(torch.from_numpy(out), n, bpd).numpy()
    return out


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Every world size on gloo, and the JAX package's sweeps, run once."""
    tmp = tmp_path_factory.mktemp("spmd")
    env = _env()
    deadline = time.monotonic() + TIME_LIMIT_S
    jax_proc = _spawn(["jax", str(tmp)], env)
    worlds = {n: _run_world("gloo", n, tmp, env, deadline) for n in WORLDS}
    _join([jax_proc], deadline)
    return worlds, dict(np.load(tmp / "jax.npz"))


def _whole_lattice_ref(shape):
    import jax.numpy as jnp
    from repro.kernels.jacobi.ref import jacobi_sweep_ref

    return np.asarray(jacobi_sweep_ref(jnp.asarray(_lattice(shape))))


CASES = [(n, name, schedule) for n in WORLDS for name in ("even", "odd")
         for schedule in SCHEDULES]


def _case(n, name):
    return next(c for c in _cases(n) if c[0] == name)


class TestAgainstReference:
    @pytest.mark.parametrize("n,name,schedule", CASES)
    def test_equals_whole_lattice_ref(self, spmd, n, name, schedule):
        ranks, _ = spmd[0][n]
        _, shape, bpd = _case(n, name)
        got = _assemble(ranks, f"{name}-{schedule}", n, bpd, schedule)
        np.testing.assert_allclose(got, _whole_lattice_ref(shape), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("n,name,schedule", CASES)
    def test_equals_jax_spmd_sweep(self, spmd, n, name, schedule):
        ranks, _ = spmd[0][n]
        _, _, bpd = _case(n, name)
        got = _assemble(ranks, f"{name}-{schedule}", n, bpd, schedule)
        np.testing.assert_allclose(got, spmd[1][f"{n}-{name}-{schedule}"], rtol=0, atol=1e-6)

    @pytest.mark.parametrize("n,schedule", [(n, s) for n in WORLDS for s in SCHEDULES])
    def test_c_is_ignored_as_in_reference(self, spmd, n, schedule):
        """R2, kept as P11: both sweeps use 1/6 whatever ``c`` says."""
        ranks, _ = spmd[0][n]
        for r in ranks:
            np.testing.assert_array_equal(r[f"even-{schedule}-c0.25"], r[f"even-{schedule}"])

    @pytest.mark.parametrize("n,schedule", [(n, s) for n in WORLDS for s in SCHEDULES])
    def test_plain_path_is_the_same(self, spmd, n, schedule):
        ranks, _ = spmd[0][n]
        for r in ranks:
            for name in ("even", "odd"):
                np.testing.assert_array_equal(r[f"{name}-{schedule}-plain"],
                                              r[f"{name}-{schedule}"])


class TestCommunication:
    @pytest.mark.parametrize("n", WORLDS)
    def test_bytes_handed_per_rank(self, spmd, n):
        """Contiguous: one plane to each neighbour that exists.  Scattered:
        every slab's two boundary planes, gathered from every rank."""
        _, meta = spmd[0][n]
        for name, shape, bpd in _cases(n):
            plane = 4 * shape[1] * shape[2]
            for r, m in enumerate(meta):
                neighbours = (r > 0) + (r < n - 1)
                contig = m["bytes"][f"{name}-contiguous"]
                assert contig == ({"p2p_sent": neighbours * plane,
                                   "p2p_received": neighbours * plane}
                                  if neighbours else {})
                assert m["bytes"][f"{name}-scattered"] == {
                    "all_gather_in": bpd * 2 * plane,
                    "all_gather_out": n * bpd * 2 * plane}

    @pytest.mark.parametrize("n", [2, 4])
    def test_scattered_over_contiguous_ratio(self, spmd, n):
        """The most any rank hands over: ``n x bpd`` times the contiguous
        sends of an inner rank (2 planes), ``2 n bpd`` at two ranks, where
        each rank has one neighbour."""
        _, meta = spmd[0][n]
        for name, _, bpd in _cases(n):
            contig = max(m["bytes"][f"{name}-contiguous"]["p2p_sent"] for m in meta)
            scat = max(m["bytes"][f"{name}-scattered"]["all_gather_out"] for m in meta)
            assert scat / contig == (n * bpd if n > 2 else 2 * n * bpd)

    @pytest.mark.parametrize("n", WORLDS)
    def test_cpu_ranks_launch_no_kernel(self, spmd, n):
        """On the CPU the wrappers take the plain version and count no
        launch; on the card the same sweeps launch K1 once per padded slab
        (``test_one_nccl_rank_on_the_card``)."""
        _, meta = spmd[0][n]
        assert all(v == 0 for m in meta for v in m["launches"].values())


@pytest.mark.cuda
def test_one_nccl_rank_on_the_card(tmp_path):
    """One NCCL rank on the card (NCCL takes one rank per GPU): K1 once for
    the contiguous sweep and once per slab for the scattered one, equal to
    the whole-lattice sweep bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernels have no CPU mode)")
    import torch.distributed as dist
    if not dist.is_nccl_available():
        pytest.skip("this PyTorch has no NCCL")
    ranks, meta = _run_world("nccl", 1, tmp_path, _env(), time.monotonic() + TIME_LIMIT_S)
    from repro_torch.kernels.jacobi.ref import jacobi_sweep_ref

    for name, shape, bpd in _cases(1):
        want = jacobi_sweep_ref(torch.from_numpy(_lattice(shape))).numpy()
        assert meta[0]["launches"][f"{name}-contiguous"] == 1
        assert meta[0]["launches"][f"{name}-scattered"] == bpd
        for schedule in SCHEDULES:
            got = _assemble(ranks, f"{name}-{schedule}", 1, bpd, schedule)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            assert (got != _assemble(ranks, f"{name}-{schedule}-plain", 1, bpd,
                                     schedule)).sum() == 0


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        backend, rank, world, init, out = sys.argv[2:7]
        _rank_main(backend, int(rank), int(world), init, out)
    else:
        _jax_main(sys.argv[2])
