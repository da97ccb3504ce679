"""The vocab-parallel cross-entropy (``repro_torch.models.common``) against the
JAX package's ``cross_entropy``.

Logits whose vocab axis a mesh shards take ``VocabParallelNLL`` on each
rank's shard.  Eight gloo ranks of this file (``python
tests/test_torch_vocab_loss.py rank R 8 INIT DIR``) compute the loss and its
logits gradient on (2, 4) and (4, 2) meshes, with and without a mask, and
with a planted fault (the gold pick at the global offset 0 in place of the
shard's own); one more process (``... single DIR``) runs a (1, 1) gloo mesh
against the plain form bit for bit, then counts the loss on a (16, 16) mesh
of PyTorch's fake process group (256 ranks) under ``roofline.op_cost``.
Every process is waited for with a time limit.

Limits are the reference check's: the loss to rtol 2e-5 and the gradient to
atol 2e-4 against the JAX package's ``cross_entropy`` and ``jax.grad`` of it
on the same numpy-seeded inputs.  The vocab of 1001 words does not divide
by 2 or 4, so the shards are uneven and the offsets are not multiples of
one shard's length.
"""
import datetime
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
TIME_LIMIT_S = 180
B, S, V = 8, 6, 1001
MESHES = ((2, 4), (4, 2))
# the fake group's cell: 256 ranks, bf16 logits over a vocab of 8192
FAKE_MESH, FAKE_SHAPE = (16, 16), (32, 64, 8192)


def _inputs():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int64)
    labels[0, :3] = (0, V - 1, 500)          # the first word, the last, a shard edge
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return {"logits": logits, "labels": labels, "mask": mask}


# -- the rank processes ------------------------------------------------------

def _loss_and_grad(logits, labels, mask, placements, mesh):
    """The loss and the whole logits gradient on ``mesh``; labels and mask
    as plain tensors (replicated values) under implicit replication."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.common import cross_entropy

    x = distribute_tensor(logits, mesh, placements).requires_grad_(True)
    with implicit_replication():
        loss = cross_entropy(x, labels, mask)
        (g,) = torch.autograd.grad(loss, x)
    return loss.full_tensor().detach(), g.full_tensor()


def _rank_main(rank, world, init, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import common

    inp = {k: torch.from_numpy(v) for k, v in np.load(pathlib.Path(out) / "inputs.npz").items()}
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            tag = f"{shape[0]}x{shape[1]}"
            for masked in (False, True):
                mask = inp["mask"] if masked else None
                if masked:
                    loss, g = _loss_and_grad(inp["logits"], inp["labels"], mask,
                                             [Shard(0), Shard(2)], mesh)
                else:           # the labels as a DTensor placed as the batch
                    from repro_torch.models.common import cross_entropy
                    x = distribute_tensor(inp["logits"], mesh,
                                          [Shard(0), Shard(2)]).requires_grad_(True)
                    lab = distribute_tensor(inp["labels"], mesh, [Shard(0), Replicate()])
                    loss_d = cross_entropy(x, lab)
                    (gd,) = torch.autograd.grad(loss_d, x)
                    loss, g = loss_d.full_tensor().detach(), gd.full_tensor()
                res[f"{tag}_{'mask' if masked else 'plain'}"] = (loss, g)
            # the planted fault: every shard picks its gold at offset 0
            real = common._vocab_shard
            common._vocab_shard = lambda logits, dims: (0, real(logits, dims)[1])
            try:
                res[f"{tag}_fault"] = _loss_and_grad(inp["logits"], inp["labels"], None,
                                                     [Shard(0), Shard(2)], mesh)
            finally:
                common._vocab_shard = real
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(res, pathlib.Path(out) / "ranks.pt")


def _single_main(out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import fake_world
    from repro_torch.models.common import cross_entropy
    from repro_torch.roofline.op_cost import measure, wire_bytes

    out = pathlib.Path(out)
    inp = {k: torch.from_numpy(v) for k, v in np.load(out / "inputs.npz").items()}
    res = {}

    # (1, 1): the vocab-parallel path against the plain form, bit for bit
    dist.init_process_group("gloo", init_method=f"file://{out / 'single_rendezvous'}",
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        for dtype in (torch.float32, torch.bfloat16):
            for mask in (None, inp["mask"]):
                x0 = inp["logits"].to(dtype)
                plain = x0.clone().requires_grad_(True)
                want = cross_entropy(plain, inp["labels"], mask)
                (want_g,) = torch.autograd.grad(want, plain)
                got, got_g = _loss_and_grad(x0, inp["labels"], mask, [Shard(0), Shard(2)],
                                            mesh)
                tag = f"{str(dtype)[6:]}_{'plain' if mask is None else 'mask'}"
                res[f"one_{tag}"] = (want, want_g, got, got_g)
    finally:
        dist.destroy_process_group()

    # 256 fake ranks: what the loss sends and holds on rank 0
    b, s, v = FAKE_SHAPE
    with fake_world(FAKE_MESH[0] * FAKE_MESH[1]):
        mesh = init_device_mesh("cpu", FAKE_MESH, mesh_dim_names=("data", "model"))
        bl, vl = b // FAKE_MESH[0], v // FAKE_MESH[1]
        g = torch.Generator().manual_seed(0)
        x = DTensor.from_local(torch.randn((bl, s, vl), generator=g).bfloat16(), mesh,
                               [Shard(0), Shard(2)], run_check=False, shape=FAKE_SHAPE,
                               stride=(s * v, v, 1)).requires_grad_(True)
        lab = DTensor.from_local(torch.randint(0, v, (bl, s), generator=g), mesh,
                                 [Shard(0), Replicate()], run_check=False, shape=(b, s),
                                 stride=(s, 1))
        loss, fwd = measure(cross_entropy, x, lab, record=True)
        (grad,), bwd = measure(torch.autograd.grad, loss, x, record=True)
        res["fake"] = {
            "forward": [(r.op, wire_bytes(r)[0], r.operand_bytes) for r in fwd.records
                        if wire_bytes(r)],
            "backward": [(r.op, wire_bytes(r)[0], r.operand_bytes) for r in bwd.records
                         if wire_bytes(r)],
            "peak": max(fwd.peak, bwd.peak), "rows": bl * s,
            "grad": (str(tuple(grad.placements)), tuple(grad.to_local().shape),
                     str(grad.dtype))}
    torch.save(res, out / "single.pt")


# -- the test's side ---------------------------------------------------------

def _jax_reference(inp):
    import jax
    import jax.numpy as jnp

    from repro.models.common import cross_entropy

    out = {}
    for masked in (False, True):
        mask = jnp.asarray(inp["mask"]) if masked else None

        def f(x):
            return cross_entropy(x, jnp.asarray(inp["labels"]), mask)
        loss, g = jax.value_and_grad(f)(jnp.asarray(inp["logits"]))
        out["mask" if masked else "plain"] = (np.asarray(loss), np.asarray(g))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab_loss")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    this = str(pathlib.Path(__file__).resolve())
    init = f"file://{d / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, this, "rank", str(r), str(WORLD), init, str(d)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen([sys.executable, this, "single", str(d)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ref = _jax_reference(inp)
    deadline = time.monotonic() + TIME_LIMIT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a process ran past {TIME_LIMIT_S} s and was killed")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return (torch.load(d / "ranks.pt", weights_only=False),
            torch.load(d / "single.pt", weights_only=False), ref)


def _off(got, want):
    """(the loss's relative gap, the gradient's largest absolute gap)."""
    (loss, g), (rloss, rg) = got, want
    return (abs(float(loss) - float(rloss)) / abs(float(rloss)),
            float(np.abs(g.numpy() - rg).max()))


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("kind", ["plain", "mask"])
def test_sharded_loss_and_gradient_match_jax(runs, mesh, kind):
    ranks, _, ref = runs
    loss_gap, grad_gap = _off(ranks[f"{mesh}_{kind}"], ref[kind])
    assert loss_gap <= 2e-5
    assert grad_gap <= 2e-4


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
def test_planted_fault_fails_the_parity_check(runs, mesh):
    """The gold picked at offset 0 on every shard: the check above must
    see it."""
    ranks, _, ref = runs
    loss_gap, grad_gap = _off(ranks[f"{mesh}_fault"], ref["plain"])
    assert loss_gap > 2e-5 and grad_gap > 2e-4


@pytest.mark.parametrize("case", ["float32_plain", "float32_mask", "bfloat16_plain",
                                  "bfloat16_mask"])
def test_one_rank_mesh_is_the_plain_form_bit_for_bit(runs, case):
    want, want_g, got, got_g = runs[1][f"one_{case}"]
    assert torch.equal(got, want.detach())
    assert got_g.dtype == want_g.dtype
    assert torch.equal(got_g.view(torch.int16 if got_g.dtype == torch.bfloat16
                                  else torch.int32),
                       want_g.view(torch.int16 if want_g.dtype == torch.bfloat16
                                   else torch.int32))


def test_forward_sends_three_row_sized_all_reduces(runs):
    fake = runs[1]["fake"]
    assert [(op, kind) for op, kind, _ in fake["forward"]] == \
        [("c10d.allreduce_", "all-reduce")] * 3
    assert all(nbytes == fake["rows"] * 4 for _, _, nbytes in fake["forward"])


def test_backward_sends_nothing(runs):
    fake = runs[1]["fake"]
    assert fake["backward"] == []
    b, s, v = FAKE_SHAPE
    assert fake["grad"] == ("(Shard(dim=0), Shard(dim=2))",
                            (b // FAKE_MESH[0], s, v // FAKE_MESH[1]), "torch.bfloat16")


def test_peak_stays_below_one_whole_vocab_copy(runs):
    """Rank 0 never holds its rows' logits over the whole vocab in f32."""
    fake = runs[1]["fake"]
    assert fake["peak"] < fake["rows"] * FAKE_SHAPE[2] * 4


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1] == "rank":
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        _single_main(sys.argv[2])
