"""The port's op counter (``repro_torch.roofline``) against hand counts and
against the JAX package's HLO cost analysis: the twin of
``tests/test_roofline.py``.

The hand-counted cases are the reference test's, on ``meta`` tensors (the
counter reads shapes, not values).  Cases that need a process group run in
a subprocess of their own under ``launch.mesh.fake_world`` (this file,
``python tests/test_torch_roofline.py fakepg DIR``), waited for with a time
limit.  Against the reference: full-width qwen2-0.5b at 2 layers, batch 1,
128 tokens, f32; the port's count of ``loss_fn`` and of its gradient is
held to ``repro.roofline.hlo_cost.analyze_text`` of the JAX package's
jitted ``loss_fn`` and ``jax.grad`` at 5 % in FLOPs.  Bytes are not
compared: XLA fuses and counts bytes only at fusion boundaries, eager
PyTorch counts them at every op.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 120


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


class TestFlops:
    def test_plain_matmul(self):
        from repro_torch.roofline.op_cost import count

        cost = count(lambda a, b: a @ b, _meta(512, 1024), _meta(1024, 2048))
        expect = 2 * 512 * 1024 * 2048
        assert abs(cost.flops - expect) / expect < 0.05

    def test_loop_counts_every_iteration(self):
        """Eager code runs each iteration, which the reference's trip-count
        multiplier reconstructs from the HLO."""
        from repro_torch.roofline.op_cost import count

        def f(x, w):
            for _ in range(10):
                x = torch.tanh(x @ w)
            return x
        cost = count(f, _meta(512, 1024), _meta(1024, 1024))
        one = 2 * 512 * 1024 * 1024
        assert abs(cost.flops - 10 * one) / (10 * one) < 0.1

    def test_nested_loop(self):
        from repro_torch.roofline.op_cost import count

        def f(x, w):
            for _ in range(3):
                for _ in range(4):
                    x = x @ w
            return x
        cost = count(f, _meta(128, 256, dtype=torch.float32),
                     _meta(256, 256, dtype=torch.float32))
        one = 2 * 128 * 256 * 256
        assert abs(cost.flops - 12 * one) / (12 * one) < 0.1

    def test_grad_adds_backward_flops(self):
        from repro_torch.roofline.op_cost import count

        def f(a, b):
            return torch.autograd.grad(torch.sum(a @ b), (a, b))
        cost = count(f, _meta(256, 256, dtype=torch.float32, grad=True),
                     _meta(256, 256, dtype=torch.float32, grad=True))
        one = 2 * 256 ** 3
        assert cost.flops > 1.8 * one     # two backward matmuls


class TestBytes:
    def test_matmul_bytes_reasonable(self):
        from repro_torch.roofline.op_cost import count

        cost = count(lambda a, b: a @ b, _meta(1024, 1024, dtype=torch.float32),
                     _meta(1024, 1024, dtype=torch.float32))
        minimum = 3 * 1024 * 1024 * 4
        assert minimum <= cost.bytes <= 4 * minimum

    def test_views_are_free_and_gathers_count_twice_the_result(self):
        from repro_torch.roofline.op_cost import count

        x = _meta(64, 32, dtype=torch.float32)
        assert count(lambda x: x.view(32, 64).t().unsqueeze(0), x).bytes == 0
        idx = torch.empty(16, dtype=torch.int64, device="meta")
        assert count(lambda x, i: x[i], x, idx).bytes == 2 * 16 * 32 * 4

    def test_slice_update_counts_twice_the_update(self):
        from repro_torch.roofline.op_cost import count

        def f(buf, upd):
            buf[:, 8:12] = upd
            return buf
        cost = count(f, _meta(64, 32, dtype=torch.float32),
                     _meta(64, 4, dtype=torch.float32))
        assert cost.bytes == 2 * 64 * 4 * 4

    def test_peak_live_bytes(self):
        """Arguments, then each result until its last reference dies."""
        from repro_torch.roofline.op_cost import measure

        def f(x):
            y = x * 2          # 4 MiB live on top of x
            z = y + 1          # and 4 more
            del y
            return z.sum()
        x = _meta(1024, 1024, dtype=torch.float32)
        _, counter = measure(f, x)
        assert counter.peak == 3 * 4 * 2 ** 20


class TestKernelLaunch:
    """A hand-written kernel does not pass the dispatcher: its wrapper
    reports each launch (``op_cost.kernel_launch``)."""

    def test_counts_reads_writes_and_flops_in_every_active_counter(self):
        from repro_torch.roofline.op_cost import OpCounter, kernel_launch, measure

        a = _meta(64, 32, dtype=torch.float32)
        b = _meta(32, 16, dtype=torch.bfloat16)

        def f(a, b):
            out = torch.empty(64, 16, dtype=torch.float32, device="meta")   # free
            kernel_launch("K", (a, b, a), (out,), 1234.0)
            return out
        outer = OpCounter(record=True)
        with outer:
            _, inner = measure(f, a, b, record=True)
        want = 64 * 32 * 4 + 32 * 16 * 2 + 64 * 16 * 4       # a counted once
        for counter in (inner, outer):
            assert counter.cost.flops == 1234.0
            assert counter.cost.bytes == want
            assert [r.op for r in counter.records] == ["aten.empty", "kernel.K"]
        assert inner.peak == 64 * 32 * 4 + 32 * 16 * 2 + 64 * 16 * 4

    def test_no_counter_no_cost(self):
        from repro_torch.roofline import op_cost

        assert op_cost._ACTIVE == []
        op_cost.kernel_launch("K", (_meta(4, 4),), (), 1.0)     # nothing to count into
        with op_cost.OpCounter():
            assert len(op_cost._ACTIVE) == 1
        assert op_cost._ACTIVE == []

    @pytest.mark.parametrize("tq,tk,causal,window,q_offset", [
        (64, 64, True, 0, 0), (77, 333, True, 40, 256), (128, 1536, False, 0, 0),
        (1, 4096, True, 0, 4095), (100, 300, True, 16, 500), (5, 8, True, 3, -2)])
    def test_visible_pairs_are_the_masks(self, tq, tk, causal, window, q_offset):
        """K3's reported work: the pairs ``mha_ref``'s mask lets through."""
        from repro_torch.kernels.flash_attention.kernel import visible_pairs

        qi = torch.arange(tq)[:, None] + q_offset
        ki = torch.arange(tk)[None, :]
        ok = torch.ones(tq, tk, dtype=torch.bool)
        if causal:
            ok = ki <= qi
            if window > 0:
                ok &= ki > qi - window
        assert visible_pairs(tq, tk, causal=causal, window=window,
                             q_offset=q_offset) == int(ok.sum())

    @pytest.mark.cuda
    def test_k3_reports_its_launches_on_the_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (K3 has no CPU mode)")
        from repro_torch.kernels.flash_attention.kernel import FlashAttentionFn
        from repro_torch.roofline.op_cost import measure

        b, hq, hkv, t, hd = 2, 4, 2, 256, 64
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(b, t, h, hd, generator=gen, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2).requires_grad_(True)
                   for h in (hq, hkv, hkv))

        def step(q, k, v):
            out = FlashAttentionFn.apply(q, k, v, True, 0, 0)
            return torch.autograd.grad(out.float().sum(), (q, k, v))
        _, counter = measure(step, q, k, v, record=True)
        recs = {r.op: r for r in counter.records if r.op.startswith("kernel.")}
        pairs = t * (t + 1) // 2
        assert recs["kernel.K3"].flops == 4 * hd * b * hq * pairs
        assert recs["kernel.K3 backward"].flops == 10 * hd * b * hq * pairs
        qb, kvb = b * t * hq * hd * 2, b * t * hkv * hd * 2
        lse, o32 = b * hq * t * 4, b * t * hq * hd * 4
        assert recs["kernel.K3"].bytes == qb + 2 * kvb + qb + lse + o32


class TestRooflineTerms:
    def test_bottleneck_selection(self):
        from repro_torch.roofline.analysis import HBM_BW, LINK_BW, PEAK_FLOPS, Roofline

        assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
        r = Roofline(flops=989e12, hbm_bytes=1e9, coll_bytes=0, coll_by_kind={})
        assert r.bottleneck == "compute"
        assert abs(r.t_compute - 1.0) < 1e-9
        r2 = Roofline(flops=1e12, hbm_bytes=3.35e12 * 2, coll_bytes=0,
                      coll_by_kind={})
        assert r2.bottleneck == "memory"
        assert abs(r2.t_bound - 2.0) < 1e-9
        r3 = Roofline(flops=0, hbm_bytes=0, coll_bytes=LINK_BW * 3,
                      coll_by_kind={})
        assert abs(r3.t_collective - 3.0) < 1e-9
        assert r3.bottleneck == "collective"

    def test_as_dict_keys_are_the_reference(self):
        from repro.roofline.analysis import Roofline as RefRoofline
        from repro_torch.roofline.analysis import Roofline

        args = dict(flops=1.0, hbm_bytes=2.0, coll_bytes=3.0, coll_by_kind={"all-gather": 3.0})
        assert Roofline(**args).as_dict().keys() == RefRoofline(**args).as_dict().keys()


# -- the fake process group (a process of its own) ---------------------------

def _fakepg_main(out):
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import fake_world
    from repro_torch.roofline.analysis import collective_bytes
    from repro_torch.roofline.op_cost import measure

    res = {}
    with fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        x = DTensor.from_local(_meta(16, 64), mesh, [Shard(0), Shard(1)],
                               run_check=False, shape=(256, 1024), stride=(1024, 1))
        w = DTensor.from_local(_meta(1024, 256), mesh, [Replicate(), Shard(1)],
                               run_check=False, shape=(1024, 4096), stride=(4096, 1))
        y, counter = measure(lambda a, b: a @ b, x, w, record=True)
        res["sharded"] = {
            "flops": counter.cost.flops, "global": list(y.shape),
            "local": list(y.to_local().shape),
            "products": [r.op for r in counter.records if r.op == "aten.mm"],
            "coll": dict(counter.cost.coll)}

    with fake_world(4):
        group = list(range(4))
        t = torch.empty(8, 4, device="meta")          # 128 bytes

        def collectives(t):
            dist.all_reduce(t)
            dist.all_gather_into_tensor(torch.empty(32, 4, device="meta"), t)
            dist.reduce_scatter_tensor(torch.empty(2, 4, device="meta"), t)
            dist.all_to_all_single(torch.empty(8, 4, device="meta"), t)
            dist.isend(t, 1).wait()
            dist.irecv(t, 1).wait()
            funcol.wait_tensor(funcol.all_reduce(t, "sum", group))
            funcol.wait_tensor(funcol.all_gather_tensor(t, 0, group))
            funcol.wait_tensor(funcol.reduce_scatter_tensor(t, "sum", 0, group))
            funcol.wait_tensor(funcol.all_to_all_single(t, None, None, group))
        _, counter = measure(collectives, t, record=True)
        res["kinds"] = {"coll": dict(counter.cost.coll),
                        "from_records": collective_bytes(counter.records)}
    pathlib.Path(out, "fakepg.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def fakepg(tmp_path_factory):
    d = tmp_path_factory.mktemp("roofline")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, __file__, "fakepg", str(d)], env=env,
                          capture_output=True, text=True, timeout=TIME_LIMIT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads((d / "fakepg.json").read_text())


def test_sharded_product_counts_one_cards_work(fakepg):
    """Probe 1: x (256, 1024) on [Shard(0), Shard(1)] times w (1024, 4096)
    on [Replicate(), Shard(1)] of a (16, 16) mesh.  One card multiplies its
    (16, 1024) rows (x's columns gathered over the model axis) by its
    (1024, 256) columns; DTensor's propagation of the global (256, 1024) x
    (1024, 4096) product on fake tensors is not counted."""
    got = fakepg["sharded"]
    assert got["flops"] == 2 * 16 * 1024 * 256
    assert got["products"] == ["aten.mm"]
    assert got["global"] == [256, 4096] and got["local"] == [16, 256]
    # x's (16, 64) shards gathered over the 16 model ranks: (256, 64) bf16
    assert got["coll"] == {"all-gather": 256 * 64 * 2}


def test_collective_weights(fakepg):
    """Each kind's weight on a 128-byte operand, twice (the c10d op and the
    functional one): all-reduce 2 x operand, all-gather the 512-byte
    result, reduce-scatter and all-to-all the operand; a send the operand,
    a receive nothing (the ring counts each stage's send once)."""
    got = fakepg["kinds"]
    want = {"all-reduce": 2 * 2 * 128.0, "all-gather": 2 * 512.0,
            "reduce-scatter": 2 * 128.0, "all-to-all": 2 * 128.0,
            "collective-permute": 128.0}
    assert got["coll"] == want
    assert got["from_records"] == {**want, "ragged-all-to-all": 0.0}


# -- against the JAX package's HLO cost ----------------------------------------

def _reference_flops(cfg_ref, batch, seq):
    from repro.models.model import build_model
    from repro.roofline.hlo_cost import analyze_text

    model = build_model(cfg_ref, max_pos=seq)
    params = model.abstract_params()
    toks = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    b = {"tokens": toks, "labels": toks}

    def loss(p, b):
        return model.loss_fn(p, b)[0]
    fwd = analyze_text(jax.jit(loss).lower(params, b).compile().as_text()).flops
    grad = analyze_text(jax.jit(jax.grad(loss)).lower(params, b).compile().as_text()).flops
    return fwd, grad


def _port_flops(cfg, batch, seq):
    from repro_torch._tree import leaves, unflatten
    from repro_torch.models.model import build_model
    from repro_torch.roofline.op_cost import count

    model = build_model(cfg, max_pos=seq, device="cpu", use_kernel=False)
    params = model.abstract_params()
    b = {"tokens": torch.empty((batch, seq), dtype=torch.int32, device="meta")}
    b["labels"] = b["tokens"]
    fwd = count(lambda p, b: model.loss_fn(p, b)[0], params, b).flops

    def grad(p, b):
        flat = [x.detach().requires_grad_(True) for x in leaves(p)]
        loss = model.loss_fn(unflatten(p, flat), b)[0]
        return torch.autograd.grad(loss, flat, allow_unused=True)
    return fwd, count(grad, params, b).flops


def test_qwen2_flops_match_the_reference_hlo_cost():
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config

    kw = dict(num_layers=2, dtype="float32")
    ref_fwd, ref_grad = _reference_flops(
        dataclasses.replace(ref_config("qwen2-0.5b"), **kw), 1, 128)
    fwd, grad = _port_flops(dataclasses.replace(get_config("qwen2-0.5b"), **kw), 1, 128)
    assert abs(fwd - ref_fwd) / ref_fwd < 0.05, (fwd, ref_fwd)
    assert abs(grad - ref_grad) / ref_grad < 0.05, (grad, ref_grad)
    assert grad > 2.5 * fwd          # the backward's two products a product


if __name__ == "__main__":
    _fakepg_main(sys.argv[2])
