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

    def test_reports_from_many_threads_lose_nothing(self):
        """The runtime's workers report K1 launches while the counting thread
        runs ops: more threads than cores, a short switch interval, every
        launch's flops, bytes and record counted, and each output storage
        (slabs of one result, reported from several threads) live once."""
        import threading

        from repro_torch.roofline.op_cost import kernel_launch, measure

        threads, n = 4 * (os.cpu_count() or 1), 400
        a = _meta(8, 8, dtype=torch.float32)
        results = [_meta(2, 4, dtype=torch.float32) for _ in range(n)]
        start = threading.Barrier(threads)

        def work(i):
            start.wait(timeout=60)
            for res in results[i % 2::2] if i % 3 else results:
                kernel_launch("K", (a,), (res[i % 2],), 3.0)

        def run(a):
            pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
            for t in pool:
                t.start()
            for _ in range(200):
                torch.add(a, 1.0)            # the counting thread's own ops
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            _, counter = measure(run, a, record=True)
        finally:
            sys.setswitchinterval(old)
        launches = sum(n if i % 3 == 0 else n // 2 for i in range(threads))
        assert sum(r.op == "kernel.K" for r in counter.records) == launches
        assert counter.cost.flops == 3.0 * launches + 200 * 64
        assert counter.cost.bytes == (8 * 8 * 4 + 4 * 4) * launches + 200 * 2 * 8 * 8 * 4
        # the argument, every result's storage once, an add's result or two
        assert counter.peak <= 8 * 8 * 4 + n * 2 * 4 * 4 + 2 * 8 * 8 * 4

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


PAPER = (2400, 600, 600)            # the paper's lattice; 10-row slabs
PLANE = 600 * 600 * 4


def _records(fn, *args):
    from repro_torch.roofline.op_cost import measure

    _, counter = measure(fn, *args, record=True)
    return [r for r in counter.records if r.op.startswith("kernel.")]


class TestKernelReports:
    """Each wrapper's report helper (what it passes to ``kernel_launch``)
    against hand counts on ``meta`` tensors: the reads and writes of one
    launch once each, and the flops behind chip_smoke.py's bounds."""

    def test_jacobi_flops_are_the_plain_sweeps(self):
        from repro_torch.kernels.jacobi import kernel as k1
        from repro_torch.kernels.jacobi.ref import jacobi_sweep_ref, jacobi_two_step_ref
        from repro_torch.roofline.op_cost import OpCounter, count

        f = _meta(7, 5, 9, dtype=torch.float32)
        assert k1.flops_per_site() == count(jacobi_sweep_ref, f).flops / f.numel() == 6
        assert k1.flops_per_site(True) == count(jacobi_two_step_ref, f).flops / f.numel() == 12
        k1.flops_per_site.cache_clear()
        with OpCounter() as counter:            # read inside an open counter
            assert k1.flops_per_site() == 6
        assert counter.cost.flops == 0 and counter.cost.bytes == 0

    @pytest.mark.parametrize("r0,planes_read", [(0, 11), (10, 12), (1200, 12), (2390, 11)])
    def test_k1_slab_reads_its_rows_and_halo_planes(self, r0, planes_read):
        from repro_torch.kernels.jacobi.kernel import report

        f = _meta(*PAPER, dtype=torch.float32)
        out = _meta(10, *PAPER[1:], dtype=torch.float32)
        (rec,) = _records(lambda: report(f, out, (r0, r0 + 10)))
        assert rec.op == "kernel.K1"
        assert rec.bytes == (planes_read + 10) * PLANE
        assert rec.result_bytes == 10 * PLANE
        assert rec.flops == 6 * 10 * 600 * 600

    def test_k1_runtime_sweep_hand_count(self):
        """240 slab launches of the paper's sweep: 2878 planes read (each
        slab's 10 rows and its halo planes), 2400 written."""
        from repro_torch.kernels.jacobi.kernel import report

        f, res = _meta(*PAPER, dtype=torch.float32), _meta(*PAPER, dtype=torch.float32)

        def sweep():
            for r0 in range(0, PAPER[0], 10):
                report(f, res[r0:r0 + 10], (r0, r0 + 10))
        recs = _records(sweep)
        assert len(recs) == 240 and {r.op for r in recs} == {"kernel.K1"}
        assert sum(r.bytes for r in recs) == (2878 + 2400) * PLANE == 7.60032e9
        assert sum(r.flops for r in recs) == 6 * 2400 * 600 * 600

    @pytest.mark.parametrize("two_step", [False, True])
    def test_whole_lattice_k1_and_k2(self, two_step):
        from repro_torch.kernels.jacobi.kernel import report

        f, out = _meta(*PAPER, dtype=torch.float32), _meta(*PAPER, dtype=torch.float32)
        (rec,) = _records(lambda: report(f, out, two_step=two_step))
        assert rec.op == ("kernel.K2" if two_step else "kernel.K1")
        assert rec.bytes == 2 * 2400 * PLANE == 6.912e9
        assert rec.flops == (12 if two_step else 6) * 2400 * 600 * 600

    @pytest.mark.parametrize("state_in", [True, False])
    def test_k4_forward(self, state_in):
        """rwkv6-3b's prefill: r, k, v bf16, w and o f32, u, the state in
        (when given) and out."""
        from repro_torch.kernels.rwkv6 import kernel as k4

        b, t, h, hd = 1, 1024, 40, 64
        r, k, v = (_meta(b, t, h, hd) for _ in range(3))
        w, o = _meta(b, t, h, hd, dtype=torch.float32), _meta(b, t, h, hd, dtype=torch.float32)
        u = _meta(h, hd, dtype=torch.float32)
        s0 = _meta(b, h, hd, hd, dtype=torch.float32) if state_in else None
        st = _meta(b, h, hd, hd, dtype=torch.float32)
        (rec,) = _records(lambda: k4._report("K4", (r, k, v, w, u, s0), (o, st), r,
                                             k4.FWD_FLOPS))
        n, state = b * t * h * hd, 4 * b * h * hd * hd
        assert rec.op == "kernel.K4"
        assert rec.bytes == 3 * 2 * n + 4 * n + 4 * h * hd + 4 * n + state * (2 if state_in else 1)
        assert rec.flops == 5 * n * hd

    def test_k4_state_updated_in_place_is_read_and_written(self):
        """Serving's decode passes its cached state as ``s0`` and K4 writes
        the final state into it: one state read and one written."""
        from repro_torch.kernels.rwkv6 import kernel as k4

        b, t, h, hd = 1, 1, 40, 64
        r, k, v = (_meta(b, t, h, hd) for _ in range(3))
        w, o = _meta(b, t, h, hd, dtype=torch.float32), _meta(b, t, h, hd, dtype=torch.float32)
        u, s0 = _meta(h, hd, dtype=torch.float32), _meta(b, h, hd, hd, dtype=torch.float32)
        (rec,) = _records(lambda: k4._report("K4", (r, k, v, w, u, s0), (o, s0), r,
                                             k4.FWD_FLOPS))
        n = b * t * h * hd
        assert rec.bytes == 3 * 2 * n + 4 * n + 4 * h * hd + 4 * n + 2 * 4 * b * h * hd * hd

    def test_k4_backward(self):
        from repro_torch.kernels.rwkv6 import kernel as k4

        b, t, h, hd = 1, 1024, 40, 64
        bf = [_meta(b, t, h, hd) for _ in range(6)]                 # r k v dr dk dv
        f32 = [_meta(b, t, h, hd, dtype=torch.float32) for _ in range(3)]    # w do dw
        u, du = _meta(h, hd, dtype=torch.float32), _meta(h, hd, dtype=torch.float32)
        s0, dst, ds0 = (_meta(b, h, hd, hd, dtype=torch.float32) for _ in range(3))
        r, k, v, dr, dk, dv = bf
        w, do, dw = f32
        (rec,) = _records(lambda: k4._report(
            "K4 backward", (r, k, v, w, u, s0, do, dst), (dr, dk, dv, dw, du, ds0), r,
            k4.BWD_FLOPS))
        n = b * t * h * hd
        assert rec.op == "kernel.K4 backward"
        assert rec.bytes == n * (3 * 2 + 4 + 4 + 3 * 2 + 4) + 3 * 4 * b * h * hd * hd \
            + 2 * 4 * h * hd
        assert rec.flops == 14 * n * hd

    @pytest.mark.parametrize("state_in", [True, False])
    def test_k5_forward_and_backward(self, state_in):
        """recurrentgemma-9b's width: a, b, h, dh, da, db f32 (B, T, W); h0 and
        dh0 (B, W) when a state is carried in."""
        from repro_torch.kernels.rglru import kernel as k5

        bt, t, w = 1, 1024, 4096
        a, x, h, dh, da, db = (_meta(bt, t, w, dtype=torch.float32) for _ in range(6))
        h0, dh0 = ((_meta(bt, w, dtype=torch.float32) for _ in range(2)) if state_in
                   else (None, None))
        fwd, bwd = _records(lambda: (k5._report("K5", (a, x, h0), (h,), k5.FWD_FLOPS),
                                     k5._report("K5 backward", (a, h, dh, h0), (da, db, dh0),
                                                k5.BWD_FLOPS)))
        n, state = bt * t * w, (4 * bt * w if state_in else 0)
        assert (fwd.op, fwd.bytes, fwd.flops) == ("kernel.K5", 12 * n + state, 2 * n)
        assert (bwd.op, bwd.bytes, bwd.flops) == ("kernel.K5 backward", 20 * n + 2 * state,
                                                  3 * n)

    # -- on the card: the records of real launches -------------------------------

    @staticmethod
    def _card():
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")

    @pytest.mark.cuda
    def test_k1_and_k2_report_their_launches_on_the_card(self):
        self._card()
        from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
        from repro_torch.kernels.jacobi.temporal import jacobi_two_step_cuda

        ni, nj, nk = 40, 30, 64
        plane = nj * nk * 4
        f = torch.randn(ni, nj, nk, device="cuda")
        res = torch.empty_like(f)

        def run(f):
            for r0 in range(0, ni, 10):
                jacobi_sweep_cuda(f, out=res[r0:r0 + 10], rows=(r0, r0 + 10))
            jacobi_sweep_cuda(f)
            jacobi_two_step_cuda(f)
        recs = _records(run, f)
        assert [r.op for r in recs] == ["kernel.K1"] * 5 + ["kernel.K2"]
        assert [r.bytes / plane for r in recs] == [21, 22, 22, 21, 80, 80]
        assert [r.flops for r in recs] == [6 * 10 * nj * nk] * 4 + [6 * f.numel(),
                                                                      12 * f.numel()]

    @pytest.mark.cuda
    def test_k4_reports_its_launches_on_the_card(self):
        self._card()
        from repro_torch.kernels.rwkv6 import kernel as k4

        b, t, h, hd = 2, 300, 4, 64
        gen = torch.Generator(device="cuda").manual_seed(0)
        r, k, v = (torch.randn(b, t, h, hd, generator=gen, device="cuda").bfloat16()
                   .requires_grad_(True) for _ in range(3))
        w = torch.rand(b, t, h, hd, generator=gen, device="cuda").requires_grad_(True)
        u = torch.randn(h, hd, generator=gen, device="cuda").requires_grad_(True)

        def step(r, k, v, w, u):
            o, st = k4.wkv6_cuda(r, k, v, w, u, chunk=t)
            return torch.autograd.grad(o.sum() + st.sum(), (r, k, v, w, u))
        k4.wkv6_cuda.launches = k4.wkv6_backward.launches = 0
        recs = _records(step, r, k, v, w, u)
        assert [x.op for x in recs] == ["kernel.K4", "kernel.K4 backward"]
        assert (k4.wkv6_cuda.launches, k4.wkv6_backward.launches) == (1, 1)
        n, state = b * t * h * hd, 4 * b * h * hd * hd
        assert recs[0].bytes == 3 * 2 * n + 4 * n + 4 * h * hd + 4 * n + state
        assert recs[0].flops == 5 * n * hd
        # no s0 given: the state's gradient read (dsT), ds0 written
        assert recs[1].bytes == n * (3 * 2 + 4 + 4 + 3 * 2 + 4) + 2 * state + 2 * 4 * h * hd
        assert recs[1].flops == 14 * n * hd

    @pytest.mark.cuda
    def test_k5_reports_its_launches_on_the_card(self):
        self._card()
        from repro_torch.kernels.rglru import kernel as k5

        bt, t, w = 2, 100, 256
        gen = torch.Generator(device="cuda").manual_seed(0)
        a = torch.rand(bt, t, w, generator=gen, device="cuda").requires_grad_(True)
        x = torch.randn(bt, t, w, generator=gen, device="cuda").requires_grad_(True)
        h0 = torch.randn(bt, w, generator=gen, device="cuda").requires_grad_(True)

        def step(a, x, h0):
            h = k5.rglru_scan_cuda(a, x, chunk=t, h0=h0)
            return torch.autograd.grad(h.sum(), (a, x, h0))
        k5.rglru_scan_cuda.launches = k5.rglru_scan_backward.launches = 0
        recs = _records(step, a, x, h0)
        assert [r.op for r in recs] == ["kernel.K5", "kernel.K5 backward"]
        assert (k5.rglru_scan_cuda.launches, k5.rglru_scan_backward.launches) == (1, 1)
        n = bt * t * w
        assert (recs[0].bytes, recs[0].flops) == (12 * n + 4 * bt * w, 2 * n)
        assert (recs[1].bytes, recs[1].flops) == (20 * n + 8 * bt * w, 3 * n)


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
