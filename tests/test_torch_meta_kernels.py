"""The kernels' path on ``meta`` tensors (F14): what the dry run and the
counted steps run in place of a launch.

On a meta tensor each wrapper of K3, K4 and K5, forward and backward,
walks its CUDA path without launching: its results have the shapes and
dtypes of the plain version's on the CPU (the same small inputs, drawn
with numpy from a seed), it allocates what the launch would (results,
statistics, scratch, workspaces), and it reports one record a call with
its own flops and bytes.  ``_build.load`` and every plain ``*_ref`` (and
the model's plain attention forms) are replaced by functions that raise,
so nothing here launches and nothing falls back.

Then reduced train, prefill and decode steps of qwen2-0.5b, rwkv6-3b and
recurrentgemma-9b counted on meta tensors give the records per layer and
site that ``chip_smoke.py``'s phases 5, 7d and 7h count on the card; and,
in a process of its own under ``launch.mesh.fake_world`` (this file,
``python tests/test_torch_meta_kernels.py fakepg DIR``): the dry run's
``count_cell`` of a reduced rwkv6-3b cell on a (2, 4) mesh counts K4, in
fewer bytes than the plain count, and a sharded decode hands K3 each
rank's local shards (F15).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 240


def _raise(*_a, **_k):
    raise AssertionError("a meta call reached a launch or a plain version")


@pytest.fixture
def no_launch(monkeypatch):
    """``_build.load`` and every plain version raise."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.kernels.rglru import kernel as k5
    from repro_torch.kernels.rglru import ops as k5_ops
    from repro_torch.kernels.rwkv6 import kernel as k4
    from repro_torch.kernels.rwkv6 import ops as k4_ops
    from repro_torch.models import attention

    monkeypatch.setattr(_build, "load", _raise)
    for mod, names in ((k3, ["mha_ref"]), (k4, ["wkv6_ref", "wkv6_bwd_ref"]),
                       (k5, ["rglru_scan_ref", "rglru_scan_bwd_ref"]),
                       (k4_ops, ["wkv6_ref"]), (k5_ops, ["rglru_scan_ref"]),
                       (attention, ["direct_attention", "chunked_attention",
                                    "banded_attention", "decode_attention"])):
        for name in names:
            monkeypatch.setattr(mod, name, _raise)
    for fn in (k3.flash_attention, k3.flash_attention_backward, k4.wkv6_cuda,
               k4.wkv6_backward, k5.rglru_scan_cuda, k5.rglru_scan_backward):
        monkeypatch.setattr(fn, "launches", 0, raising=False)


def _cpu(rng, shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def _meta(x):
    return None if x is None else x.detach().to("meta").requires_grad_(x.requires_grad)


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def _pairs(tq, tk, causal, window, q_offset):
    """Visible (query, key) pairs a query head, counted by hand."""
    if not causal:
        return tq * tk
    return sum(1 for t in range(tq) for j in range(tk)
               if j <= q_offset + t and (window <= 0 or j > q_offset + t - window))


def _like(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


def _kernel_records(counter):
    return [(r.op, r.flops, r.bytes) for r in counter.records if r.op.startswith("kernel.")]


# -- K3 -----------------------------------------------------------------------------

K3_CASES = [  # (b, hq, hkv, tq, tk, hd, causal, window, q_offset)
    (2, 4, 2, 32, 32, 16, True, 0, 0),
    (1, 8, 2, 16, 48, 64, True, 8, 32),
    (2, 4, 4, 8, 24, 32, False, 0, 0),
    (1, 4, 1, 1, 4096, 64, True, 0, 4095),      # a decode the plan splits
]


def _k3_inputs(case, dtype, grad=False):
    b, hq, hkv, tq, tk, hd = case[:6]
    rng = np.random.default_rng(0)
    q, k, v = (_cpu(rng, s, dtype) for s in ((b, hq, tq, hd), (b, hkv, tk, hd), (b, hkv, tk, hd)))
    return [x.requires_grad_(grad) for x in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", K3_CASES, ids=lambda c: "x".join(map(str, c[:6])))
def test_k3_forward(case, dtype, no_launch, monkeypatch):
    """``flash_attention`` on meta: the plain version's shape and dtype in
    the kernel's (B, Tq, Hq, hd) memory, one K3 record, its split's f32
    partials and tickets live at the peak, no launch."""
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.roofline.op_cost import measure

    b, hq, hkv, tq, tk, hd, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = _k3_inputs(case, dtype)
    want = mha_ref(q, k, v, **kw)
    monkeypatch.setattr(k3, "_TICKETS", {})
    mq, mk, mv = (_meta(x) for x in (q, k, v))
    out, counter = measure(k3.flash_attention, mq, mk, mv, bq=tq, bk=tk, record=True, **kw)
    _like([out], [want])
    assert out.transpose(1, 2).is_contiguous()
    flops = 4 * hd * b * hq * _pairs(tq, tk, causal, window, q_offset)
    assert _kernel_records(counter) == [("kernel.K3", flops, _nbytes(q, k, v, want))]
    scratch = 0
    if dtype == torch.bfloat16:
        rows = k3.variant(hq, hkv, tq, hd)[0]
        plan = k3.split_plan(b, hq, hkv, tq, tk, hd, slots=k3.H100_SMS * k3.H100_BLOCKS_PER_SM[
            rows, hd], causal=causal, window=window, q_offset=q_offset)
        if plan.splits > 1:
            tiles = b * hkv * plan.row_tiles
            scratch = 4 * tiles * plan.splits * plan.rows * (2 + hd) + 4 * max(tiles, 256)
    if case == K3_CASES[-1] and dtype == torch.bfloat16:
        assert scratch > 0                        # the decode is split
    assert counter.peak == _nbytes(q, k, v, want) + scratch
    assert k3.flash_attention.launches == 0


def test_k3_meta_plan_is_the_h100s():
    """The meta plan reads the H100's occupancy from a table of every
    compiled bf16 variant, not from a library (phase 9 holds the table to
    the library's answer)."""
    from repro_torch.kernels.flash_attention import kernel as k3

    assert k3.H100_SMS == 132
    assert set(k3.H100_BLOCKS_PER_SM) == {(r, hd) for r in (k3.DECODE_ROWS, k3.PREFILL_ROWS)
                                          for hd in k3.HEAD_DIMS}
    assert all(n >= 1 for n in k3.H100_BLOCKS_PER_SM.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", K3_CASES[:3], ids=lambda c: "x".join(map(str, c[:6])))
def test_k3_function_forward_and_backward(case, dtype, no_launch):
    """``FlashAttentionFn`` on meta: in bf16 the forward writes o, the
    log-sum-exp and o in f32 (one K3 record), the backward reads them and
    writes dq, dk, dv and delta (one K3 backward record); in f32 the
    backward makes its own log-sum-exp.  The gradients have the plain
    version's shapes and dtypes."""
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.roofline.op_cost import measure

    b, hq, hkv, tq, tk, hd, causal, window, q_offset = case
    q, k, v = _k3_inputs(case, dtype, grad=True)
    o = mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = torch.autograd.grad(o.float().sum(), (q, k, v))

    def step(q, k, v):
        out = k3.FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
        return (out,) + torch.autograd.grad(out.float().sum(), (q, k, v))
    got, counter = measure(step, *(_meta(x) for x in (q, k, v)), record=True)
    _like(got, [o.detach(), *want])
    pairs = _pairs(tq, tk, causal, window, q_offset)
    row = b * hq * tq * 4                                    # (B, Hq, Tq) f32
    qkv = _nbytes(q, k, v)
    o32 = o.numel() * 4
    if dtype == torch.bfloat16:
        fwd = qkv + _nbytes(o) + row + o32
        bwd = qkv + _nbytes(o) + row + o32 + qkv + row       # dout, lse, o32; dq dk dv delta
    else:
        fwd = qkv + _nbytes(o)
        bwd = qkv + _nbytes(o) + row + qkv + row             # dout, lse; dq dk dv delta
    assert _kernel_records(counter) == [("kernel.K3", 4 * hd * b * hq * pairs, fwd),
                                        ("kernel.K3 backward", 10 * hd * b * hq * pairs, bwd)]
    assert k3.flash_attention.launches == k3.flash_attention_backward.launches == 0


def test_k3_backward_without_stats_runs_the_forward_again(no_launch):
    """In bf16 ``flash_attention_backward`` without the forward's
    statistics counts K3 once more to make them, then its backward."""
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.roofline.op_cost import measure

    q, k, v = (_meta(x) for x in _k3_inputs(K3_CASES[0], torch.bfloat16))
    dout = torch.empty_like(q)
    got, counter = measure(k3.flash_attention_backward, q, k, v, dout, record=True)
    _like(got, [q, k, v])
    assert [r[0] for r in _kernel_records(counter)] == ["kernel.K3", "kernel.K3 backward"]


# -- K4 -----------------------------------------------------------------------------

K4_CASES = [  # (b, t, h, hd, state in)
    (2, 16, 2, 16, False),
    (1, 200, 2, 64, True),          # past TIME_CHUNK (128): three launches and scratch
    (2, 130, 1, 32, False),         # past BWD_CHUNK (64) and TIME_CHUNK
]


def _k4_inputs(case, grad=False):
    b, t, h, hd, state = case
    rng = np.random.default_rng(1)
    r, k, v = (_cpu(rng, (b, t, h, hd), torch.bfloat16, 0.5) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 0.99, (b, t, h, hd)).astype(np.float32))
    u = _cpu(rng, (h, hd), scale=0.5)
    s0 = _cpu(rng, (b, h, hd, hd), scale=0.1) if state else None
    return [None if x is None else x.requires_grad_(grad) for x in (r, k, v, w, u, s0)]


@pytest.mark.parametrize("case", K4_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k4_forward(case, no_launch):
    """``wkv6_cuda`` on meta: (o, sT) as the plain version's, sT the given
    state itself (updated in place), one K4 record, the time chunks'
    scratch live at the peak."""
    from repro_torch.kernels.rwkv6 import kernel as k4
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.roofline.op_cost import measure

    b, t, h, hd, state = case
    xs = _k4_inputs(case)
    want = wkv6_ref(*xs[:5], s0=xs[5])
    m = [_meta(x) for x in xs]
    (o, st), counter = measure(k4.wkv6_cuda, *m[:5], chunk=t, s0=m[5], record=True)
    _like([o, st], list(want))
    assert (st is m[5]) == state
    writes = _nbytes(want[0]) + b * h * hd * hd * 4
    assert _kernel_records(counter) == [("kernel.K4", 5 * b * t * h * hd * hd,
                                         _nbytes(*xs) + writes)]
    chunks = -(-t // k4.TIME_CHUNK)
    scratch = 4 * b * h * (chunks * (hd * hd + hd) + t * hd) if t > k4.TIME_CHUNK else 0
    new_state = 0 if state else b * h * hd * hd * 4
    assert counter.peak == _nbytes(*xs) + _nbytes(want[0]) + new_state + scratch
    assert k4.wkv6_cuda.launches == 0


@pytest.mark.parametrize("case", K4_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k4_function_forward_and_backward(case, no_launch):
    """``WKV6Fn`` on meta: a new final state forward (the given one left
    alone), then ``wkv6_backward``: the plain backward's shapes and dtypes,
    one K4 backward record, its workspace (``bwd_workspace_floats``, the
    C interface's formula) live at the peak."""
    from repro_torch.kernels.rwkv6 import kernel as k4
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref
    from repro_torch.roofline.op_cost import measure

    b, t, h, hd, state = case
    xs = _k4_inputs(case, grad=True)
    rng = np.random.default_rng(2)
    do = _cpu(rng, (b, t, h, hd))
    want = wkv6_bwd_ref(*(None if x is None else x.detach() for x in xs), do, None)
    m = [_meta(x) for x in xs]
    mdo = _meta(do)

    def step(r, k, v, w, u, s0):
        o, st = k4.wkv6_cuda(r, k, v, w, u, chunk=t, s0=s0)
        assert st is not s0
        return torch.autograd.grad((o, st), [x for x in (r, k, v, w, u, s0) if x is not None],
                                   (mdo, torch.zeros_like(st)))
    got, counter = measure(step, *m, record=True)
    _like(got, [g for g, x in zip(want, xs) if x is not None])
    recs = _kernel_records(counter)
    assert [r[0] for r in recs] == ["kernel.K4", "kernel.K4 backward"]
    state_bytes = b * h * hd * hd * 4
    reads = _nbytes(*xs) + _nbytes(do) + state_bytes            # do, dsT
    writes = _nbytes(*xs[:5]) + state_bytes                     # dr dk dv dw du, ds0
    assert recs[1][1:] == (14 * b * t * h * hd * hd, reads + writes)
    workspace = 4 * k4.bwd_workspace_floats(b, t, h, hd, k4.BWD_CHUNK)
    assert counter.peak >= _nbytes(*xs) + writes + workspace
    assert k4.wkv6_cuda.launches == k4.wkv6_backward.launches == 0


def test_k4_backward_workspace_is_the_c_formula():
    """``bwd_workspace_floats`` against ``wkv6_bwd_workspace_floats`` of
    ``csrc/wkv6_bwd.cu``, term for term, either side of one chunk."""
    from repro_torch.kernels.rwkv6 import kernel as k4

    def c_formula(batch, t, h, hd, chunk):
        nc, bh = (t + chunk - 1) // chunk, batch * h
        tiles = hd // 32 if hd > 32 else 1
        return (bh * nc * hd * (2 * hd + 1) if nc > 1 else 0) + tiles * batch * t * h * hd \
            + batch * nc * h * hd
    for b, t, h, hd in ((1, 1, 1, 8), (2, 64, 3, 64), (2, 65, 3, 64), (1, 1024, 40, 64),
                        (4, 300, 2, 32)):
        for chunk in k4.BWD_CHUNKS:
            assert k4.bwd_workspace_floats(b, t, h, hd, chunk) == c_formula(b, t, h, hd, chunk)
    assert k4.bwd_workspace_floats(1, 1024, 40, 64, 64) == (
        40 * 16 * 64 * 129 + 2 * 1024 * 40 * 64 + 16 * 40 * 64)


# -- K5 -----------------------------------------------------------------------------

K5_CASES = [(2, 16, 32, False), (1, 70, 64, True)]      # (b, t, w, state in)


@pytest.mark.parametrize("case", K5_CASES, ids=lambda c: "x".join(map(str, c)))
def test_k5_forward_and_backward(case, no_launch):
    """``rglru_scan_cuda`` and ``RGLRUScanFn`` on meta: the plain
    version's shapes and dtypes, one K5 record forward and one K5 backward
    record, each with its own reads, writes and flops."""
    from repro_torch.kernels.rglru import kernel as k5
    from repro_torch.kernels.rglru.ref import rglru_scan_bwd_ref, rglru_scan_ref
    from repro_torch.roofline.op_cost import measure

    b, t, w, state = case
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 0.99, (b, t, w)).astype(np.float32))
    x = _cpu(rng, (b, t, w))
    h0 = _cpu(rng, (b, w)) if state else None
    h = rglru_scan_ref(a, x, h0)
    want = rglru_scan_bwd_ref(a, h, torch.ones_like(h), h0)
    ma, mx, mh0 = _meta(a), _meta(x), _meta(h0)
    out, counter = measure(k5.rglru_scan_cuda, ma, mx, chunk=t, h0=mh0, record=True)
    _like([out], [h])
    assert _kernel_records(counter) == [("kernel.K5", 2 * a.numel(), _nbytes(a, x, h0, h))]
    grads, counter = measure(k5.rglru_scan_backward, ma, out, torch.ones_like(out), mh0,
                             record=True)
    _like(list(grads), list(want))
    assert _kernel_records(counter) == [
        ("kernel.K5 backward", 3 * a.numel(), _nbytes(a, h, h, h0) + _nbytes(*want))]

    leaves = [y.requires_grad_(True) for y in (_meta(a), _meta(x), _meta(h0)) if y is not None]

    def step(*ls):
        hh = k5.rglru_scan_cuda(ls[0], ls[1], chunk=t, h0=ls[2] if state else None)
        return torch.autograd.grad(hh.sum(), ls)
    grads, counter = measure(step, *leaves, record=True)
    _like(list(grads), [want[0], want[1]] + ([want[2]] if state else []))
    assert [r[0] for r in _kernel_records(counter)] == ["kernel.K5", "kernel.K5 backward"]
    assert k5.rglru_scan_cuda.launches == k5.rglru_scan_backward.launches == 0


# -- reduced model steps -------------------------------------------------------------

def _step_records(arch, kind, microbatches=1):
    """The kernel records of one reduced ``arch`` step on meta tensors
    (train: 2 x 16 tokens; prefill: 2 x 16; decode: one token at position
    15 of a 16-slot cache), and the reduced config."""
    from repro_torch.configs import SHAPES, get_config, reduce_config
    from repro_torch.models.model import build_model
    from repro_torch.roofline.op_cost import measure
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import (make_decode_step, make_prefill_step,
                                              make_train_step)

    cfg = dataclasses.replace(reduce_config(get_config(arch)), microbatches=microbatches)
    shape = dataclasses.replace(SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                                        "decode": "decode_32k"}[kind]],
                                seq_len=16, global_batch=2 * microbatches)
    model = build_model(cfg, max_pos=16, device="cpu")
    params = model.abstract_params()
    if kind == "train":
        args = (params, init_opt_state(params), model.input_specs(shape))
        step = make_train_step(model, donate=True)
    elif kind == "prefill":
        args = (params, model.input_specs(shape), model.cache_specs(shape))
        step = make_prefill_step(model)
    else:
        tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
        args = (params, tokens, shape.seq_len - 1, model.cache_specs(shape))
        step = make_decode_step(model)
    with torch.no_grad() if kind != "train" else torch.enable_grad():
        _, counter = measure(step, *args, record=True)
    names = [r.op for r in counter.records if r.op.startswith("kernel.")]
    return cfg, {n: names.count(n) for n in set(names)}


STEP_ARCHS = {"qwen2-0.5b": "K3", "rwkv6-3b": "K4", "recurrentgemma-9b": None}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(STEP_ARCHS))
def test_reduced_step_counts_the_kernels_per_layer(arch, kind, no_launch):
    """A train step records each attention layer's K3 (recurrent layer's
    K4 or K5) twice forward under remat and once backward, a microbatch,
    as phases 7d and 7h count on the card; a prefill or decode step once a
    layer, as phase 5's drains count a call."""
    from repro_torch.kernels.flash_attention import kernel as k3

    cfg, got = _step_records(arch, kind)
    kinds = cfg.layer_kinds()
    sites = {"K3": sum(kd in ("full", "local") for kd in kinds),
             "K4": sum(kd == "rwkv" for kd in kinds),
             "K5": sum(kd == "rglru" for kd in kinds)}
    assert sites["K3"] + sites["K4"] + sites["K5"] == cfg.num_layers, kinds
    want = {}
    for name, n in sites.items():
        if n:
            want[f"kernel.{name}"] = n * (2 if kind == "train" and cfg.remat else 1)
            if kind == "train":
                want[f"kernel.{name} backward"] = n
    assert got == want, (kinds, got)
    if STEP_ARCHS[arch]:
        assert [n for n in sites if sites[n]] == [STEP_ARCHS[arch]]
    assert k3.flash_attention.launches == 0


def test_reduced_train_step_counts_every_microbatch(no_launch):
    """Two microbatches: each layer's kernels twice as often."""
    cfg, one = _step_records("rwkv6-3b", "train")
    _, two = _step_records("rwkv6-3b", "train", microbatches=2)
    assert two == {k: 2 * n for k, n in one.items()}


# -- the dry run under a fake process group -------------------------------------------

def _fakepg_main(out):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SHAPES, get_config, reduce_config
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    from repro_torch.roofline import op_cost

    seen = []
    report = op_cost.kernel_launch

    def spy(name, reads, writes, flops):
        seen.append({"name": name, "dtensor": any(type(t).__name__ == "DTensor"
                                                  for t in list(reads) + list(writes)
                                                  if t is not None),
                     "shapes": [list(t.shape) for t in reads if t is not None]})
        return report(name, reads, writes, flops)
    op_cost.kernel_launch = spy

    res = {}
    cfg = reduce_config(get_config("rwkv6-3b"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
    with fake_world(8):
        mesh = make_debug_mesh(2, 4, device="cpu")
        for kernel in (True, False):
            seen.clear()
            cell = count_cell(cfg, shape, mesh, kernel=kernel)
            res[f"rwkv_{kernel}"] = {"cell": cell, "reports": list(seen)}
    # F15: a sharded decode on the smallest mesh that shards the cache's
    # slots, (1, 2): K3 on each rank's local shards
    qcfg = dataclasses.replace(reduce_config(get_config("qwen2-0.5b")), dtype="bfloat16")
    decode = dataclasses.replace(SHAPES["decode_32k"], seq_len=64, global_batch=2)
    with fake_world(2):
        mesh = make_debug_mesh(1, 2, device="cpu")
        seen.clear()
        res["decode"] = {"cell": count_cell(qcfg, decode, mesh), "reports": list(seen),
                         "layers": qcfg.num_layers}
    pathlib.Path(out, "fakepg.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    d = tmp_path_factory.mktemp("meta_kernels")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    try:
        proc = subprocess.run([sys.executable, __file__, "fakepg", str(d)], env=env,
                              capture_output=True, text=True, timeout=TIME_LIMIT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the fake-group process ran past {TIME_LIMIT_S} s and was killed")
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return json.loads((d / "fakepg.json").read_text())


def test_dryrun_cell_counts_k4_on_local_shards(fake):
    """``count_cell`` of a reduced rwkv6-3b train cell on the (2, 4) mesh
    counts the kernel path: K4 forward and backward, each on a rank's
    local shards (the batch over the data axis), and fewer bytes than the
    plain count, whose per-step states the card never moves; the same
    FLOPs within ``KERNEL_FLOPS_RATIO``'s range."""
    kern, plain = fake["rwkv_True"], fake["rwkv_False"]
    names = [r["name"] for r in kern["reports"]]
    assert names.count("K4") > 0 and names.count("K4 backward") > 0
    assert not any(r["dtensor"] for r in kern["reports"])
    assert all(r["shapes"][0][0] == 4 for r in kern["reports"])    # batch 8 over 2
    assert plain["reports"] == []
    kb = kern["cell"]["roofline"]["hbm_bytes_per_chip"]
    pb = plain["cell"]["roofline"]["hbm_bytes_per_chip"]
    assert kb < pb, (kb, pb)
    ratio = kern["cell"]["roofline"]["flops_per_chip"] / plain["cell"]["roofline"][
        "flops_per_chip"]
    assert 0.85 <= ratio <= 1.0, ratio


def test_sharded_decode_runs_k3_on_local_shards(fake):
    """F15: a decode step under mesh rules handed K3 the DTensors of the
    query and the slot-sharded cache, so the kernel counted (and on the
    card would have read) the global shapes on every rank.  Now one K3 a
    layer on each rank's local shards: the query heads the rank holds, the
    cache's slots gathered."""
    dec = fake["decode"]
    reports = dec["reports"]
    assert [r["name"] for r in reports] == ["K3"] * dec["layers"]
    for r in reports:
        assert not r["dtensor"]
        q, k = r["shapes"][0], r["shapes"][1]
        assert q[2] == 1 and k[2] == 64              # one query, every slot
        assert q[1] == 2                             # 4 query heads over 2 ranks
    assert dec["cell"]["roofline"]["flops_per_chip"] > 0


if __name__ == "__main__":
    _fakepg_main(sys.argv[2])
