"""The port's serving engine on the six configurations that
``tests/test_torch_serving.py`` and ``tests/test_torch_archs.py`` do not
drain, held against the JAX package's engine on the CPU.

gemma3-1b (local layers on a ring cache), qwen2-1.5b (GQA), minicpm3-4b
(MLA's absorbed decode on the engine's caches), whisper-base (the decoder
on the engine's zeroed cross caches, learned positions),
phi3.5-moe-42b-a6.6b (the MoE block's decode gather) and
llama-3.2-vision-90b ("cross" layers with their gates set non-zero in both
trees), each reduced (``reduce_config``, f32), with the reference's
initialised parameters carried across by ``params_from_jax``.  Both engines
serve the same numpy-seeded requests of 12-24 prompt tokens and 7 new
tokens each under every routing policy, and once with ``batch=2``: the
tokens must be equal and ``ServeStats`` equal as dataclasses.  The reduced
gemma3-1b's local layers keep a 16-slot ring, so every request's ring
wraps while it decodes (``test_gemma_rings_wrap_in_decode`` pins that).
Last, the serving driver's weights do not depend on the device it serves
on (ROADMAP F12); its run on the card is marked ``cuda`` and skips here.
"""
import contextlib
import dataclasses
import functools
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models.model import build_model as jax_build_model
from repro.serving import engine as jax_engine
from repro_torch._tree import flatten_with_path
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.engine import POLICIES, Request, ServingEngine

ARCHS = ["gemma3-1b", "qwen2-1.5b", "minicpm3-4b", "whisper-base",
         "phi3.5-moe-42b-a6.6b", "llama-3.2-vision-90b"]
PROMPT_LEN = (12, 24)       # inclusive; gemma3-1b's reduced window is 16
MAX_NEW = 7
MAX_SEQ = 48                # above the reduced window: the ring has 16 slots
MAX_POS = 64                # whisper's learned decoder positions


def _gates_on(jp):
    """The VLM's cross gates set non-zero (tanh(0) = 0 silences them)."""
    for group in jp["stack"]["groups"]:
        if "gate_x" in group:
            group["gate_x"] = group["gate_x"] + 0.5
            group["gate_m"] = group["gate_m"] - 0.7
    return jp


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(cfg, JAX model, JAX params, port model, port params), reduced."""
    cfg = reduce_config(get_config(arch))
    jm = jax_build_model(jax_reduce_config(jax_get_config(arch)), max_pos=MAX_POS)
    jp = _gates_on(jm.init_params(jax.random.key(0)))
    pm = build_model(cfg, max_pos=MAX_POS, device="cpu")
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jm, jp, pm, pp


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    """The JAX model's prefill and decode step, jitted once per
    architecture.  Each ``jax_engine.Replica`` jits its own pair, and the
    pairs share no compilations, so every replica of every engine would
    compile them again; the functions and what they compute are the same."""
    jm = _models(arch)[1]
    return jax.jit(jm.prefill), jax.jit(jm.decode_step)


def _jax_engine(arch, **kw):
    _, jm, jp, _, _ = _models(arch)
    engine = jax_engine.ServingEngine(jm, jp, **kw)
    for rep in engine.replicas:
        rep._prefill, rep._decode = _jitted(arch)
    return engine


def _requests(cls, cfg, n, replicas, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        toks = rng.integers(0, cfg.vocab_size, size=plen)
        home = int(rng.integers(0, replicas)) if rng.random() < 0.7 else -1
        out.append(cls(uid=i, tokens=toks, max_new=MAX_NEW, home_replica=home))
    return out


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    return {r.uid: list(r.out_tokens) for r in done}, engine.stats


def test_gemma_rings_wrap_in_decode():
    """Every request of the traffic below runs past gemma3-1b's reduced
    window while it decodes, so its local layers' ring wraps."""
    cfg = reduce_config(get_config("gemma3-1b"))
    assert cfg.attn_window == 16 < MAX_SEQ and "local" in cfg.layer_kinds()
    for n, replicas, seed in ((6, 2, 0), (8, 3, 5)):
        for req in _requests(Request, cfg, n, replicas, seed):
            assert len(req.tokens) + MAX_NEW > cfg.attn_window
    assert PROMPT_LEN[0] < cfg.attn_window < PROMPT_LEN[1]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy,replicas,batch,n,seed",
                         [(p, 2, 1, 6, 0) for p in POLICIES]
                         + [("locality", 3, 2, 8, 5)])
def test_same_tokens_and_stats(arch, policy, replicas, batch, n, seed):
    cfg, _, _, pm, pp = _models(arch)
    kw = dict(num_replicas=replicas, max_seq=MAX_SEQ, policy=policy, batch=batch)
    want, wstats = _serve(_jax_engine(arch, **kw),
                          _requests(jax_engine.Request, cfg, n, replicas, seed))
    got, gstats = _serve(ServingEngine(pm, pp, device="cpu", **kw),
                         _requests(Request, cfg, n, replicas, seed))
    assert len(got) == n and all(len(t) == MAX_NEW for t in got.values())
    assert got == want
    assert dataclasses.asdict(gstats) == dataclasses.asdict(wstats)


def test_driver_draws_one_model_for_every_device():
    """The serving driver draws its weights on the CPU and moves them, so
    ``--device cuda`` serves the model ``--device cpu`` serves (a CUDA
    generator draws other numbers; ROADMAP F12): the device only receives
    a copy of the CPU draw."""
    cfg = reduce_config(get_config("qwen2-1.5b"))
    want = build_model(cfg, max_pos=256, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    got = serve.random_params(cfg, 256, 3, "cpu")
    on_meta = serve.random_params(cfg, 256, 3, "meta")
    pairs = list(zip(flatten_with_path(want), flatten_with_path(got),
                     flatten_with_path(on_meta)))
    assert len(pairs) == len(flatten_with_path(want)) > 10
    for (pw, w), (pg, g), (pm, m) in pairs:
        assert pw == pg == pm and m.is_meta and m.shape == w.shape and m.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_driver_on_the_card_prints_the_cpu_run(arch):
    """``python -m repro_torch.launch.serve`` on the card against the same
    call with ``--device cpu``: the same stats line and, f32 with K3 within
    3e-5, the same tokens (``chip_smoke.py`` also allows a printed tie)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no interpret mode")
    out = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(["--arch", arch, "--device", dev])
        out[dev] = buf.getvalue().splitlines()
    assert out["cuda"] == out["cpu"]
