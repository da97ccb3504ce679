"""The port's mixture-of-experts block (``repro_torch.models.moe``) held
against the JAX package's (``repro.models.moe``) on the CPU.

The reduced qwen3-moe-30b-a3b (8 experts, top 2, width 32, d 64, f32), the
reference's own ``moe_init`` parameters carried across as numpy arrays,
inputs from a numpy seed.  Cases cover both of the port's dispatch forms
(the gather at ``tokens * k <= E``: t 1, 3 and 4; the batched product
otherwise), one and two token groups (t 1024 makes two groups of 512),
capacity factors that drop nothing (8.0), some pairs (1.25) and most
(0.01), a zero router (every gate ties) and the reference's ``TypeError``
for a group count that does not divide the tokens (R5).  Tolerance: atol
2e-5, rtol 1e-3, as in ``tests/test_moe.py``.  Also mirrors
``tests/test_moe.py`` on the port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import moe as jax_moe
from repro_torch import configs
from repro_torch.models import moe

ARCH = "qwen3-moe-30b-a3b"
TOL = dict(atol=2e-5, rtol=1e-3)
SHAPES = [(2, 16), (1, 1), (1, 513), (1, 1024), (1, 3), (1, 4)]
FACTORS = [8.0, 1.25, 0.01]


def _cfgs(**kw):
    """(reference cfg, port cfg), reduced, with MoE fields replaced."""
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    cfg = configs.reduce_config(configs.get_config(ARCH))
    if kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
    return jcfg, cfg


@pytest.fixture(scope="module")
def params():
    """The reference's ``moe_init`` (key 0): (JAX tree, port tree)."""
    jcfg, _ = _cfgs()
    jp = jax_moe.moe_init(jax.random.key(0), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(b, t, d=64, seed=1):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)


def _both(jp, pp, x, factor, **kw):
    jcfg, cfg = _cfgs(capacity_factor=factor, **kw)
    want, waux = jax_moe.moe_block(jp, jnp.asarray(x), jcfg)
    got, gaux = moe.moe_block(pp, torch.from_numpy(x), cfg)
    return np.asarray(want), float(waux), got.numpy(), float(gaux)


class TestAgainstReference:
    @pytest.mark.parametrize("factor", FACTORS)
    @pytest.mark.parametrize("b,t", SHAPES)
    def test_output_and_aux(self, params, b, t, factor):
        jp, pp = params
        want, waux, got, gaux = _both(jp, pp, _x(b, t), factor)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(gaux, waux, **TOL)
        dropped = int((np.linalg.norm(want.reshape(b * t, -1), axis=-1) < 1e-6).sum())
        if factor == 0.01 and t >= 16:
            assert dropped > 0, "capacity 0.01 must drop tokens"
        if factor == 8.0:
            assert dropped == 0

    @pytest.mark.parametrize("b,t", [(1, 1), (1, 3), (2, 16), (1, 513)])
    def test_zero_router_ties_every_expert(self, params, b, t):
        """Equal gates: the reference's ``top_k`` takes the lowest expert
        indices first; so must the port, in both dispatch forms."""
        jp, pp = params
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        pp = dict(pp, router=torch.zeros_like(pp["router"]))
        want, waux, got, gaux = _both(jp, pp, _x(b, t, seed=2), 1.25)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(gaux, waux, **TOL)
        _, cfg = _cfgs()
        _, topv, topi = moe.route(pp, torch.from_numpy(_x(1, t, seed=2)), cfg)
        assert (topi == torch.arange(cfg.moe.top_k)).all()
        torch.testing.assert_close(topv, torch.full_like(topv, 1 / cfg.moe.top_k))

    @pytest.mark.parametrize("b,t", [(1, 1025), (1, 1537)])
    def test_group_that_does_not_divide_raises_like_the_reference(self, params, b, t):
        """R5: 1025 tokens make 2 groups that the reshape cannot form."""
        jp, pp = params
        jcfg, cfg = _cfgs()
        x = _x(b, t)
        with pytest.raises(TypeError, match="cannot reshape"):
            jax_moe.moe_block(jp, jnp.asarray(x), jcfg)
        with pytest.raises(TypeError, match="cannot reshape"):
            moe.moe_block(pp, torch.from_numpy(x), cfg)

    def test_route_matches_top_k(self, params):
        """Gates, normalised top-k weights and indices of the router alone."""
        jp, pp = params
        jcfg, cfg = _cfgs()
        x = _x(2, 16, seed=4)
        gates, topv, topi = moe.route(pp, torch.from_numpy(x), cfg)
        wg = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
        wv, wi = jax.lax.top_k(wg, cfg.moe.top_k)
        np.testing.assert_allclose(gates.numpy(), np.asarray(wg), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(topv.numpy(), np.asarray(wv / wv.sum(-1, keepdims=True)),
                                   rtol=0, atol=1e-6)

    def test_init_layout(self, params):
        jp, _ = params
        _, cfg = _cfgs()
        mine = moe.moe_init(torch.Generator().manual_seed(0), cfg)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        assert mine["router"].dtype == torch.float32

    def test_local_expert_bias_without_a_mesh(self):
        """No expert axis: the bias is zero, as the reference's without rules."""
        want = jax_moe._local_expert_bias(4, 8, 50.0)
        got = moe._local_expert_bias(4, 8, 50.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not got.any()

    def test_gather_and_batched_forms_agree(self, params):
        """The same tokens through both dispatch forms: one decode token at a
        time (the gather) against all of them at once in one group (the
        batched product, nothing dropped)."""
        _, pp = params
        _, cfg = _cfgs(capacity_factor=8.0)
        x = torch.from_numpy(_x(1, 24, seed=5))
        whole, _ = moe.moe_block(pp, x, cfg)
        steps = torch.cat([moe.moe_block(pp, x[:, i:i + 1], cfg)[0] for i in range(24)], 1)
        torch.testing.assert_close(steps, whole, **TOL)


class TestOnThePort:
    """``tests/test_moe.py``'s cases on the port alone."""

    def test_no_drop_equals_dense_expert_mix(self, params):
        _, pp = params
        _, cfg = _cfgs(capacity_factor=16.0)
        x = torch.from_numpy(_x(1, 8, seed=6)) * 0.3
        out, _ = moe.moe_block(pp, x, cfg)
        gates = torch.softmax(x @ pp["router"], -1)
        topv, topi = torch.topk(gates, cfg.moe.top_k)
        topv = topv / topv.sum(-1, keepdim=True)
        ref = torch.zeros_like(x)
        for t in range(x.shape[1]):
            for j in range(cfg.moe.top_k):
                e = int(topi[0, t, j])
                h = torch.nn.functional.silu(x[0, t] @ pp["w_gate"][e]) * (x[0, t] @ pp["w_up"][e])
                ref[0, t] += topv[0, t, j] * (h @ pp["w_down"][e])
        torch.testing.assert_close(out, ref, **TOL)

    def test_aux_loss_decreases_with_balance(self, params):
        _, pp = params
        _, cfg = _cfgs()
        x = torch.from_numpy(_x(2, 32, seed=7))
        _, uniform = moe.moe_block(dict(pp, router=torch.zeros_like(pp["router"])), x, cfg)
        biased = torch.zeros_like(pp["router"])
        biased[:, 0] = 20.0
        _, skewed = moe.moe_block(dict(pp, router=biased), x, cfg)
        assert float(skewed) > float(uniform)
