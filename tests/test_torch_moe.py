"""The port's MoE FFN (``repro_torch.models.moe``) and cross-attention
(``attention.cross_attention``) against ``repro.models``.

Router logits and inputs are numpy draws from a seed (normal draws: no
ties); expert and attention weights are drawn by JAX and carried across.
Tolerances:

* the routing exactly: the port's dispatch, expanded to the reference's
  ``(G, g, E, C)`` one-hot, equals JAX's, with capacity dropping active;
  combine and the Switch loss within 1e-6 (softmax and mean in another
  order);
* ``moe_ffn`` in f32 within 1e-5 absolute: the port computes the experts'
  products on slot buffers where the reference contracts one-hot tensors,
  so only the products' summation order differs, and the combine of a
  token's two rows is one f32 sum in both;
* ``cross_attention`` in f32 within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.models import moe as jmoe
from repro_torch.models import attention, moe
from torch_parity import one_torch_thread, run_fast  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _dense_dispatch(routing, num_experts, capacity):
    """The reference's ``(G, g, E, C)`` dispatch (0/1) and combine (the
    gates) tensors of a port routing, in f32."""
    k, groups, g = routing.expert.shape
    dispatch = torch.zeros((groups, g, num_experts, capacity))
    combine = torch.zeros_like(dispatch)
    gi, ti = torch.meshgrid(torch.arange(groups), torch.arange(g),
                            indexing="ij")
    for c in range(k):
        keep = routing.kept[c]
        at = (gi[keep], ti[keep], routing.expert[c][keep],
              routing.slot[c][keep])
        dispatch[at] = 1.0
        combine[at] = routing.gate[c][keep]
    return dispatch, combine


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 2), (2, 5), (3, 4)])
def test_top_k_dispatch_matches_jax(k, capacity):
    groups, g, e = 3, 16, 6
    logits = np.random.default_rng(k * 10 + capacity).normal(
        size=(groups, g, e)).astype(np.float32)
    jd, jc, jaux = run_fast(("dispatch", k, capacity), lambda lg: (
        jmoe._top_k_dispatch(lg, k, capacity)), logits)
    routing, aux = moe._top_k_dispatch(torch.from_numpy(logits), k,
                                       capacity)
    # Capacity binds: some (token, choice) pairs are dropped.
    assert not bool(routing.kept.all())
    d, c = _dense_dispatch(routing, e, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    assert routing.expert.dtype == routing.slot.dtype == torch.int64


D, FF, E = 24, 40, 4


@pytest.fixture(scope="module")
def experts():
    jp = run_fast("init_moe", lambda key: jmoe.init_moe(
        key, D, FF, E, jnp.float32), jax.random.PRNGKey(0))
    return jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("b,s,cf", [(2, 16, 1.25), (1, 32, 0.5),
                                    (3, 1, 1.25), (2, 8, 4.0)])
def test_moe_ffn_matches_jax(experts, b, s, cf):
    # (3, 1): decode's shape, one group a lane at capacity 1.
    jp, pp = experts
    x = np.random.default_rng(s).normal(size=(b, s, D)).astype(np.float32)
    kw = dict(experts_per_token=2, capacity_factor=cf)
    jout, jaux = run_fast(("moe", cf), lambda p, xx: jmoe.moe_ffn(
        p, xx, compute_dtype=jnp.float32, group_size=16, **kw), jp, x)
    out, aux = moe.moe_ffn(pp, torch.from_numpy(x),
                           compute_dtype=torch.float32, group_size=16, **kw)
    assert out.shape == (b, s, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


def test_moe_ffn_gradients_match_jax(experts):
    jp, pp = experts
    x = np.random.default_rng(5).normal(size=(2, 16, D)).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, experts_per_token=2,
                                capacity_factor=1.0,
                                compute_dtype=jnp.float32)
        return jnp.sum(out ** 2) + aux

    jg = run_fast("moe_grad", jax.grad(jloss, argnums=(0, 1)), jp, x)
    leaves = {k: v.clone().requires_grad_() for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_ffn(leaves, xt, experts_per_token=2,
                           capacity_factor=1.0, compute_dtype=torch.float32)
    grads = torch.autograd.grad((out ** 2).sum() + aux,
                                [*leaves.values(), xt])
    want = [jg[0][k] for k in leaves] + [jg[1]]
    for g, w in zip(grads, want):
        scale = np.abs(_np(w)).max()
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_jax(qk_norm):
    d, h, kh, hd, t = 32, 4, 2, 8, 24
    jp = run_fast(("init_attn", qk_norm), lambda key: (
        jattention.init_attention(key, d, h, kh, hd, False, qk_norm,
                                  jnp.float32)), jax.random.PRNGKey(1))
    if qk_norm:  # non-zero scales, so the norms' weights matter
        jp = dict(jp, q_norm=jnp.full((hd,), 0.5), k_norm=jnp.full((hd,),
                                                                 -0.25))
    pp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, d)).astype(np.float32)
    kv = rng.normal(size=(2, t, d)).astype(np.float32)
    kw = dict(num_heads=h, num_kv_heads=kh, head_dim=hd, chunk=8)
    want = run_fast(("cross", qk_norm), lambda p, xx, kk: (
        jattention.cross_attention(p, xx, kk, compute_dtype=jnp.float32,
                                   **kw)), jp, x, kv)
    got = attention.cross_attention(pp, torch.from_numpy(x),
                                    torch.from_numpy(kv),
                                    compute_dtype=torch.float32, **kw)
    assert got.shape == (2, 11, d)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=TOL)


def test_moe_smoke_routing_drops_at_the_published_capacity():
    # phi3.5-moe-smoke's router at its default capacity factor drops
    # tokens; at capacity factor = num_experts (the decode-vs-forward
    # checks' setting) it drops none.
    from repro_torch.configs import registry

    cfg = registry.get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    logits = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 24, cfg.num_experts)).astype(np.float32) * 3)
    for cf, drops in ((cfg.moe_capacity_factor, True),
                      (float(cfg.num_experts), False)):
        c = dataclasses.replace(cfg, moe_capacity_factor=cf)
        capacity = max(1, int(24 * c.experts_per_token
                              * c.moe_capacity_factor / c.num_experts))
        routing, _ = moe._top_k_dispatch(logits, c.experts_per_token,
                                         capacity)
        assert (not bool(routing.kept.all())) == drops
