"""The port's linear recurrences (``repro_torch.models.ssm``) against
``repro.models.ssm``.

Inputs are numpy draws from a seed; block weights are drawn by JAX's
``init_mlstm`` / ``init_mamba2`` and carried across. Tolerances:

* f32 forward values (``glr_chunked``, ``glr_decode_step``, the mLSTM and
  Mamba2 blocks and decodes) within 1e-5 absolute: the two frameworks sum
  each chunk's products in different orders (the largest difference seen
  is about 1e-6);
* f32 gradients within 1e-4 relative to the largest entry of each;
* bf16 blocks within ``4 sqrt(k) 2^-8`` of the largest output, ``k`` the
  bf16 roundings on the path (8 for the mLSTM's, 12 for Mamba2's: the
  projections, the conv, the gates, the recurrence's output, the skip, the
  norm and the down projection), as chip_smoke holds a whole model: XLA
  fuses elementwise chains and skips some roundings the port makes, so the
  two differ by independent roundings of that many stages (the largest
  seen is 2^-5.6 of the largest output, Mamba2 from a bf16 history). Their
  output dtypes equal JAX's exactly: f32 from an f32 conv history and bf16
  from a bf16 one.

At a strong decay (``log_f = -3`` a step, chunk 64) the reference's
gradients are NaN (its masked ``exp`` overflows above the triangle); the
port's are finite and equal those of a step-by-step ``glr_decode_step``
loop within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm
from torch_parity import one_torch_thread, run_fast  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
GRAD_RTOL = 1e-4


def _bf16_bound(stages, peak):
    return 4.0 * np.sqrt(stages) * 2.0 ** -8 * peak


def _draws(seed, b=2, s=40, h=3, dk=4, dv=5, decay=0.3):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    q, k, v = f(b, s, h, dk), f(b, s, h, dk), f(b, s, h, dv)
    log_f = (-decay * rng.random((b, s, h))).astype(np.float32)
    gate_i = rng.random((b, s, h)).astype(np.float32)
    return q, k, v, log_f, gate_i


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(tree, dtype=torch.float32):
    return {k: _t(v, dtype) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("s", [32, 37])
def test_glr_chunked_matches_jax(s, normalize):
    # S = 32 fills four chunks of 8; S = 37 pads the last with log_f = 0.
    arrays = _draws(0, s=s)
    jy, jst = run_fast(("glr", normalize), lambda *xs: jssm.glr_chunked(
        *xs, chunk=8, normalize=normalize), *arrays)
    y, st = ssm.glr_chunked(*map(torch.from_numpy, arrays), chunk=8,
                            normalize=normalize)
    assert y.shape == (2, s, 3, 5) and y.dtype == torch.float32
    _close(y, jy)
    _close(st.s, jst.s)
    _close(st.n, jst.n)


def test_glr_chunked_raw_and_carried_state():
    arrays = _draws(1, s=29)
    jarr, tarr = list(map(jnp.asarray, arrays)), list(map(torch.from_numpy,
                                                          arrays))
    # A carried state: the second half after the first half's state equals
    # the whole sequence's tail.
    j0 = jssm.glr_chunked(*(a[:, :13] for a in jarr), chunk=4,
                          normalize=True)[1]
    s0 = ssm.RecurrentState(_t(j0.s), _t(j0.n))
    (jy, jnd), jst = jssm.glr_chunked(*(a[:, 13:] for a in jarr), j0,
                                      chunk=4, normalize=True,
                                      return_raw=True)
    (y, nd), st = ssm.glr_chunked(*(a[:, 13:] for a in tarr), s0, chunk=4,
                                  normalize=True, return_raw=True)
    assert y.dtype == nd.dtype == torch.float32 and nd.shape == (2, 16, 3)
    _close(y, jy)
    _close(nd, jnd)
    _close(st.s, jst.s)
    whole, _ = ssm.glr_chunked(*tarr, chunk=4, normalize=True)
    _close(y / torch.clamp(nd.abs(), min=1.0)[..., None], whole[:, 13:])


def test_glr_chunked_gradients_match_jax():
    arrays = _draws(2, s=21)
    w = np.random.default_rng(3).normal(size=(2, 21, 3, 5)).astype(
        np.float32)

    def jloss(*xs):
        y, st = jssm.glr_chunked(*xs, chunk=8, normalize=True)
        return jnp.sum(y * w) + jnp.sum(st.s) + jnp.sum(st.n)

    want = run_fast("glr_grad", jax.grad(jloss, argnums=(0, 1, 2, 3, 4)),
                    *arrays)
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, st = ssm.glr_chunked(*xs, chunk=8, normalize=True)
    loss = (y * torch.from_numpy(w)).sum() + st.s.sum() + st.n.sum()
    got = torch.autograd.grad(loss, xs)
    for g, wnt in zip(got, want):
        assert np.isfinite(_np(wnt)).all()
        scale = np.abs(_np(wnt)).max()
        np.testing.assert_allclose(_np(g), _np(wnt), rtol=0,
                                   atol=GRAD_RTOL * scale)


def test_strong_decay_gradients_are_finite_and_equal_the_step_loop():
    b, s, h, dk, dv = 1, 128, 2, 4, 4
    q, k, v, _, gate_i = _draws(4, b=b, s=s, h=h, dk=dk, dv=dv)
    log_f = np.full((b, s, h), -3.0, np.float32)
    arrays = (q, k, v, log_f, gate_i)

    def jloss(lf):
        y, _ = jssm.glr_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), lf, jnp.asarray(gate_i),
                                chunk=64)
        return jnp.sum(y)

    # The reference: a finite forward, NaN gradients (ROADMAP, "Caveats in
    # the reference").
    assert np.isnan(_np(run_fast("glr_nan", jax.grad(jloss),
                                 log_f))).all()

    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, _ = ssm.glr_chunked(*xs, chunk=64)
    got = torch.autograd.grad(y.sum(), xs)
    ys = [torch.from_numpy(a).requires_grad_() for a in arrays]
    state = ssm.RecurrentState(torch.zeros(b, h, dk, dv),
                               torch.zeros(b, h, dk))
    total = 0.0
    for t in range(s):
        yt, state = ssm.glr_decode_step(*(a[:, t] for a in ys), state)
        total = total + yt.sum()
    want = torch.autograd.grad(total, ys)
    for g, wnt in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(
            g.numpy(), wnt.numpy(), rtol=0,
            atol=GRAD_RTOL * float(wnt.abs().max()))


@pytest.mark.parametrize("normalize", [False, True])
def test_glr_decode_step_matches_jax(normalize):
    q, k, v, log_f, gate_i = (a[:, 0] for a in _draws(5, s=1))
    rng = np.random.default_rng(6)
    s0 = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    n0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    jy, jst = jssm.glr_decode_step(
        *map(jnp.asarray, (q, k, v, log_f, gate_i)),
        jssm.RecurrentState(jnp.asarray(s0), jnp.asarray(n0)),
        normalize=normalize)
    y, st = ssm.glr_decode_step(
        *map(torch.from_numpy, (q, k, v, log_f, gate_i)),
        ssm.RecurrentState(torch.from_numpy(s0), torch.from_numpy(n0)),
        normalize=normalize)
    _close(y, jy)
    _close(st.s, jst.s)
    _close(st.n, jst.n)


D, EXPAND, HEADS, STATE, CONV = 16, 2, 4, 6, 4


def _x(seed, b=2, s=19):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(
        np.float32)


def test_mlstm_block_and_decode_match_jax():
    jp = run_fast("init_mlstm", lambda key: jssm.init_mlstm(
        key, D, EXPAND, HEADS, jnp.float32), jax.random.PRNGKey(0))
    pp = _params(jp)
    x = _x(7)
    _close(ssm.mlstm_block(pp, torch.from_numpy(x), HEADS, 8, torch.float32),
           run_fast("mlstm", lambda p, xx: jssm.mlstm_block(
               p, xx, HEADS, 8, jnp.float32), jp, x))
    jst = jssm.mlstm_state_shape(2, D, EXPAND, HEADS)
    st = ssm.mlstm_state_shape(2, D, EXPAND, HEADS, torch.device("cpu"))
    assert st.s.shape == jst.s.shape and st.s.dtype == torch.float32
    for t in range(4):
        xt = x[:, t:t + 1]
        jy, jst = run_fast("mlstm_decode", lambda p, xx, st: (
            jssm.mlstm_decode(p, xx, st, HEADS, jnp.float32)), jp, xt, jst)
        y, st = ssm.mlstm_decode(pp, torch.from_numpy(xt), st, HEADS,
                                 torch.float32)
        _close(y, jy)
        _close(st.s, jst.s)
        _close(st.n, jst.n)


def test_mamba2_block_and_decode_match_jax():
    jp = run_fast("init_mamba2", lambda key: jssm.init_mamba2(
        key, D, EXPAND, STATE, HEADS, CONV, jnp.float32),
        jax.random.PRNGKey(1))
    pp = _params(jp)
    x = _x(8)
    _close(ssm.mamba2_block(pp, torch.from_numpy(x), HEADS, STATE, 8,
                            torch.float32),
           run_fast("mamba2", lambda p, xx: jssm.mamba2_block(
               p, xx, HEADS, STATE, 8, jnp.float32), jp, x))
    jst = jssm.mamba_state_shape(2, D, EXPAND, STATE, HEADS, CONV)
    st = ssm.mamba_state_shape(2, D, EXPAND, STATE, HEADS, CONV,
                               torch.device("cpu"))
    assert st.conv.shape == jst.conv.shape
    for t in range(5):  # past the conv's width of 4
        xt = x[:, t:t + 1]
        jy, jst = run_fast("mamba2_decode", lambda p, xx, st: (
            jssm.mamba2_decode(p, xx, st, HEADS, STATE, jnp.float32)), jp, xt,
            jst)
        y, st = ssm.mamba2_decode(pp, torch.from_numpy(xt), st, HEADS,
                                  STATE, torch.float32)
        _close(y, jy)
        _close(st.ssm.s, jst.ssm.s)
        _close(st.conv, jst.conv)


@pytest.mark.parametrize("history", ["float32", "bfloat16"])
def test_mamba2_decode_in_bf16_follows_the_histories_dtype(history):
    # f32 history (init_decode_state's): f32 from the conv to the output;
    # bf16 history (what prefill returns in a bf16 model): bf16.
    jp = run_fast("init_mamba2_bf16", lambda key: jssm.init_mamba2(
        key, D, EXPAND, STATE, HEADS, CONV, jnp.bfloat16),
        jax.random.PRNGKey(2))
    pp = _params(jp, torch.bfloat16)
    x = _x(9, s=3)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[history]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[history]
    conv = np.random.default_rng(10).normal(
        size=(2, CONV - 1, D * EXPAND + 2 * STATE)).astype(np.float32)
    jst = jssm.MambaState(
        ssm=jssm.mamba_state_shape(2, D, EXPAND, STATE, HEADS, CONV).ssm,
        conv=jnp.asarray(conv, jdt))
    st = ssm.MambaState(
        ssm=ssm.mamba_state_shape(2, D, EXPAND, STATE, HEADS, CONV,
                                  torch.device("cpu")).ssm,
        conv=_t(jst.conv, tdt))
    for t in range(3):
        xt = x[:, t:t + 1]
        jy, jst = run_fast("mamba2_decode_bf16", lambda p, xx, st: (
            jssm.mamba2_decode(p, xx, st, HEADS, STATE, jnp.bfloat16)), jp,
            jnp.asarray(xt, jnp.bfloat16), jst)
        y, st = ssm.mamba2_decode(pp, _t(xt, torch.bfloat16), st, HEADS,
                                  STATE, torch.bfloat16)
        assert str(y.dtype).split(".")[-1] == jy.dtype.name == history
        assert (str(st.conv.dtype).split(".")[-1] == jst.conv.dtype.name
                == history)
        _close(y, jy, _bf16_bound(12, np.abs(_np(jy)).max()))


def test_mlstm_block_in_bf16_matches_jax_within_its_bound():
    jp = run_fast("init_mlstm_bf16", lambda key: jssm.init_mlstm(
        key, D, EXPAND, HEADS, jnp.bfloat16), jax.random.PRNGKey(3))
    pp = _params(jp, torch.bfloat16)
    x = _x(11)
    jy = run_fast("mlstm_bf16", lambda p, xx: jssm.mlstm_block(
        p, xx, HEADS, 8, jnp.bfloat16), jp, jnp.asarray(x, jnp.bfloat16))
    y = ssm.mlstm_block(pp, _t(x, torch.bfloat16), HEADS, 8, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _close(y, jy, _bf16_bound(8, np.abs(_np(jy)).max()))
