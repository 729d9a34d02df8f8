"""The sequence-parallel mLSTM recurrence (``ssm.glr_sequence_parallel``,
``ssm.glr_shardmapped``, ``cfg.sequence_parallel``) against
``repro.models.ssm.glr_shardmapped`` and the reference model under
``jax.set_mesh``.

JAX runs the recurrence under ``shard_map`` on a ``model`` axis of forced
host devices, so one subprocess on 4 of them computes all of this file's
JAX results from numpy inputs drawn here; the port runs the same inputs on
``Mesh(["cpu"] * P, "model")``. Tolerances (f32):

* ``glr_sequence_parallel`` at P in {1, 2, 4} (spans that are and are not
  a multiple of the chunk, shorter than it, normalized or not, with and
  without the final state) within 2e-5 absolute of JAX's outputs and
  states (|y| up to about 3): both sum each span's chunks and the scan in
  f32, in their own orders; JAX's own runs differ from its meshless
  recurrence by up to 2.4e-6;
* gradients through every span and copy within 1e-4 relative L2 of the
  port's meshless ``glr_chunked``'s;
* the xlstm smoke model (3 mLSTM blocks, chunk 16) with
  ``sequence_parallel=True`` at P = 2 and 4: ``forward``, ``prefill``
  (logits and every state), 4 decode steps from that state and
  ``train_loss`` within 1e-4 absolute of JAX's (its gradients within 1e-4
  relative L2 a leaf), and within the same of the port's meshless run.

Without an ambient mesh, without a ``model`` axis, or with a sequence the
axis does not divide, the path raises, as the reference's does.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.models import model, ssm
from repro_torch.sharding.mesh import Mesh, set_mesh
from repro_torch.train import train_step as ts
from repro_torch.train import tree as tree_lib
from torch_parity import CPU, one_torch_thread  # noqa: F401

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 2e-5
MODEL_TOL = 1e-4
B, H, DK, DV = 2, 2, 4, 8
# (devices on the model axis, sequence, chunk, normalize, return_state)
CASES = [(1, 32, 8, True, True), (2, 32, 8, True, True),
         (4, 32, 8, False, True), (4, 32, 8, True, False),
         (2, 24, 8, True, True), (4, 24, 16, False, True),
         (4, 64, 8, True, True), (2, 40, 16, False, False)]
LM_P, LM_S, LM_DECODE = (2, 4), 32, 4


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.normal(size=shape).astype(np.float32)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    return {"q": 0.5 * n(B, s, H, DK), "k": 0.5 * n(B, s, H, DK),
            "v": n(B, s, H, DV),
            "log_f": np.log(sig(n(B, s, H) + 2.0)).astype(np.float32),
            "gate_i": sig(n(B, s, H)).astype(np.float32)}


def _tokens():
    rng = np.random.default_rng(7)
    return rng.integers(0, 128, size=(B, LM_S + LM_DECODE)).astype(np.int32)


_JAX_PROG = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.models import model, ssm
    import dataclasses
    jax.config.update("jax_platform_name", "cpu")
    inp = pickle.load(sys.stdin.buffer)
    out = {"glr": []}
    for (p, s, chunk, norm, ret), x in zip(inp["cases"], inp["glr"]):
        mesh = Mesh(np.array(jax.devices()[:p]), ("model",))
        with jax.set_mesh(mesh):
            f = jax.jit(lambda *a: ssm.glr_shardmapped(
                *a, seq_axis="model", chunk=chunk, normalize=norm,
                return_state=ret))
            r = f(*(x[k] for k in ("q", "k", "v", "log_f", "gate_i")))
        out["glr"].append(jax.tree.map(np.asarray, r))
    cfg = dataclasses.replace(registry.get_config("xlstm-1.3b", smoke=True),
                              sequence_parallel=True)
    params = model.init_params(jax.random.PRNGKey(3), cfg)
    out["params"] = jax.tree.map(np.asarray, params)
    toks = jnp.asarray(inp["tokens"])
    s = inp["prefix"]
    batch = {"tokens": toks[:, :s], "labels": jnp.roll(toks[:, :s], -1, 1)}
    dec = jax.jit(lambda pr, st, t, pos: model.decode_step(
        pr, cfg, st, {"tokens": t}, pos))
    for p in inp["lm_p"]:
        with jax.set_mesh(Mesh(np.array(jax.devices()[:p]), ("model",))):
            hidden, _ = jax.jit(lambda pr, b: model.forward(pr, cfg, b))(
                params, batch)
            state, logits = jax.jit(lambda pr, b: model.prefill(
                pr, cfg, b, s + inp["decode"]))(params, batch)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda pr, b: model.train_loss(pr, cfg, b)))(params, batch)
        steps, st = [], state
        for i in range(inp["decode"]):
            lg, st = dec(params, st, toks[:, s + i], s + i)
            steps.append(np.asarray(lg))
        out[p] = {"hidden": np.asarray(hidden), "logits": np.asarray(logits),
                  "state": jax.tree.map(np.asarray, state), "loss":
                  float(loss), "grads": jax.tree.map(np.asarray, grads),
                  "decode": steps}
    try:
        model.forward(params, cfg, batch)
    except ValueError as e:
        out["no_mesh"] = str(e)
    sys.stdout.buffer.write(pickle.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_side():
    payload = {"cases": CASES, "tokens": _tokens(), "prefix": LM_S,
               "decode": LM_DECODE, "lm_p": LM_P,
               "glr": [_inputs(i, c[1]) for i, c in enumerate(CASES)]}
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _JAX_PROG], env=env,
                         input=pickle.dumps(payload), capture_output=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    return pickle.loads(run.stdout)


def _t(a):
    return torch.from_numpy(np.array(a))


def _glr_args(i):
    x = _inputs(i, CASES[i][1])
    return [_t(x[k]) for k in ("q", "k", "v", "log_f", "gate_i")]


def _max_diff(got, want):
    return float((got - _t(want)).abs().max())


@pytest.mark.parametrize("case", range(len(CASES)))
def test_glr_sequence_parallel_equals_jax(case, jax_side):
    p, s, chunk, norm, ret = CASES[case]
    mesh = Mesh([CPU] * p, "model")
    got = ssm.glr_sequence_parallel(*_glr_args(case), mesh, chunk=chunk,
                                    normalize=norm, return_state=ret)
    want = jax_side["glr"][case]
    if ret:
        (y, st), (wy, wst) = got, want
        assert _max_diff(st.s, wst[0]) <= TOL
        assert _max_diff(st.n, wst[1]) <= TOL
    else:
        y, wy = got, want
    assert y.shape == (B, s, H, DV) and y.dtype == torch.float32
    assert _max_diff(y, wy) <= TOL
    # the ambient-mesh form, and the meshless recurrence
    with set_mesh(mesh):
        again = ssm.glr_shardmapped(*_glr_args(case), seq_axis="model",
                                    chunk=chunk, normalize=norm,
                                    return_state=ret)
    assert torch.equal(again[0] if ret else again, y)
    ref, ref_st = ssm.glr_chunked(*_glr_args(case), chunk=chunk,
                                  normalize=norm)
    assert float((y - ref).abs().max()) <= TOL
    if p == 1:
        assert torch.equal(y, ref)


@pytest.mark.parametrize("p", [2, 4])
def test_glr_sequence_parallel_gradients(p):
    args = [a.requires_grad_(True) for a in _glr_args(6)]
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, 64, H, DV)).astype(np.float32))
    y, st = ssm.glr_sequence_parallel(*args, Mesh([CPU] * p, "model"),
                                      chunk=8, normalize=True,
                                      return_state=True)
    got = torch.autograd.grad((y * w).sum() + st.s.sum() + st.n.sum(), args)
    ref_args = [a.detach().clone().requires_grad_(True) for a in args]
    y0, st0 = ssm.glr_chunked(*ref_args, chunk=8, normalize=True)
    want = torch.autograd.grad((y0 * w).sum() + st0.s.sum() + st0.n.sum(),
                               ref_args)
    for g, r in zip(got, want):
        assert float((g - r).norm() / r.norm()) <= 1e-4


def test_glr_sequence_parallel_raises_without_a_mesh_or_axis():
    args = _glr_args(0)
    with pytest.raises(ValueError, match="ambient mesh"):
        ssm.glr_shardmapped(*args, seq_axis="model")
    with set_mesh(Mesh([CPU] * 2, "data")):
        with pytest.raises(ValueError, match="'model'"):
            ssm.glr_shardmapped(*args, seq_axis="model")
    with pytest.raises(ValueError, match="not divisible"):
        ssm.glr_sequence_parallel(*args, Mesh([CPU] * 3, "model"))
    # a grid: the model axis at the first device's other coordinates
    grid = Mesh([CPU] * 4, ("data", "model"), (2, 2))
    y = ssm.glr_sequence_parallel(*args, grid, chunk=8, normalize=True)
    assert torch.equal(y, ssm.glr_sequence_parallel(
        *args, Mesh([CPU] * 2, "model"), chunk=8, normalize=True))


@pytest.fixture(scope="module")
def xlstm(jax_side):
    cfg = dataclasses.replace(registry.get_config("xlstm-1.3b", smoke=True),
                              sequence_parallel=True)
    params = interop.lm_params(jax_side["params"], cfg, CPU)
    toks = torch.from_numpy(_tokens()).to(torch.int64)
    batch = {"tokens": toks[:, :LM_S],
             "labels": torch.roll(toks[:, :LM_S], -1, dims=1)}
    return cfg, params, toks, batch


def _run_lm(cfg, params, toks, batch):
    """forward, prefill, decode steps, loss and gradients."""
    hidden, _ = model.forward(params, cfg, batch)
    state, logits = model.prefill(params, cfg, batch, LM_S + LM_DECODE)
    st, steps = state, []
    for i in range(LM_DECODE):
        lg, st = model.decode_step(params, cfg, st,
                                   {"tokens": toks[:, LM_S + i]}, LM_S + i)
        steps.append(lg)
    loss, grads = ts.loss_and_grads(ts.trainable(tree_lib.tree_map(
        lambda t: t.detach().clone(), params)), cfg, batch)
    return hidden, logits, state, steps, loss, grads


@pytest.mark.parametrize("p", LM_P)
def test_xlstm_sequence_parallel_equals_jax(p, jax_side, xlstm):
    cfg, params, toks, batch = xlstm
    want = jax_side[p]
    with set_mesh(Mesh([CPU] * p, "model")):
        hidden, logits, state, steps, loss, grads = _run_lm(
            cfg, params, toks, batch)
    assert _max_diff(hidden, want["hidden"]) <= MODEL_TOL
    assert _max_diff(logits, want["logits"]) <= MODEL_TOL
    for c, cycle in enumerate(state):
        s_want, n_want = want["state"]["pos0"]
        assert _max_diff(cycle["pos0"].s, s_want[c]) <= MODEL_TOL
        assert _max_diff(cycle["pos0"].n, n_want[c]) <= MODEL_TOL
    for lg, w in zip(steps, want["decode"]):
        assert _max_diff(lg, w) <= MODEL_TOL
    assert abs(float(loss) - want["loss"]) <= MODEL_TOL * abs(want["loss"])
    jgrads = interop.lm_params(want["grads"], cfg, CPU)
    for (path, g), (_, w) in zip(tree_lib.leaf_paths(grads),
                                 tree_lib.leaf_paths(jgrads)):
        assert float((g - w).norm() / w.norm().clamp(min=1e-30)) <= \
            MODEL_TOL, path

    # the port's meshless run of the same model
    flat = dataclasses.replace(cfg, sequence_parallel=False)
    h0, lg0, st0, steps0, loss0, _ = _run_lm(flat, params, toks, batch)
    assert float((hidden - h0).abs().max()) <= MODEL_TOL
    assert float((logits - lg0).abs().max()) <= MODEL_TOL
    assert float((state[-1]["pos0"].s - st0[-1]["pos0"].s).abs().max()) \
        <= MODEL_TOL
    assert abs(float(loss) - float(loss0)) <= MODEL_TOL * abs(float(loss0))


def test_sequence_parallel_model_raises_as_the_reference(jax_side, xlstm):
    cfg, params, toks, batch = xlstm
    with pytest.raises(ValueError, match="cannot be empty"):
        model.forward(params, cfg, batch)
    assert "cannot be empty" in jax_side["no_mesh"]
    with set_mesh(Mesh([CPU] * 2, "data")):
        with pytest.raises(ValueError, match="'model'"):
            model.prefill(params, cfg, batch, LM_S)
    with set_mesh(Mesh([CPU] * 3, "model")):
        with pytest.raises(ValueError, match="not divisible"):
            model.train_loss(params, cfg, batch)


def test_recompute_in_the_backward_sees_the_forward_mesh(xlstm):
    """On the card autograd runs the backward, and so the remat forward's
    recompute, on a thread of its own, where the caller's ambient mesh is
    not set. The recompute must run under the mesh of its forward: here the
    backward starts after the mesh's context has closed."""
    cfg, params, _, batch = xlstm
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_lib.leaves(params)]
    trainable = tree_lib.unflatten(params, leaves)
    with set_mesh(Mesh([CPU] * 2, "model")):
        loss = model.train_loss(trainable, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    _, want = ts.loss_and_grads(ts.trainable(tree_lib.tree_map(
        lambda t: t.detach().clone(), params)), dataclasses.replace(
            cfg, sequence_parallel=False), batch)
    for g, w in zip(grads, tree_lib.leaves(want)):
        assert float((g - w).norm() / w.norm().clamp(min=1e-30)) <= MODEL_TOL
