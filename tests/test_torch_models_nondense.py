"""The port's six non-dense LMs against ``repro.models``.

The smoke configs of xlstm-1.3b (mLSTM blocks), zamba2-2.7b (Mamba2 blocks
and one shared attention block), mixtral-8x22b (top-2 of 4 experts,
sliding window 32: the decode ring wraps), phi3.5-moe (top-2 of 8
experts), musicgen-medium (``embeds`` inputs) and llama-3.2-vision
(cross-attention onto 64 frontend states) are initialized by JAX in f32
and carried across with ``interop.lm_params``; both packages run the same
numpy inputs (S = 40 crosses every smoke config's attention chunk).
Tolerances:

* forward (hidden states and the MoE aux), prefill (logits and every
  state), decode steps (per-lane and scalar positions, tapped and
  untapped, from JAX's prefill state) and ``forward_taps`` within 1e-4
  absolute: the frameworks sum products in different orders (the largest
  difference seen is about 1e-5); the MoE routing is the same, so the
  capacity drops of a prefill are the same tokens; the port's tapped and
  untapped steps equal each other bit for bit;
* ``train_loss`` within 1e-5 relative and each leaf's gradient within 1e-4
  relative L2 (a leaf the loss does not reach, musicgen's token table, is
  0 in both);
* an engine run's streams equal JAX engine's (greedy tokens);
* decode and train states round-trip through ``interop`` exactly, a
  train state also through the reference's checkpoint on disk;
* both launchers run each smoke config on the CPU.

The JAX side is compiled once per config into one program that draws the
parameters and gives the forward, the loss's gradients, ``forward_taps``
and the prefill together; its decode step once per config, which the
decode tests and JAX's engine share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import checkpoint as jcheckpoint
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import layers, model, ssm
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import train_step as ts
from repro_torch.train import tree as tree_lib
from torch_parity import CPU, one_torch_thread, run_fast  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("xlstm-1.3b", "zamba2-2.7b", "mixtral-8x22b",
         "phi3.5-moe-42b-a6.6b", "musicgen-medium", "llama-3.2-vision-11b")
B, S = 2, 40
PREFIX = S - 4
F32_TOL = 1e-4

class _Jax:
    """One config's JAX side: its parameters (and the port's copy through
    ``interop.lm_params``) and its sequence-mode results on ``_batch(cfg)``
    with ``_labels(cfg)``: the forward's ``hidden``, ``aux``; the loss
    (``jmodel.train_loss``'s own composition, the forward's chunked
    cross-entropy plus 0.01 aux) and its ``grads``; ``forward_taps``'
    ``taps_hidden``, ``taps``; the prefill of the first ``PREFIX`` tokens
    into a cache of ``S``, ``pre_state``, ``pre_logits``."""

    def __init__(self, arch):
        self.jcfg = jcfg = jregistry.get_config(arch, smoke=True)
        self.cfg = registry.get_config(arch, smoke=True)
        batch = _batch(self.cfg)
        batch["labels"] = _labels(self.cfg)
        self.batch = batch

        def loss(p, b):
            hidden, aux = jmodel.forward(p, jcfg, b)
            xent = jlayers.chunked_softmax_xent(
                hidden, jmodel.unembed_table(p, jcfg), b["labels"], None,
                chunk=jcfg.xent_chunk)
            return xent + 0.01 * aux, (hidden, aux)

        def program(key, b):
            p = jmodel.init_params(key, jcfg)
            (value, outputs), grads = jax.value_and_grad(
                loss, has_aux=True)(p, b)
            fwd = {k: v for k, v in b.items() if k != "labels"}
            taps = jmodel.forward_taps(p, jcfg, fwd, _taps(jcfg))
            pre = jmodel.prefill(p, jcfg, _prefix(fwd, PREFIX), S)
            return p, outputs, (value, grads), taps, pre

        jp, outputs, lg, taps, pre = run_fast(
            ("all", arch), program, jax.random.PRNGKey(0), _jb(batch))
        self.jp = jp
        self.pp = interop.lm_params(jax.tree.map(np.asarray, jp), self.cfg,
                                    CPU)
        ((self.hidden, self.aux), (self.loss, self.grads),
         (self.taps_hidden, self.taps)) = jax.tree.map(
            np.asarray, (outputs, lg, taps))
        self.pre_state, self.pre_logits = pre

    def decode(self, state, inputs, pos):
        """JAX's tapped decode step at cycles ``(0, last)``: ``(logits,
        state, taps)``."""
        taps = (0, self.cfg.num_cycles - 1)
        return run_fast(("decode", self.cfg.name),
                        lambda p, st, i, q: jmodel.decode_step(
                            p, self.jcfg, st, i, q, tap_layers=taps),
                        self.jp, state, inputs, pos)


@pytest.fixture(scope="module")
def lms():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _Jax(arch)
        return cache[arch]

    return get


def _taps(cfg):
    return tuple(range(cfg.num_cycles))[::-1]


def _batch(cfg, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embeddings_provided:
        out["embeds"] = (0.1 * rng.normal(size=(b, s, cfg.d_model))).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     size=(b, s)).astype(np.int32)
    if "cross_attn" in cfg.cycle:
        out["cross_states"] = (0.1 * rng.normal(
            size=(b, cfg.cross_attn_tokens, cfg.d_model))).astype(np.float32)
    return out


def _labels(cfg):
    return np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _prefix(batch, n):
    return {k: (v[:, :n] if k in ("tokens", "embeds") else v)
            for k, v in batch.items()}


def _step_inputs(batch, pos):
    if "embeds" in batch:
        return {"embeds": batch["embeds"][:, pos:pos + 1]}
    return {"tokens": batch["tokens"][:, pos]}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _states_close(got_state, jstate):
    got = jax.tree.leaves(interop.decode_state_to_numpy(got_state))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def _fwd_batch(j):
    return {k: v for k, v in j.batch.items() if k != "labels"}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(lms, arch):
    j = lms(arch)
    got, aux = model.forward(j.pp, j.cfg, _tb(_fwd_batch(j)))
    assert got.shape == (B, S, j.cfg.d_model)
    _close(got, j.hidden)
    assert (float(aux) > 0) == j.cfg.is_moe
    np.testing.assert_allclose(float(aux), float(j.aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(lms, arch):
    j = lms(arch)
    cfg = j.cfg
    pre = _prefix(_fwd_batch(j), PREFIX)
    state, logits = model.prefill(j.pp, cfg, _tb(pre), cache_len=S)
    _close(logits, j.pre_logits)
    _states_close(state, j.pre_state)
    # Every leaf in JAX's dtype (f32 here), the structure the kinds give.
    for i, kind in enumerate(cfg.cycle):
        st = state[0][f"pos{i}"]
        want = {"mlstm": ssm.RecurrentState,
                "mamba": ssm.MambaState}.get(kind, model.attention.KVCache)
        assert type(st) is want
    if "cross_attn" in cfg.cycle:
        i = cfg.cycle.index("cross_attn")
        assert state[0][f"pos{i}"].k.shape[2] == cfg.cross_attn_tokens


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(lms, arch, per_lane):
    # JAX's tapped step at per-lane positions only: its logits and state
    # are bit for bit its untapped step's (tests/test_telemetry.py), and a
    # scalar position is the same position in every lane. The port's
    # untapped and tapped steps, at per-lane or scalar positions, are each
    # held against it, and equal each other.
    j = lms(arch)
    cfg, pp = j.cfg, j.pp
    batch = _fwd_batch(j)
    taps = (0, cfg.num_cycles - 1)
    jstate = j.pre_state
    # The port starts from JAX's state, so each step is compared alone.
    state = interop.decode_state(jax.tree.map(np.asarray, jstate), cfg, CPU)
    for pos in range(PREFIX, S):
        jpos = jnp.full((B,), pos, jnp.int32)
        tpos = (torch.full((B,), pos, dtype=torch.int32) if per_lane
                else torch.tensor(pos, dtype=torch.int32))
        inp = _step_inputs(batch, pos)
        jout = j.decode(jstate, _jb(inp), jpos)
        plain = model.decode_step(pp, cfg, state, _tb(inp), tpos)
        out = model.decode_step(pp, cfg, state, _tb(inp), tpos,
                                tap_layers=taps)
        assert len(plain) == 2 and len(out) == len(jout) == 3
        _close(plain[0], jout[0])
        assert torch.equal(out[0], plain[0])
        assert all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(out[1]), tree_lib.leaves(plain[1])))
        assert out[2].shape == (2, B, 1, cfg.d_model)
        _close(out[2], jout[2])
        jstate, state = jout[1], plain[1]
    _states_close(state, jstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_taps_match_jax(lms, arch):
    j = lms(arch)
    taps = _taps(j.cfg)
    h, tp = model.forward_taps(j.pp, j.cfg, _tb(_fwd_batch(j)), taps)
    assert tp.shape == (len(taps), B, S, j.cfg.d_model)
    _close(h, j.taps_hidden)
    _close(tp, j.taps)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(lms, arch):
    j = lms(arch)
    params = ts.trainable(j.pp)
    loss, grads = ts.loss_and_grads(params, j.cfg, _tb(j.batch))
    np.testing.assert_allclose(float(loss), float(j.loss), rtol=1e-5)
    got = jax.tree.leaves(interop.lm_params_to_numpy(grads))
    want = jax.tree.leaves(j.grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        norm = np.linalg.norm(w)
        if norm == 0:
            assert not g.any()
            continue
        assert np.linalg.norm(g - w) / norm <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(lms, arch):
    # Five requests over two slots: lanes are freed and re-admitted, so
    # the reset zeroes recurrent states, conv histories and cross caches.
    # JAX's engine runs the decode tests' compiled step (its lanes and
    # cache are theirs): the same decode_step, compiled once.
    j = lms(arch)
    cfg, pp = j.cfg, j.pp
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 5, 2, 4, 3)]
    jeng = JServeEngine(j.jp, j.jcfg, slots=B, cache_len=S)
    jeng._decode = lambda st, toks, pos: j.decode(st, {"tokens": toks},
                                                  pos)[:2]
    want = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    eng = ServeEngine(pp, cfg, slots=B, cache_len=S, device=CPU)
    got = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(prompts)])
    assert {c.rid: c.tokens for c in got} == {c.rid: c.tokens for c in want}
    assert eng.resets == len(prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_states_round_trip_through_interop(lms, arch, tmp_path):
    j = lms(arch)
    cfg, pp, jp, grads = j.cfg, j.pp, j.jp, j.grads
    want = jax.tree.map(np.asarray, j.pre_state)
    state = interop.decode_state(want, cfg, CPU)
    for g, w in zip(jax.tree.leaves(interop.decode_state_to_numpy(state)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    # The parameters and a whole train state ("shared" and the experts'
    # stacks included), its moments the gradients and their squares.
    for g, w in zip(jax.tree.leaves(interop.lm_params_to_numpy(pp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(g, w)
    jtrain = jts.TrainStateT(
        params=jp, opt=jopt.AdamWState(
            step=np.int32(3), mu=grads,
            nu=jax.tree.map(np.square, grads), master=None),
        step=np.int32(3))
    # In memory, and through the reference's checkpoint on disk (whose
    # leaf paths do not name zamba2's empty shared_attn position).
    jcheckpoint.save(str(tmp_path), 3, jtrain)
    step, tree, _ = interop.read_jax_checkpoint(str(tmp_path))
    assert step == 3
    for source in (jax.tree.map(np.asarray, jtrain), tree):
        back = interop.train_state_to_numpy(interop.train_state(source, cfg,
                                                                CPU))
        assert back["step"] == back["opt"]["step"] == 3
        assert back["opt"]["master"] is None
        for got, src in ((back["params"], jp), (back["opt"]["mu"], grads),
                         (back["opt"]["nu"], jtrain.opt.nu)):
            gl, wl = jax.tree.leaves(got), jax.tree.leaves(src)
            assert len(gl) == len(wl)
            for g, w in zip(gl, wl):
                np.testing.assert_array_equal(g, np.asarray(w, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(lms, arch):
    # The port alone, as tests/test_models_smoke.py holds the reference:
    # prefill then decode against the full-sequence forward, within 1e-3
    # (the MoE pair without capacity drops).
    cfg = lms(arch).cfg
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg,
                                  moe_capacity_factor=float(cfg.num_experts))
    pp = model.init_params(None, cfg, device=CPU)
    assert model.param_count(pp) == cfg.param_count()
    batch = _tb(_batch(cfg, seed=5))
    hidden, _ = model.forward(pp, cfg, batch)
    full = layers.unembed(model.unembed_table(pp, cfg), hidden,
                          torch.float32)
    state, logits = model.prefill(pp, cfg, _prefix(batch, PREFIX),
                                  cache_len=S)
    errs = [float((logits - full[:, PREFIX - 1]).abs().max())]
    for pos in range(PREFIX, S):
        logits, state = model.decode_step(pp, cfg, state,
                                          _step_inputs(batch, pos), pos)
        errs.append(float((logits - full[:, pos]).abs().max()))
    assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_dtypes(arch):
    # The recurrences' states and Mamba's conv history in f32, caches in
    # the compute dtype, as the reference's init_decode_state.
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jregistry.get_config(arch, smoke=True),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    want = jax.tree.leaves(jmodel.init_decode_state(jcfg, 2, 16))
    state = model.init_decode_state(cfg, 2, 16, device=CPU)
    assert len(state) == cfg.num_cycles
    got = tree_lib.leaves(state[0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape[1:])
        assert str(g.dtype).split(".")[-1] == w.dtype.name


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_each_smoke_config(arch, tmp_path):
    # Both launchers on the CPU; the training one feeds cross_states to a
    # model with cross-attention (the reference's feeds tokens alone).
    line = serve_launch.main(["--arch", arch, "--device", "cpu",
                              "--requests", "2", "--max-new", "2"])
    assert line.startswith("served 2 requests, 4 tokens")
    line = train_launch.main(["--arch", arch, "--smoke-config", "--device",
                              "cpu", "--steps", "1", "--batch", "2",
                              "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert line.startswith(f"arch={registry.get_config(arch, True).name} "
                           f"steps=1 ")
    assert "nan" not in line
