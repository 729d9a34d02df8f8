"""The port's training path (``repro_torch.train``, ``layers.
chunked_softmax_xent``, remat and ``model.train_loss``,
``launch/train.py``) against ``repro.train`` on the CPU.

JAX initializes each state; it crosses to the port through
``interop.train_state`` (parameters through ``interop.lm_params``), and
both packages run the same numpy token batches. The smoke configs are
qwen2-7b (f32, QKV bias, two cycles) and gemma3-1b (tied embeddings, local
window 16; sequences of 40 run past it and pad the 16-token attention and
32-token xent chunks).

Tolerances, f32 unless said: the two frameworks sum products in different
orders, so values agree to f32 rounding, not bit for bit. The xent within
1e-6 relative; ``train_loss`` within 1e-5 relative and each leaf's gradient
within 1e-4 relative L2; the schedule within 2 f32 ulps (the cosine's
rounding); AdamW's update, from identical gradients, within 1e-6 relative
of the largest value of each leaf (a few ulps of each op), and bf16 leaves
within one bf16 ulp a step (a value next to a rounding boundary may round
either way); a whole train step's update within 1e-3 relative L2, each
parameter within 1e-6 of its leaf's largest value plus 0.05 lr
(``_assert_step_close`` says why). The remat policies repeat the same ops,
so they agree bit for bit.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import checkpoint as jcheckpoint
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.launch import train as train_launch
from repro_torch.models import layers, model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train import trainer
from repro_torch.train import tree as tree_lib
from torch_parity import CPU

jax.config.update("jax_platform_name", "cpu")

B, S = 4, 32          # the reference tests' batch
S_LONG = 40           # past gemma3-smoke's window; pads attention and xent


def _opt(module, **kw):
    base = dict(learning_rate=3e-3, warmup_steps=5, total_steps=60)
    base.update(kw)
    return module.AdamWConfig(**base)


def _cfgs(arch, dtype=None, **kw):
    jcfg = jregistry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    if dtype is not None:
        kw = dict(param_dtype=dtype, **kw)
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw))


def _batch_np(cfg, seed=7, b=B, s=S, mask=False):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if mask:
        out["loss_mask"] = (np.random.default_rng(seed + 1).uniform(
            size=(b, s)) < 0.7).astype(np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _port_state(jstate, cfg):
    return interop.train_state(jax.tree.map(np.asarray, jstate), cfg, CPU)


_JSTEPS = {}


def _jstep(jcfg, jtcfg):
    key = (jcfg, jtcfg)
    if key not in _JSTEPS:
        _JSTEPS[key] = jax.jit(lambda s, b: jts.train_step(s, b, jcfg, jtcfg))
    return _JSTEPS[key]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _assert_trees_close(got, want, rel, what):
    """Each leaf within ``rel`` of the largest magnitude of that leaf."""
    gl = jax.tree.leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for g, w in zip(gl, wl):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, what
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rel * scale, (
            what, float(np.abs(g - w).max()), scale)


def _assert_step_close(got, want, old, lr, what):
    """A train step's parameters against JAX's, from the same ``old``: the
    whole update within 1e-3 relative L2, each element within 1e-6 of its
    leaf's largest magnitude plus 0.05 lr. Adam divides by ``sqrt(nu) +
    eps``, so an element whose gradient is as small as the frameworks'
    rounding (about 1e-8: a token seen once, or the key bias, whose exact
    gradient is 0 as softmax ignores a shift shared by every key) moves by
    some fraction of lr in each framework's own direction; those elements
    are few."""
    flat = lambda t: np.concatenate(
        [np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(t)])
    g, w, o = flat(got), flat(want), flat(old)
    assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w - o), what
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, what
        bound = 1e-6 * float(np.abs(w).max()) + 0.05 * lr
        assert float(np.abs(g - w).max()) <= bound, (
            what, float(np.abs(g - w).max()), bound)


def _bf16_ulps(got, want):
    """The largest distance in bf16 ulps (of the larger magnitude)."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(abs(g), abs(w)),
                                              1e-38))) - 7)
    return float((np.abs(g - w) / ulp).max())


@pytest.fixture(scope="module")
def setup():
    """The reference tests' setting: qwen2-7b-smoke, lr 3e-3, a fixed
    (4, 32) batch."""
    jcfg, cfg = _cfgs("qwen2-7b")
    jtcfg = jts.TrainConfig(optimizer=_opt(jopt))
    tcfg = ts.TrainConfig(optimizer=_opt(opt_lib))
    jstate = jts.init_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    return jcfg, jtcfg, jstate, cfg, tcfg, _batch_np(cfg)


# ---------------------------------------------------------------------------
# The model side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [64, 50])
def test_chunked_xent_matches_jax(s, masked):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(3, s, 24)).astype(np.float32)
    table = rng.normal(size=(24, 97)).astype(np.float32)
    labels = rng.integers(0, 97, size=(3, s)).astype(np.int32)
    mask = ((rng.uniform(size=(3, s)) < 0.6).astype(np.float32)
            if masked else None)
    want = float(jlayers.chunked_softmax_xent(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), chunk=16))
    got = float(layers.chunked_softmax_xent(
        torch.from_numpy(x), torch.from_numpy(table),
        torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), chunk=16))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_chunked_xent_all_masked_is_zero():
    x = torch.ones(1, 5, 3)
    got = layers.chunked_softmax_xent(x, torch.ones(3, 7),
                                      torch.zeros(1, 5, dtype=torch.int32),
                                      torch.zeros(1, 5), chunk=2)
    assert float(got) == 0.0  # divided by max(count, 1)


_jloss_grad = jax.jit(jax.value_and_grad(jmodel.train_loss),
                      static_argnums=(1,))


@pytest.mark.parametrize("arch,masked", [("qwen2-7b", False),
                                         ("gemma3-1b", True)])
def test_train_loss_and_grads_match_jax(arch, masked):
    jcfg, cfg = _cfgs(arch)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = ts.trainable(interop.lm_params(_np_tree(jp), cfg, CPU))
    batch = _batch_np(cfg, b=2, s=S_LONG, mask=masked)
    want_loss, want_grads = _jloss_grad(jp, jcfg, _jb(batch))
    loss = model.train_loss(params, cfg, _tb(batch))
    grads = torch.autograd.grad(loss, tree_lib.leaves(params))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * float(
        want_loss)
    got = interop.lm_params_to_numpy(tree_lib.unflatten(params, grads))
    want = _np_tree(want_grads)
    assert (jax.tree.structure(jax.tree.map(lambda _: 0, got))
            == jax.tree.structure(jax.tree.map(lambda _: 0, want)))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.isfinite(g).all()
        assert _rel_l2(g, w) <= 1e-4


def _grads(params, cfg, batch):
    loss = model.train_loss(params, cfg, batch)
    return loss, torch.autograd.grad(loss, tree_lib.leaves(params))


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b"])
def test_remat_settings_agree_bit_for_bit(arch):
    cfg = registry.get_config(arch, smoke=True)
    params = ts.trainable(model.init_params(torch.Generator().manual_seed(0),
                                            cfg, device=CPU))
    batch = _tb(_batch_np(cfg, b=2, s=S_LONG))
    settings = [("nothing", None), ("dots", None), ("none", None),
                ("nothing", 2), ("dots", 2), ("none", 2)]
    base_loss, base = _grads(params, dataclasses.replace(
        cfg, remat_policy="none"), batch)
    for policy, group in settings:
        loss, grads = _grads(params, dataclasses.replace(
            cfg, remat_policy=policy, remat_group=group), batch)
        assert torch.equal(loss, base_loss), (policy, group)
        assert all(torch.equal(a, b) for a, b in zip(grads, base)), (
            policy, group)
    # The serving forward gives the remat forward's values.
    hid, _ = model.forward(params, cfg, batch)
    hid_remat, _ = model.forward(params, cfg, batch, remat=True)
    assert torch.equal(hid, hid_remat)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("group", [None, 2])
def test_remat_policies_recompute_what_they_should(group):
    """The backward recomputes a cycle's weight products under "nothing",
    keeps them under "dots" (the reference's
    ``checkpoint_dots_with_no_batch_dims``) and recomputes nothing under
    "none"; a remat group also recomputes the cycles before its last to
    rebuild the inner checkpoints' inputs. A recompute stops once it has
    what the backward needs, so a cycle's last product (``down``, whose
    output nothing saves) is not run again."""
    cfg = registry.get_config("qwen2-7b", smoke=True)
    params = ts.trainable(model.init_params(torch.Generator().manual_seed(0),
                                            cfg, device=CPU))
    batch = _tb(_batch_np(cfg, b=2, s=S))
    counts = {}
    for policy in ("nothing", "dots", "none"):
        c = dataclasses.replace(cfg, remat_policy=policy, remat_group=group)
        loss = model.train_loss(params, c, batch)
        with _CountMM() as mode:
            torch.autograd.grad(loss, tree_lib.leaves(params))
        counts[policy] = mode.mm
    # 7 weight products a block (q, k, v, o, gate, up, down), one block a
    # cycle, two cycles.
    per_cycle = 7 * len(cfg.cycle)
    inner = (per_cycle - 1) * cfg.num_cycles
    outer = per_cycle * (group - 1) * (cfg.num_cycles // group) if group else 0
    assert counts["nothing"] - counts["none"] == inner + outer
    assert counts["dots"] == counts["none"]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_schedule_matches_jax():
    kw = dict(learning_rate=3e-3, warmup_steps=10, total_steps=100,
              min_lr_ratio=0.1)
    jc, c = jopt.AdamWConfig(**kw), opt_lib.AdamWConfig(**kw)
    for step in range(121):
        want = np.float32(jopt.schedule(jc, jnp.int32(step)))
        got = np.float32(opt_lib.schedule(c, torch.tensor(step)))
        assert abs(got - want) <= 2 * np.spacing(want), step


@pytest.mark.parametrize("bf16", [False, True])
def test_apply_matches_jax(setup, bf16):
    """Two updates from the same parameters and gradients; with ``bf16``
    the ``test_bf16_moments_and_master`` setting (bf16 parameters and
    moments, f32 master)."""
    jcfg, _, _, cfg, _, batch = setup
    kw = dict(moment_dtype="bfloat16") if bf16 else {}
    jc, c = _opt(jopt, **kw), _opt(opt_lib, **kw)
    if bf16:
        jcfg, cfg = (dataclasses.replace(x, param_dtype="bfloat16")
                     for x in (jcfg, cfg))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jopt.init(jc, jp)
    params = ts.trainable(interop.lm_params(jax.tree.map(np.asarray, jp),
                                            cfg, CPU))
    state = opt_lib.init(c, params)
    assert (state.master is None) == (jstate.master is None) == (not bf16)
    for i in range(2):
        _, jg = _jloss_grad(jp, jcfg, _jb(_batch_np(cfg, seed=i)))
        grads = interop.lm_params(_np_tree(jg), cfg, CPU)
        jp, jstate, jm = jopt.apply(jc, jp, jg, jstate)
        params, state, m = opt_lib.apply(c, params, grads, state)
        for k in ("grad_norm", "lr", "param_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-6 * float(jm[k]), k
    assert int(state.step) == int(jstate.step) == 2
    if bf16:
        _assert_trees_close(interop.lm_params_to_numpy(state.master),
                            _np_tree(jstate.master), 1e-6, "master")
        # One bf16 ulp a step: each store may round the other way where
        # the f32 values (their clip scales differ in the last ulp: the
        # norms sum in another order) straddle a boundary.
        for got, want in ((params, jp), (state.mu, jstate.mu),
                          (state.nu, jstate.nu)):
            for g, w in zip(jax.tree.leaves(interop.lm_params_to_numpy(got)),
                            jax.tree.leaves(_np_tree(want))):
                assert _bf16_ulps(g, w) <= 2.0
        assert all(t.dtype == torch.bfloat16
                   for t in tree_lib.leaves((params, state.mu, state.nu)))
    else:
        for got, want, what in ((params, jp, "params"),
                                (state.mu, jstate.mu, "mu"),
                                (state.nu, jstate.nu, "nu")):
            _assert_trees_close(interop.lm_params_to_numpy(got),
                                _np_tree(want), 1e-6, what)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(setup, microbatches):
    jcfg, _, jstate, cfg, _, batch = setup
    jtcfg = jts.TrainConfig(optimizer=_opt(jopt), microbatches=microbatches)
    tcfg = ts.TrainConfig(optimizer=_opt(opt_lib), microbatches=microbatches)
    state = _port_state(jstate, cfg)
    jnew, jm = _jstep(jcfg, jtcfg)(jstate, _jb(batch))
    new, m = ts.train_step(state, _tb(batch), cfg, tcfg)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(
        jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * \
        float(jm["grad_norm"])
    assert float(m["lr"]) == float(jm["lr"])
    assert abs(float(m["param_norm"]) - float(jm["param_norm"])) <= 1e-6 * \
        float(jm["param_norm"])
    assert int(new.step) == int(new.opt.step) == 1
    _assert_step_close(interop.lm_params_to_numpy(new.params),
                       _np_tree(jnew.params), _np_tree(jstate.params),
                       float(jm["lr"]), "params")


# ---------------------------------------------------------------------------
# Ports of tests/test_train.py
# ---------------------------------------------------------------------------


class TestOptimizer:
    def test_memorizes_fixed_batch(self, setup):
        _, _, jstate, cfg, tcfg, batch = setup
        state = _port_state(jstate, cfg)
        losses = []
        for _ in range(25):
            state, m = ts.train_step(state, _tb(batch), cfg, tcfg)
            losses.append(float(m["loss"]))
        assert losses[-1] < 0.5 * losses[0]
        assert all(np.isfinite(l) for l in losses)

    def test_schedule_warmup_and_decay(self):
        cfg = opt_lib.AdamWConfig(learning_rate=1.0, warmup_steps=10,
                                  total_steps=100, min_lr_ratio=0.1)
        lr5 = float(opt_lib.schedule(cfg, torch.tensor(5)))
        lr10 = float(opt_lib.schedule(cfg, torch.tensor(10)))
        lr100 = float(opt_lib.schedule(cfg, torch.tensor(100)))
        assert lr5 == pytest.approx(0.5)
        assert lr10 == pytest.approx(1.0)
        assert lr100 == pytest.approx(0.1, rel=1e-3)

    def test_grad_clipping_bounds_update(self, setup):
        _, _, jstate, cfg, _, batch = setup
        tcfg = ts.TrainConfig(
            optimizer=opt_lib.AdamWConfig(learning_rate=1e-3, grad_clip=1e-9))
        state = _port_state(jstate, cfg)
        before = [p.detach().clone() for p in tree_lib.leaves(state.params)]
        new_state, _ = ts.train_step(state, _tb(batch), cfg, tcfg)
        # with an absurdly small clip the params barely move
        delta = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(tree_lib.leaves(new_state.params), before))
        assert delta < 1e-2

    def test_bf16_moments_and_master(self, setup):
        _, _, _, cfg, _, batch = setup
        tcfg = ts.TrainConfig(
            optimizer=opt_lib.AdamWConfig(moment_dtype="bfloat16"))
        cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                                    compute_dtype="bfloat16")
        state = ts.init_state(torch.Generator().manual_seed(0), cfg16, tcfg,
                              device=CPU)
        assert all(m.dtype == torch.bfloat16
                   for m in tree_lib.leaves(state.opt.mu))
        assert state.opt.master is not None  # f32 master for bf16 params
        new_state, metrics = ts.train_step(state, _tb(batch), cfg16, tcfg)
        assert np.isfinite(float(metrics["loss"]))


class TestAccumulation:
    def test_microbatch_equivalence(self, setup):
        _, _, jstate, cfg, _, batch = setup
        params = _port_state(jstate, cfg).params
        l1, g1 = ts.loss_and_grads(params, cfg, _tb(batch), microbatches=1)
        l2, g2 = ts.loss_and_grads(params, cfg, _tb(batch), microbatches=2)
        assert float(l1) == pytest.approx(float(l2), abs=1e-5)
        for a, b in zip(tree_lib.leaves(g1), tree_lib.leaves(g2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _state_arrays(state):
    return [(name, leaf.detach()) for name, leaf in
            tree_lib.leaf_paths(state)]


def _assert_states_equal(a, b):
    pa, pb = _state_arrays(a), _state_arrays(b)
    assert [n for n, _ in pa] == [n for n, _ in pb]
    for (name, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


class TestCheckpoint:
    def test_roundtrip_bitexact(self, setup, tmp_path):
        _, _, jstate, cfg, _, _ = setup
        state = _port_state(jstate, cfg)
        checkpoint.save(str(tmp_path), 3, state)
        step, restored, _ = checkpoint.restore(str(tmp_path), state)
        assert step == 3
        _assert_states_equal(restored, state)
        assert all(p.requires_grad for p in tree_lib.leaves(restored.params))

    def test_bf16_state_roundtrip_bitexact(self, setup, tmp_path):
        """The reference cannot restore a bf16 leaf (``np.save`` writes
        ``'<V2'``, which its restore cannot cast); the port stores the
        16-bit pattern."""
        _, _, _, cfg, _, batch = setup
        cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                                    compute_dtype="bfloat16")
        tcfg = ts.TrainConfig(optimizer=_opt(opt_lib,
                                             moment_dtype="bfloat16"))
        state = ts.init_state(torch.Generator().manual_seed(1), cfg16, tcfg,
                              device=CPU)
        state, _ = ts.train_step(state, _tb(batch), cfg16, tcfg)
        path = checkpoint.save(str(tmp_path), 1, state)
        fresh = ts.init_state(torch.Generator().manual_seed(2), cfg16, tcfg,
                              device=CPU)
        step, restored, _ = checkpoint.restore(str(tmp_path), fresh)
        assert step == 1
        _assert_states_equal(restored, state)
        with open(os.path.join(path, "manifest.json")) as f:
            kinds = {m["dtype"] for m in json.load(f)["arrays"].values()}
        assert kinds == {"bfloat16", "float32", "int32"}

    def test_keep_k_gc(self, setup, tmp_path):
        _, _, jstate, cfg, _, _ = setup
        state = _port_state(jstate, cfg)
        for s in range(5):
            checkpoint.save(str(tmp_path), s, state, keep=2)
        assert checkpoint.available_steps(str(tmp_path)) == [3, 4]

    def test_corrupt_checkpoint_falls_back(self, setup, tmp_path):
        """Fault tolerance: a torn/corrupt newest checkpoint is skipped."""
        _, _, jstate, cfg, _, _ = setup
        state = _port_state(jstate, cfg)
        d = str(tmp_path)
        checkpoint.save(d, 1, state)
        p2 = checkpoint.save(d, 2, state)
        victim = next(f for f in os.listdir(p2) if f.endswith(".npy"))
        with open(os.path.join(p2, victim), "r+b") as f:
            f.truncate(16)
        step, _, _ = checkpoint.restore(d, state)
        assert step == 1  # fell back past the corrupt one
        # a flipped byte past the header fails its CRC the same way
        p3 = checkpoint.save(d, 3, state)
        victim = max((f for f in os.listdir(p3) if f.endswith(".npy")),
                     key=lambda f: os.path.getsize(os.path.join(p3, f)))
        with open(os.path.join(p3, victim), "r+b") as f:
            f.seek(-3, os.SEEK_END)
            byte = f.read(1)
            f.seek(-3, os.SEEK_END)
            f.write(bytes([byte[0] ^ 1]))
        step, _, _ = checkpoint.restore(d, state)
        assert step == 1

    def test_elastic_dtype_cast_restore(self, setup, tmp_path):
        """Restore into a different dtype template (topology/policy change)."""
        _, _, jstate, cfg, _, _ = setup
        state = _port_state(jstate, cfg)
        checkpoint.save(str(tmp_path), 1, state.params)
        template = tree_lib.tree_map(
            lambda x: torch.empty(x.shape, dtype=torch.bfloat16),
            state.params)
        _, restored, _ = checkpoint.restore(str(tmp_path), template)
        assert all(r.dtype == torch.bfloat16
                   for r in tree_lib.leaves(restored))
        for r, p in zip(tree_lib.leaves(restored),
                        tree_lib.leaves(state.params)):
            assert torch.equal(r, p.detach().to(torch.bfloat16))

    def test_no_checkpoint_restores_none(self, setup, tmp_path):
        _, _, jstate, cfg, _, _ = setup
        state = _port_state(jstate, cfg)
        assert checkpoint.restore(str(tmp_path / "absent"), state) is None


class TestTrainerLoop:
    def test_resume_after_kill(self, setup, tmp_path):
        """Simulated preemption: run 6 steps, 'kill', resume, finish at 10."""
        _, _, _, cfg, tcfg, batch = setup
        d = str(tmp_path)
        data = lambda step: _tb(batch)
        gen = lambda: torch.Generator().manual_seed(0)
        loop = trainer.LoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=d)
        r1 = trainer.train(gen(), cfg, tcfg, loop, data, device=CPU)
        assert r1.steps_run == 6
        loop2 = trainer.LoopConfig(total_steps=10, ckpt_every=3, ckpt_dir=d)
        r2 = trainer.train(gen(), cfg, tcfg, loop2, data, device=CPU)
        assert r2.resumed_from == 6
        assert r2.steps_run == 4  # only the remaining steps

    def test_straggler_detection(self, setup):
        """Inject a slow step and check it is flagged."""
        _, _, _, cfg, tcfg, batch = setup
        took = []

        def slow_fn(s, b):
            t0 = time.perf_counter()
            out = ts.train_step(s, b, cfg, tcfg)
            float(out[1]["loss"])
            if len(took) == 8:
                # slower than 3x any step so far, however busy the host
                time.sleep(1.5 + 4 * max(took))
            took.append(time.perf_counter() - t0)
            return out

        loop = trainer.LoopConfig(total_steps=12, ckpt_every=100,
                                  straggler_factor=3.0)
        report = trainer.train(torch.Generator().manual_seed(0), cfg, tcfg,
                               loop, lambda s: _tb(batch), step_fn=slow_fn,
                               device=CPU)
        assert 8 in report.straggler_steps

    def test_nan_loss_restores_from_the_checkpoint(self, setup, tmp_path):
        """A NaN step poisons the in-place state; the loop restores the last
        checkpoint (once) and finishes from it with finite parameters."""
        _, _, _, cfg, tcfg, batch = setup
        calls = {"n": 0}

        def nan_once(s, b):
            calls["n"] += 1
            s, m = ts.train_step(s, b, cfg, tcfg)
            if calls["n"] == 4:
                with torch.no_grad():
                    tree_lib.leaves(s.params)[0].fill_(float("nan"))
                m["loss"] = torch.tensor(float("nan"))
            return s, m

        d = str(tmp_path)
        loop = trainer.LoopConfig(total_steps=5, ckpt_every=2, ckpt_dir=d)
        report = trainer.train(torch.Generator().manual_seed(0), cfg, tcfg,
                               loop, lambda s: _tb(batch), step_fn=nan_once,
                               device=CPU)
        assert report.restores == 1
        assert report.steps_run == 5 and len(report.losses) == 6
        assert all(np.isfinite(report.losses))
        fresh = ts.init_state(torch.Generator().manual_seed(0), cfg, tcfg,
                              device=CPU)
        step, state, _ = checkpoint.restore(d, fresh)
        assert step == 5
        assert all(torch.isfinite(p).all()
                   for p in tree_lib.leaves(state.params))

    def test_nan_loss_without_checkpoint_raises(self, setup):
        _, _, _, cfg, tcfg, batch = setup

        def nan_fn(s, b):
            s, m = ts.train_step(s, b, cfg, tcfg)
            m["loss"] = torch.tensor(float("nan"))
            return s, m

        loop = trainer.LoopConfig(total_steps=3, ckpt_every=100)
        with pytest.raises(FloatingPointError, match="NaN loss at step 0"):
            trainer.train(torch.Generator().manual_seed(0), cfg, tcfg, loop,
                          lambda s: _tb(batch), step_fn=nan_fn, device=CPU)


# ---------------------------------------------------------------------------
# tests/test_system.py::TestTrainCheckpointServe, and the launcher
# ---------------------------------------------------------------------------


class TestTrainCheckpointServe:
    def test_full_lifecycle(self, tmp_path):
        cfg = registry.get_config("qwen2-7b", smoke=True)
        tcfg = ts.TrainConfig(optimizer=opt_lib.AdamWConfig(
            learning_rate=3e-3, warmup_steps=5, total_steps=40))
        toks = _batch_np(cfg)["tokens"]
        batch = _tb({"tokens": toks, "labels": np.roll(toks, -1, 1)})
        d = str(tmp_path)
        gen = lambda: torch.Generator().manual_seed(0)

        loop = trainer.LoopConfig(total_steps=15, ckpt_every=5, ckpt_dir=d)
        r1 = trainer.train(gen(), cfg, tcfg, loop, lambda step: batch,
                           device=CPU)
        # "preemption": resume and continue to 25
        loop2 = trainer.LoopConfig(total_steps=25, ckpt_every=5, ckpt_dir=d)
        r2 = trainer.train(gen(), cfg, tcfg, loop2, lambda step: batch,
                           device=CPU)
        assert r2.resumed_from == 15
        assert r2.final_loss < r1.losses[0], "loss did not improve"

        # restore final params and serve them
        state = ts.init_state(gen(), cfg, tcfg, device=CPU)
        step, state, _ = checkpoint.restore(d, state)
        assert step == 25
        engine = ServeEngine(state.params, cfg, slots=2, cache_len=64,
                             device=CPU)
        outs = engine.run([
            Request(rid=0, prompt=toks[0, :6], max_new_tokens=8),
            Request(rid=1, prompt=toks[1, :4], max_new_tokens=8),
        ])
        assert sorted(c.rid for c in outs) == [0, 1]
        assert all(len(c.tokens) == 8 for c in outs)
        assert all(0 <= t < cfg.vocab_size for c in outs for t in c.tokens)


def test_launcher_trains_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--smoke-config", "--steps", "4", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    line = train_launch.main(argv)
    assert line.startswith("arch=qwen2-7b-smoke steps=4 final_loss=")
    assert line.endswith("resumed=None")
    assert checkpoint.available_steps(str(tmp_path)) == [4]
    again = train_launch.main(argv[:4] + ["6"] + argv[5:])
    assert "steps=2 " in again and again.endswith("resumed=4")


def test_launcher_data_is_deterministic_in_the_step():
    a = train_launch.data_for_step(3, 2, 8, 100)
    b = train_launch.data_for_step(3, 2, 8, 100)
    c = train_launch.data_for_step(4, 2, 8, 100)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))


# ---------------------------------------------------------------------------
# interop: training state and the reference's checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_train_state_round_trip(bf16):
    jcfg, cfg = _cfgs("qwen2-7b", "bfloat16" if bf16 else None)
    jtcfg = jts.TrainConfig(optimizer=_opt(
        jopt, moment_dtype="bfloat16" if bf16 else "float32"))
    jstate = jts.init_state(jax.random.PRNGKey(3), jcfg, jtcfg)
    jstate, _ = _jstep(jcfg, jtcfg)(jstate, _jb(_batch_np(cfg)))
    state = _port_state(jstate, cfg)
    assert (state.opt.master is None) == (not bf16)
    got = interop.train_state_to_numpy(state)
    assert got["step"] == got["opt"]["step"] == 1
    for part, want in (("params", jstate.params), ("mu", jstate.opt.mu),
                       ("nu", jstate.opt.nu), ("master", jstate.opt.master)):
        tree = got["params"] if part == "params" else got["opt"][part]
        if want is None:
            assert tree is None
            continue
        for g, w in zip(jax.tree.leaves(tree), jax.tree.leaves(
                _np_tree(want))):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bf16", [False, True])
def test_jax_checkpoint_restores_and_steps_like_jax(tmp_path, bf16):
    """JAX trains 3 steps and saves; the port reads that directory (bf16
    leaves from ``'<V2'`` files), takes step 4, and lands where JAX's step
    4 does. With ``bf16``: bf16 parameters and moments, f32 master, f32
    compute."""
    jcfg, cfg = _cfgs("qwen2-7b", "bfloat16" if bf16 else None)
    kw = dict(moment_dtype="bfloat16") if bf16 else {}
    jtcfg = jts.TrainConfig(optimizer=_opt(jopt, **kw))
    tcfg = ts.TrainConfig(optimizer=_opt(opt_lib, **kw))
    jfn = _jstep(jcfg, jtcfg)
    jstate = jts.init_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    batches = [_batch_np(cfg, seed=10 + i) for i in range(4)]
    for b in batches[:3]:
        jstate, _ = jfn(jstate, _jb(b))
    jcheckpoint.save(str(tmp_path), 3, jstate)
    if bf16:
        np.testing.assert_raises(ValueError, jcheckpoint.restore,
                                 str(tmp_path), jstate)

    step, tree, _ = interop.read_jax_checkpoint(str(tmp_path))
    assert step == 3
    state = interop.train_state(tree, cfg, CPU)
    # Every saved leaf read back bit for bit.
    got = interop.train_state_to_numpy(state)
    for g, w in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(_np_tree(jstate.params))):
        np.testing.assert_array_equal(g, w)
    for part in ("mu", "nu", "master"):
        want = getattr(jstate.opt, part)
        if want is None:
            assert got["opt"][part] is None
            continue
        for g, w in zip(jax.tree.leaves(got["opt"][part]),
                        jax.tree.leaves(_np_tree(want))):
            np.testing.assert_array_equal(g, w)
    assert int(state.step) == int(state.opt.step) == 3

    # Step 4: the port's own step gives JAX's loss, gradient norm and
    # learning rate; AdamW from the restored state, on JAX's gradients,
    # gives JAX's update (as test_apply_matches_jax holds it).
    fresh = interop.train_state(tree, cfg, CPU)
    _, jm = jfn(jstate, _jb(batches[3]))
    _, m = ts.train_step(state, _tb(batches[3]), cfg, tcfg)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(
        jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * \
        float(jm["grad_norm"])
    assert float(m["lr"]) == float(jm["lr"])
    _, jg = _jloss_grad(jstate.params, jcfg, _jb(batches[3]))
    jparams, jopt_state, _ = jopt.apply(jtcfg.optimizer, jstate.params, jg,
                                        jstate.opt)
    params, opt_state, _ = opt_lib.apply(
        tcfg.optimizer, fresh.params,
        interop.lm_params(_np_tree(jg), cfg, CPU), fresh.opt)
    assert int(opt_state.step) == int(jopt_state.step) == 4
    f32 = [(opt_state.mu, jopt_state.mu), (opt_state.nu, jopt_state.nu)]
    f32 = [(opt_state.master, jopt_state.master)] if bf16 else f32 + [
        (params, jparams)]
    for got, want in f32:
        _assert_trees_close(interop.lm_params_to_numpy(got), _np_tree(want),
                            1e-6, "step 4")
    if bf16:  # one bf16 ulp: this step's stores may round either way
        for got, want in ((params, jparams), (opt_state.mu, jopt_state.mu),
                          (opt_state.nu, jopt_state.nu)):
            for g, w in zip(jax.tree.leaves(interop.lm_params_to_numpy(got)),
                            jax.tree.leaves(_np_tree(want))):
                assert _bf16_ulps(g, w) <= 1.0
