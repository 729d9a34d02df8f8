"""The port's dense LM (``repro_torch.models``) against ``repro.models``.

The four dense smoke configs (qwen2-7b: QKV bias; gemma3-1b: tied
embeddings and local layers run past their 16-token window, so the decode
ring wraps; qwen3-32b: qk-norm; llama3-405b: three cycles) are initialized
by JAX and carried across with ``interop.lm_params``; both packages then
run the same numpy token batches. In f32 the port's forward, prefill,
decode steps (per-lane and scalar positions, tapped and untapped) and tap
extraction agree with JAX's within 1e-4 absolute (the two frameworks sum
the products in different orders; the largest difference seen is 8e-6).
Registry contents and the analytic parameter counts of all 20 configs are
equal exactly; the six non-dense configs (held against JAX in
``test_torch_models_nondense.py``) build with ``sequence_parallel``, whose
mLSTM recurrence runs over a mesh's ``model`` axis (held against JAX in
``test_torch_sequence_parallel.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_launch
from repro_torch.models import layers, model
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding.mesh import Mesh, set_mesh
from repro_torch.train import tree as tree_lib
from torch_parity import CPU

jax.config.update("jax_platform_name", "cpu")

DENSE = ("qwen2-7b", "gemma3-1b", "qwen3-32b", "llama3-405b")
NON_DENSE = tuple(a for a in jregistry.ARCH_IDS if a not in DENSE)
B, S = 2, 40          # S past gemma3-smoke's local window of 16
PREFIX = S - 6        # decode the last 6 tokens after a prefill
F32_TOL = 1e-4

# One compiled decode program per (config, shapes, taps), shared by tests.
_jdecode = jax.jit(jmodel.decode_step, static_argnums=(1,),
                   static_argnames=("tap_layers",))


@pytest.fixture(scope="module")
def lms():
    cache = {}

    def get(arch, dtype=None):
        key = (arch, dtype)
        if key not in cache:
            jcfg = jregistry.get_config(arch, smoke=True)
            cfg = registry.get_config(arch, smoke=True)
            if dtype is not None:
                jcfg = dataclasses.replace(jcfg, param_dtype=dtype,
                                           compute_dtype=dtype)
                cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                          compute_dtype=dtype)
            jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
            pp = interop.lm_params(jax.tree.map(np.asarray, jp), cfg, CPU)
            cache[key] = (jcfg, jp, cfg, pp)
        return cache[key]

    return get


def _tokens(cfg, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _f32(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.float32).numpy()


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(lms, arch):
    jcfg, jp, cfg, pp = lms(arch)
    toks = _tokens(cfg)
    want, _ = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(pp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), _np(want), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_jax(lms, arch):
    jcfg, jp, cfg, pp = lms(arch)
    toks = _tokens(cfg)[:, :PREFIX]
    jstate, jlogits = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                     cache_len=S)
    state, logits = model.prefill(pp, cfg, {"tokens": torch.from_numpy(toks)},
                                  cache_len=S)
    np.testing.assert_allclose(_f32(logits), _np(jlogits), rtol=0,
                               atol=F32_TOL)
    # The caches, ring layout included, through the state converter.
    want = jax.tree.map(np.asarray, jstate)
    got = interop.decode_state_to_numpy(state)
    assert sorted(got) == sorted(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("tapped", [False, True])
@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_jax(lms, arch, per_lane, tapped):
    jcfg, jp, cfg, pp = lms(arch)
    toks = _tokens(cfg)
    taps = (0, cfg.num_cycles - 1) if tapped else None
    jstate, _ = jmodel.prefill(jp, jcfg,
                               {"tokens": jnp.asarray(toks[:, :PREFIX])},
                               cache_len=S)
    # The port starts from JAX's caches, so each step is compared alone.
    state = interop.decode_state(jax.tree.map(np.asarray, jstate), cfg, CPU)
    for pos in range(PREFIX, S):
        jpos = (jnp.full((B,), pos, jnp.int32) if per_lane
                else jnp.int32(pos))
        tpos = (torch.full((B,), pos, dtype=torch.int32) if per_lane
                else torch.tensor(pos, dtype=torch.int32))
        jout = _jdecode(jp, jcfg, jstate,
                        {"tokens": jnp.asarray(toks[:, pos])}, jpos,
                        tap_layers=taps)
        out = model.decode_step(pp, cfg, state,
                                {"tokens": torch.from_numpy(toks[:, pos])},
                                tpos, tap_layers=taps)
        assert len(out) == len(jout) == (3 if tapped else 2)
        np.testing.assert_allclose(_f32(out[0]), _np(jout[0]), rtol=0,
                                   atol=F32_TOL)
        if tapped:
            assert out[2].shape == (2, B, 1, cfg.d_model)
            assert out[2].dtype == torch.float32
            np.testing.assert_allclose(out[2].numpy(), _np(jout[2]), rtol=0,
                                       atol=F32_TOL)
        jstate, state = jout[1], out[1]
    want = jax.tree.map(np.asarray, jstate)
    got = interop.decode_state_to_numpy(state)
    for name in want:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_per_lane_positions_write_each_lanes_own_slot(lms, arch):
    # Lanes at different offsets (the engine's case): lane 1 is 7 tokens
    # behind lane 0, so a ring wraps for one lane and not the other.
    jcfg, jp, cfg, pp = lms(arch)
    toks = _tokens(cfg, seed=3)
    jstate = jmodel.init_decode_state(jcfg, B, 24)
    state = model.init_decode_state(cfg, B, 24, device=CPU)
    for step in range(24):
        pos = np.array([step, max(step - 7, 0)], np.int32)
        tok = toks[:, step]
        jlog, jstate = _jdecode(jp, jcfg, jstate,
                                {"tokens": jnp.asarray(tok)},
                                jnp.asarray(pos))
        log, state = model.decode_step(pp, cfg, state,
                                       {"tokens": torch.from_numpy(tok)},
                                       torch.from_numpy(pos))
        np.testing.assert_allclose(_f32(log), _np(jlog), rtol=0,
                                   atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_taps_match_jax(lms, arch):
    jcfg, jp, cfg, pp = lms(arch)
    toks = _tokens(cfg)
    taps = tuple(range(cfg.num_cycles))[::-1]
    jh, jt = jmodel.forward_taps(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                 taps)
    h, tp = model.forward_taps(pp, cfg, {"tokens": torch.from_numpy(toks)},
                               taps)
    assert tp.shape == (len(taps), B, S, cfg.d_model)
    np.testing.assert_allclose(_f32(h), _np(jh), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(tp.numpy(), _np(jt), rtol=0, atol=F32_TOL)
    # The last cycle's tap is the stream the final norm reads.
    fwd, _ = model.forward(pp, cfg, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(h, fwd)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(lms, arch):
    # The port alone, as tests/test_models_smoke.py holds the reference:
    # prefill then decode against the full-sequence forward, within 1e-3.
    _, _, cfg, pp = lms(arch)
    toks = torch.from_numpy(_tokens(cfg))
    hidden, _ = model.forward(pp, cfg, {"tokens": toks})
    full = layers.unembed(model.unembed_table(pp, cfg), hidden, torch.float32)
    state, logits = model.prefill(pp, cfg, {"tokens": toks[:, :PREFIX]},
                                  cache_len=S)
    errs = [float((logits - full[:, PREFIX - 1]).abs().max())]
    for pos in range(PREFIX, S):
        logits, state = model.decode_step(pp, cfg, state,
                                          {"tokens": toks[:, pos]}, pos)
        errs.append(float((logits - full[:, pos]).abs().max()))
    assert max(errs) < 1e-3, errs


def test_bf16_matches_jax_within_its_bound(lms):
    # qwen2-7b-smoke in bf16: both frameworks round each of the 2L + 1
    # stages (every sublayer's output, the final norm) to bf16 (unit
    # roundoff u = 2^-8), in different orders. Independent roundings add
    # up as sqrt(2L + 1) u; four standard deviations of that, times the
    # largest logit, bound the difference (chip_smoke phase 19 holds the
    # full-width decode to the same formula).
    jcfg, jp, cfg, pp = lms("qwen2-7b", "bfloat16")
    assert pp["embed"].dtype == torch.bfloat16
    toks = _tokens(cfg)
    factor = 4.0 * np.sqrt(2 * cfg.num_layers + 1) * 2.0 ** -8
    jh, _ = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    h, _ = model.forward(pp, cfg, {"tokens": torch.from_numpy(toks)})
    assert h.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(h), _np(jh), rtol=0,
                               atol=factor * np.abs(_np(jh)).max())
    jstate, jlog = jmodel.prefill(jp, jcfg,
                                  {"tokens": jnp.asarray(toks[:, :PREFIX])},
                                  cache_len=S)
    state, log = model.prefill(pp, cfg, {"tokens": torch.from_numpy(
        toks[:, :PREFIX])}, cache_len=S)
    for pos in range(PREFIX, S + 1):
        bound = factor * np.abs(_np(jlog)).max()
        np.testing.assert_allclose(_f32(log), _np(jlog), rtol=0, atol=bound)
        if pos == S:
            break
        jlog, jstate = _jdecode(
            jp, jcfg, jstate, {"tokens": jnp.asarray(toks[:, pos])},
            jnp.full((B,), pos, jnp.int32))
        log, state = model.decode_step(
            pp, cfg, state, {"tokens": torch.from_numpy(toks[:, pos])},
            torch.full((B,), pos, dtype=torch.int32))


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_matches_the_analytic_count(arch):
    cfg = registry.get_config(arch, smoke=True)
    params = model.init_params(None, cfg, device=CPU)
    assert model.param_count(params) == cfg.param_count()
    assert len(params["blocks"]) == cfg.num_cycles
    assert params["embed"].dtype == layers.dtype_of(cfg.param_dtype)
    # Norm scales and biases start at zero; the seed fixes the draw.
    block = params["blocks"][0]["pos0"]
    assert not block["pre_norm"].any()
    again = model.init_params(torch.Generator().manual_seed(0), cfg,
                              device=CPU)
    assert torch.equal(params["embed"], again["embed"])


@pytest.mark.parametrize("arch", DENSE)
def test_lm_params_round_trip(lms, arch):
    jcfg, jp, cfg, pp = lms(arch)
    back = interop.lm_params_to_numpy(pp)
    want = jax.tree.map(np.asarray, jp)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(back)
    assert tree_w == tree_g
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w)


def test_registry_equals_jax():
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.LONG_CONTEXT_ARCHS == jregistry.LONG_CONTEXT_ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in registry.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jregistry.SHAPES.items()})
    for skipped in (False, True):
        assert (registry.cells(include_skipped=skipped)
                == jregistry.cells(include_skipped=skipped))
    for arch, shape, _ in jregistry.cells(include_skipped=True):
        assert (registry.skip_reason(arch, shape)
                == jregistry.skip_reason(arch, shape))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_configs_and_counts_equal_jax(arch, smoke):
    want = jregistry.get_config(arch, smoke=smoke)
    got = registry.get_config(arch, smoke=smoke)
    got_fields, want_fields = dataclasses.asdict(got), dataclasses.asdict(want)
    assert {k: got_fields[k] for k in want_fields} == want_fields
    # The port's own fields (NemotronH's: no counterpart in the reference)
    # sit at their defaults in every config the two packages share.
    own = {f.name: f.default for f in dataclasses.fields(got)
           if f.name not in want_fields}
    assert own and {k: got_fields[k] for k in own} == own
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert (got.num_cycles, got.q_per_kv, got.is_moe) == (
        want.num_cycles, want.q_per_kv, want.is_moe)


@pytest.mark.parametrize("arch", NON_DENSE)
def test_non_dense_configs_raise_at_build(arch):
    """The name is the earlier check's, from when ``sequence_parallel``
    raised at build. Now each non-dense config builds with
    ``sequence_parallel=True``, its decode state initialises and
    ``interop.lm_params`` carries it. Under a ``model``-axis CPU mesh the
    mLSTM model's forward equals the meshless forward within 1e-5 (f32:
    the spans' sums run in another order) and raises without a mesh, as the
    reference's does; a config without mLSTM blocks gives the meshless
    result bit for bit."""
    base = registry.get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, sequence_parallel=True)
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device=CPU)
    state = model.init_decode_state(cfg, 1, 8, device=CPU)
    assert len(state) == cfg.num_cycles
    carried = dict(tree_lib.leaf_paths(interop.lm_params(
        interop.lm_params_to_numpy(params), cfg, CPU)))
    own = dict(tree_lib.leaf_paths(params))
    assert set(carried) == set(own)
    assert all(torch.equal(carried[k], own[k]) for k in own)
    gen = torch.Generator().manual_seed(1)
    batch = ({"embeds": torch.randn((2, 32, cfg.d_model), generator=gen)}
             if cfg.embeddings_provided else
             {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                      generator=gen)})
    if "cross_attn" in cfg.cycle:
        batch["cross_states"] = torch.randn(
            (2, cfg.cross_attn_tokens, cfg.d_model), generator=gen)
    with torch.no_grad():
        want, _ = model.forward(params, base, batch)
        with set_mesh(Mesh([CPU] * 2, "model")):
            got, _ = model.forward(params, cfg, batch)
        if "mlstm" in cfg.cycle:
            assert float((got - want).abs().max()) <= 1e-5
            with pytest.raises(ValueError, match="ambient mesh"):
                model.forward(params, cfg, batch)
        else:
            assert torch.equal(got, want)


def test_tap_layers_are_validated(lms):
    _, _, cfg, pp = lms("qwen2-7b")
    toks = torch.from_numpy(_tokens(cfg, b=1, s=4))
    for bad in ((), (cfg.num_cycles,), (-1,)):
        with pytest.raises(ValueError, match="tap_layers"):
            model.forward_taps(pp, cfg, {"tokens": toks}, bad)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; with a card device=None runs there")
def test_entry_points_need_a_card_without_device():
    cfg = registry.get_config("qwen2-7b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_decode_state(cfg, 1, 8)
    params = model.init_params(None, cfg, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg, slots=1, cache_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_launch.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_params({}, cfg)
