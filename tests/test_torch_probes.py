"""The port's STORM probes (``repro_torch.core.probes``) against
``repro.core.probes``, and the probe contracts of ``tests/test_probes.py``.

Features come from the qwen2-7b smoke model (JAX-initialized, carried
across with ``interop.lm_params``); the hash family and the DFO draws are
JAX's, carried as numpy (``torch_parity``). Probe rows and moments agree
within 1e-5 relative (the two frameworks reduce the means in different
orders). Sketch counts agree up to fp sign ties: row masses exact, at most
1e-4 of the increments in other buckets. Fits agree within the fits' own
sensitivity (``_LOSS_RTOL`` and ``_MSE_RTOL`` below).
Port against port, the bank, sharded and lone fits are bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import probes as jprobes
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.core import dfo, probes, sketch as sketch_lib
from repro_torch.sharding.mesh import Mesh
from torch_parity import CPU, fleet_draws, t, tenant_draws

jax.config.update("jax_platform_name", "cpu")

_MOVED = 1e-4           # the share of increments a sign tie may move
# The probe fit is chaotic at fp rounding: moving the port's own sphere
# directions by one ulp moves the final sketch loss by up to 0.6% and the
# held-in MSE by up to 5.3% (this file's 256 rows of d_model = 64, R = 4096,
# the default probe DFO; six draws). Port against JAX, the first loss
# evaluation is held to 1e-3 and the end of the fit to 5% (final sketch
# loss) and 10% (MSE), as tests/test_torch_banks.py holds the banked fits.
_FIRST_RTOL, _LOSS_RTOL, _MSE_RTOL = 1e-3, 0.05, 0.10
_FIT_ROWS = 4096


@pytest.fixture(scope="module")
def lm():
    jcfg = jregistry.get_config("qwen2-7b", smoke=True)
    cfg = registry.get_config("qwen2-7b", smoke=True)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, interop.lm_params(jax.tree.map(np.asarray, jp),
                                            cfg, CPU)


@pytest.fixture(scope="module")
def linear(lm):
    """Pooled features of 256 random 16-token sequences and a target that
    is a linear readout of them (the reference test's shapes)."""
    jcfg, jp, cfg, pp = lm
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (256, 16), 0,
                                         cfg.vocab_size))
    feats = np.asarray(jprobes.extract_features(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, "mean"))
    w_true = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                          (cfg.d_model,)))
    targets = (feats @ w_true + 0.01 * np.asarray(jax.random.normal(
        jax.random.PRNGKey(4), (256,)))).astype(np.float32)
    return toks, feats, targets, w_true


def _jax_family(key, config, d_model):
    from repro.core import lsh as jlsh

    jfam = jlsh.init_srp(key, config.rows, config.planes, d_model + 3)
    return interop.lsh_params(np.asarray(jfam.projections), CPU)


def _assert_counts_close(got: torch.Tensor, want, n: int):
    counts = got.numpy().astype(np.int64)
    np.testing.assert_array_equal(counts.sum(-1), 2 * n)
    moved = np.abs(counts - np.asarray(want, np.int64)).sum() // 2
    assert moved <= _MOVED * counts.sum(), moved


def _carried(jstate, fam):
    """A JAX probe state's counters and moments as the port's."""
    return probes.ProbeState(
        sketch=interop.sketch(np.asarray(jstate.sketch.counts),
                              int(jstate.sketch.n), CPU),
        params=fam, **{f: t(getattr(jstate, f)) for f in
                       ("x_mean", "x_scale", "y_mean", "y_scale", "scale")})


def _assert_fits_close(traces, jtraces, fleet_losses, jfleet_losses):
    if traces is not None:
        np.testing.assert_allclose(traces[:, 0].numpy(),
                                   np.asarray(jtraces)[:, 0],
                                   rtol=_FIRST_RTOL)
    np.testing.assert_allclose(fleet_losses.numpy(),
                               np.asarray(jfleet_losses), rtol=_LOSS_RTOL)


def _port_dfo():
    return dfo.DFOConfig(**{f: getattr(jprobes._PROBE_DFO, f)
                            for f in jprobes._PROBE_DFO.__dataclass_fields__})


class TestFeaturesAndRows:
    @pytest.mark.parametrize("pool", ["mean", "last"])
    def test_extract_features_match_jax(self, lm, pool):
        jcfg, jp, cfg, pp = lm
        toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (6, 16))
        want = jprobes.extract_features(jp, jcfg,
                                        {"tokens": jnp.asarray(toks)}, pool)
        got = probes.extract_features(pp, cfg, {"tokens": torch.from_numpy(
            toks)}, pool)
        assert got.shape == (6, cfg.d_model) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)

    def test_pool_hidden_rejects_unknown_pools(self):
        with pytest.raises(ValueError):
            probes.pool_hidden(torch.zeros(1, 2, 3), "max")

    def test_probe_rows_and_moments_match_jax(self, linear):
        _, feats, targets, _ = linear
        config = probes.ProbeConfig()
        want, jm = jprobes.probe_rows(jnp.asarray(feats),
                                      jnp.asarray(targets))
        got, m = probes.probe_rows(t(feats), t(targets), config)
        for name in probes.ProbeMoments._fields:
            np.testing.assert_allclose(getattr(m, name).numpy(),
                                       np.asarray(getattr(jm, name)),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        # Under JAX's frozen moments (drifted data clips onto the sphere).
        frozen = probes.ProbeMoments(*(t(getattr(jm, f))
                                       for f in jm._fields))
        want2, _ = jprobes.probe_rows(jnp.asarray(3 * feats),
                                      jnp.asarray(targets), moments=jm)
        got2, same = probes.probe_rows(t(3 * feats), t(targets),
                                       moments=frozen)
        assert same is frozen
        np.testing.assert_allclose(got2.numpy(), np.asarray(want2),
                                   rtol=1e-5, atol=1e-6)
        assert float(got2.norm(dim=-1).max()) <= 1.0 + 1e-6


class TestSketchAndFit:
    def test_sketch_features_match_jax(self, linear):
        _, feats, targets, _ = linear
        config = probes.ProbeConfig(rows=512, batch=64)
        key = jax.random.PRNGKey(5)
        want = jprobes.sketch_features(key, jnp.asarray(feats),
                                       jnp.asarray(targets), config)
        fam = _jax_family(key, config, feats.shape[1])
        for engine in ("scan", "kernel"):
            cfg_e = probes.ProbeConfig(rows=512, batch=64, engine=engine)
            got = probes.sketch_features(None, t(feats), t(targets), cfg_e,
                                         params=fam, device=CPU)
            assert int(got.sketch.n) == int(got.count) == 256
            _assert_counts_close(got.sketch.counts, want.sketch.counts, 256)
            for f in ("x_mean", "x_scale", "y_mean", "y_scale", "scale"):
                np.testing.assert_allclose(getattr(got, f).numpy(),
                                           np.asarray(getattr(want, f)),
                                           rtol=1e-5, atol=1e-6)
        # A drawn family is seeded by the generator.
        a = probes.sketch_features(torch.Generator().manual_seed(1),
                                   t(feats), t(targets), config, device=CPU)
        b = probes.sketch_features(torch.Generator().manual_seed(1),
                                   t(feats), t(targets), config, device=CPU)
        assert a.params.dim == feats.shape[1] + 3
        assert torch.equal(a.sketch.counts, b.sketch.counts)

    def test_fit_probe_matches_jax_and_recovers_the_readout(self, lm,
                                                            linear):
        """The reference test's shape (256 rows, R = 4096, the default
        probe DFO): the port on JAX's family and draws lands on JAX's fit,
        and both beat the mean predictor and align with the readout."""
        _, _, cfg, _ = lm
        _, feats, targets, w_true = linear
        config = probes.ProbeConfig(rows=_FIT_ROWS)
        jstate = jprobes.sketch_features(jax.random.PRNGKey(5),
                                         jnp.asarray(feats),
                                         jnp.asarray(targets), config)
        want = jprobes.fit_probe(jax.random.PRNGKey(6), jstate, cfg.d_model)
        state = probes.sketch_features(
            None, t(feats), t(targets), config,
            params=_jax_family(jax.random.PRNGKey(5), config, cfg.d_model),
            device=CPU)
        _assert_counts_close(state.sketch.counts, jstate.sketch.counts, 256)
        pd = _port_dfo()
        dirs, _ = fleet_draws(jax.random.PRNGKey(6)[None], pd.steps,
                              pd.num_queries, cfg.d_model + 1)
        got = probes.fit_probe(None, state, cfg.d_model, directions=dirs,
                               device=CPU)
        _assert_fits_close(got.losses[None], want.losses[None],
                           got.fleet_losses, want.fleet_losses)
        x, y = t(feats), t(targets)
        jmse = float(want.mse(jnp.asarray(feats), jnp.asarray(targets)))
        mse = float(got.mse(x, y))
        assert abs(mse - jmse) <= _MSE_RTOL * jmse
        assert mse < float(y.var(correction=0)), mse
        cos = float(got.theta @ t(w_true)
                    / (got.theta.norm() * np.linalg.norm(w_true)))
        assert cos > 0.25, cos

    def test_fit_probe_many_matches_jax_on_shared_draws(self, lm, linear):
        _, _, cfg, _ = lm
        _, feats, targets, _ = linear
        config = probes.ProbeConfig(rows=_FIT_ROWS)
        key = jax.random.PRNGKey(8)
        halves = [(feats[:128], targets[:128]), (feats[128:], -targets[128:])]
        jstates = [jprobes.sketch_features(key, jnp.asarray(f),
                                           jnp.asarray(y), config)
                   for f, y in halves]
        # JAX's counters carried across: the fits alone are compared.
        fam = _jax_family(key, config, cfg.d_model)
        states = [_carried(js, fam) for js in jstates]
        want = jprobes.fit_probe_many(jax.random.PRNGKey(9), jstates,
                                      cfg.d_model)
        pd = _port_dfo()
        keys, _ = tenant_draws(jax.random.PRNGKey(9), 2, cfg.d_model + 1,
                               init_noise=False)
        dirs, _ = fleet_draws(keys, pd.steps, pd.num_queries,
                              cfg.d_model + 1)
        got = probes.fit_probe_many(None, states, cfg.d_model,
                                    directions=dirs, device=CPU)
        assert got.tenants == 2 and got.theta.shape == (2, cfg.d_model)
        _assert_fits_close(got.losses, want.losses, got.fleet_losses,
                           want.fleet_losses)
        jf = jnp.stack([jnp.asarray(f) for f, _ in halves])
        jy = jnp.stack([jnp.asarray(y) for _, y in halves])
        np.testing.assert_allclose(
            got.mse(t(np.asarray(jf)), t(np.asarray(jy))).numpy(),
            np.asarray(want.mse(jf, jy)), rtol=_MSE_RTOL)
        for i, (f, y) in enumerate(halves):
            assert torch.equal(got.select(i).theta, got.theta[i])
            assert float(got.select(i).mse(t(f), t(y))) < float(
                t(y).var(correction=0))

    def test_fit_probe_sharded_matches_jax_on_shared_draws(self, lm, linear):
        from repro.core import fleet as jfleet

        _, _, cfg, _ = lm
        _, feats, targets, _ = linear
        config = probes.ProbeConfig(rows=_FIT_ROWS)
        key = jax.random.PRNGKey(10)
        jstate = jprobes.sketch_features(key, jnp.asarray(feats),
                                         jnp.asarray(targets), config)
        f, dim = 4, cfg.d_model + 1
        want = jprobes.fit_probe_sharded(jax.random.PRNGKey(11), jstate,
                                         cfg.d_model, restarts=f)
        pd = _port_dfo()
        jkeys, *_ = jfleet.seed_fleet(jax.random.PRNGKey(11), f, dim,
                                      jprobes._PROBE_DFO)
        inits = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(k, 0), (dim,))) for k in jkeys[1:]])
        dirs, _ = fleet_draws(jkeys, pd.steps, pd.num_queries, dim)
        state = _carried(jstate, _jax_family(key, config, cfg.d_model))
        got = probes.fit_probe_sharded(None, state, cfg.d_model, restarts=f,
                                       inits=t(inits), directions=dirs,
                                       device=CPU)
        _assert_fits_close(None, None, got.fleet_losses, want.fleet_losses)
        jmse = float(want.mse(jnp.asarray(feats), jnp.asarray(targets)))
        assert abs(float(got.mse(t(feats), t(targets))) - jmse) \
            <= _MSE_RTOL * jmse


class TestPortFitsAgree:
    """Port against port: one program, bit for bit."""

    @pytest.fixture(scope="class")
    def state(self):
        # Eight features: the refine pass's O(d^2) samples stay small.
        g = torch.Generator().manual_seed(12)
        feats = torch.randn(256, 8, generator=g)
        targets = feats @ torch.randn(8, generator=g)
        return probes.sketch_features(g, feats, targets,
                                      probes.ProbeConfig(rows=512, batch=64),
                                      device=CPU)

    _DFO = dfo.DFOConfig(steps=40, num_queries=8, sigma=0.5,
                         learning_rate=2.0)

    @pytest.mark.parametrize("restarts", [1, 3])
    def test_fit_probe_many_of_one_is_fit_probe(self, state, restarts):
        d = state.x_mean.shape[0]
        gen = lambda: torch.Generator().manual_seed(13)  # noqa: E731
        lone = probes.fit_probe(gen(), state, d, dfo_config=self._DFO,
                                restarts=restarts, device=CPU)
        many = probes.fit_probe_many(gen(), [state], d, dfo_config=self._DFO,
                                     restarts=restarts, device=CPU)
        assert torch.equal(many.theta[0], lone.theta)
        assert torch.equal(many.intercept[0], lone.intercept)
        assert torch.equal(many.fleet_losses[0], lone.fleet_losses)

    @pytest.mark.parametrize("shards", [1, 2])
    def test_fit_probe_sharded_equals_the_unsharded_fit(self, state, shards):
        d = state.x_mean.shape[0]
        gen = lambda: torch.Generator().manual_seed(14)  # noqa: E731
        kw = dict(restarts=4, dfo_config=self._DFO, refine_steps=1)
        meshless = probes.fit_probe_sharded(gen(), state, d, device=CPU, **kw)
        sharded = probes.fit_probe_sharded(
            gen(), state, d, mesh=Mesh(["cpu"] * shards, "fleet"), **kw)
        lone = probes.fit_probe(gen(), state, d, device=CPU, **kw)
        for fit in (sharded, lone):
            assert torch.equal(fit.theta, meshless.theta)
            assert torch.equal(fit.intercept, meshless.intercept)
            assert torch.equal(fit.fleet_losses, meshless.fleet_losses)

    def test_fit_probe_many_rejects_two_hash_families(self, state):
        g = torch.Generator().manual_seed(99)
        other = probes.sketch_features(g, torch.randn(64, 8, generator=g),
                                       torch.randn(64, generator=g),
                                       probes.ProbeConfig(rows=512),
                                       device=CPU)
        with pytest.raises(ValueError, match="ONE shared hash family"):
            probes.fit_probe_many(None, [state, other],
                                  state.x_mean.shape[0], device=CPU)
        with pytest.raises(ValueError, match="at least one"):
            probes.fit_probe_many(None, [], 4, device=CPU)


class TestMerge:
    def test_shard_merge_equals_union(self, lm):
        jcfg, jp, cfg, pp = lm
        toks = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (64, 12)))
        feats = probes.extract_features(pp, cfg, {"tokens": toks}, "last")
        targets = feats[:, 0]
        config = probes.ProbeConfig(rows=128, batch=16)
        full = probes.sketch_features(torch.Generator().manual_seed(8),
                                      feats, targets, config, device=CPU)
        # Shard-local sketches under the SAME hash family and global stats.
        zs, _ = probes.probe_rows(feats, targets, config)
        halves = [full._replace(sketch=sketch_lib.sketch_dataset(
            full.params, part, batch=16, paired=True, device=CPU),
            count=torch.tensor(part.shape[0], dtype=torch.int32))
            for part in (zs[:32], zs[32:])]
        merged = probes.merge_probe_states(halves)
        assert int(merged.sketch.n) == int(full.sketch.n) == 64
        assert torch.equal(merged.sketch.counts, full.sketch.counts)
        assert torch.allclose(merged.x_mean, full.x_mean)
        assert torch.allclose(merged.x_scale, full.x_scale, rtol=1e-5)

    @staticmethod
    def _shards(d=5):
        rng = np.random.default_rng(0)
        fa = (2.0 + 1.5 * rng.normal(size=(96, d))).astype(np.float32)
        fb = (-1.0 + 0.5 * rng.normal(size=(32, d))).astype(np.float32)
        ta = (fa @ np.ones(d) + rng.normal(size=96)).astype(np.float32)
        tb = (5.0 + rng.normal(size=32)).astype(np.float32)
        return (fa, ta), (fb, tb)

    def test_heterogeneous_merge_matches_jax_and_the_concatenation(self):
        (fa, ta), (fb, tb) = self._shards()
        config = probes.ProbeConfig(rows=128, batch=16)
        key = jax.random.PRNGKey(5)
        fam = _jax_family(key, config, 5)
        build = lambda f, y: probes.sketch_features(  # noqa: E731
            None, t(f), t(y), config, params=fam, device=CPU)
        sa, sb = build(fa, ta), build(fb, tb)
        full = build(np.concatenate([fa, fb]), np.concatenate([ta, tb]))
        merged = probes.merge_probe_states([sa, sb])
        jmerged = jprobes.merge_probe_states([
            jprobes.sketch_features(key, jnp.asarray(f), jnp.asarray(y),
                                    config) for f, y in ((fa, ta), (fb, tb))])
        for f in ("x_mean", "x_scale", "y_mean", "y_scale", "scale"):
            np.testing.assert_allclose(getattr(merged, f).numpy(),
                                       np.asarray(getattr(jmerged, f)),
                                       rtol=1e-5, atol=1e-6)
        assert torch.allclose(merged.x_mean, full.x_mean, atol=1e-5)
        assert torch.allclose(merged.y_mean, full.y_mean, atol=1e-5)
        assert torch.allclose(merged.x_scale, full.x_scale, rtol=1e-4)
        assert torch.allclose(merged.y_scale, full.y_scale, rtol=1e-4)
        assert torch.allclose(merged.scale, full.scale, rtol=0.3)
        assert int(merged.count) == 96 + 32 == int(merged.sketch.n)
        # Keeping the first shard's moments would be measurably wrong.
        assert not torch.allclose(merged.x_mean, sa.x_mean, atol=1e-3)
        assert not torch.allclose(merged.y_mean, sa.y_mean, atol=1e-3)
        # The pool is order-free.
        ba = probes.merge_probe_states([sb, sa])
        assert torch.allclose(ba.x_mean, merged.x_mean, atol=1e-6)
        assert torch.allclose(ba.x_scale, merged.x_scale, rtol=1e-5)
        assert torch.equal(ba.sketch.counts, merged.sketch.counts)


class TestProbeConfigWiring:
    def test_config_fields_equal_jax(self):
        import dataclasses

        assert (dataclasses.asdict(probes.ProbeConfig())
                == dataclasses.asdict(jprobes.ProbeConfig()))
        assert not hasattr(probes.ProbeConfig(), "regressor")

    def test_norm_slack_is_threaded(self):
        g = torch.Generator().manual_seed(2)
        feats = torch.randn(64, 4, generator=g)
        targets = torch.randn(64, generator=g)
        build = lambda slack: probes.sketch_features(  # noqa: E731
            torch.Generator().manual_seed(3), feats, targets,
            probes.ProbeConfig(rows=64, norm_slack=slack), device=CPU)
        tight, loose = build(1.05), build(2.1)
        assert torch.allclose(loose.scale, tight.scale * (2.1 / 1.05),
                              rtol=1e-5)
        assert not torch.equal(tight.sketch.counts, loose.sketch.counts)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal; with a card device=None runs there")
def test_probe_entry_points_need_a_card_without_device():
    g = torch.Generator().manual_seed(0)
    feats, targets = torch.randn(32, 4, generator=g), torch.randn(32,
                                                                  generator=g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.sketch_features(None, feats, targets)
    state = probes.sketch_features(g, feats, targets,
                                   probes.ProbeConfig(rows=64), device=CPU)
    for fit in (probes.fit_probe, probes.fit_probe_sharded):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit(None, state, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.fit_probe_many(None, [state], 4)
