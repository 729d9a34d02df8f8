"""The port's end-to-end regression against ``repro.core.regression``.

The paper's edge story on the port: stream -> sketch -> drop the data ->
merge -> train from counters only, with the JAX test's bars; and the port's
``regression.fit`` against the JAX fit on the same data, hash family and DFO
draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import dfo as jdfo
from repro.core import fleet as jfleet
from repro.core import losses as jlosses
from repro.core import lsh as jlsh
from repro.core import regression as jregression
from repro.data import datasets as jdatasets
from repro_torch import interop
from repro_torch.core import (baselines, dfo, distributed, erm, fleet, losses,
                              lsh, regression)
from repro_torch.core import sketch as sketch_lib
from repro_torch.data import datasets
from repro_torch.device import generator
from torch_parity import CPU, fleet_draws, t


def _cos(a, b):
    return float(torch.dot(a, b) / (a.norm() * b.norm() + 1e-12))


def _port_dfo(cfg):
    return dfo.DFOConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


class TestEdgeToModelPipeline:
    def test_train_from_counters_only(self):
        """Sketch the stream, delete the data, train, beat the mean-predictor."""
        kd, _ = jax.random.split(jax.random.PRNGKey(0))
        jx, jy, _ = jdatasets.make_regression(kd, 1500, 6, noise=0.2,
                                              condition=8)
        x, y = t(jx), t(jy)
        cfg = regression.StormRegressorConfig(
            rows=2048,
            dfo=dfo.DFOConfig(steps=250, num_queries=8, sigma=0.5,
                              sigma_decay=0.995, learning_rate=2.0,
                              decay=0.995, average_tail=0.5),
        )
        xs = (x - x.mean(0)) / (x.std(0, correction=0) + 1e-8)
        ys = (y - y.mean()) / (y.std(correction=0) + 1e-8)
        z = torch.cat([xs, ys[:, None]], dim=-1)
        zs, _ = lsh.scale_to_unit_ball(z, cfg.norm_slack)
        jparams = jlsh.init_srp(jax.random.PRNGKey(42), cfg.rows, cfg.planes,
                                z.shape[1] + 2)
        params = interop.lsh_params(np.asarray(jparams.projections), CPU)
        merged = distributed.tree_merge(
            [sketch_lib.sketch_dataset(params, s, batch=256, device=CPU)
             for s in torch.tensor_split(zs, 3)])
        assert int(merged.n) == x.shape[0]

        fit = regression.fit(generator(0, CPU), x, y, cfg,
                             prebuilt=(merged, params, None), device=CPU)
        mse = float(fit.mse(x, y))
        assert mse < 0.6 * float(y.var(correction=0)), mse
        assert _cos(fit.theta, baselines.ols(x, y).theta) > 0.5


def test_fit_matches_jax_on_shared_draws():
    key = jax.random.PRNGKey(3)
    jx, jy, _ = jdatasets.make_regression(jax.random.PRNGKey(1), 1200, 5,
                                          noise=0.3, condition=10)
    cfg = jregression.StormRegressorConfig(
        rows=1024, dfo=jdfo.DFOConfig(steps=150, num_queries=8, sigma=0.5,
                                      sigma_decay=0.995, learning_rate=2.0,
                                      decay=0.995, average_tail=0.5))
    want = jregression.fit(key, jx, jy, cfg)

    k_hash, k_dfo = jax.random.split(key)
    params = interop.lsh_params(
        np.asarray(jlsh.init_srp(k_hash, cfg.rows, cfg.planes, 5 + 3)
                   .projections), CPU)
    dim = 5 + 1
    dirs, refine = fleet_draws(k_dfo[None], cfg.dfo.steps,
                               cfg.dfo.num_queries, dim,
                               refine_steps=cfg.refine_steps,
                               m=dfo.refine_sample_count(dim))
    pcfg = regression.StormRegressorConfig(rows=cfg.rows,
                                           dfo=_port_dfo(cfg.dfo))
    x, y = t(jx), t(jy)
    got = regression.fit(None, x, y, pcfg, params=params, directions=dirs,
                         refine_samples=refine, device=CPU)

    # Same data, hash and draws. Standardization and unit-ball scaling round
    # differently in the two frameworks, so a few projections near zero flip
    # sign: row masses stay exact and under 1e-4 of the increments move.
    counts = got.sketch.counts.numpy()
    np.testing.assert_array_equal(counts.sum(1), np.full(cfg.rows, 2 * 1200))
    moved = np.abs(counts - np.asarray(want.sketch.counts)).sum() // 2
    assert moved <= 1e-4 * counts.sum(), moved
    # The DFO trajectories then drift apart only by fp32 rounding.
    np.testing.assert_allclose(got.fleet_losses.numpy(),
                               np.asarray(want.fleet_losses), rtol=1e-3)
    jmse = float(want.mse(jx, jy))
    assert abs(float(got.mse(x, y)) - jmse) <= 0.02 * jmse
    assert _cos(got.theta, t(want.theta)) > 0.99


def test_fit_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    x, y, _ = datasets.make_regression(generator(0, CPU), 50, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        regression.fit(None, x, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        generator(0)
    params = lsh.init_srp(generator(0, CPU), 16, 2, 6, device=CPU)
    z, _ = lsh.scale_to_unit_ball(torch.cat([x, y[:, None]], dim=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        sketch_lib.sketch_dataset(params, z)
    sk = sketch_lib.sketch_dataset(params, z, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        erm.fit("prp_regression", sk, params, dfo.DFOConfig(steps=2))
    assert erm.fit("prp_regression", sk, params, dfo.DFOConfig(steps=2),
                   generator=generator(0, CPU), device=CPU).theta.shape == (4,)


def test_fit_runs_a_restart_fleet_on_its_own_draws():
    x, y, _ = datasets.make_regression(generator(0, CPU), 800, 4, noise=0.2)
    cfg = regression.StormRegressorConfig(
        rows=512, restarts=3, restart_select="average",
        dfo=dfo.DFOConfig(steps=100, num_queries=8, sigma=0.5,
                          learning_rate=2.0, decay=0.995))
    a = regression.fit(generator(5, CPU), x, y, cfg, device=CPU)
    b = regression.fit(generator(5, CPU), x, y, cfg, device=CPU)
    assert torch.equal(a.theta, b.theta)
    assert a.fleet_losses.shape == (3,)
    assert float(a.mse(x, y)) < float(y.var())
    with pytest.raises(ValueError):
        regression.fit(None, x, y, regression.StormRegressorConfig(
            restart_select="median"), device=CPU)


def test_ols_matches_jax():
    jx, jy, _ = jdatasets.make_regression(jax.random.PRNGKey(2), 300, 4)
    want = jbaselines.ols(jx, jy)
    got = baselines.ols(t(jx), t(jy))
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.intercept), float(want.intercept),
                               atol=1e-5)
    assert got.memory_bytes == want.memory_bytes


def test_make_regression_is_seeded_and_conditioned():
    spec = datasets.UCI_MATCHED[0]
    x, y, theta = datasets.make_uci_matched(generator(0, CPU), spec)
    x2, _, _ = datasets.make_uci_matched(generator(0, CPU), spec)
    assert x.shape == (spec.n, spec.d) and y.shape == (spec.n,)
    assert torch.equal(x, x2)
    eig = torch.linalg.eigvalsh(torch.cov(x.T))
    assert 10 < float(eig[-1] / eig[0]) < 100  # condition 30, sampled
    resid = y - x @ theta
    assert abs(float(resid.std()) - spec.noise) < 0.05


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(100, 3)).astype(np.float32) * 0.3
    y = rng.normal(size=100).astype(np.float32) * 0.3
    th = np.array([0.2, -0.1, 0.4], np.float32)
    np.testing.assert_allclose(
        float(losses.prp_empirical_risk(t(th), t(x), t(y), 4)),
        float(jlosses.prp_empirical_risk(jnp.asarray(th), jnp.asarray(x),
                                         jnp.asarray(y), 4)), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.l2_empirical_risk(t(th), t(x), t(y))),
        float(jlosses.l2_empirical_risk(jnp.asarray(th), jnp.asarray(x),
                                        jnp.asarray(y))), rtol=1e-6)
    z = np.concatenate([x, y[:, None]], 1)
    tt = np.append(th, -1.0).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.PRP_REGRESSION.objective(t(tt), t(z), 4)),
        float(jlosses.PRP_REGRESSION.objective(jnp.asarray(tt),
                                               jnp.asarray(z), 4)), rtol=1e-6)
    assert erm.resolve("prp_regression") is losses.PRP_REGRESSION
    with pytest.raises(ValueError):
        losses.register(
            losses.Surrogate(**{**losses.PRP_REGRESSION.__dict__, "pad": 2}))
    with pytest.raises(ValueError):
        losses.get_surrogate("hinge")


@pytest.mark.parametrize("select", ["best", "average"])
def test_select_theta_matches_jax(select):
    thetas = np.array([[0.3, -1.0], [0.1, -1.0], [0.12, -1.0]], np.float32)
    traces = np.arange(9, dtype=np.float32).reshape(3, 3)
    guard = np.array([0.0, -1.0], np.float32)
    jl = lambda th: jnp.sum((th - jnp.array([0.11, -1.0])) ** 2, -1)
    tl = lambda th: torch.sum((th - torch.tensor([0.11, -1.0])) ** 2, -1)
    want = jfleet.select_theta(jl, jnp.asarray(thetas), jnp.asarray(traces),
                               select=select, basin_tol=0.5,
                               guard=jnp.asarray(guard))
    got = fleet.select_theta(tl, t(thetas), t(traces), select=select,
                             basin_tol=0.5, guard=t(guard))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_sketch_memory_bytes_matches_jax():
    for dt in ("int32", "int16", "int8"):
        assert regression.sketch_memory_bytes(
            regression.StormRegressorConfig(count_dtype=dt)
        ) == jregression.sketch_memory_bytes(
            jregression.StormRegressorConfig(count_dtype=dt))
