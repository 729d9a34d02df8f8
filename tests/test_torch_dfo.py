"""The port's DFO against ``repro.core.dfo`` on an analytic quadratic, with the
JAX draws (sphere directions, refine samples) carried across.

Trajectories are compared with rtol 1e-4: the sums run in other orders in
the two frameworks, and 200 steps of fp32 updates accumulate the rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dfo as jdfo
from repro.core import fleet as jfleet
from repro_torch import interop
from repro_torch.core import dfo, fleet
from torch_parity import fleet_draws, t

DIM = 5
_A = np.linspace(0.5, 2.0, DIM).astype(np.float32)
_C = np.array([0.3, -0.2, 0.5, 0.1, -1.0], np.float32)


def jax_loss(th):
    return jnp.sum(jnp.asarray(_A) * (th - jnp.asarray(_C)) ** 2, axis=-1)


def torch_loss(th):
    return torch.sum(t(_A) * (th - t(_C)) ** 2, dim=-1)


CONFIG = jdfo.DFOConfig(steps=200, num_queries=6, sigma=0.3, sigma_decay=0.99,
                        learning_rate=0.05, decay=0.995, average_tail=0.25)


def _port_config(cfg):
    return dfo.DFOConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("antithetic", [True, False])
def test_minimize_fleet_matches_jax(antithetic):
    cfg = CONFIG if antithetic else jdfo.DFOConfig(
        **{**CONFIG.__dict__, "antithetic": False})
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    theta0 = np.random.default_rng(0).normal(size=(3, DIM)).astype(np.float32)
    sig = np.array([0.3, 0.2, 0.5], np.float32)
    lr = np.array([0.05, 0.08, 0.03], np.float32)
    proj = jdfo.pin_last_coordinate(-1.0)
    want = jdfo.minimize_fleet(jax_loss, jnp.asarray(theta0), keys, cfg,
                               project=proj, sigma=jnp.asarray(sig),
                               learning_rate=jnp.asarray(lr))
    dirs, _ = fleet_draws(keys, cfg.steps, cfg.num_queries, DIM)
    got = dfo.minimize_fleet(torch_loss, t(theta0), _port_config(cfg),
                             project=dfo.pin_last_coordinate(-1.0),
                             sigma=t(sig), learning_rate=t(lr),
                             directions=dirs)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-4, atol=1e-6)
    assert np.all(got.theta.numpy()[:, -1] == -1.0)


def test_quadratic_refine_fleet_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    theta = np.array([[0.1, 0.0, 0.3, 0.2, -1.0],
                      [0.5, -0.4, 0.2, 0.0, -1.0]], np.float32)
    m = dfo.refine_sample_count(DIM)
    samples = jax.vmap(lambda kk: jax.random.normal(kk, (m, DIM)))(keys)
    proj = jdfo.pin_last_coordinate(-1.0)
    want = jdfo.quadratic_refine_fleet(jax_loss, jnp.asarray(theta), keys,
                                       radius=0.5, project=proj)
    got = dfo.quadratic_refine_fleet(torch_loss, t(theta), radius=0.5,
                                     project=dfo.pin_last_coordinate(-1.0),
                                     samples=t(samples))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    # The model of an exact quadratic moves toward its minimizer.
    assert np.all(torch_loss(got).numpy() < torch_loss(t(theta)).numpy())


def test_run_fleet_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    theta0 = np.zeros((2, DIM), np.float32)
    cfg = jdfo.DFOConfig(**{**CONFIG.__dict__, "steps": 60})
    proj = jdfo.pin_last_coordinate(-1.0)
    want = jfleet.run_fleet(jax_loss, jnp.asarray(theta0), keys, cfg,
                            project=proj, refine_steps=2, refine_radius=0.4)
    dirs, refine = fleet_draws(keys, cfg.steps, cfg.num_queries, DIM,
                               refine_steps=2,
                               m=dfo.refine_sample_count(DIM))
    got = fleet.run_fleet(torch_loss, t(theta0), _port_config(cfg),
                          project=dfo.pin_last_coordinate(-1.0),
                          refine_steps=2, refine_radius=0.4,
                          directions=dirs, refine_samples=refine)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=1e-4, atol=1e-5)


def test_minimize_is_the_one_member_fleet():
    gen = torch.Generator().manual_seed(0)
    cfg = _port_config(CONFIG)
    dirs = dfo.sphere_directions(gen, cfg.steps, 1, cfg.num_queries, DIM, "cpu")
    one = dfo.minimize(torch_loss, torch.zeros(DIM), cfg, directions=dirs[:, 0])
    many = dfo.minimize_fleet(torch_loss, torch.zeros(1, DIM), cfg,
                              directions=dirs)
    assert torch.equal(one.theta, many.theta[0])
    assert torch.equal(one.losses, many.losses[0])
    assert float(torch_loss(one.theta)) < 0.05 * float(torch_loss(torch.zeros(DIM)))


def test_quadratic_refine_is_the_one_member_fleet():
    gen = torch.Generator().manual_seed(1)
    theta = torch.tensor([0.1, 0.0, 0.3, 0.2, -1.0])
    samples = torch.randn(dfo.refine_sample_count(DIM), DIM, generator=gen)
    proj = dfo.pin_last_coordinate(-1.0)
    one = dfo.quadratic_refine(torch_loss, theta, radius=0.5, project=proj,
                               samples=samples)
    many = dfo.quadratic_refine_fleet(torch_loss, theta[None], radius=0.5,
                                      project=proj, samples=samples[None])
    assert torch.equal(one, many[0])
    assert float(torch_loss(one)) < float(torch_loss(theta))


def test_draws_come_from_the_generator_or_raise():
    cfg = _port_config(CONFIG)
    run = lambda seed: dfo.minimize_fleet(
        torch_loss, torch.zeros(2, DIM), cfg,
        generator=torch.Generator().manual_seed(seed)).theta
    assert torch.equal(run(3), run(3))
    with pytest.raises(ValueError):
        dfo.minimize_fleet(torch_loss, torch.zeros(2, DIM), cfg)
    with pytest.raises(ValueError):
        dfo.minimize_fleet(torch_loss, torch.zeros(2, DIM), cfg,
                           directions=torch.zeros(3, 2, 6, DIM))
    with pytest.raises(ValueError):
        dfo.minimize_fleet(torch_loss, torch.zeros(2, DIM), cfg,
                           sigma=torch.ones(3))


def test_interop_directions_shape():
    with pytest.raises(ValueError):
        interop.directions(np.zeros((3, 4, 5)), device="cpu")
    assert interop.refine_samples(np.zeros((1, 2, 3, 4)),
                                  device="cpu").shape == (1, 2, 3, 4)


def test_seed_fleet_ladders_match_jax():
    cfg = jdfo.DFOConfig(sigma=0.5, learning_rate=2.0)
    _, jtheta0, jsig, jlr = jfleet.seed_fleet(jax.random.PRNGKey(0), 4, DIM,
                                              cfg)
    inits = (np.asarray(jtheta0[1:]) / 0.3).astype(np.float32)
    theta0, sig, lr = fleet.seed_fleet(4, DIM, _port_config(cfg),
                                       inits=t(inits), device="cpu")
    np.testing.assert_array_equal(sig.numpy(), np.asarray(jsig))
    np.testing.assert_array_equal(lr.numpy(), np.asarray(jlr))
    np.testing.assert_allclose(theta0.numpy(), np.asarray(jtheta0), atol=1e-7)


def test_tenant_key_keeps_tenant_zero():
    gen = torch.Generator().manual_seed(11)
    assert fleet.tenant_key(gen, 0) is gen
    a, b = fleet.tenant_key(gen, 2), fleet.tenant_key(gen, 2)
    assert torch.equal(torch.randn(3, generator=a), torch.randn(3, generator=b))
    assert fleet.tenant_key(gen, 1).initial_seed() != a.initial_seed()
