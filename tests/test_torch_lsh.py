"""The port's hash families against ``repro.core.lsh`` on shared projections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro_torch.core import lsh
from torch_parity import jax_params, t, unit_ball_rows


@pytest.mark.parametrize("seed,n,rows,planes,dim", [
    (0, 64, 32, 4, 7), (1, 33, 50, 1, 3), (2, 20, 17, 8, 12),
])
def test_srp_codes_equal_jax(seed, n, rows, planes, dim):
    jp, tp = jax_params(seed, rows, planes, dim)
    x = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    want = np.asarray(jlsh.srp_codes(jp, jnp.asarray(x)))
    got = lsh.srp_codes(tp, t(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n,rows,planes,d", [(0, 80, 40, 4, 6),
                                                  (3, 25, 9, 2, 3)])
def test_prp_codes_equal_jax(seed, n, rows, planes, d):
    jp, tp = jax_params(seed, rows, planes, d + 2)
    z = unit_ball_rows(seed, n, d)
    for want, got in zip(jlsh.prp_codes(jp, jnp.asarray(z)),
                         lsh.prp_codes(tp, t(z))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_query_codes_equal_jax():
    jp, tp = jax_params(4, 64, 4, 9)
    q = np.random.default_rng(4).normal(size=(17, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        lsh.query_codes(tp, t(q)).numpy(),
        np.asarray(jlsh.query_codes(jp, jnp.asarray(q))))


def test_scale_to_unit_ball_matches_jax():
    z = np.random.default_rng(0).normal(size=(1001, 5)).astype(np.float32) * 3
    want, wc = jlsh.scale_to_unit_ball(jnp.asarray(z), 1.05)
    got, gc = lsh.scale_to_unit_ball(t(z), 1.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(gc), float(wc), rtol=1e-6)
    assert float(got.norm(dim=1).max()) <= 1.0 + 1e-6


def test_augmentations_match_jax():
    # Inside the ball: at |z| = 1 the pad sqrt(1 - |z|^2) amplifies the last
    # ulp of |z|^2, which depends on the summation order.
    z = 0.9 * unit_ball_rows(1, 40, 6)
    np.testing.assert_allclose(lsh.augment_data(t(z)).numpy(),
                               np.asarray(jlsh.augment_data(jnp.asarray(z))),
                               atol=1e-6)
    q = np.asarray(jlsh.normalize_query(jnp.asarray(z)))
    np.testing.assert_allclose(lsh.normalize_query(t(z)).numpy(), q,
                               atol=1e-6)
    np.testing.assert_allclose(lsh.augment_query(t(z)).numpy(),
                               np.asarray(jlsh.augment_query(jnp.asarray(z))),
                               atol=1e-6)


def test_collision_probabilities_match_jax():
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(2, 30, 4)).astype(np.float32)
    inner = rng.uniform(-1, 1, size=50).astype(np.float32)
    np.testing.assert_allclose(
        lsh.srp_collision_prob(t(x), t(y), 4).numpy(),
        np.asarray(jlsh.srp_collision_prob(jnp.asarray(x), jnp.asarray(y), 4)),
        atol=1e-6)
    np.testing.assert_allclose(
        lsh.ip_collision_prob(t(inner), 3).numpy(),
        np.asarray(jlsh.ip_collision_prob(jnp.asarray(inner), 3)), atol=1e-6)


def test_pair_codes_is_injective():
    a, b = torch.meshgrid(torch.arange(4), torch.arange(8), indexing="ij")
    codes = lsh.pair_codes(a, b, 8)
    assert codes.unique().numel() == 32


def test_init_srp_orthogonal_blocks():
    gen = torch.Generator().manual_seed(0)
    params = lsh.init_srp(gen, rows=10, planes=3, dim=4, orthogonal=True,
                          device="cpu")
    assert params.projections.shape == (10, 3, 4)
    block = params.projections[:4, 1]  # one plane index, one block of dim rows
    torch.testing.assert_close(block @ block.T, torch.eye(4), atol=1e-5,
                               rtol=0)


def test_init_srp_draws_from_the_generator():
    a = lsh.init_srp(torch.Generator().manual_seed(7), 8, 2, 5, device="cpu")
    b = lsh.init_srp(torch.Generator().manual_seed(7), 8, 2, 5, device="cpu")
    assert torch.equal(a.projections, b.projections)
    assert (a.rows, a.planes, a.dim, a.buckets) == (8, 2, 5, 4)
