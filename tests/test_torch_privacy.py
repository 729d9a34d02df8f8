"""The port's privacy layer (``repro_torch.core.privacy``) against
``repro.core.privacy``, case by case as ``tests/test_privacy.py`` pins it.

The JAX package draws the mechanism noise with ``jax.random``, which torch
cannot reproduce: those draws cross as arrays (``interop.noise``) and the
releases and codes then agree bit for bit. The release-window noise of
``PrivateBankView`` is numpy on the host in both packages, so the port's
windows equal JAX's bit for bit from the seed alone. Each test also runs
the port on its own draws (a ``torch.Generator``) where the reference test
checks a statistical property.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lsh as jlsh
from repro.core import privacy as jprivacy
from repro.core import sketch as jsketch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import lsh, privacy, sketch
from repro_torch.core.privacy import (
    BudgetState, EpsilonLedger, PrivateBankView, ReleasePolicy,
)
from repro_torch.device import generator
from torch_parity import CPU, t

_JDTYPE = {torch.int16: jnp.int16, torch.int8: jnp.int8,
           torch.int32: jnp.int32}


def _built_sketch(seed=0, n=400, rows=64, dtype=torch.int32):
    """A JAX-built paired sketch and its hash family, on both sides."""
    jp = jlsh.init_srp(jax.random.PRNGKey(seed), rows, 4, 5 + 2)
    z = 0.5 * jax.random.normal(jax.random.PRNGKey(seed + 1), (n, 5))
    zs, _ = jlsh.scale_to_unit_ball(z)
    jsk = jsketch.sketch_dataset(jp, zs, batch=100, paired=True,
                                 engine="scan", dtype=_JDTYPE[dtype])
    tp = interop.lsh_params(np.asarray(jp.projections), CPU)
    sk = interop.sketch(np.asarray(jsk.counts), int(jsk.n), CPU)
    return (jp, jsk), (tp, sk)


def _gen(seed):
    return generator(seed, CPU)


def _same_plan(plan, jplan):
    """The port's plan and the reference's (carried across) are one
    verdict: status, release-time count, spend and the noise's bits."""
    jplan = interop.read_plan(jplan)
    return (plan.status, plan.n, plan.spent) == (
        jplan.status, jplan.n, jplan.spent) and (
        plan.noise is None and jplan.noise is None
        or np.array_equal(plan.noise, jplan.noise))


class TestLaplaceCounts:
    def test_high_epsilon_close_to_exact(self):
        _, (_, sk) = _built_sketch()
        ps = privacy.privatize_counts(_gen(2), sk, epsilon=1e5)
        np.testing.assert_allclose(ps.counts.numpy(), sk.counts.numpy(),
                                   atol=0.5)

    def test_jax_noise_gives_the_jax_release(self):
        (_, jsk), (_, sk) = _built_sketch()
        key = jax.random.PRNGKey(2)
        want = jprivacy.privatize_counts(key, jsk, epsilon=3.0)
        noise = jprivacy.count_noise(key, jsk.counts.shape, 3.0, jsk.rows)
        got = privacy.privatize_counts(None, sk, 3.0,
                                       noise=interop.noise(noise, CPU))
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
        assert int(got.n) == int(want.n)

    def test_noise_scales_with_epsilon(self):
        _, (_, sk) = _built_sketch()
        loose = privacy.privatize_counts(_gen(3), sk, epsilon=10.0)
        tight = privacy.privatize_counts(_gen(3), sk, epsilon=0.1)
        err_loose = float((loose.counts - sk.counts).abs().mean())
        err_tight = float((tight.counts - sk.counts).abs().mean())
        assert err_tight > err_loose * 10

    @pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
    def test_noise_has_the_policy_scale(self, mechanism):
        # The port's own draws: mean 0 and the spread the scale says
        # (Laplace: mean |x| = b; Gaussian: std = sigma), 2^18 cells.
        pol = ReleasePolicy(epsilon_release=2.0, mechanism=mechanism)
        draw = pol.sample_noise(_gen(4), (512, 512), device=CPU).double()
        scale = pol.noise_scale(512)
        assert abs(float(draw.mean())) < 0.01 * scale
        spread = (float(draw.abs().mean()) if mechanism == "laplace"
                  else float(draw.std()))
        assert spread == pytest.approx(scale, rel=0.01)
        assert torch.isfinite(draw).all()

    def test_private_query_unbiased(self):
        """Laplace noise is zero-mean: private queries track exact ones."""
        _, (tp, sk) = _built_sketch(rows=512)
        q = torch.randn(4, 5, generator=_gen(5))
        codes = lsh.query_codes(tp, q)
        exact = sketch.query(sk, codes, paired=True)
        ests = [privacy.query_private(
            privacy.privatize_counts(_gen(100 + s), sk, epsilon=5.0), codes,
            paired=True) for s in range(20)]
        mean_est = torch.stack(ests).mean(0)
        np.testing.assert_allclose(mean_est.numpy(), exact.numpy(), atol=0.02)

    def test_query_private_over_the_jax_release(self):
        """The port's estimate over JAX's release: JAX sums the gathered
        row in f32 and the port in float64, so they differ by the f32
        sum's rounding only, |d| <= R * 2^-23 * mean|x| / (2n)."""
        (jp, jsk), (tp, sk) = _built_sketch()
        key = jax.random.PRNGKey(6)
        jps = jprivacy.privatize_counts(key, jsk, epsilon=0.5)
        ps = interop.private_sketch(np.asarray(jps.counts), int(jps.n), CPU)
        q = jax.random.normal(jax.random.PRNGKey(7), (16, 5))
        codes = jlsh.query_codes(jp, q)
        want = np.asarray(jprivacy.query_private(jps, codes), np.float64)
        got = privacy.query_private(ps, t(codes, torch.int32)).numpy()
        assert torch.equal(t(codes, torch.int32),
                           lsh.query_codes(tp, t(q)))
        mean_abs = np.abs(np.asarray(jps.counts))[
            np.arange(jsk.rows)[None, :], np.asarray(codes)].mean(-1)
        bound = jsk.rows * 2.0 ** -23 * mean_abs / (2.0 * int(jsk.n))
        assert np.all(np.abs(got - want) <= bound)


class TestNarrowDtypeRelease:
    """The release is f32(counts) + noise, never f32(counts +
    noise_cast_narrow): on int16/int8 banks the wrong order truncates the
    noise onto the integer grid and saturates at the dtype bound."""

    @pytest.mark.parametrize("dtype", [torch.int16, torch.int8])
    def test_widen_before_noise(self, dtype):
        (_, jsk), (_, sk) = _built_sketch(rows=32, n=60, dtype=dtype)
        assert sk.counts.dtype == dtype
        key = jax.random.PRNGKey(2)
        want = jprivacy.privatize_counts(key, jsk, epsilon=1.0)
        noise = jprivacy.count_noise(key, jsk.counts.shape, 1.0, jsk.rows,
                                     paired=True)
        ps = privacy.privatize_counts(None, sk, 1.0,
                                      noise=interop.noise(noise, CPU))
        assert ps.counts.dtype == torch.float32
        np.testing.assert_array_equal(ps.counts.numpy(),
                                      np.asarray(want.counts))
        for rel in (ps, privacy.privatize_counts(_gen(2), sk, 1.0)):
            counts = rel.counts.numpy()
            frac = counts - np.round(counts)
            assert np.mean(np.abs(frac) > 1e-3) > 0.9
            # Unclipped: the Laplace scale 64 is far beyond int8's range.
            assert (np.abs(counts).max() > torch.iinfo(dtype).max
                    or dtype != torch.int8)

    def test_view_release_matches_int16(self):
        (_, jsk), (_, sk) = _built_sketch(seed=3, rows=32, n=40,
                                          dtype=torch.int16)
        view = PrivateBankView(ReleasePolicy(epsilon_total=10.0), seed=5)
        plan, ps = view.read(7, sk)
        assert plan.status == "fresh" and plan.spent
        np.testing.assert_array_equal(
            ps.counts.numpy(), sk.counts.numpy().astype(np.float32)
            + plan.noise)
        jview = jprivacy.PrivateBankView(
            jprivacy.ReleasePolicy(epsilon_total=10.0), seed=5)
        jplan, jps = jview.read(7, jsk)
        assert _same_plan(plan, jplan)
        np.testing.assert_array_equal(ps.counts.numpy(),
                                      np.asarray(jps.counts))


class TestGaussianProjections:
    def test_sigma_zero_matches_plain(self):
        (jp, _), (tp, _) = _built_sketch()
        x = 0.4 * torch.randn(10, 7, generator=_gen(6))
        noisy = privacy.private_srp_codes(_gen(7), tp, x, 0.0)
        assert torch.equal(noisy, lsh.srp_codes(tp, x))
        np.testing.assert_array_equal(
            noisy.numpy(), np.asarray(jlsh.srp_codes(jp, jnp.asarray(
                x.numpy()))))

    def test_jax_draws_give_the_jax_codes(self):
        (jp, _), (tp, _) = _built_sketch()
        key = jax.random.PRNGKey(9)
        x = 0.4 * jax.random.normal(jax.random.PRNGKey(8), (50, 7))
        want = jprivacy.private_srp_codes(key, jp, x, 0.7)
        draw = jax.random.normal(key, (50, jp.rows * jp.planes))
        got = privacy.private_srp_codes(None, tp, t(x), 0.7,
                                        noise=interop.noise(draw, CPU))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_large_sigma_decorrelates(self):
        _, (tp, _) = _built_sketch()
        x = 0.4 * torch.randn(50, 7, generator=_gen(8))
        noisy = privacy.private_srp_codes(_gen(9), tp, x, 100.0)
        agree = float((noisy == lsh.srp_codes(tp, x)).float().mean())
        assert agree < 0.35  # ~1/16 for p = 4 plus chance alignment

    def test_sigma_formula_monotone(self):
        s1 = privacy.gaussian_sigma(1.0, 1e-5)
        s2 = privacy.gaussian_sigma(2.0, 1e-5)
        assert s1 > s2 > 0
        assert s1 == jprivacy.gaussian_sigma(1.0, 1e-5)

    def test_sigma_is_static_python_float(self):
        s = privacy.gaussian_sigma(1.0, 1e-5)
        assert type(s) is float
        width = int(privacy.gaussian_sigma(0.5, 1e-6, sensitivity=8.0))
        assert torch.zeros((width,)).shape[0] >= 1

    def test_private_insert_counts_mass(self):
        _, (tp, _) = _built_sketch()
        sk = sketch.init_sketch(64, 16, device=CPU)
        z = 0.3 * torch.randn(20, 5, generator=_gen(10))
        sk = privacy.private_prp_insert(_gen(11), sk, tp, z, 0.5)
        assert int(sk.counts.sum()) == 20 * 64 * 2
        assert int(sk.n) == 20

    def test_private_insert_with_jax_draws_equals_jax(self):
        (jp, _), (tp, _) = _built_sketch()
        key = jax.random.PRNGKey(11)
        z = 0.3 * jax.random.normal(jax.random.PRNGKey(10), (20, 5))
        want = jprivacy.private_prp_insert(key, jsketch.init_sketch(64, 16),
                                           jp, z, 0.5)
        k_s, k_t = jax.random.split(key)
        shape = (20, jp.rows * jp.planes)
        got = privacy.private_prp_insert(
            None, sketch.init_sketch(64, 16, device=CPU), tp, t(z), 0.5,
            e_s=interop.noise(jax.random.normal(k_s, shape), CPU),
            e_t=interop.noise(jax.random.normal(k_t, shape), CPU))
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
        assert int(got.n) == int(want.n)


class TestPairedPrivateCodes:
    """ONE shared-pass, full-rank Gaussian release of the per-plane (s, t)
    pair, both antithetic code sets derived from it."""

    @staticmethod
    def _jax_draws(key, z, jp):
        k_s, k_t = jax.random.split(key)
        shape = (z.shape[0], jp.rows * jp.planes)
        return (interop.noise(jax.random.normal(k_s, shape), CPU),
                interop.noise(jax.random.normal(k_t, shape), CPU))

    def test_jax_draws_give_the_jax_release(self):
        (jp, _), (tp, _) = _built_sketch()
        key = jax.random.PRNGKey(21)
        z = 0.4 * jax.random.normal(jax.random.PRNGKey(20), (30, 5))
        want = jprivacy.private_prp_codes(key, jp, z, 0.7)
        e_s, e_t = self._jax_draws(key, z, jp)
        got = privacy.private_prp_codes(None, tp, t(z), 0.7, e_s=e_s, e_t=e_t)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        # t~ = pad * w + 0.7 e_t: the pad's sum of squares rounds in XLA's
        # order and in torch's, a few ulps apart; the codes do not move.
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-6)

    def test_paired_relation_under_noise(self):
        """pos from s~ + t~ > 0, neg from t~ - s~ > 0: v_pos + v_neg = 2t~."""
        _, (tp, _) = _built_sketch()
        z = 0.4 * torch.randn(30, 5, generator=_gen(20))
        e_s = torch.randn(30, tp.rows * tp.planes, generator=_gen(21))
        e_t = torch.randn(30, tp.rows * tp.planes, generator=_gen(22))
        cpos, cneg, noisy_t = privacy.private_prp_codes(None, tp, z, 0.7,
                                                        e_s=e_s, e_t=e_t)
        r, p, d_aug = tp.projections.shape
        w = tp.projections.reshape(r * p, d_aug)
        pad = torch.sqrt(torch.clamp(1.0 - (z * z).sum(-1, keepdim=True),
                                     min=0.0))
        noisy_s = z @ w[:, :5].T + 0.7 * e_s
        assert torch.equal(noisy_t, pad * w[:, 6] + 0.7 * e_t)
        weights = 2 ** torch.arange(p, dtype=torch.int32)

        def pack(bits):
            return (bits.reshape(30, r, p).to(torch.int32) * weights).sum(
                -1, dtype=torch.int32)

        assert torch.equal(cpos, pack(noisy_s + noisy_t > 0))
        assert torch.equal(cneg, pack(noisy_t - noisy_s > 0))

    def test_rejects_independent_draws(self):
        """Two independent draws on two full projections must NOT
        reproduce the shared-release codes."""
        _, (tp, _) = _built_sketch()
        z = 0.4 * torch.randn(50, 5, generator=_gen(22))
        _, cneg, _ = privacy.private_prp_codes(_gen(23), tp, z, 0.7)
        buggy_neg = privacy.private_srp_codes(_gen(24), tp,
                                              lsh.augment_data(-z), 0.7)
        assert not torch.equal(cneg, buggy_neg)

    def test_boundary_points_not_distinguishable(self):
        """pad = 0 points stay noisy: complementary code sets only where
        |t~| is small by chance (one reused scalar draw gives 1.0)."""
        _, (tp, _) = _built_sketch()
        z = torch.randn(40, 5, generator=_gen(26))
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        cpos, cneg, _ = privacy.private_prp_codes(_gen(27), tp, z, 0.5)
        complementary = float((cpos + cneg == (1 << tp.planes) - 1).float()
                              .mean())
        assert complementary < 0.9

    def test_sigma_zero_matches_clean_prp(self):
        (jp, _), (tp, _) = _built_sketch()
        z = 0.4 * jax.random.normal(jax.random.PRNGKey(24), (40, 5))
        cpos, cneg, _ = privacy.private_prp_codes(_gen(25), tp, t(z), 0.0)
        want_pos, want_neg = lsh.prp_codes(tp, t(z))
        assert torch.equal(cpos, want_pos) and torch.equal(cneg, want_neg)
        jpos, jneg = jlsh.prp_codes(jp, z)
        np.testing.assert_array_equal(cpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(cneg.numpy(), np.asarray(jneg))

    def test_wrong_dim_rejected(self):
        _, (tp, _) = _built_sketch()
        with pytest.raises(ValueError, match="dim"):
            privacy.private_prp_codes(_gen(0), tp, torch.zeros((3, 7)), 0.1)


class TestQueryDenominatorCrossCheck:
    """At the eps -> inf clean limit query_private, sketch.query and the
    kernels' plain gather agree bit for bit, and with JAX's."""

    @pytest.mark.parametrize("paired", [True, False])
    def test_bit_level_agreement_clean_limit(self, paired):
        (jp, jsk), (tp, sk) = _built_sketch()
        ps = privacy.privatize_counts(_gen(30), sk, epsilon=math.inf,
                                      paired=paired)
        np.testing.assert_array_equal(ps.counts.numpy(),
                                      sk.counts.numpy().astype(np.float32))
        q = jax.random.normal(jax.random.PRNGKey(31), (8, 5))
        codes = lsh.query_codes(tp, t(q))
        private = privacy.query_private(ps, codes, paired=paired)
        assert torch.equal(private, sketch.query(sk, codes, paired=paired))
        want = jsketch.query(jsk, jlsh.query_codes(jp, q), paired=paired)
        np.testing.assert_array_equal(private.numpy(), np.asarray(want))

    def test_bit_level_agreement_with_ref_gather(self):
        from repro_torch.kernels import ops, ref

        (jp, jsk), (tp, sk) = _built_sketch()
        ps = privacy.privatize_counts(_gen(32), sk, epsilon=math.inf)
        q = jax.random.normal(jax.random.PRNGKey(33), (8, 5))
        q_aug = lsh.augment_query(lsh.normalize_query(t(q)))
        w = ops.from_lsh_params(tp)
        codes = ref.srp_hash(q_aug, w)
        want = ref.sketch_query(q_aug, w, sk.counts) / sketch.denominator(
            sk.n, True)
        got = privacy.query_private(ps, codes, paired=True)
        assert torch.equal(got, want)
        # The f32 table through the same plain gather: the same bits.
        assert torch.equal(ref.sketch_query(q_aug, w, ps.counts),
                           ref.sketch_query(q_aug, w, sk.counts))
        jq = jlsh.augment_query(jlsh.normalize_query(q))
        jwant = jref.sketch_query(jq, jops.from_lsh_params(jp), jsk.counts) \
            / (jnp.maximum(jsk.n.astype(jnp.float32), 1.0) * 2.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


class TestReleasePolicy:
    def test_noise_scale_monotone_and_equal_to_jax(self):
        for mech in ("laplace", "gaussian"):
            scales = [ReleasePolicy(epsilon_release=e, mechanism=mech)
                      .noise_scale(64) for e in (0.1, 0.5, 1.0, 4.0, 32.0)]
            assert all(a > b > 0 for a, b in zip(scales, scales[1:]))
            assert scales == [
                jprivacy.ReleasePolicy(epsilon_release=e, mechanism=mech)
                .noise_scale(64) for e in (0.1, 0.5, 1.0, 4.0, 32.0)]

    def test_noise_scale_is_host_float(self):
        assert type(ReleasePolicy().noise_scale(64)) is float

    def test_sensitivity_paired_vs_single(self):
        pol = ReleasePolicy(epsilon_release=1.0)
        assert pol.noise_scale(64, paired=True) == \
            pytest.approx(2 * pol.noise_scale(64, paired=False))

    def test_unlimited_is_noiseless_identity(self):
        pol = ReleasePolicy.unlimited()
        assert pol.noiseless and pol.noise_scale(64) == 0.0
        assert not pol.sample_noise(_gen(0), (4, 8)).any()

    def test_validation(self):
        with pytest.raises(ValueError, match="mechanism"):
            ReleasePolicy(mechanism="exponential")
        with pytest.raises(ValueError, match="on_exhaust"):
            ReleasePolicy(on_exhaust="retry")
        with pytest.raises(ValueError, match="positive"):
            ReleasePolicy(epsilon_release=0.0)
        with pytest.raises(ValueError, match="positive"):
            ReleasePolicy(epsilon_total=-1.0)
        with pytest.raises(ValueError, match="noiseless"):
            ReleasePolicy(epsilon_total=4.0, epsilon_release=math.inf)
        with pytest.raises(ValueError, match="delta"):
            ReleasePolicy(mechanism="gaussian", delta=0.0)


class TestEpsilonLedger:
    def test_spend_sequence_exact_vs_closed_form(self):
        eps, k = 0.1, 1000  # 0.1 + 0.1 + ... drifts under naive addition
        led = EpsilonLedger(ReleasePolicy(epsilon_total=1e9,
                                          epsilon_release=eps))
        jled = jprivacy.EpsilonLedger(jprivacy.ReleasePolicy(
            epsilon_total=1e9, epsilon_release=eps))
        for _ in range(k):
            assert led.charge(3) is BudgetState.OK
            jled.charge(3)
        assert led.spent(3) == math.fsum([eps] * k) == jled.spent(3)
        assert len(led.spend_log(3)) == k

    def test_spent_monotone_nondecreasing(self):
        led = EpsilonLedger(ReleasePolicy(epsilon_total=5.0,
                                          epsilon_release=1.0))
        prev = 0.0
        for _ in range(8):
            led.charge(0)
            assert led.spent(0) >= prev
            prev = led.spent(0)
        assert led.spent(0) == 5.0

    def test_exactly_zero_remaining_refuses(self):
        led = EpsilonLedger(ReleasePolicy(epsilon_total=3.0,
                                          epsilon_release=1.0))
        for _ in range(3):
            assert led.charge(1) is BudgetState.OK
        assert led.remaining(1) == 0.0
        assert led.state(1) is BudgetState.EXHAUSTED
        assert led.charge(1) is BudgetState.EXHAUSTED
        assert led.spent(1) == 3.0

    def test_partial_remainder_refuses_full_cost_releases(self):
        led = EpsilonLedger(ReleasePolicy(epsilon_total=2.5,
                                          epsilon_release=1.0))
        assert [led.charge(0) for _ in range(3)] == \
            [BudgetState.OK, BudgetState.OK, BudgetState.EXHAUSTED]
        assert led.remaining(0) == 0.5

    def test_tenants_isolated(self):
        led = EpsilonLedger(ReleasePolicy(epsilon_total=1.0,
                                          epsilon_release=1.0))
        assert led.charge(0) is BudgetState.OK
        assert led.charge(0) is BudgetState.EXHAUSTED
        assert led.charge(1) is BudgetState.OK
        assert led.keys() == [0, 1]

    def test_noiseless_never_exhausts(self):
        led = EpsilonLedger(ReleasePolicy.unlimited())
        for _ in range(10):
            assert led.charge(0) is BudgetState.OK
        assert led.spent(0) == 0.0


class TestPrivateBankView:
    def _pair(self, dtype=torch.int32):
        (_, jsk), (_, sk) = _built_sketch(rows=32, n=50, dtype=dtype)
        return jsk, sk

    @staticmethod
    def _views(seed, **pol):
        return (PrivateBankView(ReleasePolicy(**pol), seed=seed),
                jprivacy.PrivateBankView(jprivacy.ReleasePolicy(**pol),
                                         seed=seed))

    def test_open_window_reread_is_free_and_bit_identical(self):
        jsk, sk = self._pair()
        view, jview = self._views(1, epsilon_total=10.0)
        plan1, ps1 = view.read(0, sk)
        plan2, ps2 = view.read(0, sk)
        assert plan1.spent and not plan2.spent
        assert view.releases == 1 and view.ledger.spent(0) == 1.0
        assert torch.equal(ps1.counts, ps2.counts)
        np.testing.assert_array_equal(plan1.noise, plan2.noise)
        jplan1, _ = jview.read(0, jsk)
        np.testing.assert_array_equal(plan1.noise, jplan1.noise)

    def test_version_advance_closes_the_window(self):
        jsk, sk = self._pair()
        view, jview = self._views(2, epsilon_total=10.0)
        plans = [view.read(0, sk, version=v)[0] for v in (50, 61)]
        jplans = [jview.read(0, jsk, version=v)[0] for v in (50, 61)]
        assert all(p.spent for p in plans) and view.releases == 2
        assert not np.array_equal(plans[0].noise, plans[1].noise)
        assert all(_same_plan(p, jp) for p, jp in zip(plans, jplans))

    def test_exhausted_refuses_by_default(self):
        _, sk = self._pair()
        view, _ = self._views(3, epsilon_total=1.0)
        assert view.read(0, sk, version=1)[0].status == "fresh"
        plan, ps = view.read(0, sk, version=2)
        assert plan.status == "refuse" and ps is None and not plan.spent

    def test_exhausted_stale_needs_a_resident_lane(self):
        _, sk = self._pair()
        view, _ = self._views(4, epsilon_total=1.0, on_exhaust="stale")
        view.read(0, sk, version=5)
        assert view.read(0, sk, version=9)[0].status == "refuse"
        view.mark_resident(0)
        plan, ps = view.read(0, sk, version=9)
        assert plan.status == "stale" and ps is None and plan.n == 5
        view.drop_resident(0)
        assert view.read(0, sk, version=9)[0].status == "refuse"

    def test_window_survives_lane_drop(self):
        _, sk = self._pair()
        view, _ = self._views(5, epsilon_total=1.0)
        plan1, ps1 = view.read(0, sk, version=7)
        view.mark_resident(0)
        view.drop_resident(0)
        plan2, ps2 = view.read(0, sk, version=7)
        assert plan1.spent and not plan2.spent
        assert torch.equal(ps1.counts, ps2.counts)

    @pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
    def test_windows_equal_jax_bit_for_bit(self, mechanism):
        """The same seed gives JAX's release sequence: plans, noise,
        spends, across tenants, re-reads, versions and exhaustion."""
        jsk, sk = self._pair(torch.int16)
        view, jview = self._views(6, epsilon_total=3.0,
                                  mechanism=mechanism, on_exhaust="stale")
        script = [(0, 3), (1, 3), (0, 3), (0, 4), (2, 1), (0, 9), (0, 11),
                  (1, 5), (1, 6), (1, 7), (1, 8)]
        for k, (tenant, version) in enumerate(script):
            plan, ps = view.read(tenant, sk, version=version)
            jplan, jps = jview.read(tenant, jsk, version=version)
            assert _same_plan(plan, jplan), k
            assert (ps is None) == (jps is None)
            if ps is not None:
                np.testing.assert_array_equal(ps.counts.numpy(),
                                              np.asarray(jps.counts))
            if k == 2:
                view.mark_resident(0)
                jview.mark_resident(0)
        assert view.summary() == jview.summary()

    def test_deterministic_across_rebuilds(self):
        _, sk = self._pair()
        a, _ = self._views(6, epsilon_total=10.0)
        b, _ = self._views(6, epsilon_total=10.0)
        np.testing.assert_array_equal(a.read(0, sk, version=3)[0].noise,
                                      b.read(0, sk, version=3)[0].noise)

    def test_summary_is_json_safe(self):
        _, sk = self._pair()
        view, _ = self._views(7, epsilon_total=2.0)
        view.read(0, sk, version=1)
        view.read(0, sk, version=2)
        view.read(1, sk, version=1)
        s = view.summary()
        json.dumps(s)
        assert s["releases"] == 3
        assert s["spent"] == {"0": 2.0, "1": 1.0}
        assert s["remaining"] == {"0": 0.0, "1": 1.0}
        assert s["exhausted"] == [0]
        unlimited = PrivateBankView(ReleasePolicy.unlimited()).summary()
        json.dumps(unlimited)
        assert unlimited["epsilon_total"] is None
