"""The port's serving gateway against ``repro.serve.storm_gateway``.

The JAX gateway runs with ``mode="ref"`` (its pure-jnp oracle, as on the
CPU) and the port's on the CPU (its kernels' plain versions), on the same
numpy request streams under the JAX hash family carried across. Counters,
query results and reports agree bit for bit: integer counts are exact, and
at these seeds no projection is a sign tie. Port-only contracts mirror
``tests/test_serve_gateway.py`` and ``tests/test_serve_fit.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as jsk
from repro.serve import storm_gateway as jgw
from repro_torch import interop
from repro_torch.core import dfo, erm, fleet, lsh, sketch as sketch_lib
from repro_torch.device import generator
from repro_torch.kernels import ops
from repro_torch.serve import storm_gateway as port_gw
from repro_torch.serve.storm_gateway import (
    FitRequest, IngestRequest, QueryRequest, StormGateway, report_key,
)
from torch_parity import CPU, jax_params, t

S = 4
D = 5  # sketch-space dim (the hash family has D + 2 features)
_JDTYPE = {torch.int32: jnp.int32, torch.int16: jnp.int16,
           torch.int8: jnp.int8}


@pytest.fixture(scope="module")
def hashes():
    return jax_params(0, 64, 3, D + 2)


def _streams(tenants=S, n_base=37, step=11, seed=10, dim=D):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(n_base + step * i, dim))).astype(
        np.float32) for i in range(tenants)]


def _thetas(q=9, seed=50, tenants=S):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(q, D)).astype(np.float32)
            for _ in range(tenants)]


def _script(seed, tenants=S, rounds=6, dim=D, augment=False):
    """Per-round request lists: ingest chunks (some beyond a tick's slots),
    queries (some empty) and an idle round."""
    rng = np.random.default_rng(seed)
    rid = 0
    script = []
    for r in range(rounds):
        reqs = []
        if r == rounds // 2:
            script.append(reqs)
            continue
        for tenant in range(tenants):
            if rng.random() < 0.8:
                z = (0.3 * rng.normal(size=(int(rng.integers(1, 40)), dim))
                     ).astype(np.float32)
                if augment:
                    z = _augment(z)
                reqs.append(("ingest", rid, tenant, z))
                rid += 1
            if rng.random() < 0.7:
                th = rng.normal(size=(int(rng.integers(0, 9)), D)).astype(
                    np.float32)
                reqs.append(("query", rid, tenant, th))
                rid += 1
        script.append(reqs)
    return script


def _augment(z):
    z = z / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1.0)
    return lsh.augment_data(t(z)).numpy()


def _requests(mod, reqs):
    return [mod.IngestRequest(rid=rid, tenant=tn, z=a) if kind == "ingest"
            else mod.QueryRequest(rid=rid, tenant=tn, thetas=a)
            for kind, rid, tn, a in reqs]


def _drive(gw, mod, script):
    reports = []
    for reqs in script:
        gw.submit_many(_requests(mod, reqs))
        reports.append(gw.tick())
    while gw.pending:
        reports.append(gw.tick())
    return reports


@pytest.mark.parametrize("paired,dtype", [
    (True, torch.int32), (True, torch.int16), (True, torch.int8),
    (False, torch.int32),
])
def test_ticks_equal_the_jax_gateway(hashes, paired, dtype):
    jp, tp = hashes
    kw = dict(paired=paired, query_slots=4, ingest_slots=16)
    want_gw = jgw.StormGateway(jp, S, count_dtype=_JDTYPE[dtype], mode="ref",
                               **kw)
    got_gw = StormGateway(tp, S, count_dtype=dtype, device=CPU, **kw)
    dim = D if paired else D + 2
    script = _script(7, dim=D, augment=not paired)
    want = _drive(want_gw, jgw, script)
    got = _drive(got_gw, port_gw, script)
    assert got_gw.ingest_dim == want_gw.ingest_dim == dim
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    assert got_gw.bank.counts.dtype == dtype
    np.testing.assert_array_equal(got_gw.bank.counts.numpy(),
                                  np.asarray(want_gw.bank.counts))
    np.testing.assert_array_equal(got_gw.bank.n.numpy(),
                                  np.asarray(want_gw.bank.n))
    assert got_gw.queue_stats() == want_gw.queue_stats()


def test_warm_start_bank_carried_from_jax(hashes):
    jp, tp = hashes
    bank = jsk.sketch_dataset_many(jp, [jnp.asarray(z) for z in _streams()],
                                   batch=16, engine="scan")
    want_gw = jgw.StormGateway(jp, S, query_slots=4, ingest_slots=8,
                               bank=bank, mode="ref")
    got_gw = StormGateway(tp, S, query_slots=4, ingest_slots=8, device=CPU,
                          bank=interop.sketch_bank(np.asarray(bank.counts),
                                                   np.asarray(bank.n),
                                                   device=CPU))
    script = _script(11)
    want = _drive(want_gw, jgw, script)
    got = _drive(got_gw, port_gw, script)
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    np.testing.assert_array_equal(got_gw.bank.counts.numpy(),
                                  np.asarray(want_gw.bank.counts))


class TestIngest:
    @pytest.mark.parametrize("engine", ["scan", "kernel"])
    def test_interleaved_chunks_match_standalone_build(self, hashes, engine):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=4, ingest_slots=16, device=CPU)
        streams = _streams()
        chunks = [(tn, z[off:off + 13]) for tn, z in enumerate(streams)
                  for off in range(0, len(z), 13)]
        np.random.default_rng(0).shuffle(chunks)
        for i, (tn, z) in enumerate(chunks):
            gw.submit(IngestRequest(rid=i, tenant=tn, z=z))
        gw.run_until_idle()
        for tn, z in enumerate(streams):
            sk = sketch_lib.sketch_dataset(tp, t(z), batch=16, engine=engine,
                                           device=CPU)
            assert torch.equal(gw.bank.counts[tn], sk.counts)
            assert int(gw.bank.n[tn]) == len(z)

    def test_overflow_spills_to_next_tick(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, 1, query_slots=2, ingest_slots=8, device=CPU)
        z = _streams()[0][:20]
        gw.submit(IngestRequest(rid=0, tenant=0, z=z))
        assert [gw.tick().rows_ingested for _ in range(3)] == [8, 8, 4]
        assert gw.pending == 0
        sk = sketch_lib.sketch_dataset(tp, t(z), engine="scan", device=CPU)
        assert torch.equal(gw.bank.counts[0], sk.counts)

    def test_narrow_dtype_gateway_saturates(self):
        params = lsh.init_srp(generator(3, CPU), 4, 1, 4, device=CPU)
        gw = StormGateway(params, 1, query_slots=2, ingest_slots=64,
                          count_dtype="int8", device=CPU)
        z = (0.3 * np.random.default_rng(4).normal(size=(400, 2))).astype(
            np.float32)
        for off in range(0, 400, 64):
            gw.submit(IngestRequest(rid=off, tenant=0, z=z[off:off + 64]))
        gw.run_until_idle()
        assert gw.bank.counts.dtype == torch.int8
        assert int(gw.bank.counts.max()) == 127
        sk = sketch_lib.sketch_dataset(params, t(z), dtype=torch.int8,
                                       engine="scan", device=CPU)
        assert torch.equal(gw.bank.counts[0], sk.counts)

    def test_masked_slots_add_nothing(self, hashes):
        """A tick with one row for one tenant pads every other slot; the
        padding adds int(0) everywhere."""
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=2, ingest_slots=8, device=CPU)
        gw.submit(IngestRequest(rid=0, tenant=2, z=_streams()[2][:1]))
        gw.tick()
        mass = gw.bank.counts.to(torch.int64).sum(dim=(1, 2))
        assert mass.tolist() == [0, 0, 2 * tp.rows, 0]
        assert gw.bank.n.tolist() == [0, 0, 1, 0]


class TestQuery:
    def test_results_match_standalone_query(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=4, ingest_slots=64, device=CPU)
        for tn, z in enumerate(_streams()):
            gw.submit(IngestRequest(rid=tn, tenant=tn, z=z))
        gw.run_until_idle()
        thetas = _thetas()
        for tn in range(S):
            gw.submit(QueryRequest(rid=tn, tenant=tn, thetas=thetas[tn]))
        results = {r.rid: r for r in gw.run_until_idle()}
        w = ops.from_lsh_params(tp)
        for tn in range(S):
            want = ops.query_theta_with_weights(gw.sketch_of(tn), w,
                                                t(thetas[tn]), paired=True)
            np.testing.assert_array_equal(results[tn].losses, want.numpy())
            assert results[tn].tenant == tn

    def test_results_match_fit_loss_closure(self, hashes):
        """The gateway serves what a fit's loss closure computes (the scan
        engine hashes another way: equal to fp tolerance)."""
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=8, ingest_slots=64, device=CPU)
        for tn, z in enumerate(_streams()):
            gw.submit(IngestRequest(rid=tn, tenant=tn, z=z))
        gw.run_until_idle()
        cand = _thetas(q=6, seed=70)
        for tn in range(S):
            gw.submit(QueryRequest(rid=tn, tenant=tn, thetas=cand[tn]))
        results = {r.rid: r for r in gw.run_until_idle()}
        for tn in range(S):
            loss_fn = fleet.make_loss_fn(gw.sketch_of(tn), tp, paired=True,
                                         engine="scan", d=D - 1)
            np.testing.assert_allclose(results[tn].losses,
                                       loss_fn(t(cand[tn])).numpy(),
                                       rtol=1e-5)

    def test_read_your_writes_within_tick(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, 1, query_slots=2, ingest_slots=64, device=CPU)
        z, theta = _streams()[0], _thetas(q=1)[0]
        gw.submit(IngestRequest(rid=0, tenant=0, z=z))
        gw.submit(QueryRequest(rid=1, tenant=0, thetas=theta))
        rep = gw.tick()
        assert rep.rows_ingested == len(z) and len(rep.results) == 1
        want = ops.query_theta_with_weights(
            gw.sketch_of(0), ops.from_lsh_params(tp), t(theta), paired=True)
        np.testing.assert_array_equal(rep.results[0].losses, want.numpy())

    def test_split_request_reassembles(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, 1, query_slots=3, ingest_slots=4, device=CPU)
        gw.submit(IngestRequest(rid=0, tenant=0, z=_streams()[0][:16]))
        gw.run_until_idle()
        thetas = _thetas(q=10)[0]
        gw.submit(QueryRequest(rid=7, tenant=0, thetas=thetas))
        reports = [gw.tick() for _ in range(4)]
        done = [r for rep in reports for r in rep.results]
        assert len(done) == 1 and done[0].rid == 7
        assert [rep.points_served for rep in reports] == [3, 3, 3, 1]
        want = ops.query_theta_with_weights(
            gw.sketch_of(0), ops.from_lsh_params(tp), t(thetas), paired=True)
        np.testing.assert_array_equal(done[0].losses, want.numpy())


class TestEngineDiscipline:
    def test_three_bodies_across_mixes(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=4, ingest_slots=8, device=CPU)
        z, th = _streams()[0][:3], _thetas(q=2)[0]
        gw.submit(IngestRequest(rid=0, tenant=0, z=z))
        gw.tick()  # ingest only
        gw.submit(QueryRequest(rid=1, tenant=1, thetas=th))
        gw.tick()  # query only
        for reqs in _script(1, rounds=8):  # full ticks and every other mix
            gw.submit_many(_requests(port_gw, reqs))
            gw.tick()
        gw.run_until_idle()
        rep = gw.tick()  # idle: a host-side no-op, still counted
        assert rep.results == [] and rep.rows_ingested == 0
        assert gw.trace_count == 3
        assert {sig[0] for sig in gw._signatures} == {"full", "ingest",
                                                      "query"}

    def test_zero_row_query_completes(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=2, ingest_slots=4, device=CPU)
        gw.submit(QueryRequest(rid=9, tenant=0,
                               thetas=np.zeros((0, D), np.float32)))
        res = gw.run_until_idle()
        assert len(res) == 1 and res[0].rid == 9
        assert res[0].losses.shape == (0,)
        assert gw.trace_count == 0  # nothing to run

    def test_validation(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=2, ingest_slots=4, device=CPU)
        with pytest.raises(ValueError, match="tenant"):
            gw.submit(IngestRequest(rid=0, tenant=S, z=np.zeros((2, D))))
        with pytest.raises(ValueError, match="ingest rows"):
            gw.submit(IngestRequest(rid=0, tenant=0, z=np.zeros((2, D + 1))))
        with pytest.raises(ValueError, match="query thetas"):
            gw.submit(QueryRequest(rid=0, tenant=0, thetas=np.zeros((2, 3))))
        with pytest.raises(TypeError):
            gw.submit("not a request")
        with pytest.raises(ValueError, match="bank holds"):
            StormGateway(tp, S, device=CPU, bank=sketch_lib.SketchBank(
                counts=torch.zeros((S + 1, 64, 8), dtype=torch.int32),
                n=torch.zeros((S + 1,), dtype=torch.int32)))
        with pytest.raises(ValueError, match="mode"):
            StormGateway(tp, S, mode="interpret", device=CPU)

    def test_warm_start_bank_is_copied(self, hashes):
        _, tp = hashes
        bank = sketch_lib.sketch_dataset_many(
            tp, [t(z) for z in _streams()], engine="scan", device=CPU)
        before = bank.counts.clone()
        gw = StormGateway(tp, S, query_slots=4, ingest_slots=4, bank=bank,
                          device=CPU)
        gw.submit(IngestRequest(rid=0, tenant=1, z=_streams()[1][:3]))
        gw.tick()
        assert torch.equal(bank.counts, before)  # the caller's bank is intact
        assert not torch.equal(gw.bank.counts, before)


def _offline_fit(req, counts, ns, params):
    """The offline spine over the cohort's counters: the oracle every
    gateway fit reproduces bit for bit."""
    bank = sketch_lib.SketchBank(
        counts=torch.stack([c.to(torch.int32) for c in counts]),
        n=torch.stack([torch.as_tensor(n, dtype=torch.int32) for n in ns]))
    cfg = dfo.DFOConfig(steps=req.steps, num_queries=req.num_queries,
                        sigma=req.sigma, learning_rate=req.learning_rate,
                        decay=req.decay)
    return erm.fit_many(req.surrogate, bank, params, cfg,
                        restarts=req.restarts, l2=req.l2,
                        refine_steps=req.refine_steps,
                        generator=generator(req.seed, CPU), device=CPU)


def _filled(tp, paired=True):
    gw = StormGateway(tp, S, paired=paired, query_slots=4, ingest_slots=64,
                      device=CPU)
    for tn, z in enumerate(_streams(n_base=31, step=9)):
        gw.submit(IngestRequest(rid=tn, tenant=tn,
                                z=z if paired else _augment(z)))
    gw.run_until_idle()
    return gw


class TestGatewayFit:
    def test_fit_matches_offline_spine_bit_for_bit(self, hashes):
        _, tp = hashes
        gw = _filled(tp)
        req = FitRequest(rid=50, tenants=[2, 0, 3], seed=7, steps=12,
                         restarts=2)
        gw.submit(req)
        assert gw.queue_stats()["pending_fits"] == 1
        rep = gw.tick()
        assert len(rep.fits) == 1
        fit = rep.fits[0]
        assert fit.rid == 50 and fit.tenants == [2, 0, 3]
        want = _offline_fit(req, [gw.bank.counts[i] for i in req.tenants],
                            [gw.bank.n[i] for i in req.tenants], tp)
        np.testing.assert_array_equal(fit.theta, want.theta.numpy())
        np.testing.assert_array_equal(fit.fleet_losses,
                                      want.fleet_losses.numpy())
        assert fit.theta.shape == (3, D)
        assert gw.fits_run == 1 and gw.queue_stats()["fits_run"] == 1

    def test_fit_leaves_counters_and_tick_bodies_alone(self, hashes):
        _, tp = hashes
        gw = _filled(tp)
        before = gw.bank.counts.clone()
        traces = gw.trace_count
        gw.submit(FitRequest(rid=1, tenants=[0, 1], steps=8))
        gw.tick()
        assert torch.equal(gw.bank.counts, before)
        assert gw.trace_count == traces <= 3

    def test_run_until_idle_drains_fits(self, hashes):
        _, tp = hashes
        gw = _filled(tp)
        gw.submit(FitRequest(rid=9, tenants=[0], steps=5))
        assert gw.pending == 1
        gw.run_until_idle()
        assert gw.pending == 0 and gw.fits_run == 1

    def test_mixed_tick_fits_see_same_tick_ingest(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=4, ingest_slots=64, device=CPU)
        z = _streams()[1]
        req = FitRequest(rid=3, tenants=[1], steps=6)
        gw.submit(IngestRequest(rid=0, tenant=1, z=z))
        gw.submit(req)
        rep = gw.tick()
        assert rep.rows_ingested == len(z) and len(rep.fits) == 1
        want = _offline_fit(req, [gw.bank.counts[1]], [gw.bank.n[1]], tp)
        np.testing.assert_array_equal(rep.fits[0].theta, want.theta.numpy())

    def test_validation(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, device=CPU)
        with pytest.raises(ValueError, match="cohort is empty"):
            gw.submit(FitRequest(rid=0, tenants=[]))
        with pytest.raises(ValueError, match="out of range"):
            gw.submit(FitRequest(rid=0, tenants=[0, S]))
        with pytest.raises(ValueError, match="unknown surrogate"):
            gw.submit(FitRequest(rid=0, tenants=[0], surrogate="nope"))
        with pytest.raises(ValueError, match="single-sided"):
            gw.submit(FitRequest(rid=0, tenants=[0], surrogate="logistic"))
        single = StormGateway(tp, S, paired=False, device=CPU)
        with pytest.raises(ValueError, match="paired"):
            single.submit(FitRequest(rid=0, tenants=[0],
                                     surrogate="prp_regression"))
        assert gw.pending == 0 and single.pending == 0

    def test_single_sided_logistic_fit(self, hashes):
        _, tp = hashes
        gw = _filled(tp, paired=False)
        req = FitRequest(rid=5, tenants=[0, 1], surrogate="logistic", seed=1,
                         steps=10)
        gw.submit(req)
        fit = gw.tick().fits[0]
        want = _offline_fit(req, [gw.bank.counts[0], gw.bank.counts[1]],
                            [gw.bank.n[0], gw.bank.n[1]], tp)
        np.testing.assert_array_equal(fit.theta, want.theta.numpy())
        assert np.all(np.isfinite(fit.theta))

    def test_served_sub_bank_equals_the_jax_gateway(self, hashes):
        """What a fit reads: the cohort's served counters, gathered on both
        engines from the same stream, are equal (the fits themselves match
        JAX only to the DFO's own sensitivity, ROADMAP Queue 3)."""
        jp, tp = hashes
        jg = jgw.StormGateway(jp, S, query_slots=4, ingest_slots=64,
                              mode="ref")
        for tn, z in enumerate(_streams(n_base=31, step=9)):
            jg.submit(jgw.IngestRequest(rid=tn, tenant=tn, z=z))
        jg.run_until_idle()
        gw = _filled(tp)
        cohort = [3, 1]
        np.testing.assert_array_equal(
            gw.bank.counts[cohort].to(torch.int32).numpy(),
            np.asarray(jg.bank.counts[jnp.asarray(cohort)]))
        np.testing.assert_array_equal(gw.bank.n[cohort].numpy(),
                                      np.asarray(jg.bank.n[jnp.asarray(
                                          cohort)]))
