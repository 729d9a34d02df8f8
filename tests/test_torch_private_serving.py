"""The port's private serving against ``repro.serve`` (mirrors
``tests/test_private_serving.py``): the eps ledger threaded through the
gateways and the wire.

The JAX gateways run with ``mode="ref"`` and the port's on the CPU (the
kernels' plain versions), on the same numpy scripts under the JAX hash
family, with the same policy and seed. What must be EQUAL: the counters,
the counter versions, every read plan (status, release-time count, spend
and the numpy noise of each window), the ledgers, the refusal counts, the
statuses of every result and fit, and the released lanes (``f32(counts) +
noise``, the same IEEE adds). The estimates differ only by the float
mean's summation order: JAX sums a point's R gathered cells in f32, the
port in float64, so ``|port - jax| <= R * 2^-23 * mean|x| / denom +
2^-22 |est|`` per point (``mean|x|`` over the point's gathered cells of its
release). The fits train on the same released sub-banks, but their DFO
draws differ (``jax.random`` and a ``torch.Generator``), so a fit is held
path to path instead: the gateway's private fit equals the offline
``erm.fit_many`` over the sub-bank it gathered, bit for bit, and that
sub-bank equals JAX's release.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import privacy as jprivacy
from repro.serve import storm_gateway as jgw
from repro.serve import tiered_gateway as jtiered
from repro_torch import interop
from repro_torch.core import dfo, erm, lsh
from repro_torch.core import sketch as sketch_lib
from repro_torch.core.privacy import ReleasePolicy
from repro_torch.device import generator
from repro_torch.kernels import ops, ref
from repro_torch.serve import storm_gateway as port_gw
from repro_torch.serve.storm_gateway import (
    FitRequest, IngestRequest, QueryRequest, StormGateway, report_key,
)
from repro_torch.serve.tiered_gateway import TieredStormGateway
from repro_torch.serve.wire import (
    BudgetExceeded, StormWireClient, StormWireServer,
)
from torch_parity import CPU, jax_params

D = 5  # sketch-space dim (the hash family has D + 2 features)
ROWS = 64


@pytest.fixture(scope="module")
def hashes():
    return jax_params(0, ROWS, 3, D + 2)


def _streams(tenants, n_base=23, step=7, seed=10):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(n_base + step * t, D))).astype(np.float32)
            for t in range(tenants)]


def _soak_script(tenants, seed=0, chunk=9, queries=3):
    """A shuffled mix of ingest chunks and queries, as ``(kind, rid,
    tenant, array)``."""
    rng = np.random.default_rng(seed)
    rids = itertools.count()
    reqs = []
    for t, z in enumerate(_streams(tenants)):
        for off in range(0, len(z), chunk):
            reqs.append(("ingest", next(rids), t, z[off:off + chunk]))
        for _ in range(queries):
            reqs.append(("query", next(rids), t,
                         rng.normal(size=(4, D)).astype(np.float32)))
    order = rng.permutation(len(reqs))
    return [reqs[i] for i in order]


def _rounds(script, per=5):
    return [script[off:off + per] for off in range(0, len(script), per)]


def _requests(mod, reqs):
    out = []
    for kind, rid, tn, a in reqs:
        if kind == "ingest":
            out.append(mod.IngestRequest(rid=rid, tenant=tn, z=a))
        elif kind == "query":
            out.append(mod.QueryRequest(rid=rid, tenant=tn, thetas=a))
        else:
            out.append(mod.FitRequest(rid=rid, tenants=list(tn), seed=a,
                                      steps=5))
    return out


def _theta(seed, n=3):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _result_key(res):
    return (res.rid, res.tenant, res.status, np.asarray(res.losses).tobytes())


class _Log:
    """``on_start`` hook of a port gateway (flat, or tiered via ``inner``):
    each tick's placements, a copy of the lanes and release-time counts
    right behind its body, and the fits' gathered sub-banks."""

    def __init__(self, inner):
        self.inner = inner
        self.placements = []  # (tick, rid, req_offset, slot, count)
        self.lanes = {}
        self.fits = []        # (rid, sub-bank, status)

    def __call__(self, fl, gathered=()):
        for st, off, slot, _, take in fl.placements:
            self.placements.append((fl.tick, st.req.rid, off, slot, take))
        if fl.placements:
            self.lanes[fl.tick] = (self.inner._release.clone(),
                                   self.inner._n_used.clone())
        for req, sub, status in list(fl.fits) + list(gathered):
            self.fits.append((req.rid, sub, status))


def _drive_pair(jg, pg, rounds, log, tiered=False):
    """Both gateways through the same rounds, one synchronous tick each per
    round, then drained; returns both report lists."""
    want, got = [], []

    def tick():
        want.append(jg.tick())
        fl = pg.tick_start()
        log(fl, pg._gathered.get(fl.tick, ()) if tiered else ())
        got.append(pg.tick_finish(fl))

    for reqs in rounds:
        jg.submit_many(_requests(jgw, reqs))
        pg.submit_many(_requests(port_gw, reqs))
        tick()
    while jg.pending or pg.pending:
        tick()
    return want, got


def _shape_key(rep):
    """A report without its loss and fit values."""
    return (rep.tick, rep.rows_ingested, rep.points_served,
            [(r.rid, r.tenant, r.status, np.asarray(r.losses).shape)
             for r in rep.results],
            [(i.rid, i.tenant, i.rows) for i in rep.ingest_done],
            [(f.rid, list(f.tenants), f.status) for f in rep.fits])


def _check_estimates(want, got, log, tp, thetas, paired=True):
    """Served points against a standalone query of the same release (bit
    for bit), and against JAX within the stated bound."""
    w = ops.from_lsh_params(tp)
    jloss = {r.rid: np.asarray(r.losses) for rep in want for r in rep.results}
    ploss = {r.rid: r.losses for rep in got for r in rep.results}
    assert jloss.keys() == ploss.keys()
    for tick, rid, off, slot, take in log.placements:
        lanes, n_used = log.lanes[tick]
        th = torch.from_numpy(thetas[rid][off:off + take])
        sk = sketch_lib.Sketch(counts=lanes[slot], n=n_used[slot])
        standalone = ops.query_theta_with_weights(sk, w, th, paired=paired)
        served = torch.from_numpy(ploss[rid][off:off + take])
        assert torch.equal(served, standalone), (tick, rid)
        q = lsh.augment_query(lsh.normalize_query(th))
        mean_abs = ref.sketch_query(q, w, lanes[slot].abs()).double()
        denom = sketch_lib.denominator(n_used[slot], paired).double()
        bound = (ROWS * 2.0 ** -23 * mean_abs / denom
                 + 2.0 ** -22 * served.double().abs())
        diff = (served.double() - torch.from_numpy(
            jloss[rid][off:off + take]).double()).abs()
        assert bool((diff <= bound).all()), (tick, rid, diff, bound)


def _check_views(pview, jview):
    assert pview.summary() == jview.summary()
    assert pview._seq == jview._seq and pview.releases == jview.releases
    assert pview.ledger.keys() == jview.ledger.keys()
    for key in jview.ledger.keys():
        assert pview.ledger.spend_log(key) == jview.ledger.spend_log(key)
    assert pview._windows.keys() == jview._windows.keys()
    for key, win in jview._windows.items():
        assert pview._windows[key].version == win.version
        np.testing.assert_array_equal(pview._windows[key].noise, win.noise)
    assert pview._lane_n == jview._lane_n


def _nonzero(d):
    return {k: v for k, v in d.items() if v}


def _offline_fit(req, sub, tp):
    """The offline spine over a sub-bank, with the request's knobs."""
    return erm.fit_many(
        req.surrogate, sub, tp,
        dfo.DFOConfig(steps=req.steps, num_queries=req.num_queries,
                      sigma=req.sigma, learning_rate=req.learning_rate,
                      decay=req.decay),
        restarts=req.restarts, l2=req.l2, refine_steps=req.refine_steps,
        generator=generator(req.seed, CPU), device=CPU)


def _check_fits(log, tp, want_fits):
    """Each gathered private fit equals the offline fit_many over the same
    released sub-bank, bit for bit; refused fits gathered nothing."""
    for rid, sub, status in log.fits:
        fit = want_fits[rid]
        assert fit.status == status
        if status == "refused":
            assert sub is None and not fit.theta.any()
            continue
        offline = _offline_fit(fit.req, sub, tp)
        np.testing.assert_array_equal(fit.theta, offline.theta.numpy())
        np.testing.assert_array_equal(fit.fleet_losses,
                                      offline.fleet_losses.numpy())


def _fits_by_rid(reports, script):
    reqs = {rid: _requests(port_gw, [(k, rid, tn, a)])[0]
            for k, rid, tn, a in script if k == "fit"}
    out = {}
    for rep in reports:
        for f in rep.fits:
            f.req = reqs[f.rid]
            out[f.rid] = f
    return out


def _fit_rounds(tenants, seed, every=4):
    """The soak script (small chunks, six queries a tenant) in rounds, a
    cohort fit over tenants 0-1 in every ``every``-th round, then a query
    of every tenant and a fit over all of them."""
    rounds = _rounds(_soak_script(tenants, seed=seed, chunk=5, queries=6))
    rid = 10_000
    for i in range(every - 1, len(rounds), every):
        rounds[i] = rounds[i] + [("fit", rid, (0, 1), i)]
        rid += 1
    rounds.append([("query", rid + 1 + t, t, _theta(t)) for t in
                   range(tenants)])
    rounds.append([("fit", rid, tuple(range(tenants)), 99)])
    return rounds


def _flat_pair(hashes, tenants, seed, **pol):
    jp, tp = hashes
    kw = dict(query_slots=8, ingest_slots=16)
    jg = jgw.StormGateway(jp, tenants, mode="ref",
                          privacy=jprivacy.ReleasePolicy(**pol),
                          privacy_seed=seed, **kw)
    pg = StormGateway(tp, tenants, privacy=ReleasePolicy(**pol),
                      privacy_seed=seed, device=CPU, **kw)
    return jg, pg


def _thetas(rounds):
    return {rid: a for reqs in rounds for kind, rid, _, a in reqs
            if kind == "query"}


class TestAgainstJax:
    @pytest.mark.parametrize("pol", [
        dict(epsilon_total=2.0, on_exhaust="refuse"),
        dict(epsilon_total=2.0, on_exhaust="stale"),
        dict(epsilon_total=1.0, epsilon_release=0.5, mechanism="gaussian",
             on_exhaust="stale"),
    ], ids=["refuse", "stale", "gaussian"])
    def test_flat_private_gateway_equals_jax(self, hashes, pol):
        tenants = 3
        jg, pg = _flat_pair(hashes, tenants, 3, **pol)
        rounds = _fit_rounds(tenants, seed=4)
        log = _Log(pg)
        want, got = _drive_pair(jg, pg, rounds, log)
        assert [_shape_key(r) for r in got] == [_shape_key(r) for r in want]
        statuses = {r.status for rep in got for r in rep.results}
        assert "ok" in statuses and len(statuses) == 2  # exhaustion happened
        _check_estimates(want, got, log, hashes[1], _thetas(rounds))
        _check_views(pg.private_view, jg.private_view)
        assert _nonzero(pg._rows_of) == _nonzero(jg._rows_of)
        pstats, jstats = pg.queue_stats(), jg.queue_stats()
        assert pstats.pop("trace_count") <= 4
        jstats.pop("trace_count")
        assert pstats == jstats
        np.testing.assert_array_equal(pg.bank.counts.numpy(),
                                      np.asarray(jg.bank.counts))
        np.testing.assert_array_equal(pg._release.numpy(),
                                      np.asarray(jg._release_buf))
        _check_fits(log, hashes[1], _fits_by_rid(got, [
            x for reqs in rounds for x in reqs]))
        assert pg.trace_count <= 4

    def test_fit_sub_bank_is_the_jax_release(self, hashes):
        """What a private fit reads: f32(counts) + the window's noise, the
        same bits JAX's fit reads."""
        jg, pg = _flat_pair(hashes, 2, 5, epsilon_total=1e6,
                            epsilon_release=0.5)
        for gw, mod in ((jg, jgw), (pg, port_gw)):
            for t, z in enumerate(_streams(2)):
                gw.submit(mod.IngestRequest(rid=t, tenant=t, z=z))
            gw.run_until_idle()
            gw.submit(mod.FitRequest(rid=2, tenants=[1, 0], seed=0, steps=5))
        jfit = jg.tick().fits[0]
        fl = pg.tick_start()
        _, sub, status = fl.fits[0]
        pfit = pg.tick_finish(fl).fits[0]
        assert (status, pfit.status, jfit.status) == ("ok", "ok", "ok")
        for j, tenant in enumerate([1, 0]):
            want = np.asarray(jg.bank.counts[tenant]).astype(np.float32) \
                + jg.private_view._windows[tenant].noise
            np.testing.assert_array_equal(sub.counts[j].numpy(), want)
        assert sub.n.tolist() == np.asarray(jg.bank.n)[[1, 0]].tolist()
        _check_views(pg.private_view, jg.private_view)

    @pytest.mark.parametrize("on_exhaust", ["stale", "refuse"])
    def test_tiered_private_gateway_equals_jax(self, hashes, on_exhaust):
        jp, tp = hashes
        t, h = 5, 2
        pol = dict(epsilon_total=4.0, on_exhaust=on_exhaust)
        kw = dict(query_slots=8, ingest_slots=16, promote_per_tick=2)
        jg = jtiered.TieredStormGateway(
            jp, t, h, mode="ref", privacy=jprivacy.ReleasePolicy(**pol),
            privacy_seed=6, **kw)
        pg = TieredStormGateway(tp, t, h, privacy=ReleasePolicy(**pol),
                                privacy_seed=6, device=CPU, **kw)
        rounds = _fit_rounds(t, seed=5, every=3)
        log = _Log(pg.gw)
        want, got = _drive_pair(jg, pg, rounds, log, tiered=True)
        assert [_shape_key(r) for r in got] == [_shape_key(r) for r in want]
        assert pg.promotions == jg.promotions > 0 and pg.demotions > 0
        _check_estimates(want, got, log, tp, _thetas(rounds))
        _check_views(pg.private_view, jg.private_view)
        assert set(pg.private_view.ledger.keys()) == set(range(t))
        assert pg.queue_stats()["privacy"] == jg.queue_stats()["privacy"]
        for tenant in range(t):
            np.testing.assert_array_equal(
                pg.sketch_of(tenant).counts.numpy(),
                np.asarray(jg.sketch_of(tenant).counts))
        _check_fits(log, tp, _fits_by_rid(got, [
            x for reqs in rounds for x in reqs]))
        assert pg.trace_count <= 5


class TestPipelined:
    @pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
    def test_pipelined_equals_sync(self, hashes, tiered):
        _, tp = hashes
        pol = ReleasePolicy(epsilon_total=4.0, on_exhaust="stale")

        def make():
            if tiered:
                return TieredStormGateway(tp, 5, 2, query_slots=8,
                                          ingest_slots=16, privacy=pol,
                                          privacy_seed=1, device=CPU)
            return StormGateway(tp, 5, query_slots=8, ingest_slots=16,
                                privacy=pol, privacy_seed=1, device=CPU)

        rounds = _fit_rounds(5, seed=7)
        runs = []
        for depth in (1, 2, 3):
            gw, inflight, reps = make(), [], []
            for reqs in rounds:
                gw.submit_many(_requests(port_gw, reqs))
                inflight.append(gw.tick_start())
                while len(inflight) >= depth:
                    reps.append(gw.tick_finish(inflight.pop(0)))
            while inflight or gw.pending:
                if gw.pending and len(inflight) < depth:
                    inflight.append(gw.tick_start())
                else:
                    reps.append(gw.tick_finish(inflight.pop(0)))
            runs.append(([report_key(r) for r in reps],
                         gw.private_view.summary()))
        assert runs[0] == runs[1] == runs[2]


class TestUnlimitedIsIdentity:
    """eps = inf builds nothing private: the gateway is the privacy=None
    one, byte for byte."""

    def test_flat_soak_bit_identical(self, hashes):
        _, tp = hashes
        plain = StormGateway(tp, 4, query_slots=8, ingest_slots=16,
                             device=CPU)
        unlim = StormGateway(tp, 4, query_slots=8, ingest_slots=16,
                             privacy=ReleasePolicy.unlimited(), device=CPU)
        for batch in _rounds(_soak_script(4, seed=1)):
            plain.submit_many(_requests(port_gw, batch))
            unlim.submit_many(_requests(port_gw, batch))
            assert ([_result_key(r) for r in plain.tick().results]
                    == [_result_key(r) for r in unlim.tick().results])
        assert ([_result_key(r) for r in plain.run_until_idle()]
                == [_result_key(r) for r in unlim.run_until_idle()])
        assert torch.equal(plain.bank.counts, unlim.bank.counts)
        assert unlim.trace_count <= 3 and unlim.private_view is None
        assert not hasattr(unlim, "_release")
        assert "privacy" not in unlim.queue_stats()
        for gw in (plain, unlim):
            gw.submit(FitRequest(rid=999, tenants=[0, 1], seed=3, steps=8))
        fit_p, fit_u = plain.tick().fits[0], unlim.tick().fits[0]
        assert fit_u.status == "ok"
        np.testing.assert_array_equal(fit_p.theta, fit_u.theta)

    def test_tiered_soak_bit_identical(self, hashes):
        _, tp = hashes
        kw = dict(query_slots=8, ingest_slots=16, promote_per_tick=2,
                  device=CPU)
        plain = TieredStormGateway(tp, 5, 2, **kw)
        unlim = TieredStormGateway(tp, 5, 2,
                                   privacy=ReleasePolicy.unlimited(), **kw)
        script = _requests(port_gw, _soak_script(5, seed=2))
        plain.submit_many(script)
        unlim.submit_many(script)
        assert ([_result_key(r) for r in plain.run_until_idle(max_ticks=500)]
                == [_result_key(r)
                    for r in unlim.run_until_idle(max_ticks=500)])
        for tenant in range(5):
            assert torch.equal(plain.sketch_of(tenant).counts,
                               unlim.sketch_of(tenant).counts)
        assert unlim.trace_count <= 4 and unlim.promotions > 0


class TestReleaseWindows:
    """One charged release per (tenant, counter version)."""

    def _gw(self, hashes, **pol):
        pol.setdefault("epsilon_total", 1e6)
        return StormGateway(hashes[1], 3, query_slots=8, ingest_slots=16,
                            privacy=ReleasePolicy(**pol), privacy_seed=0,
                            device=CPU)

    def test_one_release_covers_the_ticks_coalesced_queries(self, hashes):
        gw = self._gw(hashes)
        z = _streams(3)
        rids = itertools.count()
        for k in range(4):
            for t in range(3):
                gw.submit(IngestRequest(rid=next(rids), tenant=t, z=z[t][:5]))
                for _ in range(3):  # three queries a tick: one release
                    gw.submit(QueryRequest(rid=next(rids), tenant=t,
                                           thetas=_theta(k)))
            gw.tick()
        gw.run_until_idle()
        assert gw.private_view.releases == 3 * 4
        for t in range(3):
            assert gw.private_view.ledger.spent(t) == 4.0

    def test_reread_of_unchanged_counters_is_free(self, hashes):
        gw = self._gw(hashes)
        gw.submit(IngestRequest(rid=0, tenant=0, z=_streams(1)[0][:8]))
        gw.tick()
        th = _theta(7)
        gw.submit(QueryRequest(rid=1, tenant=0, thetas=th))
        first = gw.run_until_idle()[0]
        gw.submit(QueryRequest(rid=2, tenant=0, thetas=th))
        second = gw.run_until_idle()[0]
        assert gw.private_view.releases == 1
        assert gw.private_view.ledger.spent(0) == 1.0
        np.testing.assert_array_equal(first.losses, second.losses)

    def test_empty_reads_never_charge(self, hashes):
        gw = self._gw(hashes)
        gw.submit(IngestRequest(rid=0, tenant=1, z=_streams(2)[1][:6]))
        gw.submit(QueryRequest(rid=1, tenant=2,
                               thetas=np.zeros((0, D), np.float32)))
        gw.tick()
        gw.tick()
        assert gw.private_view.releases == 0
        assert gw.private_view.ledger.spent(1) == 0.0

    def test_noise_actually_perturbs(self, hashes):
        res = {}
        for name, pol in (("noisy", ReleasePolicy(epsilon_total=1e6,
                                                  epsilon_release=0.5)),
                          ("clean", None)):
            gw = StormGateway(hashes[1], 1, query_slots=8, ingest_slots=16,
                              privacy=pol, privacy_seed=0, device=CPU)
            gw.submit(IngestRequest(rid=0, tenant=0, z=_streams(1)[0][:20]))
            gw.submit(QueryRequest(rid=1, tenant=0, thetas=_theta(11)))
            res[name] = gw.run_until_idle()[0].losses
        assert not np.array_equal(res["noisy"], res["clean"])


class TestExhaustion:
    def test_refusal_is_deterministic_and_isolated(self, hashes):
        gw = StormGateway(hashes[1], 2, query_slots=8, ingest_slots=16,
                          privacy=ReleasePolicy(epsilon_total=2.0),
                          privacy_seed=1, device=CPU)
        z = _streams(2)
        rids = itertools.count()
        seen = []
        for k in range(5):
            gw.submit(IngestRequest(rid=next(rids), tenant=0, z=z[0][:4]))
            if k == 0:
                gw.submit(IngestRequest(rid=next(rids), tenant=1,
                                        z=z[1][:6]))
            q0, q1 = next(rids), next(rids)
            gw.submit(QueryRequest(rid=q0, tenant=0, thetas=_theta(k)))
            gw.submit(QueryRequest(rid=q1, tenant=1, thetas=_theta(k)))
            done = {r.rid: r for r in gw.tick().results}
            done.update({r.rid: r for r in gw.run_until_idle()})
            seen.append((done[q0].status, done[q1].status, done[q0].losses))
        assert [s for s, _, _ in seen] == ["ok", "ok", "refused", "refused",
                                           "refused"]
        assert all(s == "ok" for _, s, _ in seen)
        assert not any(losses.any() for _, _, losses in seen[2:])
        assert gw.queries_refused == 3
        assert gw.private_view.ledger.remaining(0) == 0.0
        assert gw.private_view.ledger.spent(1) == 1.0
        stats = gw.queue_stats()["privacy"]
        assert stats["exhausted"] == [0] and stats["queries_refused"] == 3

    def test_stale_policy_freezes_the_last_release(self, hashes):
        gw = StormGateway(hashes[1], 1, query_slots=8, ingest_slots=16,
                          privacy=ReleasePolicy(epsilon_total=1.0,
                                                on_exhaust="stale"),
                          privacy_seed=2, device=CPU)
        z = _streams(1)[0]
        th = _theta(21)
        rids = itertools.count()

        def one_round(k):
            gw.submit(IngestRequest(rid=next(rids), tenant=0,
                                    z=z[4 * k:4 * k + 4]))
            q = next(rids)
            gw.submit(QueryRequest(rid=q, tenant=0, thetas=th))
            return {r.rid: r for r in gw.run_until_idle()}[q]

        fresh = one_round(0)
        stale = [one_round(k) for k in range(1, 4)]
        assert fresh.status == "ok"
        assert [r.status for r in stale] == ["stale"] * 3
        for r in stale:
            np.testing.assert_array_equal(r.losses, fresh.losses)
        assert gw.private_view.releases == 1 and gw.queries_refused == 0

    def test_refused_fit_refuses_the_whole_cohort(self, hashes):
        gw = StormGateway(hashes[1], 2, query_slots=8, ingest_slots=16,
                          privacy=ReleasePolicy(epsilon_total=1.0),
                          privacy_seed=3, device=CPU)
        z = _streams(2)
        gw.submit(IngestRequest(rid=0, tenant=0, z=z[0][:8]))
        gw.submit(IngestRequest(rid=1, tenant=1, z=z[1][:8]))
        gw.submit(QueryRequest(rid=2, tenant=0, thetas=_theta(1)))
        gw.run_until_idle()
        gw.submit(IngestRequest(rid=3, tenant=0, z=z[0][8:12]))
        gw.tick()
        gw.submit(FitRequest(rid=4, tenants=[0, 1], seed=0, steps=5))
        fit = gw.tick().fits[0]
        assert fit.status == "refused" and not fit.theta.any()
        assert fit.theta.shape == (2, D) and gw.fits_refused == 1
        gw.submit(FitRequest(rid=5, tenants=[1], seed=0, steps=5))
        assert gw.tick().fits[0].status == "ok"

    def test_private_fit_trains_from_released_counters(self, hashes):
        _, tp = hashes
        clean = StormGateway(tp, 2, query_slots=8, ingest_slots=16,
                             device=CPU)
        noisy = StormGateway(tp, 2, query_slots=8, ingest_slots=16,
                             privacy=ReleasePolicy(epsilon_total=1e6,
                                                   epsilon_release=0.5),
                             privacy_seed=4, device=CPU)
        for gw in (clean, noisy):
            for t, z in enumerate(_streams(2)):
                gw.submit(IngestRequest(rid=t, tenant=t, z=z))
            gw.run_until_idle()
            gw.submit(FitRequest(rid=2, tenants=[0, 1], seed=0, steps=8))
        fit_c, fit_n = clean.tick().fits[0], noisy.tick().fits[0]
        assert fit_n.status == "ok" and fit_n.theta.shape == fit_c.theta.shape
        assert not np.array_equal(fit_n.theta, fit_c.theta)
        assert noisy.private_view.ledger.spent(0) == 0.5
        assert noisy.private_view.ledger.spent(1) == 0.5

    def test_stale_fit_reads_the_lane(self, hashes):
        """An exhausted member with a resident lane trains from it: the
        fit is marked stale and equals the offline fit on that lane."""
        _, tp = hashes
        gw = StormGateway(tp, 2, query_slots=8, ingest_slots=16,
                          privacy=ReleasePolicy(epsilon_total=1.0,
                                                on_exhaust="stale"),
                          privacy_seed=8, device=CPU)
        z = _streams(2)
        for t in range(2):
            gw.submit(IngestRequest(rid=t, tenant=t, z=z[t][:10]))
            gw.submit(QueryRequest(rid=10 + t, tenant=t, thetas=_theta(t)))
        gw.run_until_idle()
        lane = gw._release[0].clone()
        gw.submit(IngestRequest(rid=20, tenant=0, z=z[0][10:14]))
        req = FitRequest(rid=21, tenants=[0], seed=2, steps=6)
        gw.submit(req)
        fl = gw.tick_start()
        _, sub, status = fl.fits[0]
        fit = gw.tick_finish(fl).fits[0]
        assert status == fit.status == "stale"
        assert torch.equal(sub.counts[0], lane) and int(sub.n[0]) == 10
        np.testing.assert_array_equal(fit.theta, _offline_fit(
            req, sub, tp).theta.numpy())


class TestTraceBudgets:
    def test_flat_private_traffic_runs_at_most_four_bodies(self, hashes):
        gw = StormGateway(hashes[1], 3, query_slots=8, ingest_slots=16,
                          privacy=ReleasePolicy(epsilon_total=8.0,
                                                on_exhaust="stale"),
                          privacy_seed=5, device=CPU)
        gw.submit_many(_requests(port_gw, _soak_script(3, seed=4)))
        gw.submit(FitRequest(rid=10_000, tenants=[0, 1], seed=0, steps=5))
        gw.run_until_idle(max_ticks=200)
        assert gw.trace_count <= 4
        assert {sig[0] for sig in gw._signatures} == {"ingest", "private"}
        assert gw.private_view.releases > 0

    def test_tiered_private_churn_runs_at_most_five_bodies(self, hashes):
        gw = TieredStormGateway(hashes[1], 5, 2, query_slots=8,
                                ingest_slots=16, promote_per_tick=2,
                                privacy=ReleasePolicy(epsilon_total=8.0,
                                                      on_exhaust="stale"),
                                privacy_seed=6, device=CPU)
        script = _requests(port_gw, _soak_script(5, seed=5))
        gw.submit_many(script)
        results = gw.run_until_idle(max_ticks=500)
        want = {r.rid for r in script if isinstance(r, QueryRequest)}
        assert {r.rid for r in results} == want
        assert gw.trace_count <= 5
        assert gw.promotions > 0 and gw.demotions > 0
        assert set(gw.private_view.ledger.keys()) == set(range(5))


class TestWireBudgetFrames:
    def _server(self, hashes, **pol):
        gw = StormGateway(hashes[1], 2, query_slots=4, ingest_slots=16,
                          privacy=ReleasePolicy(**pol), privacy_seed=7,
                          device=CPU)
        return StormWireServer(gw, port=0).start(), gw

    def test_budget_exceeded_is_terminal_and_budget_frame_reports(
            self, hashes):
        server, _ = self._server(hashes, epsilon_total=1.0)
        client = StormWireClient(*server.address)
        try:
            z = _streams(1)[0]
            client.ingest(0, 0, z[:8])
            assert client.recv()[0]["type"] == "ingest_ok"
            client.query_sync(1, 0, _theta(1))  # spends the only release
            client.ingest(2, 0, z[8:12])  # closes the window
            assert client.recv()[0]["type"] == "ingest_ok"
            with pytest.raises(BudgetExceeded) as exc:
                client.query_sync(3, 0, _theta(2))
            assert exc.value.header["retryable"] is False
            assert exc.value.header["scope"] == "query"
            assert exc.value.header["tenant"] == 0
            budget = client.budget()
            assert budget["spent"] == {"0": 1.0}
            assert budget["remaining"] == {"0": 0.0}
            assert budget["exhausted"] == [0]
            with pytest.raises(BudgetExceeded) as exc:
                client.fit_sync(4, [0, 1], steps=5)
            assert exc.value.header["scope"] == "fit"
            assert exc.value.header["tenants"] == [0, 1]
        finally:
            client.close()
            server.stop()

    def test_stale_results_are_flagged_on_the_wire(self, hashes):
        server, _ = self._server(hashes, epsilon_total=1.0,
                                 on_exhaust="stale")
        client = StormWireClient(*server.address)
        try:
            z = _streams(1)[0]
            client.ingest(0, 0, z[:8])
            assert client.recv()[0]["type"] == "ingest_ok"
            first = client.query_sync(1, 0, _theta(1))
            client.ingest(2, 0, z[8:12])
            assert client.recv()[0]["type"] == "ingest_ok"
            client.query(3, 0, _theta(1))
            header, losses = client.recv()
            assert header["type"] == "result" and header["stale"] is True
            np.testing.assert_array_equal(losses, first)
        finally:
            client.close()
            server.stop()

    def test_budget_frame_none_without_policy(self, hashes):
        gw = StormGateway(hashes[1], 2, query_slots=4, ingest_slots=16,
                          device=CPU)
        server = StormWireServer(gw, port=0).start()
        client = StormWireClient(*server.address)
        try:
            assert client.budget() is None
        finally:
            client.close()
            server.stop()


def test_warm_bank_seeds_the_versions(hashes):
    """A warm-started private gateway starts each tenant's version at its
    bank's n, as the JAX gateway does: the first read is one release."""
    jp, tp = hashes
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 9, size=(2, ROWS, 8)).astype(np.int32)
    n = np.array([17, 0], np.int32)
    from repro.core import sketch as jsk

    jg = jgw.StormGateway(jp, 2, mode="ref",
                          bank=jsk.SketchBank(counts=jnp.asarray(counts),
                                              n=jnp.asarray(n)),
                          privacy=jprivacy.ReleasePolicy(epsilon_total=3.0),
                          privacy_seed=9)
    pg = StormGateway(tp, 2, bank=interop.sketch_bank(counts, n, CPU),
                      privacy=ReleasePolicy(epsilon_total=3.0),
                      privacy_seed=9, device=CPU)
    assert _nonzero(pg._rows_of) == _nonzero(jg._rows_of) == {0: 17}
    for gw, mod in ((jg, jgw), (pg, port_gw)):
        gw.submit(mod.QueryRequest(rid=0, tenant=0, thetas=_theta(4)))
    jres, pres = jg.run_until_idle()[0], pg.run_until_idle()[0]
    assert jres.status == pres.status == "ok"
    _check_views(pg.private_view, jg.private_view)
