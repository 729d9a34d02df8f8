"""The port's gateway stage contract: ``tick_start`` / ``tick_finish`` with
ticks in flight, backpressure, tick budgets (mirrors
``tests/test_serve_async.py``), and the pipelined port against the JAX
gateway's synchronous loop on the same request script."""

from collections import deque

import numpy as np
import pytest
import torch

from repro.serve import storm_gateway as jgw
from repro_torch.serve import storm_gateway as port_gw
from repro_torch.serve.storm_gateway import (
    Backpressure, IngestRequest, QueryRequest, StormGateway,
    TickBudgetExceeded, report_key,
)
from torch_parity import CPU, jax_params

S = 4
D = 5


@pytest.fixture(scope="module")
def hashes():
    return jax_params(0, 64, 3, D + 2)


def _script(mod, rounds=8, seed=7):
    """Per-round request lists: multi-tick ingests, empty queries, and an
    idle round mid-stream."""
    rng = np.random.default_rng(seed)
    rid = 0
    script = []
    for r in range(rounds):
        reqs = []
        if r == rounds // 2:
            script.append(reqs)
            continue
        for t in range(S):
            if rng.random() < 0.7:
                z = (rng.normal(size=(int(rng.integers(1, 40)), D)) * 0.3
                     ).astype(np.float32)
                reqs.append(mod.IngestRequest(rid=rid, tenant=t, z=z))
                rid += 1
            if rng.random() < 0.7:
                th = rng.normal(size=(int(rng.integers(0, 9)), D)).astype(
                    np.float32)
                reqs.append(mod.QueryRequest(rid=rid, tenant=t, thetas=th))
                rid += 1
        script.append(reqs)
    return script


def _drive_sync(gw, script):
    reports = []
    for reqs in script:
        gw.submit_many(reqs)
        reports.append(gw.tick())
    while gw.pending:
        reports.append(gw.tick())
    return reports


def _drive_async(gw, script, depth=2):
    reports = []
    inflight = deque()
    for reqs in script:
        gw.submit_many(reqs)
        inflight.append(gw.tick_start())
        while len(inflight) >= depth:
            reports.append(gw.tick_finish(inflight.popleft()))
    while gw.pending or inflight:
        while gw.pending and len(inflight) < depth:
            inflight.append(gw.tick_start())
        reports.append(gw.tick_finish(inflight.popleft()))
    return reports


def _gw(tp, **kw):
    kw = {"query_slots": 4, "ingest_slots": 16, **kw}
    return StormGateway(tp, S, device=CPU, **kw)


class TestAsyncEqualsSync:
    @pytest.mark.parametrize("depth,seed", [(2, 7), (3, 13)])
    def test_pipelined_equals_sync(self, hashes, depth, seed):
        _, tp = hashes
        gw_s, gw_a = _gw(tp), _gw(tp)
        rs = _drive_sync(gw_s, _script(port_gw, seed=seed))
        ra = _drive_async(gw_a, _script(port_gw, seed=seed), depth=depth)
        assert [report_key(r) for r in rs] == [report_key(r) for r in ra]
        assert torch.equal(gw_s.bank.counts, gw_a.bank.counts)
        assert torch.equal(gw_s.bank.n, gw_a.bank.n)
        assert gw_s.queue_stats() == gw_a.queue_stats()
        assert gw_a.trace_count <= 3 and gw_a.staging_waits == 0

    def test_pipelined_port_equals_the_jax_sync_loop(self, hashes):
        jp, tp = hashes
        want_gw = jgw.StormGateway(jp, S, query_slots=4, ingest_slots=16,
                                   mode="ref")
        got_gw = _gw(tp)
        want = _drive_sync(want_gw, _script(jgw, seed=21))
        got = _drive_async(got_gw, _script(port_gw, seed=21), depth=3)
        assert [report_key(r) for r in got] == [report_key(r) for r in want]
        np.testing.assert_array_equal(got_gw.bank.counts.numpy(),
                                      np.asarray(want_gw.bank.counts))

    def test_run_until_idle_pipelined_matches(self, hashes):
        _, tp = hashes
        gw_s, gw_a = _gw(tp), _gw(tp)
        for gw in (gw_s, gw_a):
            for reqs in _script(port_gw, seed=31):
                gw.submit_many(reqs)
        out_s = gw_s.run_until_idle()
        out_a = gw_a.run_until_idle(pipelined=True)
        assert [(r.rid, r.tenant) for r in out_s] == \
            [(r.rid, r.tenant) for r in out_a]
        for a, b in zip(out_s, out_a):
            np.testing.assert_array_equal(a.losses, b.losses)


class TestStageContract:
    def test_idle_tick_start_is_noop(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, device=CPU)
        c0 = gw.bank.counts.clone()
        inflight = gw.tick_start()
        assert inflight.est is None and gw.trace_count == 0
        assert torch.equal(gw.bank.counts, c0)
        report = gw.tick_finish(inflight)
        assert report.results == [] and report.rows_ingested == 0
        assert gw.ticks == 1

    def test_start_mutates_queues_and_returns_unread_tensor(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=4, device=CPU)
        gw.submit(QueryRequest(rid=0, tenant=1,
                               thetas=np.ones((3, D), np.float32)))
        inflight = gw.tick_start()
        assert gw.pending == 0  # packing happened at start
        assert isinstance(inflight.est, torch.Tensor)
        assert inflight.est.shape == (S * 4,)
        assert inflight.ready is None  # on the CPU the estimates are ready
        report = gw.tick_finish(inflight)
        assert [r.rid for r in report.results] == [0]

    def test_depth2_query_reads_prior_ticks_ingest(self, hashes):
        _, tp = hashes
        rng = np.random.default_rng(3)
        z = (rng.normal(size=(10, D)) * 0.3).astype(np.float32)
        th = rng.normal(size=(4, D)).astype(np.float32)

        gw = _gw(tp)
        gw.submit(IngestRequest(rid=0, tenant=2, z=z))
        t1 = gw.tick_start()
        gw.submit(QueryRequest(rid=1, tenant=2, thetas=th))
        t2 = gw.tick_start()  # launched while t1 is unread
        gw.tick_finish(t1)
        res = gw.tick_finish(t2).results[0]

        ref = _gw(tp)
        ref.submit(IngestRequest(rid=0, tenant=2, z=z))
        ref.tick()
        ref.submit(QueryRequest(rid=1, tenant=2, thetas=th))
        np.testing.assert_array_equal(res.losses,
                                      ref.tick().results[0].losses)

    def test_staging_ring_outlasts_the_deepest_pipeline(self, hashes):
        """More ticks in flight than staging buffers: each buffer is
        refilled only after its copy, so every tick still packs its own."""
        _, tp = hashes
        gw_s, gw_a = _gw(tp), _gw(tp)
        script = _script(port_gw, rounds=10, seed=41)
        rs = _drive_sync(gw_s, script)
        ra = _drive_async(gw_a, _script(port_gw, rounds=10, seed=41),
                          depth=port_gw.STAGING_SLOTS + 2)
        assert [report_key(r) for r in rs] == [report_key(r) for r in ra]


class TestBackpressure:
    def test_ingest_cap_enforced_with_intact_accounting(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, ingest_slots=8, max_pending_rows=12,
                          device=CPU)
        gw.submit(IngestRequest(rid=0, tenant=1,
                                z=np.zeros((10, D), np.float32)))
        with pytest.raises(Backpressure) as ei:
            gw.submit(IngestRequest(rid=1, tenant=1,
                                    z=np.zeros((5, D), np.float32)))
        e = ei.value
        assert (e.tenant, e.kind, e.pending, e.requested, e.limit) == \
            (1, "ingest", 10, 5, 12)
        assert gw._pending_rows[1] == 10
        gw.submit(IngestRequest(rid=2, tenant=0,
                                z=np.zeros((12, D), np.float32)))

    def test_query_cap_enforced(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=4, max_pending_points=6,
                          device=CPU)
        gw.submit(QueryRequest(rid=0, tenant=0,
                               thetas=np.zeros((5, D), np.float32)))
        with pytest.raises(Backpressure):
            gw.submit(QueryRequest(rid=1, tenant=0,
                                   thetas=np.zeros((2, D), np.float32)))

    def test_capacity_frees_at_pack_time(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, ingest_slots=8, max_pending_rows=8,
                          device=CPU)
        gw.submit(IngestRequest(rid=0, tenant=0,
                                z=np.zeros((8, D), np.float32)))
        with pytest.raises(Backpressure):
            gw.submit(IngestRequest(rid=1, tenant=0,
                                    z=np.zeros((1, D), np.float32)))
        inflight = gw.tick_start()  # packs all 8 rows; the budget frees now
        gw.submit(IngestRequest(rid=2, tenant=0,
                                z=np.zeros((8, D), np.float32)))
        gw.tick_finish(inflight)
        gw.run_until_idle()
        assert gw.rows_ingested == 16


class TestTraceCount:
    def test_three_signatures_and_no_more(self, hashes):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=4, ingest_slots=8, device=CPU)
        z = np.zeros((2, D), np.float32)
        th = np.zeros((2, D), np.float32)
        gw.submit(IngestRequest(rid=0, tenant=0, z=z))
        gw.tick()
        gw.submit(QueryRequest(rid=1, tenant=0, thetas=th))
        gw.tick()
        gw.submit(IngestRequest(rid=2, tenant=0, z=z))
        gw.submit(QueryRequest(rid=3, tenant=0, thetas=th))
        gw.tick()
        assert gw.trace_count == 3
        for _ in range(3):
            gw.submit(IngestRequest(rid=9, tenant=1,
                                    z=np.ones((3, D), np.float32)))
            gw.submit(QueryRequest(rid=10, tenant=1,
                                   thetas=np.ones((2, D), np.float32)))
            gw.tick()
        assert gw.trace_count == gw.queue_stats()["trace_count"] == 3


class TestTickBudget:
    @pytest.mark.parametrize("pipelined,budget", [(False, 2), (True, 3)])
    def test_budget_exception_carries_partial_results(self, hashes,
                                                      pipelined, budget):
        _, tp = hashes
        gw = StormGateway(tp, S, query_slots=4, ingest_slots=4, device=CPU)
        gw.submit(QueryRequest(rid=0, tenant=0,
                               thetas=np.ones((2, D), np.float32)))
        gw.submit(IngestRequest(rid=1, tenant=1,
                                z=np.zeros((40, D), np.float32)))  # 10 ticks
        with pytest.raises(TickBudgetExceeded) as ei:
            gw.run_until_idle(max_ticks=budget, pipelined=pipelined)
        assert ei.value.pending == 1
        assert [r.rid for r in ei.value.completed] == [0]
        gw.run_until_idle()
        assert gw.rows_ingested == 40
