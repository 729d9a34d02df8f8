"""The port's tiered store and tiered gateway against ``repro.core.tiered``
and ``repro.serve.tiered_gateway`` (mirrors ``tests/test_tiered.py`` and
``tests/test_tiered_gateway.py`` without the mesh cases).

Counters are integers throughout, so every comparison is exact. A JAX
bank's state crosses to the port through ``repro_torch.interop``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiered as jtiered
from repro.serve import storm_gateway as jgw
from repro.serve import tiered_gateway as jtgw
from repro_torch import interop
from repro_torch.core import sketch as sketch_lib
from repro_torch.core.tiered import (
    TenantStats, TieredBank, frequency_score, lru_score,
)
from repro_torch.serve import storm_gateway as port_gw
from repro_torch.serve.storm_gateway import (
    Backpressure, FitRequest, IngestRequest, QueryRequest, StormGateway,
    report_key,
)
from repro_torch.serve.tiered_gateway import TieredStormGateway
from torch_parity import CPU, jax_params, t

R, B = 8, 4  # small (R, B) table for the policy tests
D = 5


def _tables(count, dtype=torch.int16, seed=0):
    """Distinct counter tables in [0, 100), one per tenant."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 100, size=(count, R, B))).to(dtype)


def _bank_with(tenants_resident, tables):
    tb = TieredBank(num_tenants=tables.shape[0],
                    hot_capacity=len(tenants_resident), rows=R, buckets=B,
                    dtype=tables.dtype, device=CPU)
    counts = tables[list(tenants_resident)].clone()
    n = torch.tensor([10 * (t + 1) for t in tenants_resident],
                     dtype=torch.int32)
    return tb, counts, n


class TestTieredBankSwap:
    def test_promote_demote_round_trip_bit_exact(self):
        tables = _tables(3)
        tb, counts, n = _bank_with([0, 1], tables)
        counts, n, victim = tb.promote(2, counts, n, tick=1)
        assert victim == 0 and tb.is_resident(2) and not tb.is_resident(0)
        sk0 = tb.sketch_of(0, counts, n)  # its eviction is still pending
        assert torch.equal(sk0.counts, tables[0]) and int(sk0.n) == 10
        counts, n, victim = tb.promote(0, counts, n, tick=2)
        assert victim == 1
        slot = tb.slot_of[0]
        assert torch.equal(counts[slot], tables[0]) and int(n[slot]) == 10
        tb.flush_evictions()
        sk1 = tb.sketch_of(1, counts, n)
        assert torch.equal(sk1.counts, tables[1]) and int(sk1.n) == 20

    def test_promote_before_flush_uploads_the_pending_eviction(self):
        """A tenant promoted again while its eviction is still in flight
        comes back from that same buffer, without a flush."""
        tables = _tables(3)
        tb, counts, n = _bank_with([0, 1], tables)
        counts, n, _ = tb.promote(2, counts, n, tick=1)  # evicts 0
        assert 0 in tb._pending
        counts, n, victim = tb.promote(0, counts, n, tick=2)  # evicts 1
        assert victim == 1 and 0 not in tb._pending and 0 not in tb._cold
        assert torch.equal(counts[tb.slot_of[0]], tables[0])
        assert int(n[tb.slot_of[0]]) == 10

    def test_flush_through_a_tick_leaves_later_evictions_in_flight(self):
        """``flush_evictions(through_tick=t)`` lands what promotions up to
        tick ``t`` evicted (and any demotion), nothing queued later."""
        tables = _tables(4)
        tb, counts, n = _bank_with([0, 1], tables)
        counts, n, _ = tb.promote(2, counts, n, tick=1)  # evicts 0
        counts, n, victim = tb.promote(3, counts, n, tick=2)
        assert victim == 1
        assert tb.flush_evictions(through_tick=1) == 1
        assert 0 in tb._cold and 1 in tb._pending
        counts, n = tb.demote(2, counts, n)
        assert tb.flush_evictions(through_tick=1) == 1  # the demotion
        assert 2 in tb._cold and 1 in tb._pending
        assert tb.flush_evictions() == 1 and not tb._pending
        for tenant in (0, 1):
            assert torch.equal(tb._cold[tenant][0], tables[tenant])
        assert not tb._cold[2][0].any()  # 2 started cold, all zero

    def test_demote_frees_slot_and_promote_reuses_it(self):
        tables = _tables(3)
        tb, counts, n = _bank_with([0, 1], tables)
        counts, n = tb.demote(0, counts, n)
        assert not tb.is_resident(0) and tb._free_slot() == 0
        assert int(counts[0].abs().sum()) == 0 and int(n[0]) == 0
        counts, n, victim = tb.promote(2, counts, n, tick=1)
        assert victim is None and tb.slot_of[2] == 0
        assert tb.resident_tenants() == [2, 1]

    def test_never_demoted_cold_tenant_reads_as_zero(self):
        tb, counts, n = _bank_with([0], _tables(2))
        sk = tb.sketch_of(1, counts, n)
        assert int(sk.counts.abs().sum()) == 0 and int(sk.n) == 0

    def test_lru_victim_order_and_protection(self):
        tb, counts, n = _bank_with([0, 1, 2], _tables(4))
        tb.touch(0, tick=5)
        tb.touch(2, tick=3)
        assert tb.lru_victim() == 1
        assert tb.lru_victim(protect=[1]) == 2
        assert tb.lru_victim(protect=[0, 1, 2]) is None
        with pytest.raises(RuntimeError, match="protected"):
            tb.promote(3, counts, n, tick=6, protect=[0, 1, 2])

    def test_pluggable_victim_policy(self):
        tables = _tables(4)
        tb_lru, _, _ = _bank_with([0, 1, 2], tables)
        tb_lfu = TieredBank(num_tenants=4, hot_capacity=3, rows=R, buckets=B,
                            dtype=tables.dtype, score_fn=frequency_score,
                            device=CPU)
        assert tb_lru.score_fn is lru_score
        for tb in (tb_lru, tb_lfu):
            for tenant, tick in ((0, 1), (0, 4), (0, 7), (1, 6), (2, 2),
                                 (2, 3)):
                tb.touch(tenant, tick=tick)
        assert tb_lru.victim() == 2
        assert tb_lfu.victim() == 1
        assert tb_lfu.victim(protect=[1]) == 2
        assert tb_lfu.tenant_stats(2) == TenantStats(tenant=2, slot=2,
                                                     last_touch=3, touches=2)
        assert tb_lfu.tenant_stats(3) is None

    def test_swap_is_one_signature_for_all_slots(self):
        tb, counts, n = _bank_with([0, 1, 2], _tables(6))
        for tick, tenant in enumerate([3, 4, 5, 0, 1], start=1):
            counts, n, _ = tb.promote(tenant, counts, n, tick=tick)
        counts, n = tb.demote(1, counts, n)
        tb.flush_evictions()
        assert tb.swap_count == 6 and tb.trace_count == 1

    def test_rollup_matches_full_bank_merge_groups(self):
        tables = _tables(5, seed=7)
        all_n = torch.tensor([10 * (t + 1) for t in range(5)],
                             dtype=torch.int32)
        tb, counts, n = _bank_with([0, 1], tables)
        for tenant in (2, 3, 4):
            counts, n, _ = tb.promote(tenant, counts, n, tick=tenant)
            slot = tb.slot_of[tenant]
            counts[slot] = tables[tenant]
            n[slot] = all_n[tenant]
        tb.flush_evictions()
        assignment = np.asarray([0, 1, 0, 1, 0], np.int32)
        want = sketch_lib.SketchBank(counts=tables, n=all_n).merge_groups(
            assignment, num_groups=2)
        for _ in range(2):  # the second reads the cached cold half
            got = tb.rollup(assignment, counts, n)
            assert torch.equal(got.counts, want.counts)
            assert torch.equal(got.n, want.n)

    def test_footprint_accounting(self):
        tb = TieredBank(num_tenants=8, hot_capacity=2, rows=R, buckets=B,
                        dtype=torch.int8, device=CPU)
        assert tb.resident_bytes() == 2 * R * B * 1 + 4 * 2
        assert tb.cold_bytes() == 0
        assert tb.stats()["resident"] == 2


def _jax_bank_with(tenants_resident, tables, score_fn=None):
    jt = jnp.asarray(tables.numpy())
    tb = jtiered.TieredBank(num_tenants=tables.shape[0],
                            hot_capacity=len(tenants_resident), rows=R,
                            buckets=B, dtype=jt.dtype, score_fn=score_fn)
    counts = jt[jnp.asarray(tenants_resident)]
    n = jnp.asarray([10 * (t + 1) for t in tenants_resident], jnp.int32)
    return tb, counts, n


def _state(jtb):
    """A JAX TieredBank's state, as ``interop.tiered_bank`` takes it."""
    jtb.flush_evictions()
    return dict(
        num_tenants=jtb.num_tenants, hot_capacity=jtb.hot_capacity,
        rows=jtb.rows, buckets=jtb.buckets, dtype=jtb.dtype,
        slot_tenant=list(jtb.slot_tenant),
        cold={tn: (np.asarray(c), int(cn)) for tn, (c, cn)
              in jtb._cold.items()},
        last_touch=list(jtb._last_touch), touches=list(jtb._touches),
        swap_count=jtb.swap_count)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int8])
def test_swaps_equal_the_jax_bank_from_carried_state(dtype):
    """A JAX bank mid-life (a spill made) crosses to the port; the same
    touches, promotions and demotions then give the same slot maps,
    victims, resident tables and cold tables on both."""
    tables = _tables(6, dtype=dtype, seed=3)
    jtb, jc, jn = _jax_bank_with([0, 1, 2], tables)
    jc, jn, _ = jtb.promote(4, jc, jn, tick=1)
    tb = interop.tiered_bank(**_state(jtb), device=CPU)
    bank = interop.sketch_bank(np.asarray(jc), np.asarray(jn), device=CPU)
    counts, n = bank.counts, bank.n
    steps = [("touch", 2, 3), ("promote", 5, 4), ("promote", 0, 5),
             ("demote", 2, None), ("promote", 3, 6), ("touch", 3, 7),
             ("promote", 1, 8), ("promote", 2, 9)]
    for op, tenant, tick in steps:
        if op == "touch":
            jtb.touch(tenant, tick)
            tb.touch(tenant, tick)
        elif op == "promote":
            jc, jn, jv = jtb.promote(tenant, jc, jn, tick=tick)
            counts, n, v = tb.promote(tenant, counts, n, tick=tick)
            assert v == jv
        else:
            jc, jn = jtb.demote(tenant, jc, jn)
            counts, n = tb.demote(tenant, counts, n)
        assert tb.slot_tenant == jtb.slot_tenant
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    state = interop.tiered_to_numpy(tb)
    want = _state(jtb)
    assert state["slot_tenant"] == want["slot_tenant"]
    assert state["last_touch"] == want["last_touch"]
    assert state["touches"] == want["touches"]
    assert state["swap_count"] == want["swap_count"]
    assert sorted(state["cold"]) == sorted(want["cold"])
    for tenant, (c, cn) in want["cold"].items():
        np.testing.assert_array_equal(state["cold"][tenant][0], c)
        assert state["cold"][tenant][1] == cn
    assert tb.stats() == jtb.stats()
    assignment = np.arange(6, dtype=np.int32) % 2
    np.testing.assert_array_equal(
        tb.rollup(assignment, counts, n).counts.numpy(),
        np.asarray(jtb.rollup(assignment, jc, jn).counts))


# ---------------------------------------------------------------------------
# The tiered gateway
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hashes():
    return jax_params(0, 64, 3, D + 2)


def _streams(tenants, n_base=23, step=7, seed=10):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(n_base + step * i, D))).astype(np.float32)
            for i in range(tenants)]


def _soak_script(mod, tenants, seed=0, chunk=9, queries=3):
    """A deterministic shuffled mix of ingest chunks and queries."""
    rng = np.random.default_rng(seed)
    rids = itertools.count()
    reqs = []
    for tn, z in enumerate(_streams(tenants)):
        for off in range(0, len(z), chunk):
            reqs.append(mod.IngestRequest(rid=next(rids), tenant=tn,
                                          z=z[off:off + chunk]))
        for _ in range(queries):
            th = rng.normal(size=(4, D)).astype(np.float32)
            reqs.append(mod.QueryRequest(rid=next(rids), tenant=tn,
                                         thetas=th))
    order = rng.permutation(len(reqs))
    return [reqs[i] for i in order]


def _tiered(tp, t=6, h=2, dtype=torch.int16, **kw):
    kw = {"query_slots": 8, "ingest_slots": 16, "promote_per_tick": 2, **kw}
    return TieredStormGateway(tp, t, h, count_dtype=dtype, device=CPU, **kw)


def _ticked(gw, script, per_tick=5):
    reports = []
    for off in range(0, len(script), per_tick):
        gw.submit_many(script[off:off + per_tick])
        reports.append(gw.tick())
    while gw.pending:
        reports.append(gw.tick())
    return reports


@pytest.mark.parametrize("dtype", [torch.int16, torch.int8])
def test_tiered_gateway_equals_the_jax_tiered_gateway(hashes, dtype):
    """Churn (T = 6 over H = 2): every report, every final sketch, the
    residency map and the tier stats equal the JAX tiered gateway's."""
    jp, tp = hashes
    jdt = {torch.int16: jnp.int16, torch.int8: jnp.int8}[dtype]
    want_gw = jtgw.TieredStormGateway(jp, 6, 2, query_slots=8,
                                      ingest_slots=16, count_dtype=jdt,
                                      mode="ref", promote_per_tick=2)
    got_gw = _tiered(tp, dtype=dtype)
    want = _ticked(want_gw, _soak_script(jgw, 6, seed=3))
    got = _ticked(got_gw, _soak_script(port_gw, 6, seed=3))
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    assert got_gw.tiers.slot_tenant == want_gw.tiers.slot_tenant
    for tn in range(6):
        np.testing.assert_array_equal(
            got_gw.sketch_of(tn).counts.numpy(),
            np.asarray(want_gw.sketch_of(tn).counts))
    stats = got_gw.queue_stats()
    assert stats["tier"] == want_gw.queue_stats()["tier"]
    assert stats["tier"]["swap_count"] > 0


class TestAllHot:
    @pytest.mark.parametrize("dtype", [torch.int16, torch.int8])
    def test_soaked_ticks_match_flat_gateway(self, hashes, dtype):
        _, tp = hashes
        flat = StormGateway(tp, 4, query_slots=8, ingest_slots=16,
                            count_dtype=dtype, device=CPU)
        tiered = _tiered(tp, t=4, h=4, dtype=dtype)
        script = _soak_script(port_gw, 4, seed=1)
        for off in range(0, len(script), 5):
            flat.submit_many(script[off:off + 5])
            tiered.submit_many(script[off:off + 5])
            assert report_key(flat.tick()) == report_key(tiered.tick())
            assert torch.equal(flat.bank.counts, tiered.resident_bank.counts)
        flat.run_until_idle()
        tiered.run_until_idle()
        assert torch.equal(flat.bank.n, tiered.resident_bank.n)
        assert tiered.tiers.swap_count == 0 and tiered.trace_count <= 3


class TestMixedHotCold:
    def _drain(self, tp, dtype=torch.int16, seed=3, pipelined=False, t=6):
        gw = _tiered(tp, t=t, dtype=dtype)
        script = _soak_script(port_gw, t, seed=seed)
        gw.submit_many(script)
        results = gw.run_until_idle(max_ticks=500, pipelined=pipelined)
        return gw, script, results

    def test_all_requests_complete_with_global_ids(self, hashes):
        gw, script, results = self._drain(hashes[1])
        want = {r.rid for r in script if isinstance(r, QueryRequest)}
        assert {r.rid for r in results} == want
        rid_tenant = {r.rid: r.tenant for r in script}
        assert all(res.tenant == rid_tenant[res.rid] for res in results)
        assert gw.pending == 0 and not gw._rid_tenant
        assert gw.promotions > 0 and gw.demotions > 0

    def test_final_sketches_match_always_resident(self, hashes):
        _, tp = hashes
        gw, _, _ = self._drain(tp)
        for tn, z in enumerate(_streams(gw.num_tenants)):
            sk = gw.sketch_of(tn)
            want = sketch_lib.sketch_dataset(tp, t(z), engine="scan",
                                             dtype=torch.int16, device=CPU)
            assert torch.equal(sk.counts, want.counts)
            assert int(sk.n) == len(z)

    def test_four_signatures_under_churn(self, hashes):
        gw, _, _ = self._drain(hashes[1])
        assert gw.tiers.swap_count > 0 and gw.tiers.trace_count == 1
        assert gw.trace_count == gw.gw.trace_count + 1 <= 4

    @pytest.mark.parametrize("dtype,depth", [(torch.int16, 2),
                                             (torch.int8, 3)])
    def test_pipelined_drain_matches_sync(self, hashes, dtype, depth):
        _, tp = hashes
        gw_s, _, res_s = self._drain(tp, dtype=dtype, seed=4)
        gw_p = _tiered(tp, dtype=dtype)
        gw_p.submit_many(_soak_script(port_gw, 6, seed=4))
        res_p = gw_p.run_until_idle(max_ticks=500, pipelined=True,
                                    depth=depth)
        assert [(r.rid, r.tenant) for r in res_s] == \
            [(r.rid, r.tenant) for r in res_p]
        for tn in range(6):
            assert torch.equal(gw_s.sketch_of(tn).counts,
                               gw_p.sketch_of(tn).counts)
        assert gw_p.trace_count <= 4

    def test_single_slot_rotation_terminates(self, hashes):
        _, tp = hashes
        gw = _tiered(tp, t=3, h=1, promote_per_tick=1, query_slots=4,
                     ingest_slots=8)
        rng = np.random.default_rng(5)
        rids = itertools.count()
        for tn in range(3):
            gw.submit(IngestRequest(rid=next(rids), tenant=tn,
                                    z=rng.normal(size=(6, D)).astype(
                                        np.float32) * 0.1))
            gw.submit(QueryRequest(rid=next(rids), tenant=tn,
                                   thetas=rng.normal(size=(2, D)).astype(
                                       np.float32)))
        assert len(gw.run_until_idle(max_ticks=100)) == 3
        assert gw.pending == 0 and gw.trace_count <= 4

    def test_finishing_a_tick_leaves_the_next_ticks_eviction_in_flight(
            self, hashes):
        """Pipelined, ``tick_finish(t)`` does not wait for the swap that
        ``tick_start(t + 1)`` queued behind its own body."""
        _, tp = hashes
        gw = _tiered(tp, t=4, h=2, promote_per_tick=1)
        streams = _streams(4)
        for rid, tn in enumerate([2, 3]):  # both start cold
            gw.submit(IngestRequest(rid=rid, tenant=tn, z=streams[tn][:8]))
        first = gw.tick_start()  # promotes 2, evicting 0
        second = gw.tick_start()  # promotes 3, evicting 1
        assert gw.tiers.stats()["pending_evictions"] == 2
        gw.tick_finish(first)
        assert gw.tiers._pending.keys() == {1}
        gw.tick_finish(second)
        assert gw.tiers.stats()["pending_evictions"] == 0
        gw.run_until_idle(max_ticks=50)
        for tn in (2, 3):
            want = sketch_lib.sketch_dataset(tp, t(streams[tn][:8]),
                                             engine="scan",
                                             dtype=torch.int16, device=CPU)
            assert torch.equal(gw.sketch_of(tn).counts, want.counts)

    def test_cold_promotion_preserves_prior_ingest(self, hashes):
        _, tp = hashes
        gw = _tiered(tp, t=3, h=2, promote_per_tick=1, query_slots=4,
                     ingest_slots=32)
        z = _streams(3)[2]  # tenant 2 starts cold
        gw.submit(IngestRequest(rid=0, tenant=2, z=z[:10]))
        gw.run_until_idle(max_ticks=50)
        assert gw.tiers.is_resident(2)
        for rid, tn in enumerate([0, 1], start=1):
            gw.submit(IngestRequest(rid=rid, tenant=tn, z=_streams(3)[tn][:8]))
        gw.run_until_idle(max_ticks=50)
        gw.submit(IngestRequest(rid=9, tenant=2, z=z[10:]))
        gw.run_until_idle(max_ticks=50)
        want = sketch_lib.sketch_dataset(tp, t(z), engine="scan",
                                         dtype=torch.int16, device=CPU)
        assert torch.equal(gw.sketch_of(2).counts, want.counts)
        assert int(gw.sketch_of(2).n) == len(z)

    def test_rollup_never_promotes(self, hashes):
        _, tp = hashes
        gw, _, _ = self._drain(tp)
        resident = sorted(gw.tiers.resident_tenants())
        swaps = gw.tiers.swap_count
        assignment = np.arange(gw.num_tenants, dtype=np.int32) % 2
        got = gw.rollup(assignment, num_groups=2)
        acc = np.zeros((2, tp.rows, tp.buckets), np.int64)
        acc_n = np.zeros((2,), np.int64)
        for tn in range(gw.num_tenants):
            sk = gw.sketch_of(tn)
            acc[assignment[tn]] += sk.counts.numpy().astype(np.int64)
            acc_n[assignment[tn]] += int(sk.n)
        np.testing.assert_array_equal(
            got.counts.numpy(), np.clip(acc, -32768, 32767).astype(np.int16))
        np.testing.assert_array_equal(got.n.numpy(), acc_n)
        assert sorted(gw.tiers.resident_tenants()) == resident
        assert gw.tiers.swap_count == swaps

    def test_mixed_hot_cold_cohort_fit_matches_offline(self, hashes):
        from repro_torch.core import dfo, erm
        from repro_torch.device import generator

        _, tp = hashes
        gw = _tiered(tp, t=4, h=2, promote_per_tick=1, query_slots=4,
                     ingest_slots=64)
        streams = _streams(4)
        for tn, z in enumerate(streams):
            gw.submit(IngestRequest(rid=tn, tenant=tn, z=z))
        gw.run_until_idle(max_ticks=200)
        cohort = [0, 1, 2, 3]
        assert set(cohort) - set(gw.tiers.resident_tenants())
        swaps = gw.tiers.swap_count
        req = FitRequest(rid=70, tenants=cohort, seed=4, steps=10)
        gw.submit(req)
        fit = gw.tick().fits[0]
        assert gw.tiers.swap_count == swaps  # nobody promoted for the fit
        sks = [sketch_lib.sketch_dataset(tp, t(z), engine="scan",
                                         dtype=torch.int16, device=CPU)
               for z in streams]
        bank = sketch_lib.SketchBank(
            counts=torch.stack([s.counts.to(torch.int32) for s in sks]),
            n=torch.stack([s.n for s in sks]))
        want = erm.fit_many(
            req.surrogate, bank, tp,
            dfo.DFOConfig(steps=req.steps, num_queries=req.num_queries,
                          sigma=req.sigma, learning_rate=req.learning_rate,
                          decay=req.decay),
            generator=generator(req.seed, CPU), device=CPU)
        np.testing.assert_array_equal(fit.theta, want.theta.numpy())
        np.testing.assert_array_equal(fit.fleet_losses,
                                      want.fleet_losses.numpy())
        assert gw.fits_run == 1 and gw.trace_count <= 4


class TestCapsAndStats:
    def test_backpressure_counts_cold_queue(self, hashes):
        gw = _tiered(hashes[1], t=4, h=2, ingest_slots=8, max_pending_rows=10)
        gw.submit(IngestRequest(rid=0, tenant=3,
                                z=np.zeros((8, D), np.float32)))
        with pytest.raises(Backpressure):
            gw.submit(IngestRequest(rid=1, tenant=3,
                                    z=np.zeros((3, D), np.float32)))
        gw.submit(IngestRequest(rid=2, tenant=0,
                                z=np.zeros((3, D), np.float32)))

    def test_validation(self, hashes):
        gw = _tiered(hashes[1], t=3, h=2)
        with pytest.raises(ValueError, match="out of range"):
            gw.submit(IngestRequest(rid=0, tenant=3,
                                    z=np.zeros((1, D), np.float32)))
        with pytest.raises(ValueError, match="cohort is empty"):
            gw.submit(FitRequest(rid=0, tenants=[]))
        with pytest.raises(ValueError, match="out of range"):
            gw.submit(FitRequest(rid=0, tenants=[3]))
        with pytest.raises(ValueError, match="insert flavor"):
            gw.submit(FitRequest(rid=0, tenants=[0], surrogate="kmeans"))
        assert gw.pending == 0

    def test_queue_stats_global_tenant_space(self, hashes):
        _, tp = hashes
        gw = _tiered(tp, t=4, h=2, query_slots=4, ingest_slots=8)
        gw.submit(IngestRequest(rid=0, tenant=0,
                                z=np.zeros((3, D), np.float32)))
        gw.submit(QueryRequest(rid=1, tenant=3,
                               thetas=np.zeros((2, D), np.float32)))
        stats = gw.queue_stats()
        assert stats["tenants"] == 4
        assert stats["pending_depth"] == [1, 0, 0, 1]
        assert stats["pending_rows"] == [3, 0, 0, 0]
        assert stats["pending_points"] == [0, 0, 0, 2]
        tier = stats["tier"]
        assert tier["hot_capacity"] == 2 and tier["resident"] == 2
        assert tier["cold_queued"] == 1
        gw.run_until_idle(max_ticks=20)
        after = gw.queue_stats()
        assert after["pending_depth"] == [0] * 4
        assert after["tier"]["promotions"] == 1
