"""The port's tracer (``repro_torch.tracing``) and the spans and counters
the gateway, the telemetry bridge and the taps record.

The tracer records nothing while off, nests spans per thread, counts what a
full buffer drops and forgets everything on ``reset()``. With it on, a few
pipelined gateway ticks record their stages under ``gateway.tick_start``,
one ``gateway.queue_wait`` per ingest request and the bytes each tick
copies to the device and writes into its staging, and serve exactly what
they serve with it off; a
bridge flush nests its stages and sends the same rows. Under
``torch.profiler`` the tracer is on by itself, and its stamps lie inside
the profiler's own host ranges: one clock. A dropless MoE layer records
its four stages, its routed rows and, on the device, a tally of rows per
(layer, expert) that equals a count of its routing.
"""

import gc
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.configs import registry
from repro_torch.core import lsh, probes
from repro_torch.device import generator
from repro_torch.models import model, moe
from repro_torch.serve import storm_gateway as port_gw
from repro_torch.serve.storm_gateway import (
    FitRequest, IngestRequest, QueryRequest, StormGateway, report_key,
)
from repro_torch.telemetry import TapBatch, TapConfig, TelemetryBridge
from repro_torch.telemetry.taps import extract_tap_features

S, D, ROWS, PLANES = 4, 5, 64, 3
I_SLOTS, Q_SLOTS = 16, 4


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _by_name(recs, name):
    return recs[recs["name"] == name]


# -- the tracer ---------------------------------------------------------------


def test_off_records_nothing():
    assert not tracing.on()
    with tracing.span("a", 1):
        tracing.record("b", 1, 2, 3)
        tracing.add("c", 4)
    assert tracing.records().size == 0
    assert tracing.counters() == {}
    assert tracing.summary() == {"spans": {}, "counters": {}, "dropped": 0}


def test_spans_nest_and_carry_their_keys():
    tracing.enable()
    with tracing.span("outer", 7):
        with tracing.span("inner", 7):
            start = tracing.now()
            tracing.record("stamped", start, tracing.now() + 1, 9)
        with tracing.span("inner"):
            pass
    with tracing.span("outer", 8):
        pass
    tracing.add("c", 2)
    tracing.add("c", 3)
    recs = tracing.records()
    assert list(recs["name"]) == ["outer", "inner", "stamped", "inner",
                                  "outer"]
    outer, inner, stamped, inner2, outer2 = recs
    assert outer["parent"] == -1 and outer2["parent"] == -1
    assert inner["parent"] == outer["id"] == inner2["parent"]
    assert stamped["parent"] == inner["id"] and stamped["key"] == 9
    assert list(recs["key"]) == [7, 7, 9, -1, 8]
    for child in (inner, inner2):
        assert outer["start_ns"] <= child["start_ns"] <= child["end_ns"] \
            <= outer["end_ns"]
    assert tracing.counters() == {"c": 5}
    summary = tracing.summary()
    assert summary["spans"]["inner"]["count"] == 2
    assert summary["spans"]["outer"]["total_ms"] == pytest.approx(
        float((recs["end_ns"] - recs["start_ns"])[[0, 4]].sum()) / 1e6)


def test_full_buffer_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    tracing.reset()
    tracing.enable()
    with tracing.span("kept"):
        for _ in range(5):
            with tracing.span("child"):
                pass
    recs = tracing.records()
    assert list(recs["name"]) == ["kept", "child", "child", "child"]
    assert tracing.summary()["dropped"] == 2


def test_a_collection_under_the_lock_returns(monkeypatch):
    # A collection runs wherever an allocation triggers it, also inside the
    # tracer's own ``with _lock:`` blocks; its span must take no lock, even
    # when the buffer is full and the span is a drop.
    monkeypatch.setattr(tracing, "CAPACITY", 2)
    tracing.reset()
    tracing.enable()
    for _ in range(3):
        with tracing.span("fill"):
            pass
    assert tracing.summary()["dropped"] == 1

    def collect_under_the_lock():
        with tracing._lock:
            gc.collect()

    th = threading.Thread(target=collect_under_the_lock, daemon=True)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    assert tracing.summary()["dropped"] >= 2


def test_reset_clears_everything():
    tracing.enable()
    with tracing.span("a"):
        tracing.add("c", 1)
    tracing.reset()
    assert tracing.records().size == 0
    assert tracing.counters() == {}
    with tracing.span("b"):
        pass
    assert list(tracing.records()["id"]) == [0]


def test_threads_nest_apart_and_lose_no_update():
    tracing.enable()
    threads, per = 8, 200
    barrier = threading.Barrier(threads)

    def work(k):
        barrier.wait(timeout=10)
        for _ in range(per):
            with tracing.span("t.outer", k):
                with tracing.span("t.inner", k):
                    tracing.add("n", 1)

    pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in pool)
    recs = tracing.records()
    inner, outer = _by_name(recs, "t.inner"), _by_name(recs, "t.outer")
    assert inner.size == outer.size == threads * per
    key_of = dict(zip(outer["id"], outer["key"]))
    assert all(key_of[p] == k for p, k in zip(inner["parent"], inner["key"]))
    assert tracing.counters() == {"n": threads * per}


def test_garbage_collection_is_a_span_while_on():
    gc.collect()
    assert tracing.records().size == 0
    tracing.enable()
    with tracing.span("work"):
        gc.collect()
    recs = tracing.records()
    (work,) = _by_name(recs, "work")
    collections = _by_name(recs, "host.gc")
    assert collections.size >= 1
    assert (collections["parent"] == work["id"]).all()


# -- the gateway -------------------------------------------------------------


@pytest.fixture(scope="module")
def hashes():
    return lsh.init_srp(generator(3, "cpu"), ROWS, PLANES, D + 2,
                        device="cpu")


def _script(seed=0, rounds=5):
    """Per-round requests: ingests (some beyond a tick's slots), queries,
    and a fit in the third round."""
    rng = np.random.default_rng(seed)
    rid = 0
    script = []
    for r in range(rounds):
        reqs = []
        for tenant in range(S):
            z = (0.3 * rng.normal(size=(int(rng.integers(1, 40)), D))
                 ).astype(np.float32)
            reqs.append(IngestRequest(rid, tenant, z))
            rid += 1
            if rng.random() < 0.6:
                reqs.append(QueryRequest(rid, tenant, rng.normal(
                    size=(int(rng.integers(1, 6)), D)).astype(np.float32)))
                rid += 1
        if r == 2:
            reqs.append(FitRequest(rid, [0, 1], steps=4, num_queries=2))
            rid += 1
        script.append(reqs)
    return script


def _serve(hashes, script, depth=2):
    """The script through a pipelined gateway: reports' keys, the live
    counters and ``queue_stats()``."""
    gw = StormGateway(hashes, S, query_slots=Q_SLOTS, ingest_slots=I_SLOTS,
                      device="cpu")
    keys, inflight = [], []
    for reqs in script:
        gw.submit_many(reqs)
        inflight.append(gw.tick_start())
        if len(inflight) >= depth:
            keys.append(report_key(gw.tick_finish(inflight.pop(0))))
    while inflight:
        keys.append(report_key(gw.tick_finish(inflight.pop(0))))
    while gw.pending:
        keys.append(report_key(gw.tick()))
    return keys, gw.bank.counts.clone(), gw.bank.n.clone(), gw.queue_stats()


def test_gateway_spans_nest_under_their_tick(hashes):
    script = _script()
    tracing.enable()
    keys, *_ = _serve(hashes, script)
    recs = tracing.records()
    by_id = {int(r["id"]): r for r in recs}
    starts = _by_name(recs, "gateway.tick_start")
    finishes = _by_name(recs, "gateway.tick_finish")
    assert list(starts["key"]) == list(range(1, len(keys) + 1))
    assert sorted(finishes["key"]) == list(starts["key"])
    assert (starts["parent"] == -1).all()

    def root(r):
        while r["parent"] >= 0:
            r = by_id[int(r["parent"])]
        return r

    # On the CPU no event stands between a tick and its readback, so
    # gateway.wait (and gateway.staging_wait) record only on the card.
    for name, top in (("gateway.stage", "gateway.tick_start"),
                      ("gateway.launch", "gateway.tick_start"),
                      ("gateway.queue_wait", "gateway.tick_start"),
                      ("gateway.wait", "gateway.tick_finish"),
                      ("gateway.fit", "gateway.tick_finish")):
        got = _by_name(recs, name)
        assert got.size or name == "gateway.wait", name
        for r in got:
            parent = root(r)
            assert parent["name"] == top, name
            assert r["end_ns"] <= parent["end_ns"]
            if name == "gateway.queue_wait":
                continue  # stamped at submit, before its tick started
            assert parent["start_ns"] <= r["start_ns"]
            assert r["key"] == parent["key"], name
    # One queue wait per ingest request, keyed by its rid.
    ingests = [q.rid for reqs in script for q in reqs
               if isinstance(q, IngestRequest)]
    assert sorted(_by_name(recs, "gateway.queue_wait")["key"]) == ingests
    assert _by_name(recs, "gateway.fit").size == 1


def test_gateway_counts_the_bytes_it_copies(hashes):
    tracing.enable()
    keys, *_ = _serve(hashes, _script())
    # A tick ships the ingest half (rows and mask) if it packed rows, the
    # query half if it packed points, in one copy of float32 words.
    ingest_words = S * I_SLOTS * (D + 1)
    query_words = S * Q_SLOTS * (D + 1)
    want = sum(4 * (ingest_words * (rows > 0) + query_words * (points > 0))
               for _, rows, points, *_ in keys)
    rows = sum(k[1] for k in keys)
    counters = tracing.counters()
    assert counters.pop("gateway.staged_bytes") > 0  # the next test's
    assert counters == {"gateway.h2d_bytes": want,
                        "gateway.rows_packed": rows}


def test_gateway_counts_the_bytes_it_stages(hashes):
    """``gateway.staged_bytes`` a tick: float32 words of its rows and their
    mask ones and of the mask slots it clears (those its buffer's last
    ingest stage filled beyond this tick's fills). Queries stage nothing
    into the ingest half and count nothing."""
    tracing.enable()
    gw = StormGateway(hashes, S, query_slots=Q_SLOTS, ingest_slots=I_SLOTS,
                      device="cpu")
    full = [I_SLOTS] * S
    # Per tick: rows and query points a tenant. The ring's first round
    # is full; the fifth tick reuses buffer 0 full again; the query-only
    # eighth tick takes buffer 3 and leaves its fills alone.
    ticks = [(full, None)] * port_gw.STAGING_SLOTS + [
        (full, None), ([3, 0, 16, 9], None), ([5, 5, 5, 5], [1, 0, 4, 0]),
        ([0] * S, [2, 0, 4, 0]), ([0, 0, 0, 1], None), ([16, 16, 0, 0], None),
        ([1, 1, 1, 1], [0, 3, 0, 0]), ([2, 2, 2, 2], None)]
    rng = np.random.default_rng(6)
    old = np.zeros((port_gw.STAGING_SLOTS, S), np.int64)
    k, rid, got, want = 0, 0, [], []
    for rows, points in ticks:
        for tenant in range(S):
            if rows[tenant]:
                gw.submit(IngestRequest(rid, tenant, (0.3 * rng.normal(
                    size=(rows[tenant], D))).astype(np.float32)))
                rid += 1
            if points and points[tenant]:
                gw.submit(QueryRequest(rid, tenant, rng.normal(
                    size=(points[tenant], D)).astype(np.float32)))
                rid += 1
        before = tracing.counters().get("gateway.staged_bytes", 0)
        gw.tick()
        got.append(tracing.counters()["gateway.staged_bytes"] - before)
        words = 0
        if any(rows):
            fill = np.array(rows)
            words += (fill.sum() * (D + 1)
                      + np.maximum(old[k] - fill, 0).sum())
            old[k] = fill
        want.append(4 * int(words))
        k = (k + 1) % port_gw.STAGING_SLOTS
    assert got == want
    assert got[7] == 0  # the query-only tick
    # A full tick into a buffer whose last fill was full clears nothing.
    assert got[port_gw.STAGING_SLOTS] == 4 * S * I_SLOTS * (D + 1)
    # [3, 0, 16, 9] into buffer 1 after a full tick clears 13 + 16 + 7.
    assert got[5] == 4 * (28 * (D + 1) + 36)


def test_tracing_changes_nothing_the_gateway_serves(hashes):
    script = _script(seed=1)
    off = _serve(hashes, script)
    assert tracing.records().size == 0
    tracing.enable()
    on = _serve(hashes, script)
    assert tracing.records().size > 0
    assert on[0] == off[0]
    assert torch.equal(on[1], off[1]) and torch.equal(on[2], off[2])
    assert on[3] == off[3]


# -- the bridge and the taps -------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    cfg = registry.get_config("qwen2-7b", smoke=True)
    return cfg, model.init_params(None, cfg, device="cpu")


def _flush(cfg, seed=0):
    """Two tap windows through a bridge over a 2-tenant gateway: the rows
    it submitted and the counters it served."""
    pcfg = probes.ProbeConfig(rows=ROWS, planes=PLANES, engine="kernel")
    params = lsh.init_srp(generator(5, "cpu"), ROWS, PLANES, cfg.d_model + 3,
                          device="cpu")
    gw = StormGateway(params, 2, ingest_slots=64, device="cpu")
    sent, submit = [], gw.submit
    gw.submit = lambda req: (sent.append(req.z), submit(req))
    bridge = TelemetryBridge(gw, pcfg, window=24)
    sink = bridge.register(TapConfig(model="m", layers=(0, 1)), cfg)
    rng = np.random.default_rng(seed)
    for step in range(4):
        sink(TapBatch("m", step, rng.normal(size=(2, 12, cfg.d_model)
                                            ).astype(np.float32),
                      rng.normal(size=(12,)).astype(np.float32),
                      np.ones(12, bool)))
    return sent, gw.bank.counts.clone()


def test_bridge_flush_nests_and_sends_the_same_rows(lm):
    cfg, _ = lm
    sent_off, counts_off = _flush(cfg)
    tracing.enable()
    sent_on, counts_on = _flush(cfg)
    assert len(sent_on) == len(sent_off) == 4
    assert all(np.array_equal(a, b) for a, b in zip(sent_on, sent_off))
    assert torch.equal(counts_on, counts_off)
    recs = tracing.records()
    by_id = {int(r["id"]): r for r in recs}
    flushes = _by_name(recs, "bridge.flush")
    assert flushes.size == 2 and (flushes["parent"] == -1).all()
    for name, count in (("bridge.standardize", 4), ("bridge.readback", 4),
                        ("bridge.drain", 2)):
        got = _by_name(recs, name)
        assert got.size == count, name
        assert set(got["parent"]) <= set(flushes["id"]), name
    drains = set(_by_name(recs, "bridge.drain")["id"])
    for r in _by_name(recs, "gateway.tick_start"):
        assert by_id[int(r["parent"])]["id"] in drains


def test_taps_extract_is_one_span(lm):
    cfg, params = lm
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 5)))
    tap = TapConfig(model="m", layers=(1,))
    off = extract_tap_features(params, cfg, {"tokens": toks}, tap)
    tracing.enable()
    on = extract_tap_features(params, cfg, {"tokens": toks}, tap)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert list(tracing.records()["name"]) == ["taps.extract"]


# -- the clock ---------------------------------------------------------------


def test_spans_share_the_profilers_clock(hashes):
    """Under the profiler the tracer records without ``enable()``; a
    program span inside a ``record_function`` range lies within that
    range's Kineto stamps, and the program adds no profiler range."""
    gw = StormGateway(hashes, S, query_slots=Q_SLOTS, ingest_slots=I_SLOTS,
                      device="cpu")
    for reqs in _script(seed=2, rounds=3):
        gw.submit_many(reqs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with record_function(f"outer.{k}"):
                gw.tick()
    assert not tracing.on()
    recs = tracing.records()
    ticks = _by_name(recs, "gateway.tick_start")
    assert ticks.size == 3
    ranges = {}
    names = set()
    for e in prof.profiler.kineto_results.events():
        names.add(e.name())
        if e.name().startswith("outer."):
            ranges[int(e.name()[6:])] = (e.start_ns(),
                                         e.start_ns() + e.duration_ns())
    for k, r in enumerate(ticks):
        lo, hi = ranges[k]
        assert lo <= r["start_ns"] <= r["end_ns"] <= hi
    assert not names & set(recs["name"])


# -- the dropless MoE ---------------------------------------------------------

MOE_CFG = registry.get_config("nemotron-3-nano-30b-a3b", smoke=True)
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def _moe_layer(seed=0, layer=3):
    """One dropless layer of the smoke config over 2 x 12 tokens: its
    output and its chosen experts."""
    c = MOE_CFG
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_dropless(gen, c.d_model, c.d_ff, c.num_experts,
                          c.moe_shared_d_ff, torch.float32)
    p["router_bias"] = 0.1 * torch.randn(c.num_experts, generator=gen)
    x = torch.randn((2, 12, c.d_model), generator=gen)
    with torch.no_grad(), moe.record_choices() as got:
        y = moe.dropless_moe(p, x, experts_per_token=c.experts_per_token,
                             routed_scale=c.moe_routed_scale,
                             compute_dtype=torch.float32, layer=layer,
                             num_layers=c.num_layers)
    return y, got[0]


def test_moe_stages_and_rows_recorded_while_on():
    tracing.enable()
    _moe_layer()
    recs = tracing.records()
    assert list(recs["name"]) == list(MOE_SPANS)
    assert (recs["parent"] == -1).all()
    assert (recs["start_ns"][1:] >= recs["end_ns"][:-1]).all()
    assert tracing.counters() == {
        "moe.routed_rows": 2 * 12 * MOE_CFG.experts_per_token}


def test_moe_off_records_nothing_and_computes_the_same():
    off, _ = _moe_layer()
    assert tracing.records().size == 0
    assert tracing.counters() == {} and tracing.tallies() == {}
    tracing.enable()
    on, _ = _moe_layer()
    assert torch.equal(on, off)


def test_moe_tally_matches_a_bincount_of_the_routing():
    tracing.enable()
    _, a = _moe_layer(seed=0, layer=3)
    _, b = _moe_layer(seed=1, layer=3)
    _, c = _moe_layer(seed=2, layer=6)
    tally = tracing.tallies()["moe.expert_rows"]
    e = MOE_CFG.num_experts
    assert tally.shape == (MOE_CFG.num_layers, e)
    assert tally.dtype == torch.int64
    count = lambda idx: torch.bincount(idx.flatten(), minlength=e)
    assert torch.equal(tally[3], count(a) + count(b))
    assert torch.equal(tally[6], count(c))
    assert int(tally.sum()) == 3 * 2 * 12 * MOE_CFG.experts_per_token
    tracing.reset()
    assert tracing.tallies() == {}
