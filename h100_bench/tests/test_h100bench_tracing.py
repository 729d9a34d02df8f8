"""The readers of the program's tracer (``repro_torch.tracing``): each
returns the value planted in the tracer for a synthetic traced window, and
``None`` with nothing recorded; and each finds its spans and counters in a
short window of its cells on the CPU."""

import pytest

from h100_bench import harness
from repro_torch import tracing

ZIPF = ("stage_ms.ingest", "queue_wait_p95_ms.ingest",
        "h2d_bytes_per_row.ingest", "idle_in_gateway.ingest")
TAPS = ("idle_in_bridge.taps", "standardize_ms.taps")


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _run(window_ns, device_ops=(), counters=None):
    """A traced window ``(lo, hi)`` in ns, with ``device_ops`` in ns."""
    us = [(name, s / 1e3, e / 1e3) for name, s, e in device_ops]
    return harness.TraceRun(harness.Spans(), dict(counters or {}), {}, {},
                            us, [], (window_ns[0] / 1e3, window_ns[1] / 1e3))


def _read(metric, run):
    return harness.reader_of(metric).read(run)


def _ulps(idle_ns):
    """A share's rounding, in %: stamps near 1.8e18 ns hold 0.25 us in
    float64 microseconds, the profiler's unit, so each of four interval
    ends may move by that much."""
    return 100 * 4 * 250 / idle_ns


@pytest.mark.parametrize("metric", ZIPF + TAPS)
def test_nothing_recorded_reads_none(metric):
    t0 = tracing.now()
    assert _read(metric, _run((t0, t0 + 10 ** 9), counters={"batches": 4})) \
        is None


@pytest.mark.parametrize("metric", ZIPF + TAPS)
def test_a_program_without_the_tracer_reads_none(metric, monkeypatch):
    """A program older than the tracer has no ``repro_torch.tracing``: the
    reader returns ``None`` and does not raise."""
    import sys

    import repro_torch

    tracing.enable()
    t0 = tracing.now()
    tracing.record("gateway.stage", t0, t0 + 1)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert _read(metric, _run((t0, t0 + 10 ** 9), counters={"batches": 4})) \
        is None


def test_stage_is_the_median_tick_sum():
    tracing.enable()
    t0 = tracing.now()
    ms = 1_000_000
    # Three ticks with 1 + 2, 4 and 1.5 ms of staging; one stage outside
    # the window.
    for tick, parts in enumerate([(1, 2), (4,), (1.5,)], 1):
        with tracing.span("gateway.tick_start", tick):
            for k, p in enumerate(parts):
                s = t0 + tick * 10 * ms + k * 3 * ms
                tracing.record("gateway.stage", s, s + int(p * ms), tick)
    with tracing.span("gateway.tick_start", 4):
        tracing.record("gateway.stage", t0 + 200 * ms, t0 + 290 * ms, 4)
    run = _run((t0, t0 + 100 * ms))
    assert _read("stage_ms.ingest", run) == pytest.approx(3.0)


def test_queue_wait_is_the_nearest_rank_p95():
    tracing.enable()
    t0 = tracing.now()
    for rid in range(40):  # 1, 2, ..., 40 ms
        tracing.record("gateway.queue_wait", t0, t0 + (rid + 1) * 10 ** 6,
                       rid)
    run = _run((t0, t0 + 10 ** 9))
    assert _read("queue_wait_p95_ms.ingest", run) == pytest.approx(38.0)


def test_h2d_bytes_per_row_is_the_counters_ratio():
    tracing.enable()
    tracing.add("gateway.h2d_bytes", 11_534_336)
    tracing.add("gateway.rows_packed", 40_000)
    tracing.add("gateway.rows_packed", 14_800)
    t0 = tracing.now()
    assert _read("h2d_bytes_per_row.ingest", _run((t0, t0 + 1))) == \
        pytest.approx(11_534_336 / 54_800)


def test_idle_in_gateway_is_the_covered_share_of_idle_time():
    tracing.enable()
    t0 = tracing.now()
    ms = 1_000_000
    # Window 0-100 ms; the card busy 10-30 and 50-60: 70 ms idle. The
    # gateway's spans cover 0-5 (idle), 20-40 (10 ms idle), 35-45
    # (overlapping the last, 5 more) and 90-95: 25 ms of 70.
    ops = [("k", t0 + 10 * ms, t0 + 30 * ms), ("c", t0 + 50 * ms,
                                               t0 + 60 * ms)]
    for name, s, e in (("gateway.tick_start", 0, 5),
                       ("gateway.tick_finish", 20, 40),
                       ("gateway.tick_start", 35, 45),
                       ("gateway.tick_finish", 90, 95),
                       ("gateway.stage", 60, 90)):
        tracing.record(name, t0 + s * ms, t0 + e * ms)
    run = _run((t0, t0 + 100 * ms), ops)
    assert _read("idle_in_gateway.ingest", run) == pytest.approx(
        100 * 25 / 70, abs=_ulps(70 * ms))


def test_idle_in_bridge_reads_the_flushes():
    tracing.enable()
    t0 = tracing.now()
    ms = 1_000_000
    ops = [("gemm", t0, t0 + 80 * ms)]
    tracing.record("bridge.flush", t0 + 70 * ms, t0 + 90 * ms)
    tracing.record("gateway.tick_start", t0 + 90 * ms, t0 + 100 * ms)
    run = _run((t0, t0 + 100 * ms), ops)
    assert _read("idle_in_bridge.taps", run) == pytest.approx(
        50.0, abs=_ulps(20 * ms))


def test_standardize_is_per_batch():
    tracing.enable()
    t0 = tracing.now()
    ms = 1_000_000
    for k in range(3):
        s = t0 + k * 10 * ms
        tracing.record("bridge.standardize", s, s + 2 * ms)
        tracing.record("bridge.readback", s + 2 * ms, s + 3 * ms)
        tracing.record("bridge.drain", s + 3 * ms, s + 9 * ms)
    run = _run((t0, t0 + 100 * ms), counters={"batches": 6})
    assert _read("standardize_ms.taps", run) == pytest.approx(9 / 6)


def _window(name, seconds):
    """A short window of a cell at smoke sizes with the tracer on, as the
    profiler turns it on in a traced run; no device ops on the CPU, so the
    whole window is idle."""
    from test_h100bench_cells import CPU, SEED, cells

    cfg, mix = cells()[name]
    session = harness.loop_of(mix).Session(cfg, mix, SEED, CPU)
    tracing.reset()
    tracing.enable()
    lo = tracing.now()
    win = session.window(seconds, harness.Spans())
    hi = tracing.now()
    return harness.TraceRun(harness.Spans(), win.counters, cfg, mix, [], [],
                            (lo / 1e3, hi / 1e3), win.metrics)


def test_zipf_readers_find_the_gateways_records():
    run = _window("storm-airfoil-16t.ingest-zipf", 0.3)
    got = {m: _read(m, run) for m in ZIPF}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["idle_in_gateway.ingest"] <= 100.0
    # 256 ingest slots of 11 float32 words a tenant: at least 44 B a row.
    assert got["h2d_bytes_per_row.ingest"] >= 44.0


def test_taps_readers_find_the_bridges_records():
    run = _window("zamba2-2.7b-taps.msg-128", 0.5)
    got = {m: _read(m, run) for m in TAPS}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["idle_in_bridge.taps"] <= 100.0
