#!/usr/bin/env python3
"""What the port's tracer costs, and whether its spans share the device
trace's clock, on one cell of ``h100_bench`` (run on the card).

    python3 scripts/trace_check.py --workload storm-airfoil-16t.ingest-zipf \
        --seed 2147483700 [--cost-seconds 40 --trace-seconds 20]

Two phases on one warmed session of the cell, in one process:

1. **trace**: the window under ``torch.profiler`` as ``h100_bench/run.py
   --trace 1`` runs it (the harness's ``bench.`` ranges around the loop's
   calls); prints every per-layer metric of the cell, how far each
   ``gateway.tick_start``, ``bridge.flush`` and ``taps.extract`` record
   lies outside the harness's range around the same call, whether any
   device op bears a program span's name, each span name's share of the
   device's idle time, and the ten longest idle gaps with the spans that
   cover them.
2. **cost**: the window again (the gateway carries on) with the tracer off
   for every other call of the gateway's ``tick_start`` (storm cells) or
   the bridge's ``flush`` (capture cells) and on for the rest, each call
   timed on the host clock; prints both sides' statistics, the garbage
   collections inside each side's calls, their differences, and the
   median of each "on" call less the "off" call before it.

The last line of standard output is one JSON object; ``--out`` writes it to
a file too.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (program span, the harness's range around the same call)
CLOCK_PAIRS = (("gateway.tick_start", "tick_start"),
               ("bridge.flush", "bridge"), ("taps.extract", "forward"))


def _toggled(fn, times, gcs):
    """``fn`` timed (ns) into ``times[on]``, with the tracer off for every
    other call and on for the rest; between calls it is on, so the requests
    a call packs were stamped at submit either way. Also a ``gc`` callback
    that adds each collection inside a call to ``gcs[on]`` (count, ns)."""
    from repro_torch import tracing

    calls, side, t_gc = [0], [None], [0]

    def call(*args, **kwargs):
        on = calls[0] % 2 == 1
        calls[0] += 1
        (tracing.enable if on else tracing.disable)()
        side[0] = on
        t0 = time.perf_counter_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            times[on].append(time.perf_counter_ns() - t0)
            side[0] = None
            tracing.enable()

    def on_gc(phase, info):
        if side[0] is None:
            return
        if phase == "start":
            t_gc[0] = time.perf_counter_ns()
        else:
            gcs[side[0]][0] += 1
            gcs[side[0]][1] += time.perf_counter_ns() - t_gc[0]

    return call, on_gc


def _stats(ns):
    us = sorted(t / 1e3 for t in ns)
    if len(us) < 2:
        return {"calls": len(us)}
    q = statistics.quantiles(us, n=20)
    return {"calls": len(us), "mean_us": statistics.fmean(us),
            "median_us": statistics.median(us), "p5_us": q[0],
            "p95_us": q[-1], "max_us": us[-1],
            "trimmed_mean_us": statistics.fmean(
                us[len(us) // 20:len(us) - len(us) // 20])}


def cost(session, seconds):
    """The window with the tracer toggled call by call."""
    from h100_bench import harness
    from repro_torch import tracing

    times = {False: [], True: []}
    gcs = {False: [0, 0], True: [0, 0]}
    if hasattr(session, "bridge"):
        what, owner = "flush", session.bridge
    else:
        what, owner = "tick_start", session.gw
    call, on_gc = _toggled(getattr(owner, what), times, gcs)
    setattr(owner, what, call)
    gc.callbacks.append(on_gc)
    try:
        win = session.window(seconds, harness.Spans())
        # the program's spans the "on" calls recorded (the tracer is on
        # between calls too, where the loop's own spans fall)
        recs = tracing.records()
        inside = sum(1 for n in recs["name"]
                     if n.startswith(("gateway.", "bridge."))
                     and n != "gateway.queue_wait")
    finally:
        gc.callbacks.remove(on_gc)
        delattr(owner, what)  # the class's method again
        tracing.disable()
        tracing.reset()
    off, on = _stats(times[False]), _stats(times[True])
    out = {"call": what, "off": off, "on": on}
    for side, (n, ns) in (("off", gcs[False]), ("on", gcs[True])):
        out[side]["gc_collections"] = n
        out[side]["gc_ms"] = ns / 1e6
    if on["calls"]:
        out["spans_per_on_call"] = inside / on["calls"]
    if off["calls"] > 1 and on["calls"] > 1:
        for k in ("mean", "median", "trimmed_mean"):
            out[f"{k}_delta_us"] = on[f"{k}_us"] - off[f"{k}_us"]
            out[f"{k}_delta_share"] = out[f"{k}_delta_us"] / off[f"{k}_us"]
        # each "on" call against the "off" call just before it, so that
        # the host's slower phases fall on both sides of a pair
        pairs = [b - a for a, b in zip(times[False], times[True])]
        out["paired_median_delta_us"] = statistics.median(pairs) / 1e3
        out["paired_mean_delta_us"] = statistics.fmean(pairs) / 1e3
    if what == "flush":
        batches = win.counters["batches"]
        window_s = win.counters["batch"] * win.counters["seq_len"] \
            * batches / win.metrics["tokens_per_s"]
        out["batch_us"] = 1e6 * window_s / batches
        out["flushes_per_batch"] = len(times[False] + times[True]) / batches
        if "mean_delta_us" in out:
            out["delta_share_of_batch"] = (out["mean_delta_us"]
                                           * out["flushes_per_batch"]
                                           / out["batch_us"])
    return out


def trace(session, seconds, spec, cell):
    """The traced window, read as ``run.py --trace 1`` reads it, and the
    tracer's records against the harness's ranges and the card's idle
    time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from h100_bench import harness
    from repro_torch import tracing

    tracing.disable()
    tracing.reset()
    spans = harness.Spans(profiled=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            win = session.window(seconds, spans)
    ops, host, window_us = harness.read_profile(prof)
    del prof
    run = harness.TraceRun(spans, win.counters, session.config, session.mix,
                           ops, host, window_us, win.metrics)
    out = {"busy_s": run.busy_s, "window_s": run.window_s,
           "metrics": {}, "window_metrics": win.metrics}
    for m in harness.metrics_of(spec, cell["name"], "per_layer"):
        out["metrics"][m["name"]] = harness.reader_of(m["name"]).read(run)
    lo, hi = window_us
    recs = tracing.records()
    recs = recs[(recs["start_ns"] / 1e3 >= lo) & (recs["end_ns"] / 1e3 <= hi)]
    names = sorted(set(recs["name"]))
    out["records"] = int(recs.size)
    out["summary"] = tracing.summary()
    out["program_names_on_device"] = sorted(
        {n for n, _, _ in ops} & set(names))
    # The clock: each program span inside the harness's range around the
    # same call (the loop's drain calls the gateway outside any range).
    out["clock"] = {}
    for name, bench in CLOCK_PAIRS:
        ranges = sorted((s, e) for n, s, e in host if n == bench)
        sel = recs[recs["name"] == name]
        if not ranges or not sel.size:
            continue
        starts = [s for s, _ in ranges]
        offsets, unmatched = [], 0
        for rs, re_ in zip(sel["start_ns"] / 1e3, sel["end_ns"] / 1e3):
            i = bisect.bisect_right(starts, rs) - 1
            cands = [ranges[k] for k in (i, i + 1) if 0 <= k < len(ranges)
                     and min(re_, ranges[k][1]) > max(rs, ranges[k][0])]
            if not cands:
                unmatched += 1
                continue
            hs, he = max(cands, key=lambda r: min(re_, r[1]) - max(rs, r[0]))
            offsets.append((max(0.0, hs - rs, re_ - he), rs - hs, he - re_))
        out["clock"][name] = {
            "records": int(sel.size), "ranges": len(ranges),
            "unmatched": unmatched,
            "worst_outside_us": max(o[0] for o in offsets),
            "start_after_range_us_median": statistics.median(
                o[1] for o in offsets),
            "end_before_range_us_median": statistics.median(
                o[2] for o in offsets)}
    # Where the idle time goes: each span name's union over the idle time,
    # the harness's ranges beside them, and what no span covers (the
    # accounting of the metrics' own reader).
    idle = harness.reader_of("idle_in_gateway.ingest")
    work = [n for n in names if n != "gateway.queue_wait"]  # host work
    cover = {name: idle.idle_share(run, name) for name in names}
    cover["any program span"] = idle.idle_share(run, *work)
    work_iv = [(s / 1e3, e / 1e3) for n, s, e in zip(
        recs["name"], recs["start_ns"], recs["end_ns"]) if n in work]
    every = idle.covered_share(run, work_iv + [(s, e) for _, s, e in host])
    cover["no program or bench span"] = None if every is None else 100 - every
    out["idle_s"] = run.window_s - run.busy_s
    out["idle_share_by_span"] = cover
    # The ten longest gaps, each with the time every host span's name and
    # every harness range held in it (a name's spans do not overlap in the
    # loop's one thread, so their overlaps add up).
    gaps = sorted(idle.idle_intervals(run), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        row = {"ms": (e - s) / 1e3, "at_s": (s - lo) / 1e6}
        for name in work:
            sel = recs[recs["name"] == name]
            c = np.clip(np.minimum(e, sel["end_ns"] / 1e3)
                        - np.maximum(s, sel["start_ns"] / 1e3), 0, None).sum()
            if c > 0:
                row[name] = float(c) / 1e3
        b = {}
        for n, hs, he in host:
            c = min(e, he) - max(s, hs)
            if c > 0:
                b[n] = b.get(n, 0) + c / 1e3
        row["bench"] = b
        named.append(row)
    out["longest_idle_gaps"] = named
    # The tail of a storm cell: the queue's wait by tenant.
    if "ingests" in win.log:
        tenant = {rid: t for rid, t, *_ in win.log["ingests"]}
        waits = recs[recs["name"] == "gateway.queue_wait"]
        by = {}
        for rid, s, e in zip(waits["key"], waits["start_ns"], waits["end_ns"]):
            by.setdefault(tenant.get(int(rid), -1), []).append((e - s) / 1e6)

        def p95(v):
            v = sorted(v)
            return v[max(0, math.ceil(0.95 * len(v)) - 1)]

        out["queue_wait_by_tenant"] = {
            str(t): {"n": len(v), "p50_ms": statistics.median(v),
                     "p95_ms": p95(v)} for t, v in sorted(by.items())}
        rest = [w for t, v in by.items() if t != 0 for w in v]
        if rest:
            out["queue_wait_p95_ms_not_tenant_0"] = p95(rest)
    tracing.reset()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost-seconds", type=float, default=40.0)
    ap.add_argument("--trace-seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from h100_bench import harness
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    _build.build_all()
    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, args.workload)
    config = harness.config_of(spec, cell, ROOT)
    mix = harness.mix_of(cell)
    device = torch.device("cuda", 0)
    session = harness.loop_of(mix).Session(config, mix, args.seed, device)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device)}
    if args.trace_seconds > 0:
        out["trace"] = trace(session, args.trace_seconds, spec, cell)
    if args.cost_seconds > 0:
        out["cost"] = cost(session, args.cost_seconds)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
