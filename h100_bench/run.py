#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (import, kernel libraries, data and weights made on the card from the
seed, warm-up of the cell's own shapes) is timed from process start as
``setup_s``; a checkout's first run also builds the port's CUDA libraries
there, and the ``setup`` line on standard error gives that build apart. The window then runs for ``--seconds``. With ``--trace 0`` the
result carries the cell's end-to-end metrics; with ``--trace 1`` the window
runs under ``torch.profiler`` and the result carries the per-layer metrics,
``busy_s``, ``window_s`` and a breakdown. A cell with an end-to-end metric
whose ``source`` is ``device_trace`` runs its window under the profiler with
``--trace 0`` too, and that metric's reader ``metrics/<metric>.py`` reads it
as a per-layer reader reads its metric. After the window the plain
reference (``h100_bench/reference``) decides ``correct``. The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are also the last lines of standard error. Exits non-zero, with no
result, without enough CUDA cards, or if JAX or the JAX package was
imported by the time the result would be printed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds. The port's own nvcc builds already
    land inside it (``src/repro_torch/kernels/_build``)."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _cache_dirs()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from h100_bench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    t_import = time.perf_counter() - T_START
    torch.zeros((), device="cuda")  # the CUDA context
    t_context = time.perf_counter() - T_START - t_import
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()  # nvcc on a checkout's first run, else a hash each
    t_build = time.perf_counter() - t0
    config = harness.config_of(spec, cell, ROOT)
    mix = harness.mix_of(cell)
    loop = harness.loop_of(mix)
    device = torch.device("cuda", 0)
    profiled = bool(args.trace) or any(
        m["source"] == "device_trace"
        for m in harness.metrics_of(spec, cell["name"], "end_to_end"))
    spans = harness.Spans(profiled=profiled)

    session = loop.Session(config, mix, args.seed, device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    phases = {"imports": t_import, "context": t_context, "build": t_build,
              **getattr(session, "setup_phases", {})}
    print("setup " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
          file=sys.stderr, flush=True)

    if profiled:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("bench.window"):
                win = session.window(args.seconds, spans)
    else:
        win = session.window(args.seconds, spans)
    peak = torch.cuda.max_memory_allocated(device)
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": int(peak),
                   "power": _power_limit()}
    run = None
    if profiled:
        ops, host, window_us = harness.read_profile(prof)
        del prof
        run = harness.TraceRun(spans, win.counters, config, mix, ops, host,
                               window_us, win.metrics)
    return finish(spec, cell, session, win, setup_s, device_info, run,
                  traced=bool(args.trace))


def finish(spec: dict, cell: dict, session, win, setup_s: float,
           device_info: dict, run=None, traced=None) -> int:
    """The cell's metrics (per-layer ones when ``traced``, else end-to-end
    ones; ``run`` is the profiled window, and ``traced`` defaults to whether
    there is one), the check against the reference, and the result line.
    The look for JAX and the JAX package comes last, after every reader and
    the reference have run: with one found, nothing is printed but its
    names, and the run exits 3."""
    from h100_bench import harness

    if traced is None:
        traced = run is not None
    breakdown = None
    metrics = {}
    if traced:
        device_info["busy_s"] = run.busy_s
        device_info["window_s"] = run.window_s
        breakdown = run.breakdown()
        for m in harness.metrics_of(spec, cell["name"], "per_layer"):
            value = harness.reader_of(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.metrics_of(spec, cell["name"], "end_to_end"):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["source"] == "device_trace":
                value = (None if run is None
                         else harness.reader_of(m["name"]).read(run))
            else:
                value = win.metrics.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        # The loop's own host-clock numbers, for the record, whether or not
        # the cell reports them.
        print("window " + ", ".join(f"{k} {v!r}" for k, v in
                                    win.metrics.items()),
              file=sys.stderr, flush=True)

    checks = session.judge(win)
    correct = all(v <= lim for _, v, lim in checks)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were imported: {bad}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    print(harness.result_line(correct, win.attempted, win.failed, metrics,
                              device_info, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
