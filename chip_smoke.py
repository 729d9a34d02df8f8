#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. device: the card's name and power limit.
2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc.
3. insert: ``paired_hash_histogram`` against its plain PyTorch version, bit
   for bit, at the main path's full shape, at ragged shapes (p in {1, 4, 8},
   partial masks) and with int16/int8 outputs that saturate.
4. query: ``sketch_query`` against its plain version, bit for bit, on the
   full-size sketch for m in {17, 198, 4096, 1001}.
5. fit: ``regression.fit`` at the full configuration (n = 2^22 rows at the
   airfoil-matched widths d = 9, R = 2048, p = 4, 400 DFO steps + 1 refine)
   through the kernels, with the launch counts of that run; then the same fit
   through the plain versions (``engine="scan"``) on the same hash family and
   draws.
6. timings: CUDA-event medians of each kernel and its plain version at the
   main path's shapes, beside the least time the card could take.

The last two lines are the card (nvidia-smi's name and power limit) and
``{"ok": true, "device": {...}}``. The run needs a CUDA card and the rest of
the repository beside this file; without either it exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM data sheet: fp32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# The main path's configuration: airfoil-matched widths, a day of 50 Hz
# telemetry from one device, and the default StormRegressorConfig.
N_ROWS = 1 << 22
D_FEATURES, NOISE, CONDITION = 9, 0.3, 30.0


def _log(*args) -> None:
    print(*args, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int, torch) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof):
    """``(name, µs)`` of every device activity a torch.profiler run recorded."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def _device_ms(fn, calls: int, torch, symbol=None):
    """Device time per call of ``fn`` (only kernels whose name holds
    ``symbol``, if given) from torch.profiler; None if it saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(us for name, us in _device_events(prof)
                if symbol is None or symbol in name)
    return total / calls / 1e3 if total > 0 else None


def _fit_profile(fit, torch):
    """Wall time, device busy ms and the kernels by device time of one fit."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_name = {}
    for name, us in _device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return (busy if busy > 0 else None), ranked, wall


def _bound(bytes_moved: float, flops: float):
    by_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: run it from the repository (src/repro_torch is "
              "missing beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import baselines, lsh, regression
    from repro_torch.core import dfo
    from repro_torch.data import datasets
    from repro_torch.device import generator, resolve_device
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import sketch_query as query_kernel
    from repro_torch.kernels import storm_sketch as insert_kernel

    # -- 1. device --------------------------------------------------------------
    dev = resolve_device("cuda")  # also switches TF32 off for the plain versions
    smi = _nvidia_smi()
    _log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
         f" | {torch.cuda.get_device_name(0)}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    _log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                _log(f"[build] {path.stem}: {line.strip()}")

    gen = generator(SEED, dev)
    cfg = regression.StormRegressorConfig()
    x, y, _ = datasets.make_regression(gen, N_ROWS, D_FEATURES, NOISE,
                                       CONDITION)
    dim = D_FEATURES + 3
    params = lsh.init_srp(gen, cfg.rows, cfg.planes, dim, device=dev)
    w = ops.from_lsh_params(params)  # (p, d + 2, R)
    xs, ys, *_ = regression._standardize(x, y, True)
    z, _ = lsh.scale_to_unit_ball(torch.cat([xs, ys[:, None]], dim=1),
                                  cfg.norm_slack)
    z = z.contiguous()
    ones = torch.ones(N_ROWS, device=dev)
    errs = {"paired_hash_histogram": 0.0, "sketch_query": 0.0}

    # -- 3. insert kernel against its plain version ----------------------------
    def check_insert(label, zi, wi, mi, out_dtype):
        got = insert_kernel.paired_hash_histogram(zi, wi, mi, out_dtype)
        want = ref.paired_hash_histogram(zi, wi, mi, out_dtype)
        torch.cuda.synchronize()
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        errs["paired_hash_histogram"] = max(errs["paired_hash_histogram"], err)
        mass = got.to(torch.int64).sum(1)
        _log(f"[insert] {label}: n={zi.shape[0]} d+2={wi.shape[1]} "
             f"p={wi.shape[0]} R={wi.shape[2]} {out_dtype} max|err|={err:g} "
             f"row mass {int(mass.min())}..{int(mass.max())} "
             f"(2*sum(mask) = {2 * int(mi.sum())})")
        if not torch.equal(got, want):
            raise AssertionError(f"insert kernel differs from its plain "
                                 f"version at {label}")
        return got

    full_counts = check_insert("full", z, w, ones, torch.int32)
    for label, n, d, p, r, keep, out_dtype in (
        ("ragged", 100_003, 10, 4, 2000, 0.9, torch.int32),
        ("ragged", 77_777, 5, 1, 130, 0.7, torch.int32),
        ("ragged", 12_345, 13, 8, 77, 0.5, torch.int32),
        ("ragged", 5_001, 31, 5, 333, 1.0, torch.int32),
        ("int16 saturating", 200_001, 4, 1, 50, 1.0, torch.int16),
        ("int16", 30_000, 10, 4, 2048, 0.8, torch.int16),
        ("int8 saturating", 50_001, 3, 2, 64, 1.0, torch.int8),
    ):
        zi, _ = lsh.scale_to_unit_ball(
            torch.randn(n, d, generator=gen, device=dev))
        wi = torch.randn(p, d + 2, r, generator=gen, device=dev)
        mi = (torch.rand(n, generator=gen, device=dev) < keep).float()
        got = check_insert(label, zi.contiguous(), wi, mi, out_dtype)
        if "saturating" in label and int(got.max()) != torch.iinfo(out_dtype).max:
            raise AssertionError(f"{label} did not saturate")

    # -- 4. query kernel against its plain version ------------------------------
    for m in (17, 198, 4096, 1001):
        th = torch.randn(m, dim - 2, generator=gen, device=dev)
        q = lsh.augment_query(lsh.normalize_query(th)).contiguous()
        got = query_kernel.sketch_query(q, w, full_counts)
        want = ref.sketch_query(q, w, full_counts)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs["sketch_query"] = max(errs["sketch_query"], err)
        _log(f"[query] m={m}: max|err|={err:g}")
        if not torch.equal(got, want):
            raise AssertionError(f"query kernel differs from its plain "
                                 f"version at m={m}")

    # -- 5. end-to-end fit ------------------------------------------------------
    k, steps = cfg.dfo.num_queries, cfg.dfo.steps
    directions = dfo.sphere_directions(gen, steps, 1, k, dim - 2, dev)
    refine = torch.randn(cfg.refine_steps, 1,
                         dfo.refine_sample_count(dim - 2), dim - 2,
                         generator=gen, device=dev)
    draws = dict(params=params, directions=directions, refine_samples=refine)

    def run_fit(engine):
        c = regression.StormRegressorConfig(engine=engine)
        torch.cuda.synchronize()
        start = time.perf_counter()
        fit = regression.fit(gen, x, y, c, device=dev, **draws)
        torch.cuda.synchronize()
        return fit, time.perf_counter() - start

    fit_kernel, _ = run_fit("auto")  # warm-up: libraries loaded, caches hot
    insert_kernel.paired_hash_histogram.launches = 0
    query_kernel.sketch_query.launches = 0
    fit_kernel, fit_s = run_fit("auto")
    launches = {"paired_hash_histogram":
                insert_kernel.paired_hash_histogram.launches,
                "sketch_query": query_kernel.sketch_query.launches}
    fit_plain, plain_s = run_fit("scan")

    var_y = float(y.var(correction=0))
    ols = baselines.ols(x, y)
    results = {}
    for name, fit, secs in (("kernel", fit_kernel, fit_s),
                            ("plain", fit_plain, plain_s)):
        mse = float(fit.mse(x, y))
        cos = float(torch.dot(fit.theta, ols.theta)
                    / (fit.theta.norm() * ols.theta.norm()))
        results[name] = mse
        _log(f"[fit] {name}: {secs:.3f} s, train MSE {mse:.6f} "
             f"(var(y) {var_y:.6f}, OLS MSE {float(ols.mse(x, y)):.6f}), "
             f"R^2 {1 - mse / var_y:.6f}, cos to OLS {cos:.6f}, "
             f"final sketch loss {float(fit.fleet_losses[0]):.6f}")
        if not (torch.isfinite(fit.theta).all() and fit.theta.shape
                == (D_FEATURES,)):
            raise AssertionError(f"{name} fit gave {fit.theta}")
    _log(f"[fit] launches in the kernel fit: {launches}")
    if launches["paired_hash_histogram"] < 1:
        raise AssertionError("the fit did not run the insert kernel")
    expected_queries = steps + 2 * cfg.refine_steps + 1
    if launches["sketch_query"] != expected_queries:
        raise AssertionError(f"expected {expected_queries} query launches, "
                             f"got {launches['sketch_query']}")
    if not results["kernel"] < var_y:
        raise AssertionError("the kernel fit does not beat the mean predictor")
    if abs(results["kernel"] - results["plain"]) > 0.02 * results["plain"]:
        raise AssertionError("kernel and plain fits differ by more than 2%")

    # -- 6. timings -------------------------------------------------------------
    # "ms" is device time per launch from torch.profiler (CUPTI); where the
    # profiler records no device activity it is the CUDA-event time per call,
    # which also counts the host's gaps between launches.
    p, d_aug, rows = w.shape
    m = 2 * k + 1  # one DFO step of a one-member fleet
    th = torch.randn(m, dim - 2, generator=gen, device=dev)
    q = lsh.augment_query(lsh.normalize_query(th)).contiguous()
    counts = fit_kernel.sketch.counts
    cases = {
        "paired_hash_histogram": (
            lambda: insert_kernel.paired_hash_histogram(z, w, ones),
            lambda: ref.paired_hash_histogram(z, w, ones), 3, 1,
            "paired_hist_kernel",
            _bound(bytes_moved=4 * (z.numel() + ones.numel() + w.numel()
                                    + rows * (1 << p)),
                   flops=2.0 * N_ROWS * d_aug * rows * p)),
        "sketch_query": (
            lambda: query_kernel.sketch_query(q, w, counts),
            lambda: ref.sketch_query(q, w, counts), 200, 20,
            "sketch_query_kernel",
            # The gather reads at most m * R cells, and no cell more than once.
            _bound(bytes_moved=4 * (q.numel() + w.numel() + m
                                    + min(m * rows, counts.numel())),
                   flops=2.0 * m * d_aug * rows * p)),
    }
    times = {}
    for name, (kern, plain, reps, plain_reps, symbol, bound) in cases.items():
        wall = _median_ms(kern, reps, torch)
        plain_wall = _median_ms(plain, plain_reps, torch)
        dev_ms = _device_ms(kern, reps, torch, symbol)
        plain_dev_ms = _device_ms(plain, plain_reps, torch)
        times[name] = (dev_ms if dev_ms is not None else wall,
                       plain_dev_ms if plain_dev_ms is not None else plain_wall,
                       bound)
        _log(f"[time] {name}: device {dev_ms} ms per launch, {wall:.4f} ms "
             f"per call by CUDA events; plain version: device "
             f"{plain_dev_ms} ms, {plain_wall:.4f} ms per call")

    # Where the fit's time goes: device busy time under the profiler.
    busy, kernel_ms, wall_s = _fit_profile(lambda: run_fit("auto"), torch)
    if busy is not None:
        top = ", ".join(f"{n[:40]} {t:.2f} ms" for n, t in kernel_ms[:5])
        of = lambda symbol: sum(t for n, t in kernel_ms if symbol in n)
        _log(f"[fit] under the profiler: {wall_s * 1e3:.1f} ms wall, device "
             f"busy {busy:.1f} ms ({100 * busy / (wall_s * 1e3):.1f}%); "
             f"insert {of('paired_hist_kernel'):.2f} ms, queries "
             f"{of('sketch_query_kernel'):.2f} ms; top kernels: {top}")

    kernels = []
    for name, src, replaces in (
        ("paired_hash_histogram",
         "src/repro_torch/kernels/csrc/paired_hash_histogram.cu",
         "src/repro/kernels/storm_sketch.py:219"),
        ("sketch_query", "src/repro_torch/kernels/csrc/sketch_query.cu",
         "src/repro/kernels/sketch_query.py:80"),
    ):
        ms, plain_ms, (bound_ms, bound_by) = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        _log(f"[time] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
             f"{bound_ms:.4f} ms by {bound_by})")
    _log(json.dumps({"kernels": kernels}))
    _log(smi)
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
