#!/usr/bin/env python3
"""Time the insert kernels, both queries and the SRP hash of one or more
checkouts of the PyTorch/CUDA port, each in a fresh process, on one card.

    python3 scripts/ab_insert_kernel.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``src/repro_torch`` is imported and
its kernels are built). For every TREE in the order given, a child process
builds that checkout's kernels and times, on the same seeded inputs:

* kernel 1, ``paired_hash_histogram`` (n = 2^22 rows, d = 10, R = 2048,
  p = 4: the regression path), and kernel 4, its banked form (16 tenants of
  2^18 rows, the last 1000 short, under the same hash family);
* kernel 2, ``sketch_query``, and kernel 6, ``sketch_query_banked`` on
  the 16-tenant bank above, at m in {17, 272, 512, 4096} (one DFO step, a
  16-tenant fleet's step, the gateway's 16 x 32 query slots, a large
  batch; the banked index slot-major where m is a multiple of 16);
* kernel 3, ``hash_histogram`` at the classification path's shape (n = 2^22
  augmented rows of d = 11, R = 1024, p = 2) and at the kmeans shape
  (p = 4), and kernel 5, its banked form (16 tenants of 2^18 rows, the last
  1000 short, p = 2);
* kernel 7, ``srp_hash`` (n = 2^18, d = 12, R = 2048, p = 4: the register
  path) and its tiled path (``srp_wide``: n = 2^16, d = 515, R = 2048,
  p = 4, a probe's ``d_model + 3`` at d_model = 512);
* the inserts' wide body (``wide_paired``, ``wide_single``: d = 515,
  n = 2^16, R = 2048, p = 4; kernels 1 and 3 at a probe-sized row), and
  kernel 1 at chip_smoke phase 15's wide fit (``wide_fit``: d = 40,
  n = 2^20, R = 4096, p = 4).

For each: device time per launch from torch.profiler (the mean over the
kernel records it kept, with their count: the profiler has been seen to drop
a record of these kernels; a kernel is matched by its name in either tree,
e.g. the wide body's ``projection_tile_kernel`` or the parent's
``wide_hist_kernel``) and the median CUDA-event time per call (the
queries' keys carry their m: ``query_m272_device_ms``). While
a queue of each lone insert (kernels 1 and 3) runs, it reads the SM clock
three times with nvidia-smi (``*_sm_clock_mhz``; ``*_clock_sampled_busy``
says the card was still running them after the last reading). Each
output's sum (``*_sum``) and its sum weighted by the last axis's index
(``*_bucket_sum``) show that both trees counted the same cells, and each
query's output sum (``query*_sum``) that they answered the same. It prints
one JSON line per run. To compare two commits on one card, give them
in alternating order (A B B A). Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

N_ROWS, D, ROWS, PLANES = 1 << 22, 10, 2048, 4
QUERY_M = (17, 272, 512, 4096)
TENANTS, TENANT_ROWS, TENANT_SHORT = 16, 1 << 18, 1000
# The single-sided family: d = 9 features augmented to 11 columns.
S_D, S_ROWS, S_PLANES, KMEANS_PLANES = 11, 1024, 2, 4
SRP_ROWS = 1 << 18
WIDE_ROWS, WIDE_D = 1 << 16, 515
FIT_ROWS, FIT_D, FIT_HASH_ROWS = 1 << 20, 40, 4096
# Kernel names of the wide shapes: this design's, then earlier trees'.
TILE = ("projection_tile_kernel",)
WIDE_SYMBOLS = TILE + ("wide_hist_kernel",)
SRP_WIDE_SYMBOLS = TILE + ("srp_hash_tiled_kernel",)


def _named(symbols, name: str) -> bool:
    """Whether a profiler kernel name is one of the device functions
    ``symbols`` (a name or a tuple; demangled ``ns::symbol<...>`` or mangled
    ``<len>symbol``)."""
    symbols = (symbols,) if isinstance(symbols, str) else symbols
    return any(f"::{s}" in name or f"{len(s)}{s}" in name for s in symbols)


def _child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import lsh
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch_query as query_kernel
    from repro_torch.kernels import srp_hash as hash_kernel
    from repro_torch.kernels import storm_sketch as insert_kernel

    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit_ball(n, d):
        return lsh.scale_to_unit_ball(
            torch.randn(n, d, generator=gen, device=dev))[0].contiguous()

    z = unit_ball(N_ROWS, D)
    w = torch.randn(PLANES, D + 2, ROWS, generator=gen, device=dev)
    mask = torch.ones(N_ROWS, device=dev)
    counts = insert_kernel.paired_hash_histogram(z, w, mask)
    zb = unit_ball(TENANTS * TENANT_ROWS, D).reshape(TENANTS, TENANT_ROWS, D)
    mb = torch.ones(TENANTS, TENANT_ROWS, device=dev)
    mb[-1, TENANT_ROWS - TENANT_SHORT:] = 0
    bank = insert_kernel.paired_hash_histogram_banked(zb, w, mb)
    queries = {}
    for m in QUERY_M:
        q = lsh.augment_query(lsh.normalize_query(
            torch.randn(m, D, generator=gen, device=dev))).contiguous()
        per = m // TENANTS
        idx = (torch.repeat_interleave(torch.arange(
            TENANTS, dtype=torch.int32, device=dev), per)
            if per * TENANTS == m else torch.randint(
                0, TENANTS, (m,), generator=gen, device=dev,
                dtype=torch.int32))
        queries[m] = (q, idx)
    x = lsh.augment_data(unit_ball(N_ROWS, S_D - 2)).contiguous()
    ws = torch.randn(S_PLANES, S_D, S_ROWS, generator=gen, device=dev)
    wk = torch.randn(KMEANS_PLANES, S_D, S_ROWS, generator=gen, device=dev)
    xb = lsh.augment_data(unit_ball(TENANTS * TENANT_ROWS, S_D - 2)).reshape(
        TENANTS, TENANT_ROWS, S_D).contiguous()
    xh = lsh.augment_query(lsh.normalize_query(
        torch.randn(SRP_ROWS, D, generator=gen, device=dev))).contiguous()
    zw = unit_ball(WIDE_ROWS, WIDE_D)
    xw = lsh.augment_data(zw[:, :WIDE_D - 2]).contiguous()
    ww = torch.randn(PLANES, WIDE_D + 2, ROWS, generator=gen, device=dev)
    wws = ww[:, :WIDE_D].contiguous()
    mw = torch.ones(WIDE_ROWS, device=dev)
    zf = unit_ball(FIT_ROWS, FIT_D)
    wf = torch.randn(PLANES, FIT_D + 2, FIT_HASH_ROWS, generator=gen,
                     device=dev)
    mf = torch.ones(FIT_ROWS, device=dev)

    def timed(fn, reps, symbol):
        """(median event ms per call, device ms per record, records)."""
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        records = [e.time_range.elapsed_us() for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and _named(symbol, e.name)]
        dev_ms = sum(records) / len(records) / 1e3 if records else None
        return statistics.median(times), dev_ms, len(records)

    def sm_clock_while(fn, calls):
        """SM clock readings (MHz) taken while ``calls`` queued calls of
        ``fn`` run, and whether the card was still busy after them."""
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        mhz = [int(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True, check=True,
            timeout=60).stdout.split()[0]) for _ in range(3)]
        busy = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        return mhz, busy

    def insert():
        return insert_kernel.paired_hash_histogram(z, w, mask)

    def single():
        return insert_kernel.hash_histogram(x, ws, mask)

    out = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    for key, fn, reps, symbol in (
        ("insert", insert, 5, "paired_hist_kernel"),
        ("banked", lambda: insert_kernel.paired_hash_histogram_banked(
            zb, w, mb), 5, "paired_hist_kernel"),
        ("single", single, 5, "hist_kernel"),
        ("single_p4", lambda: insert_kernel.hash_histogram(x, wk, mask), 5,
         "hist_kernel"),
        ("single_banked", lambda: insert_kernel.hash_histogram_banked(
            xb, ws, mb), 5, "hist_kernel"),
        ("srp", lambda: hash_kernel.srp_hash(xh, w), 20,
         "srp_hash_reg_kernel"),
        ("srp_wide", lambda: hash_kernel.srp_hash(zw, wws), 5,
         SRP_WIDE_SYMBOLS),
        ("wide_paired", lambda: insert_kernel.paired_hash_histogram(
            zw, ww, mw), 5, WIDE_SYMBOLS),
        ("wide_single", lambda: insert_kernel.hash_histogram(xw, wws, mw), 5,
         WIDE_SYMBOLS),
        ("wide_fit", lambda: insert_kernel.paired_hash_histogram(zf, wf, mf),
         3, WIDE_SYMBOLS),
        *[(f"query_m{m}", lambda q=q: query_kernel.sketch_query(q, w, counts),
           200, "sketch_query_kernel") for m, (q, _) in queries.items()],
        *[(f"query_banked_m{m}",
           lambda q=q, idx=idx: query_kernel.sketch_query_banked(
               q, w, bank, idx, index_checked=True),
           200, "sketch_query_kernel") for m, (q, idx) in queries.items()],
    ):
        event_ms, dev_ms, n = timed(fn, reps, symbol)
        out.update({f"{key}_device_ms": dev_ms, f"{key}_event_ms": event_ms,
                    f"{key}_records": n})
    for key, fn, calls in (("insert", insert, 90), ("single", single, 300)):
        mhz, busy = sm_clock_while(fn, calls)
        out[f"{key}_sm_clock_mhz"] = mhz
        out[f"{key}_clock_sampled_busy"] = busy
    out["max_sm_clock_mhz"] = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    # The mass of each output, and its bucket-weighted sum (which moves
    # when a point lands in another bucket of its row).
    for key, t in (("counts", counts), ("bank", bank), ("single", single()),
                   ("single_p4", insert_kernel.hash_histogram(x, wk, mask)),
                   ("single_bank", insert_kernel.hash_histogram_banked(
                       xb, ws, mb)),
                   ("srp", hash_kernel.srp_hash(xh, w)),
                   ("srp_wide", hash_kernel.srp_hash(zw, wws)),
                   ("wide_paired", insert_kernel.paired_hash_histogram(
                       zw, ww, mw)),
                   ("wide_single", insert_kernel.hash_histogram(
                       xw, wws, mw)),
                   ("wide_fit", insert_kernel.paired_hash_histogram(
                       zf, wf, mf))):
        t = t.to(torch.int64)
        out[f"{key}_sum"] = int(t.sum())
        out[f"{key}_bucket_sum"] = int(
            (t * torch.arange(t.shape[-1], device=dev)).sum())
    for m, (q, idx) in queries.items():
        out[f"query_m{m}_sum"] = float(query_kernel.sketch_query(
            q, w, counts).double().sum())
        out[f"query_banked_m{m}_sum"] = float(query_kernel.sketch_query_banked(
            q, w, bank, idx).double().sum())
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        print(json.dumps(_child(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for tree in argv:
        out = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
