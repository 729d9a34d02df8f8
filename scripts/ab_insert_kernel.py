#!/usr/bin/env python3
"""Time the paired insert (lone and banked) and lone query kernels of one
or more checkouts of the PyTorch/CUDA port, each in a fresh process, on one
card.

    python3 scripts/ab_insert_kernel.py TREE [TREE ...]

Each TREE is the root of a checkout (its ``src/repro_torch`` is imported and
its kernels are built). For every TREE in the order given, a child process
builds that checkout's kernels and times, at the regression path's full
shapes, ``paired_hash_histogram`` (n = 2^22 rows, d = 10, R = 2048, p = 4),
``paired_hash_histogram_banked`` (16 tenants of 2^18 rows, the last 1000
rows short, under the same hash family) and ``sketch_query`` (m = 17, one
DFO step) on the same seeded inputs: device time per launch from
torch.profiler (the mean over the kernel records it kept, with their count:
the profiler has been seen to drop a record of these kernels) and the
median CUDA-event time per call. While a queue of lone inserts runs, it
reads the SM clock three times with nvidia-smi (``insert_sm_clock_mhz``;
``clock_sampled_busy`` says the card was still running them after the last
reading). It prints one JSON line per run. To compare two commits on one card, give
them in alternating order (A B B A). Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

N_ROWS, D, ROWS, PLANES, M = 1 << 22, 10, 2048, 4, 17
TENANTS, TENANT_ROWS, TENANT_SHORT = 16, 1 << 18, 1000


def _child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import lsh
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch_query as query_kernel
    from repro_torch.kernels import storm_sketch as insert_kernel

    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    z, _ = lsh.scale_to_unit_ball(
        torch.randn(N_ROWS, D, generator=gen, device=dev))
    z = z.contiguous()
    w = torch.randn(PLANES, D + 2, ROWS, generator=gen, device=dev)
    mask = torch.ones(N_ROWS, device=dev)
    counts = insert_kernel.paired_hash_histogram(z, w, mask)
    zb, _ = lsh.scale_to_unit_ball(
        torch.randn(TENANTS * TENANT_ROWS, D, generator=gen, device=dev))
    zb = zb.reshape(TENANTS, TENANT_ROWS, D).contiguous()
    mb = torch.ones(TENANTS, TENANT_ROWS, device=dev)
    mb[-1, TENANT_ROWS - TENANT_SHORT:] = 0
    bank = insert_kernel.paired_hash_histogram_banked(zb, w, mb)
    q = lsh.augment_query(lsh.normalize_query(
        torch.randn(M, D, generator=gen, device=dev))).contiguous()

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
                   and symbol in e.name]
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

    insert_ms, insert_dev, insert_n = timed(insert, 5, "paired_hist_kernel")
    banked_ms, banked_dev, banked_n = timed(
        lambda: insert_kernel.paired_hash_histogram_banked(zb, w, mb), 5,
        "paired_hist_kernel")
    query_ms, query_dev, query_n = timed(
        lambda: query_kernel.sketch_query(q, w, counts), 200,
        "sketch_query_kernel")
    mhz, busy = sm_clock_while(insert, 90)
    return {"tree": str(tree), "card": torch.cuda.get_device_name(0),
            "insert_device_ms": insert_dev, "insert_event_ms": insert_ms,
            "insert_records": insert_n,
            "banked_device_ms": banked_dev, "banked_event_ms": banked_ms,
            "banked_records": banked_n,
            "query_device_ms": query_dev, "query_event_ms": query_ms,
            "query_records": query_n,
            "insert_sm_clock_mhz": mhz, "clock_sampled_busy": busy,
            "max_sm_clock_mhz": int(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True, timeout=60).stdout.split()[0]),
            "counts_sum": int(counts.sum()),
            "bank_sum": int(bank.to(torch.int64).sum())}


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
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
