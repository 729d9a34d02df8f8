#!/usr/bin/env python3
"""Build variants of the insert and query kernels and compare them on one card.

    python3 scripts/insert_variants.py [--parent TREE] [--family NAME ...]

Each variant is a copy of an insert source in ``src/repro_torch/kernels/csrc``
with at most one of its constants rewritten, compiled by ``nvcc`` with the
repository's flags. The paired insert (``paired_hash_histogram.cu``,
kernels 1 and 4):

    paired            the source as the package builds it (two hash rows per
                      thread at d = 10, p <= 4; p <= 5 counts in registers)
    paired rows=1     kRowsPerThread = 1: one hash row per thread
    paired reg_planes=4  kRegPlanes = 4: p = 5 counts in shared memory

The single-sided insert (``hash_histogram.cu``, kernels 3 and 5):

    single            the source as the package builds it
    single narrow=N   kRowsNarrow = N (N = 1, 2, 4; the default's value is
                      skipped): hash rows per thread at d = 11, p <= 2
    single wide=N     kRowsWide = N (N = 1, 2): rows per thread at p = 3, 4

The RACE query (``sketch_query.cu``, kernels 2 and 6):

    query             the source as the package builds it
    query min_rows=N  kMinRows = N (4, 16, 32): the fewest rows of a slice
    query blocks=N    kBlocksPerSm = N (8, 16): the grid's target per SM
    query tile=N      kMaxTile = N (64, 256): points per block

``--parent TREE`` adds the sources of another checkout (the parent commit,
unpacked by ``git archive``) as ``paired parent``, ``single parent`` and
``query parent``. ``--family`` picks families (default: all three).

For every variant it prints one JSON line with:

* ``ptxas``: registers and spill bytes of the instantiations the main path
  runs (paired: d = 10, p = 4; single: d = 11 at p = 2 and p = 4; lone and
  banked);
* ``sass``: the instruction mix of the lone main-path kernel's hot loop
  (paired d = 10, p = 4; single d = 11, p = 2): the backward branch whose
  body has the most FMULs per instruction, from ``cuobjdump -sass``; each
  opcode's count per (point, row) pair, where the pairs per loop iteration
  are the float compares over the compares a pair makes (paired: two per
  plane, ``acc > 0`` and ``acc < t2``; single: one, ``acc > 0``); and the
  instructions of the loop around it beyond the hot loop itself
  (``outer_extra``: the per-group counting of the new kernels, which runs
  once per 32 records; the per-tile staging of the parents');
* the median CUDA-event time of five launches (after a warm-up), on the
  same seeded inputs, of: paired, the lone insert at n = 2^22, d = 10,
  R = 2048, p = 4 (``lone_ms``), the banked insert over 16 tenants of 2^18
  rows, the last 1000 masked (``banked_ms``), and the lone insert at p = 5
  (``lone_p5_ms``); single, the lone insert at n = 2^22, d = 11, R = 1024,
  p = 2 (``lone_ms``), the banked insert over 16 tenants of 2^18 rows at
  p = 2 (``banked_ms``) and the lone insert at p = 4 (``lone_p4_ms``);
* ``equal``: whether each of its outputs equals its family's default build's.

A query variant prints, instead of ``sass`` and the insert times, the device
time per launch (``torch.profiler``, the mean over 200 launches' records)
of the lone and the banked query at m in {17, 272, 512, 4096} on a
16-table bank at p = 4, d = 12, R = 2048 (``lone_us``, ``banked_us``; the
banked index slot-major where m is a multiple of 16).

The copies and their libraries go to
``src/repro_torch/kernels/_build/variants/``. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src/repro_torch/kernels/csrc"

N_ROWS, TENANTS, TENANT_ROWS, TENANT_SHORT = 1 << 22, 16, 1 << 18, 1000

# Per family: its source and entry point, the shape of its main path (d as
# the kernel takes it, the width of w's feature axis, R, p, the p of the
# third timing and its key), the compares per (pair, plane), the constants
# its variants rewrite, and the mangled-name stems of its main-path
# instantiations in this tree and in the parent (lone, banked, and for the
# single-sided insert lone at p = 4; its parent's template had no exact
# width).
PAIRED_STEMS = ("paired_hist_kernelILi4ELi10ELi10ELb0E",
                "paired_hist_kernelILi4ELi10ELi10ELb1E")
FAMILIES = {
    "paired": dict(
        source="paired_hash_histogram.cu", entry="storm_paired_hash_histogram",
        d=10, d_w=12, rows=2048, planes=4, third=(5, "lone_p5_ms"),
        compares=2,
        variants={"rows=1": ("kRowsPerThread", 1),
                  "reg_planes=4": ("kRegPlanes", 4)},
        stems={"new": PAIRED_STEMS, "parent": PAIRED_STEMS}),
    "single": dict(
        source="hash_histogram.cu", entry="storm_hash_histogram",
        d=11, d_w=11, rows=1024, planes=2, third=(4, "lone_p4_ms"),
        compares=1,
        variants={"narrow=1": ("kRowsNarrow", 1),
                  "narrow=2": ("kRowsNarrow", 2),
                  "narrow=4": ("kRowsNarrow", 4),
                  "wide=1": ("kRowsWide", 1),
                  "wide=2": ("kRowsWide", 2)},
        stems={"new": ("hist_kernelILi2ELi11ELi11ELb0E",
                       "hist_kernelILi2ELi11ELi11ELb1E",
                       "hist_kernelILi4ELi11ELi11ELb0E"),
               "parent": ("hist_kernelILi2ELi16ELb0E",
                          "hist_kernelILi2ELi16ELb1E",
                          "hist_kernelILi4ELi16ELb0E")}),
}
QUERY = dict(
    source="sketch_query.cu",
    variants={"min_rows=4": ("kMinRows", 4), "min_rows=16": ("kMinRows", 16),
              "min_rows=32": ("kMinRows", 32),
              "blocks=8": ("kBlocksPerSm", 8), "blocks=16": ("kBlocksPerSm", 16),
              "tile=64": ("kMaxTile", 64), "tile=256": ("kMaxTile", 256)},
    stem="sketch_query_kernelILi4ELi12ELb0E", m=(17, 272, 512, 4096))
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")


def constant_pattern(name):
    return rf"(constexpr int {name} = )(\d+);"


def variant_source(src, constant, out_dir, name):
    """A copy of ``src`` in ``out_dir`` with ``constexpr int NAME = v;``
    rewritten to ``constant = (NAME, value)``; None where the source already
    has that value (the default build is that variant)."""
    text = src.read_text()
    found = re.findall(constant_pattern(constant[0]), text)
    if len(found) != 1:
        raise RuntimeError(f"{constant[0]} is not one constant of {src}")
    if int(found[0][1]) == constant[1]:
        return None
    out = out_dir / f"{name.replace('=', '_').replace(' ', '_')}.cu"
    out.write_text(re.sub(constant_pattern(constant[0]),
                          rf"\g<1>{constant[1]};", text))
    return out


def build(name, src, out_dir, nvcc_path, flags):
    lib = out_dir / f"lib{name.replace('=', '_').replace(' ', '_')}.so"
    # -I: the copies include the package's headers from beside the source.
    proc = subprocess.run([nvcc_path, *flags, "-I", str(src.parent), "-I",
                           str(CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def ptxas_usage(log, stems):
    """{stem: (registers, spill store bytes, spill load bytes)}."""
    usage, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = next((s for s in stems if s in m.group(1)), None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage.setdefault(current, [None, 0, 0])[1:] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(current, [None, 0, 0])[0] = int(m.group(1))
            current = None
    return {k: tuple(v) for k, v in usage.items()}


def hot_loop_mix(lib, stem, planes, compares):
    """Opcode counts per pair in the hot loop of the function ``stem``."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            # The mangled name ends the line; `paired_hist_kernel` must not
            # match the stem `hist_kernel...`.
            inside = re.search(rf"(?<![A-Za-z_]){stem}", line) is not None
            continue
        if inside:
            m = INSN.search(line)
            if m:
                body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if not body:
        raise RuntimeError(f"{stem} not found in {lib}")
    loops = []  # (lo, hi, opcodes) of every backward branch
    for addr, op, rest in body:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            lo = int(m.group(1), 16)
            loops.append((lo, addr, [o for a, o, _ in body if lo <= a <= addr]))
    lo, hi, ops = max(loops, key=lambda lp: sum(
        o.startswith("FMUL") for o in lp[2]) / len(lp[2]))
    outer = [lp for lp in loops if lp[0] <= lo and lp[1] >= hi
             and len(lp[2]) > len(ops)]
    outer_extra = (min(len(lp[2]) for lp in outer) - len(ops)) if outer else 0
    counts = collections.Counter(o.split(".")[0] for o in ops)
    pairs = (counts["FSETP"] + counts["FSET"]) / (compares * planes)
    return {"instructions": len(ops), "pairs_per_iteration": pairs,
            "per_pair": {k: round(v / pairs, 3)
                         for k, v in sorted(counts.items())},
            "total_per_pair": round(len(ops) / pairs, 3),
            "outer_extra": outer_extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--family", nargs="+", default=["paired", "single",
                                                    "query"],
                    choices=["paired", "single", "query"])
    args = ap.parse_args()

    import torch

    from repro_torch.core import lsh
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("insert_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    # name -> (family, source, "new" or "parent")
    jobs = {}
    families = {f: s for f, s in FAMILIES.items() if f in args.family}
    if "query" in args.family:
        families["query"] = QUERY
    for fam, spec in families.items():
        src = _build.CSRC / spec["source"]
        jobs[fam] = (fam, src, "new")
        for label, constant in spec["variants"].items():
            copy = variant_source(src, constant, out_dir, f"{fam} {label}")
            if copy is not None:
                jobs[f"{fam} {label}"] = (fam, copy, "new")
        if args.parent is not None:
            jobs[f"{fam} parent"] = (fam, args.parent.resolve()
                                     / "src/repro_torch/kernels/csrc"
                                     / spec["source"], "parent")
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda name: build(name, jobs[name][1], out_dir, _build.nvcc(),
                               _build.NVCC_FLAGS), jobs)))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit_ball(n, d):
        return lsh.scale_to_unit_ball(
            torch.randn(n, d, generator=gen, device=dev))[0].contiguous()

    if "query" in args.family:
        time_queries({n: built[n] for n in jobs if jobs[n][0] == "query"},
                     {n: jobs[n] for n in jobs if jobs[n][0] == "query"},
                     torch, gen)
    inputs = {}
    for fam, spec in FAMILIES.items():
        if fam not in args.family:
            continue
        d, d_w, rows, planes = (spec[k] for k in ("d", "d_w", "rows",
                                                  "planes"))
        # The paired insert takes z; the single-sided one augmented rows.
        rows_of = ((lambda n: unit_ball(n, d)) if fam == "paired" else
                   (lambda n: lsh.augment_data(unit_ball(n, d - 2))))
        inputs[fam] = dict(
            x=rows_of(N_ROWS).contiguous(),
            xb=rows_of(TENANTS * TENANT_ROWS).reshape(
                TENANTS, TENANT_ROWS, d).contiguous(),
            w=torch.randn(planes, d_w, rows, generator=gen, device=dev),
            w3=torch.randn(spec["third"][0], d_w, rows, generator=gen,
                           device=dev))
    ones = torch.ones(N_ROWS, device=dev)
    mb = torch.ones(TENANTS, TENANT_ROWS, device=dev)
    mb[-1, TENANT_ROWS - TENANT_SHORT:] = 0
    stream = torch.cuda.current_stream().cuda_stream

    def timed(call, hist):
        times = []
        for rep in range(6):
            hist.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            if rep:  # the first launch warms up
                times.append(start.elapsed_time(end))
        return statistics.median(times), hist.clone()

    reference = {}
    for name, (lib_path, log) in built.items():
        fam, _, tree = jobs[name]
        if fam == "query":
            continue
        spec, inp = FAMILIES[fam], inputs[fam]
        lib = ctypes.CDLL(str(lib_path))
        lone = getattr(lib, spec["entry"])
        lone.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
        banked = getattr(lib, spec["entry"] + "_banked")
        banked.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
        lone.restype = banked.restype = ctypes.c_int

        def call(fn, *a):
            code = fn(*a)
            if code != 0:
                raise RuntimeError(f"{name}: CUDA error {code}")

        d, rows, planes = spec["d"], spec["rows"], spec["planes"]
        p3, key3 = spec["third"]
        h = torch.zeros(rows, 1 << planes, dtype=torch.int32, device=dev)
        h3 = torch.zeros(rows, 1 << p3, dtype=torch.int32, device=dev)
        hb = torch.zeros(TENANTS, rows, 1 << planes, dtype=torch.int32,
                         device=dev)
        x, xb, w, w3 = inp["x"], inp["xb"], inp["w"], inp["w3"]
        lone_ms, c1 = timed(lambda: call(
            lone, x.data_ptr(), w.data_ptr(), ones.data_ptr(), h.data_ptr(),
            h.data_ptr(), N_ROWS, d, planes, rows, 4, stream), h)
        banked_ms, cb = timed(lambda: call(
            banked, xb.data_ptr(), w.data_ptr(), mb.data_ptr(), hb.data_ptr(),
            hb.data_ptr(), TENANTS, TENANT_ROWS, d, planes, rows, 4, stream),
            hb)
        third_ms, c3 = timed(lambda: call(
            lone, x.data_ptr(), w3.data_ptr(), ones.data_ptr(), h3.data_ptr(),
            h3.data_ptr(), N_ROWS, d, p3, rows, 4, stream), h3)
        outputs = (c1, cb, c3)
        reference.setdefault(fam, outputs)
        stems = spec["stems"][tree]
        print(json.dumps({
            "variant": name, "card": torch.cuda.get_device_name(0),
            "ptxas": ptxas_usage(log, stems),
            "sass": hot_loop_mix(lib_path, stems[0], planes,
                                 spec["compares"]),
            "lone_ms": lone_ms, "banked_ms": banked_ms, key3: third_ms,
            "equal": [torch.equal(a, b) for a, b in zip(outputs,
                                                        reference[fam])],
        }), flush=True)
    return 0


def time_queries(built, jobs, torch, gen):
    """One JSON line per query variant: registers, device µs per launch of
    the lone and banked query at each m, and equality with the default."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    tables, rows, planes, d = 16, 2048, 4, 12
    w = torch.randn(planes, d, rows, generator=gen, device=dev)
    counts = torch.randint(0, 1 << 20, (tables, rows, 1 << planes),
                           generator=gen, device=dev, dtype=torch.int32)
    queries = {}
    for m in QUERY["m"]:
        per = m // tables
        idx = (torch.repeat_interleave(torch.arange(
            tables, dtype=torch.int32, device=dev), per)
            if per * tables == m else torch.randint(
                0, tables, (m,), generator=gen, device=dev,
                dtype=torch.int32))
        queries[m] = (torch.randn(m, d, generator=gen, device=dev), idx)
    sums = torch.zeros(max(QUERY["m"]), dtype=torch.int64, device=dev)
    tickets = torch.zeros(max(QUERY["m"]) // 32 + 1, dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    reference = None
    for name, (lib_path, log) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        parent = jobs[name][2] == "parent"  # the parent's entry points
        lone, banked = lib.storm_sketch_query, lib.storm_sketch_query_banked
        extra = 0 if parent else 2  # the workspace pointers
        lone.argtypes = ([ctypes.c_void_p] * (4 + extra)
                         + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        banked.argtypes = ([ctypes.c_void_p] * (5 + extra)
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        ws = () if parent else (sums.data_ptr(), tickets.data_ptr())
        times, outputs = {"lone_us": {}, "banked_us": {}}, []
        for m, (q, idx) in queries.items():
            out = torch.empty(m, device=dev)
            for key, fn, args in (
                ("lone_us", lone, (q.data_ptr(), w.data_ptr(),
                                   counts.data_ptr(), out.data_ptr())),
                ("banked_us", banked, (q.data_ptr(), w.data_ptr(),
                                       counts.data_ptr(), idx.data_ptr(),
                                       out.data_ptr())),
            ):
                def call(fn=fn, args=args, m=m):
                    code = fn(*args, *ws, m, d, planes, rows, 4, stream)
                    if code != 0:
                        raise RuntimeError(f"{name}: CUDA error {code}")

                call()
                torch.cuda.synchronize()
                outputs.append(out.clone())
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(200):
                        call()
                    torch.cuda.synchronize()
                records = [e.time_range.elapsed_us() for e in prof.events()
                           if getattr(e, "device_type", None)
                           == DeviceType.CUDA
                           and "sketch_query_kernel" in e.name]
                times[key][m] = (sum(records) / len(records)
                                 if records else None)
        reference = reference or outputs
        print(json.dumps({
            "variant": name, "card": torch.cuda.get_device_name(0),
            "ptxas": ptxas_usage(log, (QUERY["stem"],)), **times,
            "equal": all(torch.equal(a, b)
                         for a, b in zip(outputs, reference)),
        }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
