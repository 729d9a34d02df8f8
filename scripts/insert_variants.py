#!/usr/bin/env python3
"""Build variants of the paired insert kernel and compare them on one card.

    python3 scripts/insert_variants.py [--parent TREE]

Each variant is a copy of ``src/repro_torch/kernels/csrc/paired_hash_histogram.cu``
with at most one of its constants rewritten, compiled by ``nvcc`` with the
repository's flags:

    default       the source as the package builds it (two hash rows per
                  thread at d = 10, p <= 4; p <= 5 counts in registers)
    rows=1        kRowsPerThread = 1: one hash row per thread
    reg_planes=4  kRegPlanes = 4: p = 5 counts in shared memory

``--parent TREE`` adds the paired insert source of another checkout (the
parent commit, unpacked by ``git archive``) as the variant ``parent``.

For every variant it prints one JSON line with:

* ``ptxas``: registers and spill bytes of the instantiations the main path
  runs (d = 10, p = 4, lone and banked);
* ``sass``: the instruction mix of the lone d = 10, p = 4 kernel's hot loop
  (the backward branch whose body has the most FMULs per instruction), from
  ``cuobjdump -sass``: each opcode's count per (point, row) pair, where the
  pairs per loop iteration are the float compares over 2p (every pair makes
  exactly two per plane: ``acc > 0`` and ``acc < t2``); and the
  instructions of the loop around it beyond the hot loop itself
  (``outer_extra``: the per-group counting of the new kernel, which runs
  once per 32 records; the per-tile staging of the parent's);
* the median CUDA-event time of five launches (after a warm-up) of the lone
  insert at n = 2^22, d = 10, R = 2048, p = 4, of the banked insert over 16
  tenants of 2^18 rows (the last 1000 masked), and of the lone insert at
  p = 5, each on the same seeded inputs;
* ``equal``: whether each of its three outputs equals the default build's.

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

N_ROWS, D, ROWS, PLANES = 1 << 22, 10, 2048, 4
TENANTS, TENANT_ROWS, TENANT_SHORT = 16, 1 << 18, 1000
# Variant name: the constant it rewrites and its value (None: the source).
VARIANTS = {"default": None, "rows=1": ("kRowsPerThread", 1),
            "reg_planes=4": ("kRegPlanes", 4)}
# Mangled-name stems of the main path's instantiations (lone, banked):
# paired_hist_kernel<4, 10, 10, B> now, <4, 16, B> in the parent.
MAIN = {"new": ("paired_hist_kernelILi4ELi10ELi10ELb0E",
                "paired_hist_kernelILi4ELi10ELi10ELb1E"),
        "parent": ("paired_hist_kernelILi4ELi16ELb0E",
                   "paired_hist_kernelILi4ELi16ELb1E")}
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")


def variant_source(src, constant, out_dir, name):
    """A copy of ``src`` in ``out_dir`` with ``constexpr int NAME = v;``
    rewritten to ``constant = (NAME, value)``."""
    text = src.read_text()
    pattern = rf"(constexpr int {constant[0]} = )\d+;"
    if len(re.findall(pattern, text)) != 1:
        raise RuntimeError(f"{constant[0]} is not one constant of {src}")
    out = out_dir / f"{name.replace('=', '_')}.cu"
    out.write_text(re.sub(pattern, rf"\g<1>{constant[1]};", text))
    return out


def build(name, src, out_dir, nvcc_path, flags):
    lib = out_dir / f"lib{name.replace('=', '_')}.so"
    # -I: the copies include the package's headers from beside the source.
    proc = subprocess.run([nvcc_path, *flags, "-I", str(CSRC), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
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


def hot_loop_mix(lib, stem, planes):
    """Opcode counts per pair in the hot loop of the function ``stem``."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = stem in line
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
    compares = counts["FSETP"] + counts["FSET"]
    pairs = compares / (2 * planes)
    return {"instructions": len(ops), "pairs_per_iteration": pairs,
            "per_pair": {k: round(v / pairs, 3)
                         for k, v in sorted(counts.items())},
            "total_per_pair": round(len(ops) / pairs, 3),
            "outer_extra": outer_extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
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
    src = _build.CSRC / "paired_hash_histogram.cu"
    jobs = {name: (src if constant is None else
                   variant_source(src, constant, out_dir, name), "new")
            for name, constant in VARIANTS.items()}
    if args.parent is not None:
        jobs["parent"] = (args.parent.resolve() / "src/repro_torch/kernels/csrc"
                          / "paired_hash_histogram.cu", "parent")
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda name: build(name, jobs[name][0], out_dir, _build.nvcc(),
                               _build.NVCC_FLAGS), jobs)))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    z, _ = lsh.scale_to_unit_ball(
        torch.randn(N_ROWS, D, generator=gen, device=dev))
    z = z.contiguous()
    w = torch.randn(PLANES, D + 2, ROWS, generator=gen, device=dev)
    w5 = torch.randn(PLANES + 1, D + 2, ROWS, generator=gen, device=dev)
    ones = torch.ones(N_ROWS, device=dev)
    zb = torch.randn(TENANTS, TENANT_ROWS, D, generator=gen, device=dev)
    zb = lsh.scale_to_unit_ball(zb.reshape(-1, D))[0].reshape(zb.shape)
    zb = zb.contiguous()
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

    reference = None
    for name, (lib_path, log) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        lone = lib.storm_paired_hash_histogram
        lone.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
        banked = lib.storm_paired_hash_histogram_banked
        banked.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
        lone.restype = banked.restype = ctypes.c_int

        def call(fn, *a):
            code = fn(*a)
            if code != 0:
                raise RuntimeError(f"{name}: CUDA error {code}")

        h4 = torch.zeros(ROWS, 1 << PLANES, dtype=torch.int32, device=dev)
        h5 = torch.zeros(ROWS, 1 << (PLANES + 1), dtype=torch.int32,
                         device=dev)
        hb = torch.zeros(TENANTS, ROWS, 1 << PLANES, dtype=torch.int32,
                         device=dev)
        lone_ms, c4 = timed(lambda: call(
            lone, z.data_ptr(), w.data_ptr(), ones.data_ptr(), h4.data_ptr(),
            h4.data_ptr(), N_ROWS, D, PLANES, ROWS, 4, stream), h4)
        banked_ms, cb = timed(lambda: call(
            banked, zb.data_ptr(), w.data_ptr(), mb.data_ptr(), hb.data_ptr(),
            hb.data_ptr(), TENANTS, TENANT_ROWS, D, PLANES, ROWS, 4, stream),
            hb)
        p5_ms, c5 = timed(lambda: call(
            lone, z.data_ptr(), w5.data_ptr(), ones.data_ptr(), h5.data_ptr(),
            h5.data_ptr(), N_ROWS, D, PLANES + 1, ROWS, 4, stream), h5)
        if reference is None:
            reference = (c4, cb, c5)
        stems = MAIN[jobs[name][1]]
        print(json.dumps({
            "variant": name, "card": torch.cuda.get_device_name(0),
            "ptxas": ptxas_usage(log, stems),
            "sass": hot_loop_mix(lib_path, stems[0], PLANES),
            "lone_p4_ms": lone_ms, "banked_p4_ms": banked_ms,
            "lone_p5_ms": p5_ms,
            "equal": [torch.equal(a, b) for a, b in zip((c4, cb, c5),
                                                        reference)],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
