#!/usr/bin/env python3
"""Time the RACE queries' generic body (d > 32 or p > 8) and variants of it
on one card, and where a launch's time goes.

    python3 scripts/query_generic.py [--phases]

Each variant is a copy of ``src/repro_torch/kernels/csrc`` with one text
edit in ``sketch_query.cu``, compiled by ``nvcc`` with the package's flags
into ``src/repro_torch/kernels/_build/variants/``:

    generic           the source as the package builds it
    cp.async          w copied by the block's threads with 4-byte cp.async
                      instead of one TMA box a chunk
    4 stages          kGenStages = 4: three chunks in flight, not two
    8-warp tiles      m = 17 on a tile of 8 warps x 3 points (24 slots)
                      instead of 4 x 5
    no projection     the multiply-add loop skipped (wrong results): what
                      the w stream, the points' staging and the gather cost
    no point loads    the points' global loads replaced by a constant
                      (wrong results): what loading them costs

For every variant it prints one JSON line: per shape, the time of one
launch of the lone integer query (``storm_sketch_query``; CUDA events
around 20 back-to-back launches, the least of 3 such runs) and whether the
output equals the plain version's (``ref.sketch_query``). The shapes:
kernel 2 at the probe fit's m = 17 and a 2-tap fleet step's m = 34 (and
m = 1) at d = 3587, R = 2048, p = 4; the wide fit's DFO step (m = 65,
d = 43, R = 4096); m = 17 at d = 515, p = 9 (two passes). Then the cuBLAS
projection alone (``torch.matmul(q, w)``, full fp32) and ``w.sum()`` at the
probe shape, to show what streaming w costs.

``--phases`` builds the package source with ``clock64`` counters around
each part of a step and prints, per warp of one block, the cycles spent
waiting for the chunk, at the barrier, staging (the next chunk's TMA and
points) and projecting, at the probe shapes and the wide fit's.

Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

SOURCE = "sketch_query.cu"
# name -> (old, new): one edit of the source; None: as it is.
VARIANTS = {
    "generic": None,
    "cp.async": ("const bool tma = weight_map(&map, w, d, p, rows, pg);",
                 "const bool tma = false;"),
    "4 stages": ("constexpr int kGenStages = 3;",
                 "constexpr int kGenStages = 4;"),
    "8-warp tiles": ("{{3, 4}, {5, 4}, {3, 8}, {9, 4},",
                     "{{3, 4}, {3, 8}, {5, 4}, {9, 4},"),
    "no projection": ("      project<PPL, TP>(buf + wf",
                      "      if (d < 0) project<PPL, TP>(buf + wf"),
    "no point loads": ("? __ldg(qx + (size_t)e * pstep * d + f0) : 0.f;",
                       "? 1.f : 0.f;"),
}
# (m, d, R, p)
SHAPES = ((1, 3587, 2048, 4), (17, 3587, 2048, 4), (34, 3587, 2048, 4),
          (65, 43, 4096, 4), (17, 515, 2048, 9))
PHASE_SHAPES = ((1, 3587, 2048, 4), (17, 3587, 2048, 4),
                (34, 3587, 2048, 4), (65, 43, 4096, 4))
PHASES = ("wait", "barrier", "stage", "project")

# The counters: cycles per phase of each warp of block (5, 0), summed over
# the steps of one launch.
PROFILE_EDITS = (
    ("namespace generic {\n",
     "namespace generic {\n__device__ unsigned long long g_phase[8][4];\n"),
    ("      if (tma)\n        mbar_wait(",
     "      long long c0 = clock64();\n      if (tma)\n        mbar_wait("),
    ("      __syncthreads();  // step s is in; every thread is done with s - 1\n",
     "      long long c1 = clock64();\n"
     "      __syncthreads();  // step s is in; every thread is done with s - 1\n"
     "      long long c2 = clock64();\n"),
    ("      load_points(s + kGenStages);\n",
     "      load_points(s + kGenStages);\n      long long c3 = clock64();\n"),
    ("                       (min(KC, d - c * KC) + 3) >> 2, acc);\n",
     "                       (min(KC, d - c * KC) + 3) >> 2, acc);\n"
     "      long long c4 = clock64();\n"
     "      if (blockIdx.x == 5 && blockIdx.y == 0 && lane == 0) {\n"
     "        g_phase[warp][0] += c1 - c0; g_phase[warp][1] += c2 - c1;\n"
     "        g_phase[warp][2] += c3 - c2; g_phase[warp][3] += c4 - c3;\n"
     "      }\n"),
    ('extern "C" {\n',
     'extern "C" {\n\n'
     "int storm_phases(void* host, int reset) {\n"
     "  if (reset) {\n"
     "    unsigned long long z[8][4] = {};\n"
     "    return (int)cudaMemcpyToSymbol(generic::g_phase, z, sizeof(z));\n"
     "  }\n"
     "  return (int)cudaMemcpyFromSymbol(host, generic::g_phase,\n"
     "                                   sizeof(generic::g_phase));\n"
     "}\n"),
)


def edited_copy(name, edits, out_dir, csrc):
    """A copy of csrc with the edits applied to the query source."""
    home = out_dir / re.sub(r"\W+", "_", name)
    shutil.rmtree(home, ignore_errors=True)
    shutil.copytree(csrc, home)
    src = (home / SOURCE).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's anchor {old!r} is not "
                               f"in {SOURCE} exactly once")
        src = src.replace(old, new)
    (home / SOURCE).write_text(src)
    return home / SOURCE


def build(src, nvcc_path, flags):
    lib = src.with_suffix(".so")
    proc = subprocess.run([nvcc_path, *flags, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib


def query_fn(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.storm_sketch_query
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib, fn


def events_us(torch, call, reps=20, runs=3):
    """Least over ``runs`` of the mean time of ``reps`` back-to-back calls."""
    best = None
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        per = start.elapsed_time(end) / reps * 1e3
        best = per if best is None else min(best, per)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import _build, ref

    if not torch.cuda.is_available():
        print("query_generic: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: edited_copy(name, [edit] if edit else [], out_dir,
                                 _build.CSRC)
               for name, edit in VARIANTS.items()}
    if args.phases:
        sources["phases"] = edited_copy("phases", PROFILE_EDITS, out_dir,
                                        _build.CSRC)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda s: build(s, _build.nvcc(), _build.NVCC_FLAGS),
            sources.values())))

    dev = torch.device("cuda")
    inputs = {}
    for m, d, rows, p in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(m + d)
        w = torch.randn(p, d, rows, generator=gen, device=dev)
        counts = torch.randint(0, 1 << 12, (rows, 1 << p), generator=gen,
                               device=dev, dtype=torch.int32)
        q = torch.randn(m, d, generator=gen, device=dev)
        inputs[(m, d, rows, p)] = (q, w, counts,
                                   ref.sketch_query(q, w, counts))
    sums = torch.zeros(1 << 13, dtype=torch.int64, device=dev)
    tickets = torch.zeros(1 << 13, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def caller(fn, q, w, counts, out):
        m, d = q.shape
        p, _, rows = w.shape
        return lambda: fn(q.data_ptr(), w.data_ptr(), counts.data_ptr(),
                          out.data_ptr(), sums.data_ptr(), tickets.data_ptr(),
                          m, d, p, rows, 4, stream)

    for name in VARIANTS:
        _, fn = query_fn(libs[name])
        row = {}
        for (m, d, rows, p), (q, w, counts, want) in inputs.items():
            out = torch.empty(m, device=dev)
            call = caller(fn, q, w, counts, out)
            if call() != 0:
                raise RuntimeError(f"{name}: launch failed at m={m} d={d}")
            torch.cuda.synchronize()
            row[f"m={m} d={d} R={rows} p={p}"] = {
                "us": round(events_us(torch, call), 2),
                "equal": bool(torch.equal(out, want))}
        print(json.dumps({"variant": name, "card": smi, **row}), flush=True)

    q, w, _, _ = inputs[(17, 3587, 2048, 4)]
    torch.backends.cuda.matmul.allow_tf32 = False
    for m in (17, 34):
        qm = inputs[(m, 3587, 2048, 4)][0]
        print(json.dumps({
            "cuBLAS projection only": f"m={m} d=3587 R=2048 p=4",
            "us": round(events_us(torch, lambda: torch.matmul(qm, w)), 2),
            "card": smi}), flush=True)
    print(json.dumps({"w.sum()": f"{4 * w.numel() / 1e6:.1f} MB",
                      "us": round(events_us(torch, lambda: w.sum()), 2),
                      "card": smi}), flush=True)

    if args.phases:
        lib, fn = query_fn(libs["phases"])
        lib.storm_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for key in PHASE_SHAPES:
            q, w, counts, _ = inputs[key]
            out = torch.empty(q.shape[0], device=dev)
            call = caller(fn, q, w, counts, out)
            call()
            torch.cuda.synchronize()
            lib.storm_phases(None, 1)
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 32)()
            lib.storm_phases(buf, 0)
            warps = [dict(zip(PHASES, buf[4 * i:4 * i + 4]))
                     for i in range(8) if any(buf[4 * i:4 * i + 4])]
            m, d, rows, p = key
            print(json.dumps({"phases": f"m={m} d={d} R={rows} p={p}",
                              "cycles per warp of block 5": warps,
                              "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
