#!/usr/bin/env python3
"""Build variants of the insert and query kernels and compare them on one card.

    python3 scripts/insert_variants.py [--parent TREE] [--family NAME ...]

Each variant is a copy of a source in ``src/repro_torch/kernels/csrc`` with
one or more constants rewritten (in the source or in a header it includes),
compiled by ``nvcc`` with the repository's flags. The paired insert (``paired_hash_histogram.cu``,
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

The projection tile (``projection_tile.cuh``: the inserts' wide body and
the SRP hash's tiled path) and the SRP hash's register path
(``srp_hash.cu``, kernel 7), whose constants may live in a header:

    wide              both insert sources as the package builds them
    wide points=4     kProjPointsNarrow = 4: points per thread at p <= 4
    wide blocks=2     kProjMinBlocksNarrow = 2: two blocks per SM at p <= 4
                      (128 registers, spills)
    wide points=4 blocks=3   both: three blocks per SM
    wide chunk=32     kProjChunkNarrow = 32: features per stage
    srp               the source as the package builds it
    srp rows=1        kPairPlanes = 0: one hash row per thread everywhere
    srp threads=256   kRegThreads = 256: threads per block
    srp points=4, srp blocks=2   the tile's constants, as for ``wide``

``--parent TREE`` adds the sources of another checkout (the parent commit,
unpacked by ``git archive``) as ``paired parent``, ``single parent``,
``query parent``, ``wide parent`` and ``srp parent``. ``--family`` picks
families (default: all five).

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

A wide variant prints registers and spills of the tile at p = 4 (paired
and single-sided; the parent's lone and banked kernels), the hot loop's instructions per
multiply-add (``sass``: ``per_ma``, ``total_per_ma``; the loop with the most
FMULs per instruction, one FMUL per multiply-add), and the median
CUDA-event time of the lone inserts at d = 515, n = 2^16, R = 2048, p = 4
(``paired_ms``, ``single_ms``) and of the paired insert at p = 9 on 2^14
rows (``paired_p9_ms``). An srp variant prints registers and spills of the
register path at d = 12, p = 4 and of the tile at p = 4, the register
path's hot loop per (point, row) pair (``sass_reg``) and the tile's per
multiply-add (``sass_tile``), and the median CUDA-event time of
``storm_srp_hash`` at n = 2^18, d = 12, R = 2048, p = 4 (``reg_ms``) and
at n = 2^16, d = 515, R = 2048, p = 4 (``tile_ms``).

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
# The projection tile. A variant's edits may rewrite several constants, in
# the sources or in a header; the stems name the main instantiations (PG = 4,
# PAIRED; one kernel serves lone and banked streams) in this tree
# and in the parent's wide_hist_kernel (PMAX = 8, TPT = 4), lone then
# banked.
TILE_VARIANTS = {
    "points=4": (("kProjPointsNarrow", 4),),
    "blocks=2": (("kProjMinBlocksNarrow", 2),),
    "points=4 blocks=3": (("kProjPointsNarrow", 4),
                          ("kProjMinBlocksNarrow", 3)),
    "chunk=32": (("kProjChunkNarrow", 32),),
}
WIDE = dict(
    sources=("paired_hash_histogram.cu", "hash_histogram.cu"),
    variants=TILE_VARIANTS, d=515, n=1 << 16, rows=2048, planes=4,
    stems={"new": {"paired": ("projection_tile_kernelILi4ELb1E",),
                   "single": ("projection_tile_kernelILi4ELb0E",)},
           "parent": {"paired": ("wide_hist_kernelILi8ELi4ELb1ELb0E",
                                 "wide_hist_kernelILi8ELi4ELb1ELb1E"),
                      "single": ("wide_hist_kernelILi8ELi4ELb0ELb0E",
                                 "wide_hist_kernelILi8ELi4ELb0ELb1E")}})
SRP = dict(
    sources=("srp_hash.cu",),
    variants={"rows=1": (("kPairPlanes", 0),),
              "threads=256": (("kRegThreads", 256),),
              "points=4": TILE_VARIANTS["points=4"],
              "blocks=2": TILE_VARIANTS["blocks=2"]},
    reg=(1 << 18, 12, 2048, 4), tile=(1 << 16, 515, 2048, 4),
    stems={"new": ("srp_hash_reg_kernelILi4ELi12ELi12ELi2E",
                   "srp_hash_reg_kernelILi4ELi12ELi12ELi1E",
                   "projection_tile_kernelILi4ELb0E"),
           "parent": ("srp_hash_reg_kernelILi4ELi16E", None,
                      "srp_hash_tiled_kernel")})
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")


def constant_pattern(name):
    return rf"(constexpr int {name} = )(\d+);"


def variant_tree(sources, edits, out_dir, name):
    """Copies of ``sources`` (file names in the package's ``csrc``) in a
    directory of their own, with every ``(NAME, value)`` of ``edits``
    rewritten where the sources define it, else where a header does (a
    rewritten header lies beside the copies, which include it first):
    ``{source: path}``, or None where no constant changes (the default
    build is that variant)."""
    headers = sorted(f.name for f in CSRC.glob("*.cuh"))
    files = {f: (CSRC / f).read_text() for f in [*sources, *headers]}
    changed = set()
    for const, value in edits:
        def defines(names):
            return [f for f in names
                    if re.search(constant_pattern(const), files[f])]
        where = defines(sources) or defines(headers)
        if len(where) != 1:
            raise RuntimeError(f"{const} is not one constant of {sources}")
        text = files[where[0]]
        if int(re.search(constant_pattern(const), text).group(2)) == value:
            continue
        files[where[0]] = re.sub(constant_pattern(const),
                                 rf"\g<1>{value};", text)
        changed.add(where[0])
    if not changed:
        return None
    home = out_dir / name.replace("=", "_").replace(" ", "_")
    home.mkdir(parents=True, exist_ok=True)
    for f in changed | set(sources):
        (home / f).write_text(files[f])
    return {s: home / s for s in sources}


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


def hot_loop_mix(lib, stem, planes, compares, per="pair"):
    """Opcode counts per pair (per="pair") or per multiply-add (per="ma":
    one FMUL each) in the hot loop of the function ``stem``."""
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
    if per == "ma":
        units = counts["FMUL"]
    else:
        units = (counts["FSETP"] + counts["FSET"]) / (compares * planes)
    return {"instructions": len(ops), f"{per}s_per_iteration": units,
            f"per_{per}": {k: round(v / units, 3)
                           for k, v in sorted(counts.items())},
            f"total_per_{per}": round(len(ops) / units, 3),
            "outer_extra": outer_extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--family", nargs="+",
                    default=["paired", "single", "query", "wide", "srp"],
                    choices=["paired", "single", "query", "wide", "srp"])
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
            copies = variant_tree((spec["source"],), (constant,), out_dir,
                                  f"{fam} {label}")
            if copies is not None:
                jobs[f"{fam} {label}"] = (fam, copies[spec["source"]], "new")
        if args.parent is not None:
            jobs[f"{fam} parent"] = (fam, args.parent.resolve()
                                     / "src/repro_torch/kernels/csrc"
                                     / spec["source"], "parent")
    # The tile families: name -> (family, {source: path}, tree).
    tile_jobs = {}
    for fam, spec in (("wide", WIDE), ("srp", SRP)):
        if fam not in args.family:
            continue
        tile_jobs[fam] = (fam, {s: CSRC / s for s in spec["sources"]}, "new")
        for label, edits in spec["variants"].items():
            copies = variant_tree(spec["sources"], edits, out_dir,
                                  f"{fam} {label}")
            if copies is not None:
                tile_jobs[f"{fam} {label}"] = (fam, copies, "new")
        if args.parent is not None:
            tile_jobs[f"{fam} parent"] = (fam, {
                s: args.parent.resolve() / "src/repro_torch/kernels/csrc" / s
                for s in spec["sources"]}, "parent")
    units = {name: (name, src) for name, (_, src, _) in jobs.items()}
    units.update({f"{name} {Path(s).stem}": (f"{name} {Path(s).stem}", path)
                  for name, (_, srcs, _) in tile_jobs.items()
                  for s, path in srcs.items()})
    with ThreadPoolExecutor(len(units)) as pool:
        done = dict(zip(units, pool.map(
            lambda u: build(units[u][0], units[u][1], out_dir, _build.nvcc(),
                            _build.NVCC_FLAGS), units)))
    built = {name: done[name] for name in jobs}
    tile_built = {name: {Path(s).stem: done[f"{name} {Path(s).stem}"]
                         for s in srcs}
                  for name, (_, srcs, _) in tile_jobs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def unit_ball(n, d):
        return lsh.scale_to_unit_ball(
            torch.randn(n, d, generator=gen, device=dev))[0].contiguous()

    for fam, timer in (("wide", time_wide), ("srp", time_srp)):
        if fam in args.family:
            timer({n: tile_built[n] for n in tile_jobs
                   if tile_jobs[n][0] == fam},
                  {n: tile_jobs[n] for n in tile_jobs
                   if tile_jobs[n][0] == fam}, torch, gen, unit_ball)
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


def _event_ms(torch, fn, reps=5):
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
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


def _checked(name, fn):
    def call(*a):
        code = fn(*a)
        if code != 0:
            raise RuntimeError(f"{name}: CUDA error {code}")
    return call


def time_wide(built, jobs, torch, gen, unit_ball):
    """One JSON line per wide variant (see the module note)."""
    dev = torch.device("cuda")
    d, n, rows, p = (WIDE[k] for k in ("d", "n", "rows", "planes"))
    z = unit_ball(n, d)
    z9 = z[:1 << 14].contiguous()
    ones = torch.ones(n, device=dev)
    w = {True: torch.randn(p, d + 2, rows, generator=gen, device=dev),
         False: torch.randn(p, d, rows, generator=gen, device=dev)}
    w9 = torch.randn(9, d + 2, rows, generator=gen, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    reference = None
    for name, libs in built.items():
        tree = jobs[name][2]
        out = {"variant": name, "card": torch.cuda.get_device_name(0),
               "ptxas": {}, "sass": {}}
        outputs = []
        for key, stem, paired in (("paired", "paired_hash_histogram", True),
                                  ("single", "hash_histogram", False)):
            lib_path, log = libs[stem]
            lib = ctypes.CDLL(str(lib_path))
            fn = getattr(lib, f"storm_{stem}")
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            call = _checked(name, fn)
            stems = WIDE["stems"][tree][key]
            out["ptxas"][key] = ptxas_usage(log, stems)
            out["sass"][key] = hot_loop_mix(lib_path, stems[0], p, 0,
                                            per="ma")
            hist = torch.zeros(rows, 1 << p, dtype=torch.int32, device=dev)

            def run(call=call, wi=w[paired], hist=hist):
                hist.zero_()
                call(z.data_ptr(), wi.data_ptr(), ones.data_ptr(),
                     hist.data_ptr(), hist.data_ptr(), n, d, p, rows, 4,
                     stream)

            out[f"{key}_ms"] = _event_ms(torch, run)
            outputs.append(hist.clone())
            if paired:
                h9 = torch.zeros(rows, 1 << 9, dtype=torch.int32, device=dev)

                def run9(call=call):
                    h9.zero_()
                    call(z9.data_ptr(), w9.data_ptr(), ones.data_ptr(),
                         h9.data_ptr(), h9.data_ptr(), z9.shape[0], d, 9,
                         rows, 4, stream)

                out["paired_p9_ms"] = _event_ms(torch, run9)
                outputs.append(h9.clone())
        reference = reference or outputs
        out["equal"] = [torch.equal(a, b) for a, b in zip(outputs, reference)]
        print(json.dumps(out), flush=True)


def time_srp(built, jobs, torch, gen, unit_ball):
    """One JSON line per srp variant (see the module note)."""
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {}
    for key in ("reg", "tile"):
        n, d, rows, p = SRP[key]
        shapes[key] = (torch.randn(n, d, generator=gen, device=dev),
                       torch.randn(p, d, rows, generator=gen, device=dev),
                       torch.empty(n, rows, dtype=torch.int32, device=dev))
    reference = None
    for name, libs in built.items():
        tree = jobs[name][2]
        lib_path, log = libs["srp_hash"]
        lib = ctypes.CDLL(str(lib_path))
        lib.storm_srp_hash.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        call = _checked(name, lib.storm_srp_hash)
        reg2, reg1, tile = SRP["stems"][tree]
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               str(lib_path)], capture_output=True,
                              text=True, check=True).stdout
        reg = reg2 if reg2 in sass else reg1
        out = {"variant": name, "card": torch.cuda.get_device_name(0),
               "ptxas": ptxas_usage(log, (reg, tile)),
               "sass_reg": hot_loop_mix(lib_path, reg, SRP["reg"][3], 1),
               "sass_tile": hot_loop_mix(lib_path, tile, SRP["tile"][3], 0,
                                         per="ma")}
        outputs = []
        for key in ("reg", "tile"):
            n, d, rows, p = SRP[key]
            x, w, codes = shapes[key]
            out[f"{key}_ms"] = _event_ms(torch, lambda: call(
                x.data_ptr(), w.data_ptr(), codes.data_ptr(), n, d, p, rows,
                stream))
            outputs.append(codes.clone())
        reference = reference or outputs
        out["equal"] = [torch.equal(a, b) for a, b in zip(outputs, reference)]
        print(json.dumps(out), flush=True)


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
