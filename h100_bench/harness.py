"""Finding a cell's files by name, host spans, the device trace and the
result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness reads ``configs/<config>.json`` (through the configuration's
``file``), ``traffic/<mix>.json`` and the loop module ``traffic/<kind>.py``
that the mix's ``kind`` names, and one reader ``metrics/<metric>.py`` per
per-layer metric of the cell (with ``--trace 1``) or end-to-end metric of
``source`` ``device_trace`` (with ``--trace 0``). A later cell, mix or
metric is a new file: no file here lists them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# Top-level module names that no process of the benchmark may hold: JAX and
# the JAX package. ``repro_torch`` is another name, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """Names in ``sys.modules`` (or ``modules``) whose top-level name is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_of(spec: dict, workload: str) -> dict:
    return _by_name(spec["workloads"], workload, "workload")


def config_of(spec: dict, cell: dict, root: Path = ROOT) -> dict:
    entry = _by_name(spec["configs"], cell["config"], "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def mix_of(cell: dict, bench: Path = BENCH) -> dict:
    with open(bench / "traffic" / f"{cell['traffic']}.json") as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def loop_of(mix: dict, bench: Path = BENCH) -> ModuleType:
    """The loop module of a mix's ``kind``: ``traffic/<kind>.py``."""
    kind = mix["kind"]
    return _module(bench / "traffic" / f"{kind}.py",
                   f"h100_bench_loop_{kind}")


def reader_of(metric: str, bench: Path = BENCH) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<metric>.py``."""
    return _module(bench / "metrics" / f"{metric}.py",
                   "h100_bench_metric_" + metric.replace(".", "_")
                   .replace("-", "_"))


def metrics_of(spec: dict, workload: str, kind: str) -> List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those that list
    it under ``workloads``, or that list no cells (every cell)."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Window:
    """What a cell's window hands back: its end-to-end ``metrics`` by name,
    the requests ``attempted`` and ``failed``, the ``counters`` the
    per-layer readers read, and the ``log`` its check reads."""

    metrics: dict
    attempted: int
    failed: int
    counters: dict
    log: dict


class Spans:
    """Host spans from the benchmark's own loop around calls into the
    program: seconds by name. When ``profiled``, each span is also a
    ``torch.profiler.record_function`` range, so the device trace can say
    what the host was doing in each idle gap."""

    def __init__(self, profiled: bool = False):
        self.profiled = profiled
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.profiled:
            import torch
            ctx = torch.profiler.record_function(f"bench.{name}")
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)


class TraceRun:
    """What a per-layer reader (or an end-to-end one of ``source``
    ``device_trace``) reads: the spans, the program's counters, the device's
    activity in the traced window, the loop's own host-clock numbers
    (``window_metrics``), and the cell's files.

    ``device_ops``: ``(name, start_us, end_us)`` of every kernel and copy on
    the card (the profiler's clock); ``window_us``: the traced window
    ``(start, end)`` on that clock; ``host``: ``(name, start_us, end_us)``
    of the spans.
    """

    def __init__(self, spans: Spans, counters: dict, config: dict, mix: dict,
                 device_ops: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]],
                 window_us: Tuple[float, float],
                 window_metrics: Optional[dict] = None):
        self.spans = spans.seconds
        self.counters = counters
        self.window_metrics = dict(window_metrics or {})
        self.config = config
        self.mix = mix
        self.device_ops = device_ops
        self.host = host
        self.window_us = window_us

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity inside the window, merged."""
        lo, hi = self.window_us
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_ops
                       if e > lo and s < hi)
        merged: List[Tuple[float, float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_us(self, symbol: str) -> Tuple[float, int]:
        """Total µs and records of the device function ``symbol`` (demangled
        ``ns::symbol<...>`` or mangled ``<len>symbol``)."""
        hits = [e - s for name, s, e in self.device_ops
                if f"::{symbol}" in name or f"{len(symbol)}{symbol}" in name
                or name.startswith(symbol)]
        return sum(hits), len(hits)

    def breakdown(self) -> dict:
        """The ten device ops that took most time, and the ten longest idle
        gaps named by the span the host was in."""
        by_op: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.device_ops:
            by_op[name[:160]] += (e - s) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        busy = self.busy_intervals()
        lo, hi = self.window_us
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for s, e in gaps[:10]:
            best, cover = "no span", 0.0
            for name, hs, he in self.host:
                c = min(e, he) - max(s, hs)
                if c > cover:
                    best, cover = name, c
            named.append([best, (e - s) / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def read_profile(prof) -> Tuple[list, list, Tuple[float, float]]:
    """``(device_ops, host spans, window)`` in µs from a finished
    ``torch.profiler.profile``; the window is the ``bench.window`` span.
    Reads the raw Kineto records: building the profiler's event tree for a
    window of a million ops takes minutes."""
    from torch.autograd import DeviceType

    device, host = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            # The spans' own ranges appear on the device's timeline too.
            if not name.startswith("bench."):
                device.append((name, s, t))
        elif name.startswith("bench."):
            if name == "bench.window":
                window = (s, t)
            else:
                host.append((name[len("bench."):], s, t))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return device, host, window


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: List[Tuple[str, float, float]],
                breakdown: Optional[dict] = None) -> str:
    """The run's last line: the keys a reader of the result needs, then
    ``checks``, each number compared beside its limit, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)
