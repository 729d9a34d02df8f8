"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell's files by name, a fixture-added one without an edit."""

import json
import shutil
from pathlib import Path

import pytest

from h100_bench import harness

SPEC = harness.load_spec()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
METRIC = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP
    assert SPEC["command"] == ["python3", "h100_bench/run.py"]
    assert SPEC["paths"] == ["h100_bench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in SPEC[key]:
            yield item["name"]
    for cell in SPEC["workloads"]:
        yield cell["config"]
        yield cell["traffic"]
    for cfg in SPEC["configs"]:
        yield from cfg["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert harness.NAME.match(name), name


def _texts():
    for cfg in SPEC["configs"]:
        yield cfg["why"]
        yield cfg["source"]
    for cell in SPEC["workloads"]:
        yield cell["why"]
    for m in SPEC["per_layer"]:
        yield m["layer"]
    yield from SPEC["command"]


@pytest.mark.parametrize("text", list(_texts()))
def test_text_fields_are_one_short_line(text):
    assert 1 <= len(text) <= 200
    assert "\n" not in text and "\t" not in text


def test_file_size():
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert harness.UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert set(metric) - {"workloads"} == METRIC | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == METRIC | {"layer", "moves"}
        moved = [m for m in SPEC["end_to_end"] if m["name"] == metric["moves"]]
        assert moved
        cells = metric.get("workloads", [c["name"] for c in SPEC["workloads"]])
        for cell in cells:
            assert cell in moved[0].get("workloads", [cell])


def test_names_unique_and_every_cell_reports_enough():
    for key in ("configs", "workloads"):
        names = [i["name"] for i in SPEC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for cell in SPEC["workloads"]:
        e2e = harness.metrics_of(SPEC, cell["name"], "end_to_end")
        assert len(e2e) >= 2 and any(m["name"] == "setup_s" for m in e2e)
        assert harness.metrics_of(SPEC, cell["name"], "per_layer")
        assert cell["chips"] in (1, 4)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_every_cell_finds_its_files(cell):
    config = harness.config_of(SPEC, cell)
    assert config["name"] == cell["config"]
    mix = harness.mix_of(cell)
    loop = harness.loop_of(mix)
    assert hasattr(loop, "Session")
    for m in harness.metrics_of(SPEC, cell["name"], "per_layer"):
        assert callable(harness.reader_of(m["name"]).read)
    for m in harness.metrics_of(SPEC, cell["name"], "end_to_end"):
        if m["source"] == "device_trace":
            assert callable(harness.reader_of(m["name"]).read)


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_lie_under_paths(cfg):
    assert cfg["file"].startswith("h100_bench/")
    assert (harness.ROOT / cfg["file"]).is_file()
    assert json.loads((harness.ROOT / cfg["file"]).read_text())["reduced"] \
        == cfg["reduced"]


def test_added_files_are_found_without_an_edit(tmp_path):
    """A later cell brings a configuration, a mix and a metric as new files
    and BENCHMARK.json entries; the harness finds them by name."""
    bench = tmp_path / "h100_bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "storm-airfoil-4t.json").write_text(json.dumps(
        {"name": "storm-airfoil-4t", "reduced": []}))
    (bench / "traffic" / "ingest-burst.json").write_text(json.dumps(
        {"kind": "storm_ingest", "clients": 4}))
    (bench / "metrics" / "queue_depth.burst.py").write_text(
        "def read(run):\n    return run.counters.get('depth')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "storm-airfoil-4t", "source": "x",
                            "file": "h100_bench/configs/storm-airfoil-4t.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "storm-airfoil-4t.ingest-burst",
                              "config": "storm-airfoil-4t",
                              "traffic": "ingest-burst", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "queue_depth.burst", "unit": "requests",
                              "better": "lower", "source": "program_counter",
                              "layer": "gateway", "moves": "rows_per_s",
                              "workloads": ["storm-airfoil-4t.ingest-burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    spec = harness.load_spec(tmp_path)
    cell = harness.cell_of(spec, "storm-airfoil-4t.ingest-burst")
    assert harness.config_of(spec, cell, tmp_path)["name"] == \
        "storm-airfoil-4t"
    mix = harness.mix_of(cell, bench)
    assert harness.loop_of(mix, bench).Session
    names = [m["name"] for m in harness.metrics_of(spec, cell["name"],
                                                   "per_layer")]
    assert names == ["queue_depth.burst"]

    class Run:
        counters = {"depth": 3}

    assert harness.reader_of("queue_depth.burst", bench).read(Run()) == 3
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert {k: after[k] for k in before if "__pycache__" not in k.parts} == \
        {k: v for k, v in before.items() if "__pycache__" not in k.parts}


def test_result_line_shape():
    checks = [("counter_cells_off", 0, 0), ("feat_gap", 0.01, 0.05)]
    line = harness.result_line(
        True, 10, 0, {"rows_per_s": {"value": 1.5, "unit": "rows/s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 7}, checks,
        {"device_ops": [["k", 0.1]], "idle_gaps": [["tick_start", 0.01]]})
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["feat_gap"] == {"value": 0.01, "limit": 0.05}
    assert "\n" not in line
