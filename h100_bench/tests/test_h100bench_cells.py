"""Each cell's loop and reference at smoke sizes on the CPU (the port's
plain versions stand in for its kernels): a sound run comes out correct,
the control (the reference in the next lower precision in the program's
place) and every planted fault come out not correct. The card's own test,
marked ``gpu``, runs a short cell through ``run.py``."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100_bench import harness

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345  # above 32 signed bits, as a checker's seeds may be


def storm_cell(mix_name):
    cfg = json.loads((harness.BENCH / "configs" /
                      "storm-airfoil-16t.json").read_text())
    cfg["gateway"].update(tenants=3, rows=64, ingest_slots=256)
    mix = json.loads((harness.BENCH / "traffic" /
                      f"{mix_name}.json").read_text())
    mix.update(clients=3, pool_rows=4096, check_queries=4,
               query_every_ticks=4, schedule=64)
    mix["size"] = ({"fixed": 256} if "fixed" in mix["size"]
                   else {"loguniform": [16, 256]})
    return cfg, mix


def lm_cell(mix_name):
    from repro_torch.configs import registry

    cfg = json.loads((harness.BENCH / "configs" /
                      "zamba2-2.7b-taps.json").read_text())
    smoke = dataclasses.asdict(registry.get_config("zamba2-2.7b",
                                                   smoke=True))
    cfg["model"] = {k: list(v) if isinstance(v, tuple) else v
                    for k, v in smoke.items() if k in cfg["model"]}
    cfg["taps"]["layers"] = [0, 1]
    cfg["gateway"].update(rows=64, ingest_slots=16)
    cfg["bridge"]["window"] = 4  # every smoke batch flushes
    mix = json.loads((harness.BENCH / "traffic" /
                      f"{mix_name}.json").read_text())
    mix.update(seq_len=min(mix["seq_len"], 32), batch=min(mix["batch"], 8),
               check_sequences=3)
    return cfg, mix


CELLS = {"storm-airfoil-16t.ingest-uniform": storm_cell("ingest-uniform"),
         "storm-airfoil-16t.ingest-zipf": storm_cell("ingest-zipf")}


def cells():
    out = dict(CELLS)
    out["zamba2-2.7b-taps.doc-2048"] = lm_cell("doc-2048")
    out["zamba2-2.7b-taps.msg-128"] = lm_cell("msg-128")
    return out


def run_cell(name, seconds=0.4, control=False, seed=SEED):
    cfg, mix = cells()[name]
    loop = harness.loop_of(mix)
    session = loop.Session(cfg, mix, seed, CPU)
    win = session.window(seconds, harness.Spans())
    if control:
        session.lower(win)
    checks = session.judge(win)
    return win, checks, all(v <= lim for _, v, lim in checks)


NAMES = sorted(CELLS) + ["zamba2-2.7b-taps.doc-2048",
                         "zamba2-2.7b-taps.msg-128"]


@pytest.mark.parametrize("name", NAMES)
def test_sound_run_is_correct(name):
    win, checks, ok = run_cell(name)
    assert ok, checks
    assert win.attempted > 0 and win.failed == 0
    assert all(v is not None and v > 0 for v in win.metrics.values())


@pytest.mark.parametrize("name", NAMES)
def test_control_is_not_correct(name):
    _, checks, ok = run_cell(name, control=True)
    assert not ok, checks


def test_same_seed_same_inputs():
    cfg, mix = CELLS["storm-airfoil-16t.ingest-zipf"]
    loop = harness.loop_of(mix)
    a = loop.Session(cfg, mix, SEED, CPU)
    b = loop.Session(cfg, mix, SEED, CPU)
    assert np.array_equal(a.pool, b.pool)
    assert np.array_equal(a.who, b.who) and np.array_equal(a.sizes, b.sizes)
    assert torch.equal(a.projections, b.projections)
    c = loop.Session(cfg, mix, SEED + 1, CPU)
    # Another seed: the same multiset of sizes and tenants, another order.
    assert sorted(c.sizes) == sorted(a.sizes)
    assert sorted(c.who) == sorted(a.who)
    assert not np.array_equal(c.sizes, a.sizes)


# -- planted faults: the timed path broken underneath ----------------------


def _storm_state_unchanged(mp):
    from repro_torch.serve import storm_gateway
    mp.setattr(storm_gateway.StormGateway, "_ingest_half",
               lambda self, sh: None)


def _storm_half_batch(mp):
    from repro_torch.kernels import ops
    insert = ops.paired_hash_histogram_banked

    def half(z, w, mask, **kw):
        mask = mask.clone()
        mask[:, mask.shape[1] // 2:] = 0
        return insert(z, w, mask, **kw)

    mp.setattr(ops, "paired_hash_histogram_banked", half)


def _storm_answer_altered(mp):
    from repro_torch.serve import storm_gateway
    query = storm_gateway.StormGateway._query_half
    mp.setattr(storm_gateway.StormGateway, "_query_half",
               lambda self, sh: query(self, sh) * 1.001)


def _lm_state_unchanged(mp):
    from repro_torch.serve import storm_gateway
    mp.setattr(storm_gateway.StormGateway, "_ingest_half",
               lambda self, sh: None)


def _lm_half_batch(mp):
    from repro_torch.telemetry import taps
    extract = taps.extract_tap_features

    def half(params, cfg, batch, tap):
        toks = batch["tokens"]
        keep = toks[: max(1, toks.shape[0] // 2)]
        rep = keep.repeat((toks.shape[0] + keep.shape[0] - 1)
                          // keep.shape[0], 1)[: toks.shape[0]]
        return extract(params, cfg, {"tokens": rep}, tap)

    mp.setattr(taps, "extract_tap_features", half)


def _lm_answer_altered(mp):
    from repro_torch.telemetry import taps
    extract = taps.extract_tap_features

    def altered(params, cfg, batch, tap):
        feats, targets = extract(params, cfg, batch, tap)
        feats = feats.clone()
        feats[:, -1] = feats[:, 0]  # the last sequence's taps: another's
        return feats, targets

    mp.setattr(taps, "extract_tap_features", altered)


FAULTS = [
    ("storm-airfoil-16t.ingest-uniform", _storm_state_unchanged),
    ("storm-airfoil-16t.ingest-uniform", _storm_half_batch),
    ("storm-airfoil-16t.ingest-uniform", _storm_answer_altered),
    ("storm-airfoil-16t.ingest-zipf", _storm_half_batch),
    ("zamba2-2.7b-taps.msg-128", _lm_state_unchanged),
    ("zamba2-2.7b-taps.msg-128", _lm_half_batch),
    ("zamba2-2.7b-taps.doc-2048", _lm_half_batch),
    ("zamba2-2.7b-taps.doc-2048", _lm_answer_altered),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    """The exchange between chips has no fault to plant: every cell runs on
    one card."""
    fault(monkeypatch)
    seconds = 1.5 if "doc" in name else 0.4
    _, checks, ok = run_cell(name, seconds=seconds)
    assert not ok, checks


@pytest.mark.parametrize("plant", [False, True])
def test_jax_imported_by_the_check_refuses_the_result(plant, monkeypatch,
                                                      capsys):
    """A module of JAX that only the check (or a reader) loads, after the
    window, still stops the result line: the look comes last. Without one,
    the same run prints its result as the last line."""
    import types

    sys.path.insert(0, str(harness.BENCH))
    import run

    name = "storm-airfoil-16t.ingest-uniform"
    cfg, mix = cells()[name]
    session = harness.loop_of(mix).Session(cfg, mix, SEED, CPU)
    win = session.window(0.3, harness.Spans())
    judge = session.judge

    def judge_and_import(w):
        if plant:
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return judge(w)

    session.judge = judge_and_import
    spec = harness.load_spec()
    rc = run.finish(spec, harness.cell_of(spec, name), session, win, 1.0,
                    {"platform": "cpu"})
    out = capsys.readouterr()
    if plant:
        assert rc == 3 and out.out == ""
        assert "jax" in out.err
    else:
        assert rc == 0
        line = json.loads(out.out.strip().splitlines()[-1])
        assert line["correct"] and list(line)[-1] == "checks"


def test_device_trace_metric_is_read_in_an_untraced_run(capsys):
    """An end-to-end metric of ``source`` ``device_trace`` comes from its
    reader over the profiled window, with ``--trace 0``: rows inserted over
    the card's busy seconds; the loop's host numbers go to standard error
    and the per-layer metrics stay out of the line."""
    sys.path.insert(0, str(harness.BENCH))
    import run

    name = "storm-airfoil-16t.ingest-uniform"
    cfg, mix = cells()[name]
    session = harness.loop_of(mix).Session(cfg, mix, SEED, CPU)
    win = session.window(0.3, harness.Spans())
    # Two overlapping ops and one apart: 3 s busy in a 10 s window.
    ops = [("paired_hist_kernel", 1e6, 2e6), ("Memcpy HtoD", 1.5e6, 2.5e6),
           ("paired_hist_kernel", 5e6, 6.5e6)]
    trace = harness.TraceRun(harness.Spans(), win.counters, cfg, mix, ops,
                             [], (0.0, 10e6), win.metrics)
    spec = harness.load_spec()
    rc = run.finish(spec, harness.cell_of(spec, name), session, win, 1.0,
                    {"platform": "cpu"}, trace, traced=False)
    out = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"card_rows_per_s", "setup_s"}
    assert line["metrics"]["card_rows_per_s"]["value"] == pytest.approx(
        win.counters["inserted_rows"] / 3.0)
    assert "window rows_per_s" in out.err
    assert out.err.strip().splitlines()[-1].startswith("check ")


def test_host_numbers_are_per_layer_where_the_host_paces():
    """In the traced run the demoted host-clock numbers are the loop's
    own, read by their per-layer readers."""
    name = "storm-airfoil-16t.ingest-uniform"
    cfg, mix = cells()[name]
    session = harness.loop_of(mix).Session(cfg, mix, SEED, CPU)
    win = session.window(0.3, harness.Spans())
    trace = harness.TraceRun(harness.Spans(), win.counters, cfg, mix, [],
                             [], (0.0, 1e6), win.metrics)
    for metric in ("rows_per_s", "ingest_p95_ms"):
        got = harness.reader_of(f"{metric}.host").read(trace)
        assert got == win.metrics[metric] and got > 0


@pytest.mark.gpu
def test_a_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "storm-airfoil-16t.ingest-uniform", "--seed", str(SEED),
         "--seconds", "2", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=900, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "storm-airfoil-16t.ingest-uniform", "--seed", "1", "--seconds",
         "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
