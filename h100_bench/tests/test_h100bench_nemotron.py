"""The NemotronH capture cell (``hybrid_capture``) at smoke widths on the
CPU: a sound run is correct, the control and every planted fault are not;
its counts, frozen here, and its readers; its reference imports nothing of
the port or of JAX."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from h100_bench import harness
from h100_bench.counts import expert_bound, nemotron_h_flops

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
NAME = "nemotron-3-nano-30b-a3b-taps"


def _config():
    return json.loads((harness.BENCH / "configs" / f"{NAME}.json")
                      .read_text())


def cell():
    from repro_torch.configs import registry

    cfg = _config()
    smoke = dataclasses.asdict(registry.get_config(
        "nemotron-3-nano-30b-a3b", smoke=True))
    cfg["model"] = {k: list(v) if isinstance(v, tuple) else v
                    for k, v in smoke.items() if k in cfg["model"]}
    cfg["taps"]["layers"] = [3, 7]
    cfg["gateway"].update(rows=64, ingest_slots=16)
    cfg["bridge"]["window"] = 4  # every smoke batch flushes
    mix = json.loads((harness.BENCH / "traffic" /
                      "doc-zipf-8x2048.json").read_text())
    mix.update(seq_len=32, batch=4, check_sequences=3)
    return cfg, mix


def run_cell(seconds=0.6, control=False, seed=SEED):
    cfg, mix = cell()
    session = harness.loop_of(mix).Session(cfg, mix, seed, CPU)
    win = session.window(seconds, harness.Spans())
    if control:
        session.lower(win)
    checks = session.judge(win)
    return session, win, checks, all(v <= lim for _, v, lim in checks)


def test_sound_run_is_correct(capsys):
    _, win, checks, ok = run_cell()
    assert ok, checks
    assert ("rerun_off", 0, 0) in checks
    assert win.attempted > 0 and win.metrics["tokens_per_s"] > 0
    err = capsys.readouterr().err
    assert "routing apart 0 of " in err


def test_control_is_not_correct():
    _, _, checks, ok = run_cell(control=True)
    assert not ok, checks


def test_same_seed_same_tokens():
    cfg, mix = cell()
    loop = harness.loop_of(mix)
    a, b = (loop.Session(cfg, mix, SEED, CPU) for _ in range(2))
    ta, tb = a._tokens(), b._tokens()
    assert torch.equal(ta, tb)
    c = loop.Session(cfg, mix, SEED + 1, CPU)
    assert not torch.equal(c._tokens(), ta)
    # Zipf over the permuted ids: the commonest id is not id 0 everywhere,
    # and it takes about 1 / H_V of the draws.
    toks = torch.cat([a._tokens().flatten() for _ in range(40)])
    top = torch.bincount(toks, minlength=cfg["model"]["vocab_size"])
    h = sum(1.0 / r for r in range(1, cfg["model"]["vocab_size"] + 1))
    assert abs(top.max().item() / toks.numel() - 1 / h) < 0.05


# -- planted faults ----------------------------------------------------------


def _half_batch(mp):
    from repro_torch.telemetry import taps
    extract = taps.extract_tap_features

    def half(params, cfg, batch, tap):
        toks = batch["tokens"]
        keep = toks[: max(1, toks.shape[0] // 2)]
        return extract(params, cfg, {"tokens": keep.repeat(2, 1)}, tap)

    mp.setattr(taps, "extract_tap_features", half)


def _answer_altered(mp):
    from repro_torch.telemetry import taps
    extract = taps.extract_tap_features

    def altered(params, cfg, batch, tap):
        feats, targets = extract(params, cfg, batch, tap)
        feats = feats.clone()
        feats[:, -1] = feats[:, 0]  # the last sequence's taps: another's
        return feats, targets

    mp.setattr(taps, "extract_tap_features", altered)


def _shared_expert_dropped(mp):
    from repro_torch.models import moe
    layer = moe.dropless_moe

    def dropped(params, x, **kw):
        return layer({k: v for k, v in params.items()
                      if not k.startswith("shared")}, x, **kw)

    mp.setattr(moe, "dropless_moe", dropped)


def _choice_flipped(mp):
    from repro_torch.models import moe
    route = moe.route_sigmoid_bias

    def flipped(x, router, bias, k, scale):
        idx, w = route(x, router, bias, k, scale)
        idx = idx.clone()
        # Each token's last choice to the next expert not already chosen.
        e = router.shape[1]
        nxt = (idx[:, -1] + 1) % e
        while True:
            taken = (idx[:, :-1] == nxt[:, None]).any(-1)
            if not taken.any():
                break
            nxt = torch.where(taken, (nxt + 1) % e, nxt)
        idx[:, -1] = nxt
        return idx, w

    mp.setattr(moe, "route_sigmoid_bias", flipped)


def _rerun_differs(mp):
    """The window's batches right; the re-runs that give the check its
    routing off from them by a rounding, which no gap of the taps or of
    the routing can see."""
    loop_of = harness.loop_of

    def patched(mix):
        loop = loop_of(mix)
        judge = loop.Session.judge

        def judged(self, win):
            extract = self.taps_lib.extract_tap_features

            def other(params, cfg, batch, tap):
                feats, targets = extract(params, cfg, batch, tap)
                return feats * (1 + 2 ** -20), targets

            mp.setattr(self.taps_lib, "extract_tap_features", other)
            return judge(self, win)

        loop.Session.judge = judged
        return loop

    mp.setattr(harness, "loop_of", patched)


FAULTS = [_half_batch, _answer_altered, _shared_expert_dropped,
          _choice_flipped, _rerun_differs]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, _, checks, ok = run_cell()
    assert not ok, checks
    if fault is _rerun_differs:
        assert dict((n, v) for n, v, _ in checks)["rerun_off"] == 1, checks


# -- counts and readers -------------------------------------------------------


def test_flops_are_frozen():
    """Frozen here, not in ``counts/frozen.json``: 5.91 GFLOP a token at
    2048, of which the MoE layers' 3.69."""
    m = _config()["model"]
    assert nemotron_h_flops.per_sequence(m, 2048) == 12107412144128.0
    assert nemotron_h_flops.per_sequence(m, 128) == 745294266368.0
    moe = 23 * sum(nemotron_h_flops.moe_terms(m).values())
    assert moe == 3687677952.0


def test_expert_bound_tied_to_the_layer():
    """The bound's operations and bytes from the grouped products' own
    shapes at the smoke widths: the experts' stacks as the layer holds
    them, the rows its routing chose."""
    from repro_torch.configs import registry
    from repro_torch.models import moe

    c = registry.get_config("nemotron-3-nano-30b-a3b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_dropless(gen, c.d_model, c.d_ff, c.num_experts,
                          c.moe_shared_d_ff, torch.bfloat16)
    x = torch.randn((2, 16, c.d_model), generator=gen)
    with torch.no_grad(), moe.record_choices() as got:
        moe.dropless_moe(p, x, experts_per_token=c.experts_per_token,
                         routed_scale=c.moe_routed_scale,
                         compute_dtype=torch.bfloat16)
    per = torch.bincount(got[0].flatten(), minlength=c.num_experts)
    rows = int(per.sum())
    assert rows == 2 * 16 * c.experts_per_token
    # up: (n_e, d) x (d, ff), down: (n_e, ff) x (ff, d), 2 FLOPs a MAC.
    macs = sum(int(n) * (c.d_model * c.d_ff + c.d_ff * c.d_model)
               for n in per)
    assert expert_bound.operations(rows, c.d_model, c.d_ff) == 2 * macs
    weights = (p["up"].numel() + p["down"].numel()) * 2
    traffic = rows * (c.d_model + c.d_ff + c.d_ff + c.d_model) * 2
    assert expert_bound.bytes_moved(rows, c.d_model, c.d_ff,
                                    c.num_experts) == weights + traffic
    # The cell: 98,304 rows a layer, bound by its operations at 1.98 ms.
    m = _config()["model"]
    big = expert_bound.bound_s(8 * 2048 * 6, m["d_model"], m["d_ff"],
                               m["num_experts"])
    assert big == pytest.approx(1.9835e-3, rel=1e-4)
    assert big == expert_bound.operations(98304, 2688, 1856) / 989e12


def test_readers():
    cfg, mix = cell()
    m = cfg["model"]
    counters = {"batches": 3, "batch": 4, "seq_len": 32}
    reader = harness.reader_of("expert_roofline.nemotron")
    bound = 3 * m["layer_pattern"].count("moe") * expert_bound.bound_s(
        4 * 32 * m["experts_per_token"], m["d_model"], m["d_ff"],
        m["num_experts"])
    name = f"void cutlass::device_kernel<cutlass::gemm::{reader.KERNEL}<>>"
    ops = [(name, 0.0, bound * 1e6 / 2), (name, 10.0, 10 + bound * 1e6 / 2),
           ("other", 0.0, 5.0)]
    run = harness.TraceRun(harness.Spans(), counters, cfg, mix, ops, [],
                           (0.0, 1e6))
    assert reader.read(run) == pytest.approx(100.0)
    flops = 3 * 4 * nemotron_h_flops.per_sequence(m, 32)
    assert harness.reader_of("mfu.nemotron").read(run) == pytest.approx(
        100.0 * flops / 989e12)
    empty = harness.TraceRun(harness.Spans(), {}, cfg, mix, [], [],
                             (0.0, 1e6))
    assert reader.read(empty) is None
    assert harness.reader_of("mfu.nemotron").read(empty) is None


def test_expert_load_reads_the_tally():
    from repro_torch import tracing

    reader = harness.reader_of("expert_load.nemotron")
    tracing.reset()
    assert reader.read(None) is None
    tracing.enable()
    try:
        tracing.tally("moe.expert_rows", 1, 4, torch.tensor([3, 1, 0, 0]))
        tracing.tally("moe.expert_rows", 2, 4, torch.tensor([1, 1, 1, 1]))
        assert reader.read(None) == pytest.approx(3.0)  # 3 over a mean of 1
    finally:
        tracing.disable()
        tracing.reset()


def test_reference_loads_neither_the_port_nor_jax():
    code = ("import sys\n"
            "from h100_bench.reference import nemotron_h_ref\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro_torch', 'repro', 'jax', "
            "'jaxlib')))\n")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
