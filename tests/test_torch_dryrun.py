"""``repro_torch.launch.dryrun`` on smoke configs: cells on the one-card
mesh and on 16 x 16, the trip count against microbatches counted one by
one, the bytes a device holds against ``specs.spec_bytes``, and skipped
cells recorded as the reference's ``launch/dryrun.py`` records them. Every
comparison is exact."""

import dataclasses
import functools
import json
import math
import os
import sys

import pytest

from repro_torch.configs import registry
from repro_torch.launch import dryrun, op_analysis
from repro_torch.sharding import specs
from repro_torch.train import train_step as ts
from torch_parity import one_torch_thread  # noqa: F401

SMALL = {
    "train": registry.ShapeSpec("train_small", 32, 16, "train"),
    "prefill": registry.ShapeSpec("prefill_small", 32, 16, "prefill"),
    "decode": registry.ShapeSpec("decode_small", 64, 16, "decode"),
}


@functools.lru_cache(maxsize=None)
def _cell(arch, step, mesh, **kw):
    res = dryrun.run_cell(arch, SMALL[step].name, mesh, shape=SMALL[step],
                          smoke=True, **kw)
    assert res.ok, res.error
    return res


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_decode_cells_on_one_card_and_16x16(arch):
    one = _cell(arch, "decode", "1")
    pod = _cell(arch, "decode", "16x16")
    # the step's counts do not depend on the mesh; a device's share does
    assert one.cost == pod.cost
    for key in ("flops", "flops:bf16", "flops:f32", "hbm_bytes", "min_bytes"):
        assert one.roofline_inputs[key] == one.cost[key]
        assert pod.roofline_inputs[key] == pod.cost[key] / 256
    assert one.roofline_inputs["collective_bytes"] == 0
    assert pod.roofline_inputs["collective_bytes"] > 0
    assert one.memory["act_gib"] == one.cost["peak_bytes"] / 2**30
    assert pod.memory["act_gib"] == pod.cost["peak_bytes"] / 256 / 2**30
    assert one.cost["flops"] > 0 and one.cost["launches"] > 0


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x22b", "xlstm-1.3b"])
def test_train_and_prefill_cells(arch):
    for mesh, n in (("1", 1), ("16x16", 256)):
        train = _cell(arch, "train", mesh)
        # 16 sequences of 32 tokens; 16x16's data axis takes them at once
        want_micro = 1 if mesh == "16x16" else (
            16 // dryrun.TRAIN_MICRO_SEQS[arch])
        assert train.microbatches == want_micro
        assert train.roofline_inputs["flops"] == train.cost["flops"] / n
        pre = _cell(arch, "prefill", mesh)
        assert pre.roofline_inputs["flops"] == pre.cost["flops"] / n
        # a train step does at least the forward's products, thrice over
        assert train.cost["flops"] > 2.5 * pre.cost["flops"]


def test_microbatch_trips_equal_microbatches_counted():
    """One microbatch counted M times plus the update equals the train
    step's M microbatches run and counted one by one, in every key."""
    cfg = registry.get_config("qwen2-7b", smoke=True)
    tcfg = ts.TrainConfig(microbatches=2)
    batch = dryrun.input_specs(cfg, SMALL["train"])
    trips = dryrun.count_train_step(dryrun.train_state_specs(cfg, tcfg), batch,
                                    cfg, tcfg)
    every = op_analysis.analyze(ts.train_step,
                                dryrun.train_state_specs(cfg, tcfg), batch,
                                cfg, tcfg)
    assert trips == every
    one = dataclasses.replace(tcfg, microbatches=1)
    single = dryrun.count_train_step(dryrun.train_state_specs(cfg, one),
                                     batch, cfg, one)
    assert trips["flops"] == single["flops"]  # the same products in all


def test_state_gib_is_the_specs_count():
    arch = "qwen2-7b"
    res = _cell(arch, "train", "16x16")
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              remat_group=dryrun._best_remat_group(
                                  registry.get_config(arch, smoke=True)
                                  .num_cycles))
    tcfg = ts.TrainConfig(optimizer=ts.opt_lib.AdamWConfig(
        moment_dtype="bfloat16"), microbatches=res.microbatches)
    state = dryrun.train_state_specs(cfg, tcfg)
    mesh = dryrun.make_mesh("16x16")
    pspecs = specs.param_specs(state.params, cfg, mesh)
    held = (specs.spec_bytes(state.params, pspecs, mesh)
            + specs.spec_bytes(state.opt, specs.opt_state_specs(
                state.opt, pspecs), mesh))
    assert res.memory["state_gib"] == held / 2**30
    assert res.memory["peak_gib"] == (res.memory["state_gib"]
                                      + res.memory["act_gib"])


def test_collectives_from_the_rules():
    """On 16 x 16 a train step gathers each parameter (k - 1)/k of its
    bytes per forward and per backward and reduce-scatters its gradient
    once; replicated leaves all-reduce their gradient over data."""
    res = _cell("qwen2-7b", "train", "16x16")
    cfg = registry.get_config("qwen2-7b", smoke=True)
    params = dryrun.params_specs(cfg)
    mesh = dryrun.make_mesh("16x16")
    table = dict(ts.tree_lib.leaf_paths(specs.param_specs(params, cfg,
                                                          mesh)))
    gathered = scattered = reduced = 0.0
    for path, leaf in ts.tree_lib.leaf_paths(params):
        axes = [a for d in range(len(table[path]))
                for a in table[path].axes(d)]
        k = math.prod(mesh.shape[a] for a in axes)
        nbytes = leaf.numel() * leaf.element_size()
        gathered += 2 * (k - 1) / k * nbytes
        scattered += (k - 1) / k * nbytes
        if "data" not in axes:
            reduced += 2 * 15 / 16 * nbytes
    roof = res.roofline_inputs
    assert roof["coll:all-gather"] == pytest.approx(gathered, rel=1e-12)
    assert roof["coll:reduce-scatter"] == pytest.approx(scattered, rel=1e-12)
    assert roof["coll:all-reduce"] == pytest.approx(reduced, rel=1e-12)


def test_skipped_cells_recorded_as_the_reference(tmp_path, monkeypatch):
    import jax

    jax.devices()  # the backend is up: the reference's XLA_FLAGS change nothing
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jdryrun

    ref_out, out = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "qwen2-7b", "--shape", "long_500k", "--mesh",
        "both", "--out", str(ref_out)])
    jdryrun.main()
    got = dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k",
                       "--mesh", "both", "--out", str(out)])
    want = json.loads(ref_out.read_text())
    assert got == want == json.loads(out.read_text())
    assert all(c["ok"] is None and c["skipped"] for c in want.values())
    assert len(want) == 2


def test_the_sweep_resumes(tmp_path):
    out = str(tmp_path / "d.json")
    argv = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh", "1",
            "--out", out]
    first = dryrun.main(argv)
    cell = first["gemma3-1b|decode_32k|1"]
    assert cell["ok"] and cell["memory"]["peak_gib"] > 0
    again = dryrun.main(argv)  # cached: not counted again
    assert again == first
