"""``repro_torch.launch.roofline`` against the reference's
``launch/roofline.py``: the same model FLOPs for every (arch, shape,
chips), and the same terms on one cell, scaled by the ratio of the peaks
(the H100's 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink against v5e's
197 TFLOP/s, 819 GB/s, 50 GB/s). Exact up to float rounding (1e-12
relative)."""

import pytest

from repro.configs import registry as jregistry
from repro.launch import roofline as jroofline
from repro_torch.configs import registry
from repro_torch.launch import roofline


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_model_flops_per_device_match(arch):
    for shape in registry.SHAPES:
        for chips in (1, 256, 512):
            assert roofline.model_flops_per_device(arch, shape, chips) == \
                jroofline.model_flops_per_device(arch, shape, chips)
    assert registry.ARCH_IDS == jregistry.ARCH_IDS


def _cell(flops, hbm, coll):
    return {
        "arch": "qwen2-7b", "shape": "train_4k", "mesh": "16x16", "ok": True,
        "roofline_inputs": {
            "flops": flops, "flops:bf16": flops, "flops:f32": 0.0,
            "hbm_bytes": hbm, "min_bytes": hbm, "collective_bytes": coll,
            "coll:all-gather": coll},
        # the reference reads peak_est_gib / tpu_peak_est_gib, the port
        # peak_gib (state + activations a device holds)
        "memory": {"peak_est_gib": 12.0, "tpu_peak_est_gib": 9.0,
                   "peak_gib": 12.0},
    }


@pytest.mark.parametrize("flops,hbm,coll", [
    (4.0e15, 1.0e12, 1.0e10),   # compute-dominated on both cards
    (1.0e12, 2.0e12, 1.0e10),   # memory-dominated on both
    (1.0e12, 1.0e10, 2.0e11),   # collective-dominated on both
])
def test_cell_report_is_the_reference_scaled_by_the_peaks(flops, hbm, coll):
    cell = _cell(flops, hbm, coll)
    got = roofline.cell_report("k", cell)
    want = jroofline.cell_report("k", cell)
    scale = {"compute_s": jroofline.PEAK_FLOPS / roofline.PEAK_BF16_FLOPS,
             "memory_s": jroofline.HBM_BW / roofline.HBM_BW,
             "collective_s": jroofline.LINK_BW / roofline.LINK_BW}
    for key, s in scale.items():
        assert got[key] == pytest.approx(want[key] * s, rel=1e-12)
    assert got["dominant"] == want["dominant"]
    assert got["model_flops_ratio"] == pytest.approx(want["model_flops_ratio"],
                                                     rel=1e-12)
    step = {"compute": "compute_s", "memory": "memory_s",
            "collective": "collective_s"}[got["dominant"]]
    assert got["roofline_frac"] == pytest.approx(
        want["roofline_frac"] * jroofline.PEAK_FLOPS / roofline.PEAK_BF16_FLOPS
        / scale[step], rel=1e-12)
    assert got["peak_gib"] == want["peak_gib"]
    assert got["coll_breakdown"] == want["coll_breakdown"]
    assert got["hbm_over_min"] == 1.0


def test_f32_products_run_at_the_f32_peak():
    cell = _cell(3.0e12, 1.0, 0.0)
    cell["roofline_inputs"].update({"flops:bf16": 1.0e12, "flops:f32": 2.0e12})
    rep = roofline.cell_report("k", cell)
    assert rep["compute_s"] == pytest.approx(
        1.0e12 / roofline.PEAK_BF16_FLOPS + 2.0e12 / roofline.PEAK_F32_FLOPS,
        rel=1e-12)


def test_render_names_the_card_and_the_skips():
    results = {"a": _cell(4.0e15, 1.0e12, 1.0e10),
               "b": {"arch": "qwen2-7b", "shape": "long_500k",
                     "mesh": "16x16", "ok": None, "skipped": "why"}}
    text = roofline.render(results)
    assert "H100 80GB HBM3, 700 W" in text and "not measured" in text
    assert "| qwen2-7b | train_4k | 16x16 |" in text
    assert "- qwen2-7b x long_500k: why" in text
