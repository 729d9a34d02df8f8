"""NVIDIA Nemotron 3 Nano 30B-A3B (``configs/nemotron_3_nano_30b_a3b.py``)
against the benchmark's plain reference (``h100_bench/reference/
nemotron_h_ref.py``), at its smoke widths on the CPU in f32.

Every weight is seeded and the reference's fixed inits (zero norms and conv
biases, unit skips) are moved off their values, so that each equation is
exercised. The port and the reference sum in other orders (the chunked
SSD, the grouped products against a loop over experts), so the f32
comparisons hold to 1e-5 relative; every planted fault moves the result by
more than 1e-2. The JAX package has no counterpart of this model.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import nemotron_3_nano_30b_a3b as nemo
from repro_torch.configs import registry
from repro_torch.models import layers, model, moe, ssm
from repro_torch.telemetry import taps
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from h100_bench.reference import nemotron_h_ref as ref  # noqa: E402

CFG = registry.get_config("nemotron-3-nano-30b-a3b", smoke=True)
M = {k: list(v) if isinstance(v, tuple) else v
     for k, v in dataclasses.asdict(CFG).items()}
TOL = 1e-5


def _params(seed=0):
    """The reference's tree in f32 from ``seed``, its fixed leaves moved."""
    gen = torch.Generator().manual_seed(seed)
    p = ref.make_params(M, gen, torch.device("cpu"), torch.float32)
    for path, leaf in ref._leaves(p):
        if path[-1] in ("pre_norm", "final_norm", "out_norm", "conv_x_b",
                        "conv_bc_b", "d_skip"):
            leaf.add_(0.2 * torch.randn(leaf.shape, generator=gen))
    return p


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _tokens(b=2, s=40, seed=1):
    return torch.randint(0, CFG.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(seed))


def test_taps_and_logits_match_the_reference():
    p, toks = _params(), _tokens()
    last = CFG.num_layers - 1
    tl = (1, 3, last)
    with torch.no_grad():
        hidden, resid = model.forward_taps(p, CFG, {"tokens": toks}, tl)
        logits = layers.unembed(p["unembed"], hidden[:, -1], hidden.dtype)
        feats, target = ref.forward_taps(p, M, toks, list(tl))
        want = ref._rms(feats[-1], p["final_norm"], CFG.norm_eps) \
            @ p["unembed"]
        got_f, got_t = taps.extract_tap_features(
            p, CFG, {"tokens": toks}, taps.TapConfig(model="n", layers=tl))
    assert resid.shape == (3, 2, 40, CFG.d_model)
    assert _rel(resid[:, :, -1], feats) < TOL
    assert _rel(logits, want) < TOL
    assert _rel(got_f, feats) < TOL and _rel(got_t, target) < TOL


def _moe_case(fault=None):
    """The port's MoE layer and the reference's on the same input, with one
    fault planted in the port's: its relative gap."""
    p = _params(2)["blocks"][0]["pos1"]["moe"]
    x = torch.randn((3, 24, CFG.d_model),
                    generator=torch.Generator().manual_seed(3))
    want = ref._moe(p, x, M, ref.f32_mm, None)
    kw = dict(experts_per_token=CFG.experts_per_token,
              routed_scale=CFG.moe_routed_scale, compute_dtype=torch.float32)
    if fault == "shared":
        p = {k: v for k, v in p.items() if not k.startswith("shared")}
    elif fault == "bias":
        p = dict(p, router_bias=torch.zeros_like(p["router_bias"]))
    elif fault == "scale":
        kw["routed_scale"] = 1.0
    route = moe.route_sigmoid_bias
    if fault == "renorm":
        def unnormalized(x, router, bias, k, scale):
            idx, _ = route(x, router, bias, k, scale)
            s = torch.sigmoid(x.float() @ router.float())
            return idx, torch.gather(s, -1, idx) * scale
        moe.route_sigmoid_bias = unnormalized
    try:
        with torch.no_grad():
            got = moe.dropless_moe(p, x, **kw)
    finally:
        moe.route_sigmoid_bias = route
    return _rel(got, want)


@pytest.mark.parametrize("fault", [None, "shared", "bias", "scale",
                                   "renorm"])
def test_moe_layer_against_the_reference(fault):
    gap = _moe_case(fault)
    if fault is None:
        assert gap < TOL
    else:
        assert gap > 1e-2, (fault, gap)


def test_forced_skew_drops_nothing():
    """Every token routed to the same ``k`` experts: the dropless path
    keeps all ``T k`` rows and equals the reference; the capacity path's
    grouping would have dropped most of them."""
    p = dict(_params(4)["blocks"][0]["pos1"]["moe"])
    e, k = CFG.num_experts, CFG.experts_per_token
    hot = torch.tensor([5, 1, 6])
    bias = torch.full((e,), -10.0)
    bias[hot] = 10.0
    p["router_bias"] = bias
    x = torch.randn((2, 32, CFG.d_model),
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad(), moe.record_choices() as got:
        out = moe.dropless_moe(p, x, experts_per_token=k,
                               routed_scale=CFG.moe_routed_scale,
                               compute_dtype=torch.float32)
        want = ref._moe(p, x, M, ref.f32_mm, None)
    rows = torch.bincount(got[0].flatten(), minlength=e)
    assert rows[hot].tolist() == [64] * k and int(rows.sum()) == 64 * k
    assert _rel(out, want) < TOL


def test_grouped_mamba_against_the_reference():
    p = _params(6)["blocks"][0]["pos0"]["mamba"]
    x = torch.randn((2, 20, CFG.d_model),
                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = ssm.mamba2_block(p, x, CFG.ssm_heads, CFG.ssm_state_dim,
                               CFG.ssm_chunk_len, torch.float32,
                               groups=CFG.ssm_groups,
                               group_norm_eps=CFG.norm_eps)
        want = ref._mamba(p, x, M, ref.f32_mm, ref.f32_mm)
        # zamba2's norm before the gate, over all channels, is another model.
        norm_first = ssm.mamba2_block(p, x, CFG.ssm_heads, CFG.ssm_state_dim,
                                      CFG.ssm_chunk_len, torch.float32,
                                      groups=CFG.ssm_groups)
    assert _rel(got, want) < TOL
    assert _rel(norm_first, want) > 1e-2


def test_prefill_then_decode_matches_the_forward():
    p, toks = _params(8), _tokens(s=36, seed=9)
    with torch.no_grad():
        hidden, _ = model.forward(p, CFG, {"tokens": toks})
        full = layers.unembed(p["unembed"], hidden, hidden.dtype)
        state, logits = model.prefill(p, CFG, {"tokens": toks[:, :20]}, 64)
        gaps = [_rel(logits, full[:, 19])]
        for t in range(20, 36):
            logits, state, tap = model.decode_step(
                p, CFG, state, {"tokens": toks[:, t]}, t, tap_layers=(3,))
            gaps.append(_rel(logits, full[:, t]))
    assert max(gaps) < TOL
    assert tap.shape == (1, 2, 1, CFG.d_model)


def test_param_counts():
    params = model.init_params(torch.Generator().manual_seed(0), CFG, "cpu")
    assert model.param_count(params) == CFG.param_count()
    assert model.param_count(_params()) == CFG.param_count()
    full = registry.get_config("nemotron-3-nano-30b-a3b")
    assert full.param_count() == 31_577_940_288
    assert full.active_param_count(embedding=False) == 3_227_754_816
    assert full.layer_pattern == nemo.layer_pattern(nemo.PATTERN)
    assert [full.layer_pattern.count(k) for k in
            ("mamba", "moe", "attn_only")] == [23, 23, 6]


def test_registered_beside_the_assigned_ids():
    assert "nemotron-3-nano-30b-a3b" in registry.PORT_ARCH_IDS
    assert "nemotron-3-nano-30b-a3b" not in registry.ARCH_IDS
    assert registry.get_config("nemotron-3-nano-30b-a3b", smoke=True) is CFG


def test_training_raises_and_names_the_grouped_path():
    p, toks = _params(), _tokens(s=16)
    with pytest.raises(NotImplementedError, match="grouped"):
        model.train_loss(p, CFG, {"tokens": toks, "labels": toks})


def test_taps_name_layers():
    with pytest.raises(ValueError, match="out of range"):
        taps.TapConfig(model="n", layers=(CFG.num_layers,)).resolve_layers(
            CFG)
    assert taps.TapConfig(model="n").resolve_layers(CFG) == tuple(
        range(CFG.num_layers))


def test_the_ssd_chunk_changes_no_arithmetic():
    """``ssm_chunk`` is a tile of the chunked scan, not of the model: other
    chunks give the same taps to rounding. ``dataclasses.replace`` keeps a
    pattern config's pattern."""
    p, toks = _params(), _tokens(s=48)
    want = model.forward_taps(p, CFG, {"tokens": toks}, (3, 7))[1]
    for chunk in (4, 16, 48):
        cfg = dataclasses.replace(CFG, ssm_chunk=chunk)
        assert cfg.cycle == CFG.cycle and cfg.ssm_chunk_len == chunk
        got = model.forward_taps(p, cfg, {"tokens": toks}, (3, 7))[1]
        assert _rel(got, want) < TOL


@pytest.mark.parametrize("arch", ["nemotron-3-nano-30b-a3b", "zamba2-2.7b"])
def test_taps_keep_one_rule_in_both_modes(arch):
    """A tap point is the end of a cycle, or a pattern config's layer, in
    ``forward_taps`` and the tapped ``decode_step`` alike: decoding a
    prompt token by token gives the full sequence's taps at each
    position."""
    cfg = registry.get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    p = (_params() if cfg.layer_pattern else
         model.init_params(torch.Generator().manual_seed(0), cfg,
                           torch.device("cpu")))
    toks = _tokens(s=6)
    tl = (0, cfg.tap_points - 1)
    _, want = model.forward_taps(p, cfg, {"tokens": toks}, tl)
    state = model.init_decode_state(cfg, 2, 8, torch.device("cpu"))
    for t in range(toks.shape[1]):
        _, state, got = model.decode_step(p, cfg, state,
                                          {"tokens": toks[:, t]}, t,
                                          tap_layers=tl)
        assert _rel(got[:, :, 0], want[:, :, t]) < 1e-4
