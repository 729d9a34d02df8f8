"""The frozen counts: the functions against ``counts/frozen.json``, kernel
4's bound against PERF.md's reckoning, and zamba2's product FLOPs tied to
what ``launch/op_analysis`` counts in the port's forward at the smoke
config."""

import dataclasses
import json

import pytest
import torch

from h100_bench import harness
from h100_bench.counts import insert_bound, zamba2_flops

FROZEN = json.loads((harness.BENCH / "counts" / "frozen.json").read_text())


def _model():
    return json.loads((harness.BENCH / "configs" /
                       "zamba2-2.7b-taps.json").read_text())["model"]


@pytest.mark.parametrize("seq", ["2048", "128"])
def test_zamba2_counts_are_frozen(seq):
    assert zamba2_flops.per_sequence(_model(), int(seq)) == \
        FROZEN["zamba2-2.7b-taps"]["per_sequence_flops"][seq]


def test_zamba2_about_5_6_gflop_a_token():
    per = zamba2_flops.per_sequence(_model(), 2048) / 2048
    assert 5.5e9 < per < 5.8e9


def test_kernel4_bound_is_frozen_and_matches_perf_md():
    cfg = json.loads((harness.BENCH / "configs" /
                      "storm-airfoil-16t.json").read_text())
    g, width = cfg["gateway"], cfg["rows"]["d"] + 1
    frozen = FROZEN["storm-airfoil-16t"]["kernel4_bound_s"]
    tick = insert_bound.bound_s(16 * 16384, width, g["rows"], g["planes"],
                                g["tenants"], 1)
    big = insert_bound.bound_s(16 * 2 ** 18, width, g["rows"], g["planes"],
                               g["tenants"], 1)
    assert list(frozen.values()) == [tick, big]
    # PERF.md's table: kernel 4 at 16 x 2^18 rows is bound at 12.305 ms by
    # its operations.
    assert big == pytest.approx(12.305e-3, rel=1e-3)
    assert insert_bound.operations(2 ** 22, width, 2048, 4) / 67e12 == \
        pytest.approx(big, rel=1e-6)


def test_padding_is_not_counted():
    a = insert_bound.bound_s(1000, 10, 2048, 4, 16, 1)
    b = insert_bound.bound_s(2000, 10, 2048, 4, 16, 1)
    assert b == pytest.approx(2 * a, rel=1e-3)


def test_product_flops_tie_to_op_analysis():
    """At the smoke config the port's forward executes exactly the weight
    products counted here, plus its chunked forms of attention (every key
    chunk, masked) and of the SSM (chunk products); the conv and the
    recurrence are counted here and are not products there."""
    from repro_torch.configs import registry
    from repro_torch.launch import op_analysis
    from repro_torch.models import model
    from repro_torch.telemetry import taps

    cfg = registry.get_config("zamba2-2.7b", smoke=True)
    m = {k: list(v) if isinstance(v, tuple) else v
         for k, v in dataclasses.asdict(cfg).items()}
    b, s = 2, 32
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(1))
    tap = taps.TapConfig(model="z", layers=(0, 1))
    with torch.no_grad():
        counted = op_analysis.analyze(taps.extract_tap_features, params, cfg,
                                      {"tokens": toks}, tap)["flops"]
    cycles = cfg.num_layers // len(cfg.cycle)
    n_mamba = cycles * cfg.cycle.count("mamba")
    n_shared = cycles * cfg.cycle.count("shared_attn")
    c = min(cfg.attn_chunk, s)
    di = cfg.d_model * cfg.ssm_expand
    n, h = cfg.ssm_state_dim, cfg.ssm_heads
    p = di // h
    ssd_chunks = b * h * (s // c) * (4 * c * n * p + 2 * c * c * (n + p))
    attention_square = 4 * b * cfg.num_heads * cfg.head_dim * s * s
    products = b * (s * (n_mamba * zamba2_flops.mamba_terms(m)["products"]
                         + n_shared * zamba2_flops.per_token_shared(m))
                    + 2 * cfg.d_model * cfg.vocab_size)
    assert counted == products + n_mamba * ssd_chunks + \
        n_shared * attention_square
    least = b * zamba2_flops.per_sequence(m, s)
    assert least < counted
