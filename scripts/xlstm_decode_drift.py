#!/usr/bin/env python3
"""Where xlstm-1.3b's f32 decode-against-forward offset comes from, on one
card (chip_smoke phase 21's model, seeds and tokens).

    python3 scripts/xlstm_decode_drift.py [--cpu]

For f32 and bf16 in turn, builds xlstm-1.3b at full width and runs the
same 2048-token prefix through ``forward_taps`` alone and as the head of a
2112-token sequence (the decode check's forward). Prints, at the prefix's
last position, the logits' max|diff| between ``prefill`` and the 2048-token
forward and between the two forwards; the relative L2 gap of the residual
stream after cycles 0, 5, 11, 23, 35 and 47 (over all positions and at
position 0); and whether one mLSTM projection gives the same bits for the
first 4096 rows at M = 4224 and M = 4096 rows.

``--cpu`` runs a 48-layer copy of the smoke config (128 + 8 tokens) on the
CPU: a check of the script, not a measurement.

    python3 scripts/xlstm_decode_drift.py --cpu-drift L D CHUNK VOCAB PREFIX

runs xlstm-1.3b's config cut to L layers of width D on the CPU in f32 and
bf16 (parameters and tokens from ``torch.Generator().manual_seed(1)``),
prefills PREFIX tokens, decodes 64 more, and prints each 8 steps' largest
max|diff| against the forward over all of them, as a share of max|logit|
(the first entry: the prefill's last token and steps 1-7).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402

SEED = 0          # chip_smoke.py's SEED; phase 21 draws from SEED + 21
TAPS = (0, 5, 11, 23, 35, 47)


def cpu_drift(layers_, d_model, chunk, vocab, prefix, steps=64) -> None:
    base = registry.get_config("xlstm-1.3b")
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, d_model=d_model, num_layers=layers_,
                                  attn_chunk=chunk, vocab_size=vocab,
                                  param_dtype=dt, compute_dtype=dt)
        gen = torch.Generator().manual_seed(1)
        params = model.init_params(gen, cfg, device="cpu")
        toks = torch.randint(0, vocab, (2, prefix + steps), generator=gen)
        with torch.no_grad():
            hidden, _ = model.forward(params, cfg, {"tokens": toks})
            full = layers.unembed(model.unembed_table(params, cfg), hidden,
                                  layers.dtype_of(dt)).float()
            state, logits = model.prefill(
                params, cfg, {"tokens": toks[:, :prefix]},
                cache_len=prefix + steps)
            diffs = [float((logits.float() - full[:, prefix - 1]).abs()
                           .max())]
            for pos in range(prefix, prefix + steps):
                logits, state = model.decode_step(
                    params, cfg, state, {"tokens": toks[:, pos]}, pos)
                diffs.append(float((logits.float() - full[:, pos]).abs()
                                   .max()))
        peak = float(full.abs().max())
        shares = [float(f"{max(diffs[i:i + 8]) / peak:.3g}")
                  for i in range(0, steps, 8)]
        print(f"{layers_} layers, d_model {d_model}, chunk {chunk}, {dt}: "
              f"max|diff| / max|logit| per 8 steps {shares}")


def main() -> int:
    if "--cpu-drift" in sys.argv[1:]:
        at = sys.argv.index("--cpu-drift")
        cpu_drift(*(int(x) for x in sys.argv[at + 1:at + 6]))
        return 0
    cpu = "--cpu" in sys.argv[1:]
    if cpu:
        dev = torch.device("cpu")
        base = dataclasses.replace(
            registry.get_config("xlstm-1.3b", smoke=True), num_layers=48)
        prefix, extra = 128, 8
        print("cpu (a check of the script)")
    else:
        dev = resolve_device("cuda")
        base = registry.get_config("xlstm-1.3b")
        prefix, extra = 2048, 64
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    rel = lambda a, b: float((a - b).norm() / b.norm())
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, param_dtype=dt, compute_dtype=dt)
        cdt = layers.dtype_of(dt)
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(SEED + 21), cfg,
            device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        toks = torch.randint(0, cfg.vocab_size, (2, prefix + extra),
                             generator=gen, device=dev)
        short = {"tokens": toks[:, :prefix]}
        with torch.no_grad():
            h_long, t_long = model.forward_taps(params, cfg,
                                                {"tokens": toks}, TAPS)
            h_short, t_short = model.forward_taps(params, cfg, short, TAPS)
            _, pre = model.prefill(params, cfg, short,
                                   cache_len=prefix + extra)
            table = model.unembed_table(params, cfg)
            at = lambda h: layers.unembed(table, h, cdt).float()[:, 0]
            lg_short = at(h_short[:, prefix - 1:prefix])
            lg_long = at(h_long[:, prefix - 1:prefix])
        print(f"[{dt}] logits at position {prefix - 1}: prefill against "
              f"forward({prefix}) max|diff| "
              f"{float((pre.float() - lg_short).abs().max()):.3g}; "
              f"forward({prefix + extra}) against forward({prefix}) "
              f"max|diff| {float((lg_long - lg_short).abs().max()):.3g} "
              f"(max|logit| {float(lg_short.abs().max()):.3g})")
        print(f"[{dt}] residual after cycle, relative L2 of the two "
              f"forwards over the prefix: " + ", ".join(
                  f"{c}: {rel(t_long[j][:, :prefix], t_short[j]):.3g}"
                  for j, c in enumerate(TAPS)))
        print(f"[{dt}] the same at position 0: " + ", ".join(
            f"{c}: {rel(t_long[j][:, 0], t_short[j][:, 0]):.3g}"
            for j, c in enumerate(TAPS)))
        w = params["blocks"][0]["pos0"]["mlstm"]["wq"]
        x = torch.randn(2 * (prefix + extra), cfg.d_model, device=dev,
                        generator=gen).to(cdt)
        a, b = x @ w, x[:2 * prefix] @ w
        print(f"[{dt}] one projection ({tuple(x.shape)} @ "
              f"{tuple(w.shape)}): the first {2 * prefix} rows at M = "
              f"{2 * (prefix + extra)} and M = {2 * prefix} bit-equal "
              f"{torch.equal(a[:2 * prefix], b)}, max|diff| "
              f"{float((a[:2 * prefix] - b).abs().max()):.3g} (max|y| "
              f"{float(b.abs().max()):.3g})")
        del params, h_long, h_short, t_long, t_short
        if not cpu:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
