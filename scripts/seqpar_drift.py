#!/usr/bin/env python3
"""How far xlstm-1.3b's sequence-parallel prefill departs from the meshless
one, beside how far the meshless prefill departs from itself at another
chunking (chip_smoke phase 22's model, seeds and tokens), on one card.

    python3 scripts/seqpar_drift.py [--cpu]

For f32 and bf16 in turn, builds xlstm-1.3b at its published widths and
prefills the same 2 x 2048 tokens three ways: meshless (chunk 1024),
sequence-parallel over 4 names of the card on a ``model`` axis (spans of
512, so chunk 512), and meshless at chunk 512 (the spans' chunking). For
each pair it prints the logits' max|diff| as a share of 4 sqrt(K) u
max|logit| (K = 49 rounded stages, u = 2^-8 in bf16, 2^-16 in f32), the
residual stream's max|diff| relative to its largest entry after every
fourth cycle (``forward_taps``), and the final state ``s``'s at cycles 0,
1, 5, 11, 23, 35 and 47; then 8 decode steps from each prefill against the
meshless forward over 2056 tokens (chip_smoke's decode check, printed,
not held).

``--cpu`` runs 6 layers of the smoke config on 64 + 8 tokens on the CPU: a
check of the script, not a measurement.
"""
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.device import generator, resolve_device  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.sharding.mesh import Mesh, set_mesh  # noqa: E402

CYCLES = (0, 1, 5, 11, 23, 35, 47)


def main(argv) -> int:
    cpu = "--cpu" in argv
    dev = resolve_device("cpu" if cpu else "cuda")
    published = registry.get_config("xlstm-1.3b", smoke=cpu)
    if cpu:
        published = dataclasses.replace(published, num_layers=6)
        cs.ND_PREFILL = 64
    span = cs.ND_PREFILL // cs.SP_MODEL
    mesh = Mesh([dev] * cs.SP_MODEL, ("data", "model"), (1, cs.SP_MODEL))
    print(cs._nvidia_smi() if not cpu else "cpu (a check, not a "
          "measurement)", flush=True)
    for dtype, unit in (("float32", 2.0 ** -16), ("bfloat16", 2.0 ** -8)):
        flat = dataclasses.replace(published, param_dtype=dtype,
                                   compute_dtype=dtype)
        configs = {
            "meshless": flat,
            "sequence-parallel": dataclasses.replace(
                flat, sequence_parallel=True),
            "re-chunked": dataclasses.replace(flat, attn_chunk=min(
                flat.attn_chunk, span)),
        }
        params = model.init_params(generator(cs.SEED + 22, dev), flat, dev)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 22)
        batch = cs._nd_inputs(torch, flat, gen, dev, cs.ND_BATCH,
                              cs.ND_PREFILL + cs.ND_DECODE)
        pre = {"tokens": batch["tokens"][:, :cs.ND_PREFILL]}
        taps = list(range(flat.num_cycles))
        runs = {}
        with torch.no_grad(), set_mesh(mesh):
            for label, c in configs.items():
                _, resid = model.forward_taps(params, c, pre, taps)
                st, lg = model.prefill(params, c, pre,
                                       cs.ND_PREFILL + cs.ND_DECODE)
                runs[label] = (resid, lg.float(), st)
        peak = float(runs["meshless"][1].abs().max())
        limit = 4.0 * cs._rounded_stages(flat) ** 0.5 * unit * peak
        for a, b in (("sequence-parallel", "meshless"),
                     ("re-chunked", "meshless"),
                     ("sequence-parallel", "re-chunked")):
            ra, rb = runs[a][0], runs[b][0]
            stream = [float((ra[i] - rb[i]).abs().max() / rb[i].abs().max())
                      for i in range(0, len(taps), 4)]
            states = [float((runs[a][2][c]["pos0"].s - runs[b][2][c][
                "pos0"].s).abs().max() / runs[b][2][c]["pos0"].s.abs().max())
                for c in CYCLES if c < flat.num_cycles]
            diff = float((runs[a][1] - runs[b][1]).abs().max())
            print(f"[drift] {dtype} {a} against {b}: logits max|diff| "
                  f"{diff:.6g} ({diff / limit:.4f} of 4 sqrt(K) u "
                  f"max|logit|, max|logit| {peak:.4f}); residual stream "
                  f"max|diff| / max per 4 cycles "
                  f"{[float(f'{x:.3g}') for x in stream]}; final s at "
                  f"cycles {[c for c in CYCLES if c < flat.num_cycles]} "
                  f"{[float(f'{x:.3g}') for x in states]}", flush=True)
        del runs
        for label, c in configs.items():
            with torch.no_grad(), set_mesh(mesh):
                cs._decode_check(torch, flat, params, batch,
                                 f"{dtype}, decode from the {label} "
                                 f"prefill", cs.ND_DECODE, unit=unit,
                                 prefill_cfg=c, hold=False)
        del params
        if not cpu:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
