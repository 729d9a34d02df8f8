#!/usr/bin/env python3
"""Sweep the probe fit's DFO step size and ridge on chip_smoke phase 19's
probe stream (qwen2-7b at full width, random init), on one card.

    python3 scripts/lm_probe_sweep.py [--dump FILE.npz]

``--smoke --device cpu`` runs the same sweep on the smoke config, tapped at
its first and last layers, on the CPU (a check of the script, not a
measurement).

Builds the model and the probe stream exactly as ``chip_smoke.py`` phase 19
does (same seeds, same tap layers, same sequences), sketches each tap layer
through kernel 1 (d = d_model + 3, R = 2048, p = 4), and for each
(learning rate, l2) pair fits every layer with ``probes.fit_probe`` through
the kernels and the last layer again through the scan engine, under the same
directions. One line per fit: the sketch loss at the first and last step,
the final selection losses, whether the zero guard won (theta exactly 0),
|theta| in standardized units, train and held-out R^2, and for the scan fit
the largest gap between its loss trace and the kernel fit's.

``--dump`` writes the last tap layer's features and the targets (train rows
first, then the held-out rows) to an ``.npz``, so that the reference's fit
can be run on the same rows (``scripts/probe_dfo_reference.py``).
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as smoke  # noqa: E402  (phase 19's constants and seeds)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import dfo, lsh, probes  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.telemetry import TapConfig  # noqa: E402
from repro_torch.telemetry.taps import extract_tap_features  # noqa: E402

# (learning rate, l2): the probe's defaults first.
GRID = [(2.0, 3e-2), (0.2, 3e-2), (0.05, 3e-2), (0.01, 3e-2), (0.002, 3e-2),
        (0.2, 1e-3), (0.05, 1e-3), (0.01, 1e-3), (0.002, 1e-3)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    smi = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip() if dev.type == "cuda" else "cpu")
    cfg = registry.get_config(smoke.LM_ARCH, smoke=args.smoke)
    taps = (0, cfg.num_layers - 1) if args.smoke else smoke.LM_TAPS
    d = cfg.d_model
    params = model.init_params(generator(smoke.SEED + 19, dev), cfg,
                               device=dev)
    tap = TapConfig(cfg.name, layers=taps, target=smoke.LM_TARGET)
    hash_params = lsh.init_srp(generator(smoke.SEED + 191, dev),
                               smoke.LM_HASH_ROWS, smoke.LM_PLANES, d + 3,
                               device=dev)
    pconf = probes.ProbeConfig(rows=smoke.LM_HASH_ROWS,
                               planes=smoke.LM_PLANES)
    n_seq = smoke.LM_PROBE_SEQS + smoke.LM_HELDOUT
    toks = torch.randint(0, cfg.vocab_size, (n_seq, smoke.LM_PROBE_LEN),
                         generator=generator(smoke.SEED + 192, dev),
                         device=dev)
    feats, targets = [], []
    for lo in range(0, n_seq, smoke.LM_PROBE_BATCH):
        f_b, y_b = extract_tap_features(
            params, cfg, {"tokens": toks[lo:lo + smoke.LM_PROBE_BATCH]}, tap)
        feats.append(f_b)
        targets.append(y_b)
    feats, targets = torch.cat(feats, dim=1), torch.cat(targets)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    train = slice(0, smoke.LM_PROBE_SEQS)
    held = slice(smoke.LM_PROBE_SEQS, n_seq)
    if args.dump:
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        np.savez(args.dump, feats=feats[-1].cpu().numpy(),
                 targets=targets.cpu().numpy(),
                 train=smoke.LM_PROBE_SEQS, layer=taps[-1])
    states = [probes.sketch_features(None, feats[j, train], targets[train],
                                     pconf, params=hash_params, device=dev)
              for j in range(len(taps))]
    steps, k = probes._PROBE_DFO.steps, probes._PROBE_DFO.num_queries
    dirs = dfo.sphere_directions(generator(smoke.SEED + 193, dev), steps, 1,
                                 k, d + 1, dev)

    def r2(fit, x, y):
        return 1.0 - float(fit.mse(x, y)) / float(((y - y.mean()) ** 2).mean())

    def row(fit, j, **extra):
        out = dict(
            loss_first=float(fit.losses[0]), loss_last=float(fit.losses[-1]),
            loss_min=float(fit.losses.min()),
            select=[float(x) for x in fit.fleet_losses],
            guard_won=bool((fit.theta == 0).all()),
            theta_std_norm=float((fit.theta * states[j].x_scale
                                  / states[j].y_scale).norm()),
            train_r2=r2(fit, feats[j, train], targets[train]),
            held_r2=r2(fit, feats[j, held], targets[held]))
        out.update(extra)
        return out

    for lr, l2 in GRID:
        cfg_d = dataclasses.replace(probes._PROBE_DFO, learning_rate=lr)
        for j, layer in enumerate(taps):
            start = time.perf_counter()
            fit = probes.fit_probe(None, states[j], d, dfo_config=cfg_d,
                                   l2=l2, directions=dirs, device=dev)
            secs = time.perf_counter() - start
            print(json.dumps(dict(lr=lr, l2=l2, layer=layer, engine="kernel",
                                  s=secs, **row(fit, j))), flush=True)
        scan = probes.fit_probe(None, states[-1], d, dfo_config=cfg_d, l2=l2,
                                directions=dirs, engine="scan", device=dev)
        gap = (scan.losses - fit.losses).abs()
        print(json.dumps(dict(
            lr=lr, l2=l2, layer=taps[-1], engine="scan",
            trace_gap_max=float(gap.max()),
            trace_gap_rel=float((gap / fit.losses.abs().clamp(min=1e-30))
                                .max()),
            **row(scan, len(taps) - 1))), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
