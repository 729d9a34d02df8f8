#!/usr/bin/env python3
"""The reference's probe fit and the port's on the same probe rows, on the
CPU.

    PYTHONPATH=src python3 scripts/probe_dfo_reference.py FILE.npz \
        [--setting LR,L2 ...]

``FILE.npz`` holds one tap layer's pooled features and targets, train rows
first (``scripts/lm_probe_sweep.py --dump`` writes it from qwen2-7b on the
card). JAX's ``repro.core.probes.sketch_features`` sketches the train rows
(R = 2048, p = 4) and ``fit_probe`` fits them; the port's
``repro_torch.core.probes`` does the same on the CPU with JAX's hash family
and DFO draws (through ``repro_torch.interop``), so the two fit the same
state. For each (learning rate, l2) pair (default: the probe's defaults, 2.0
and 3e-2) one JSON line per framework: the sketch loss at the first, the
largest and the last step, the final selection loss, whether the zero guard
won (theta exactly 0), |theta| in standardized units, and the train and
held-out R^2. Needs JAX and the port (``PYTHONPATH=src``); no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows")
    ap.add_argument("--setting", action="append", default=None,
                    help="LR,L2 (repeatable)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.core import dfo as jdfo
    from repro.core import probes as jprobes
    from repro_torch import interop
    from repro_torch.core import dfo, probes
    from torch_parity import fleet_draws

    data = np.load(args.rows)
    feats, targets = data["feats"], data["targets"]
    n_train = int(data["train"])
    d = feats.shape[1]
    settings = [tuple(float(v) for v in s.split(","))
                for s in (args.setting or ["2.0,0.03"])]
    config = jprobes.ProbeConfig(rows=2048, planes=4)
    x_tr, y_tr = feats[:n_train], targets[:n_train]
    x_ho, y_ho = feats[n_train:], targets[n_train:]

    start = time.perf_counter()
    jstate = jprobes.sketch_features(jax.random.PRNGKey(5), jnp.asarray(x_tr),
                                     jnp.asarray(y_tr), config)
    fam = interop.lsh_params(np.asarray(jstate.params.projections), "cpu")
    state = probes.sketch_features(None, torch.from_numpy(x_tr),
                                   torch.from_numpy(y_tr),
                                   probes.ProbeConfig(rows=2048, planes=4),
                                   params=fam, device="cpu")
    moved = int(np.abs(state.sketch.counts.numpy().astype(np.int64)
                       - np.asarray(jstate.sketch.counts, np.int64)).sum()
                // 2)
    print(json.dumps({"rows": n_train, "d": d, "layer": int(data["layer"]),
                      "moved_cells": moved,
                      "sketch_s": round(time.perf_counter() - start, 1)}),
          flush=True)

    def r2(mse, y):
        return 1.0 - float(mse) / float(np.mean((y - y.mean()) ** 2))

    def report(name, lr, l2, fit, x_scale, y_scale, mse, secs):
        losses = np.asarray(fit.losses)
        theta = np.asarray(fit.theta)
        print(json.dumps({
            "engine": name, "lr": lr, "l2": l2,
            "loss_first": float(losses[0]), "loss_max": float(losses.max()),
            "loss_last": float(losses[-1]),
            "select": [float(v) for v in np.asarray(fit.fleet_losses)],
            "guard_won": bool((theta == 0).all()),
            "theta_std_norm": float(np.linalg.norm(
                theta * np.asarray(x_scale) / np.asarray(y_scale))),
            "train_r2": r2(mse(x_tr, y_tr), y_tr),
            "held_r2": r2(mse(x_ho, y_ho), y_ho),
            "seconds": round(secs, 1)}), flush=True)

    for lr, l2 in settings:
        jcfg = dataclasses.replace(jprobes._PROBE_DFO, learning_rate=lr)
        start = time.perf_counter()
        want = jprobes.fit_probe(jax.random.PRNGKey(6), jstate, d,
                                 dfo_config=jcfg, l2=l2)
        report("jax", lr, l2, want, jstate.x_scale, jstate.y_scale,
               lambda x, y: want.mse(jnp.asarray(x), jnp.asarray(y)),
               time.perf_counter() - start)
        pcfg = dfo.DFOConfig(**{f: getattr(jcfg, f)
                                for f in jdfo.DFOConfig.__dataclass_fields__})
        dirs, _ = fleet_draws(jax.random.PRNGKey(6)[None], pcfg.steps,
                              pcfg.num_queries, d + 1)
        start = time.perf_counter()
        got = probes.fit_probe(None, state, d, dfo_config=pcfg, l2=l2,
                               directions=dirs, device="cpu")
        report("port", lr, l2, got, state.x_scale, state.y_scale,
               lambda x, y: got.mse(torch.from_numpy(x), torch.from_numpy(y)),
               time.perf_counter() - start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
