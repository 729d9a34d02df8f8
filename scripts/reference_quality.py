#!/usr/bin/env python3
"""Model quality of the reference and the port on the same data, on the CPU.

    PYTHONPATH=src python3 scripts/reference_quality.py [--rows-a N] [--rows-b N]

Runs JAX's ``repro.core.regression.fit`` and the port's
``repro_torch.core.regression.fit(device="cpu")`` on the same numpy-drawn
arrays, with the same JAX-drawn hash family and DFO draws (passed to the
port through ``repro_torch.interop``), and prints MSE, R^2 and the cosine to
OLS of each fit, the final sketch loss, and how many sketch cells the two
builds put in other buckets (sign ties of the two frameworks' scaling),
one JSON line per case:

(a) the airfoil-matched draw (d = 9, noise 0.3, condition 30: chip_smoke's
    main path) at the default ``StormRegressorConfig``, ``--rows-a`` rows
    (default 2^18);
(b) chip_smoke phase 15's d = 40 shape (noise 0.2, condition 10) at its
    small steps (R = 4096, 400 DFO steps of k = 32, sigma 0.15, learning
    rate 0.25) and at the defaults, ``--rows-b`` rows (default 2^17).

It settles whether the fits' quality at these shapes comes from the method
or from the port. Needs JAX and the port (``PYTHONPATH=src``); no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-a", type=int, default=1 << 18)
    ap.add_argument("--rows-b", type=int, default=1 << 17)
    ap.add_argument("--seed", type=int, default=0, help="the fits' JAX key")
    args = ap.parse_args()

    import jax

    from torch_parity import (quality_cases, regression_draw,
                              regression_fit_pair)

    for label, seed, n, d, noise, condition, cfg in quality_cases(
            args.rows_a, args.rows_b):
        x, y = regression_draw(seed, n, d, noise, condition)
        start = time.perf_counter()
        out, moved = regression_fit_pair(jax.random.PRNGKey(args.seed), x, y,
                                         cfg)
        print(json.dumps({
            "case": label, "n": n, "d": d, "noise": noise,
            "condition": condition, "rows": cfg.rows, "steps": cfg.dfo.steps,
            "k": cfg.dfo.num_queries, "sigma": cfg.dfo.sigma,
            "lr": cfg.dfo.learning_rate, "moved_cells": moved, **out,
            "seconds": round(time.perf_counter() - start, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
