"""Quickstart: train models from a STORM sketch only, via the ERM spine
(port of ``examples/quickstart.py``).

The dataset is streamed into an R x B array of integer counters, discarded,
and the model is recovered by derivative-free optimization over sketch
queries (paper Algorithm 2). Every trainable loss is a registered
``Surrogate`` spec (``repro_torch.core.losses``) and trains through ONE
generic driver — ``erm.fit_surrogate(name, gen, x, y)`` — so a new loss is a
registry entry, not a new training loop. On the card the sketch is one
launch of the paired insert and each DFO step one launch of the query.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import baselines, erm, losses, regression
from repro_torch.data import datasets
from repro_torch.device import generator, resolve_device


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A regression problem the edge device observes as a stream.
    # Every draw (data, hash family, DFO) comes from a host generator, so
    # the card and the CPU see the same numbers.
    x, y, _ = datasets.make_regression(generator(0, "cpu"), n=2000, d=8,
                                       noise=0.2, condition=10)
    x, y = x.to(dev), y.to(dev)

    surrogates = sorted(losses.SURROGATES)
    print("registered surrogates:", surrogates)

    # 2a. The task-level driver (a thin adapter over the erm spine): it
    #     standardizes, sketches, fits, and un-standardizes for you.
    cfg = regression.StormRegressorConfig(rows=2048, planes=4)
    fit = regression.fit(generator(1, "cpu"), x, y, cfg, device=dev)

    # 2b. The same fit through the generic registry path — any registered
    #     loss trains this way, with zero per-loss driver code.
    xs = (x - x.mean(0)) / (x.std(0, unbiased=False) + 1e-8)
    ys = (y - y.mean()) / (y.std(unbiased=False) + 1e-8)
    generic = erm.fit_surrogate("prp_regression", generator(1, "cpu"), xs, ys,
                                config=erm.ERMConfig(rows=2048, planes=4),
                                device=dev)
    # pin_last=-1 makes the iterate homogeneous: <theta, [x, y]> = 0, so
    # the standardized prediction is xs @ theta[:d].
    mse_generic = float(torch.mean((xs @ generic.theta[:-1] - ys) ** 2))

    # 3. Compare against exact least squares.
    ols = baselines.ols(x, y)
    out = {
        "sketch_bytes": regression.sketch_memory_bytes(cfg),
        "dataset_bytes": x.numel() * 4 + y.numel() * 4,
        "storm_mse": float(fit.mse(x, y)),
        "exact_mse": float(ols.mse(x, y)),
        "var_y": float(torch.var(y, unbiased=False)),
        "generic_mse": mse_generic,
        "var_ys": float(torch.var(ys, unbiased=False)),
        "cos": float(torch.dot(fit.theta, ols.theta) / (
            torch.linalg.norm(fit.theta) * torch.linalg.norm(ols.theta))),
    }
    print(f"sketch size:        {out['sketch_bytes']:,} bytes")
    print(f"dataset size:       {out['dataset_bytes']:,} bytes")
    print(f"STORM    train MSE: {out['storm_mse']:.4f}")
    print(f"exact    train MSE: {out['exact_mse']:.4f}")
    print(f"variance of y:      {out['var_y']:.4f}")
    print(f"registry-path MSE (standardized space): {mse_generic:.4f} "
          f"(var ys = {out['var_ys']:.4f})")
    print(f"cos(theta_storm, theta_ols): {out['cos']:.3f}")
    out["surrogates"] = surrogates
    return out


if __name__ == "__main__":
    main()
