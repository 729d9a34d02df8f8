"""Distributed edge scenario: 8 devices sketch their local streams, merge by
integer addition (psum), and every device trains the same model from the
merged sketch — optionally with a differentially-private release (port of
``examples/edge_regression.py``).

The reference forces 8 XLA host devices. The port's single controller
takes a :class:`~repro_torch.sharding.mesh.Mesh` that names the chosen
device 8 times: every shard's insert runs (one launch of
the paired insert per shard on the card), on one device.

Run: PYTHONPATH=src python -m repro_torch.examples.edge_regression [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import distributed, dfo, erm, losses, lsh, privacy
from repro_torch.core import sketch
from repro_torch.data import datasets
from repro_torch.device import generator, resolve_device
from repro_torch.sharding.mesh import Mesh


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # One global regression problem, observed as 8 device-local streams.
    # Host generators for the data, the hash family and the DFO draws: the
    # card and the CPU see the same numbers (the release's noise is drawn
    # where the counters live).
    x, y, _ = datasets.make_regression(generator(0, "cpu"), n=4096, d=8,
                                       noise=0.2, condition=10)
    x, y = x.to(dev), y.to(dev)
    xs = (x - x.mean(0)) / (x.std(0, unbiased=False) + 1e-8)
    ys = (y - y.mean()) / (y.std(unbiased=False) + 1e-8)
    # The registered spec owns the data encoding (concat [x, y] for the
    # paired PRP regression loss) — same spine as every other loss.
    spec = losses.PRP_REGRESSION
    z = spec.encode(xs, ys)
    z_scaled, _ = lsh.scale_to_unit_ball(z)

    params = lsh.init_srp(generator(1, "cpu"), rows=2048, planes=4,
                          dim=z.shape[1] + 2, device=dev)
    mesh = Mesh([dev] * 8, "data")

    # SPMD: local sketch per shard + integer all-reduce == merged sketch.
    merged = distributed.sharded_sketch(params, z_scaled, mesh, axis="data")
    print(f"devices: {mesh.size}, merged sketch n={int(merged.n)}, "
          f"bytes={merged.memory_bytes():,}")

    # Every device can now train locally from the merged counters through
    # the generic erm driver (regression.fit is a thin adapter over it).
    res = erm.fit(spec, merged, params,
                  dfo.DFOConfig(steps=300, num_queries=8, sigma=0.5,
                                learning_rate=1.0, decay=0.995),
                  generator=generator(2, "cpu"), device=dev)
    mse = float(torch.mean((xs @ res.theta[:-1] - ys) ** 2))
    var_ys = float(torch.var(ys, unbiased=False))
    print(f"distributed-sketch model MSE (standardized): {mse:.4f} "
          f"(var ys = {var_ys:.4f})")

    # Differentially-private release of the merged sketch (eps = 1).
    private = privacy.privatize_counts(generator(3, dev), merged,
                                       epsilon=1.0)
    q = lsh.query_codes(params, torch.zeros(z.shape[1], device=dev))
    exact = float(sketch.query(merged, q, paired=True))
    noisy = float(privacy.query_private(private, q, paired=True))
    print(f"query at theta=0: exact={exact:.4f} private(eps=1)={noisy:.4f}")
    return {"devices": mesh.size, "n": int(merged.n),
            "bytes": merged.memory_bytes(), "mse": mse, "var_ys": var_ys,
            "exact": exact, "private": noisy}


if __name__ == "__main__":
    main()
