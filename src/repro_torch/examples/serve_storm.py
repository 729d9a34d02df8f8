"""Serve many tenants' sketches from one gateway: mixed read/write traffic
(port of ``examples/serve_storm.py``).

Each tenant streams its (pre-scaled) regression data to the gateway in
chunks, interleaved with other tenants' traffic and with query requests; the
gateway coalesces every tick's traffic into ONE banked insert and ONE
banked query launch (kernels 4 and 6 on the card). At the end, each
tenant's model is fit offline from its served counters alone (kernels 1
and 2 build and query) — the sketch, not the data, is what the gateway
keeps — and the served counters are checked against a standalone one-shot
build.

    PYTHONPATH=src python -m repro_torch.examples.serve_storm [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import lsh, regression, sketch
from repro_torch.data import datasets
from repro_torch.device import generator, resolve_device
from repro_torch.serve.storm_gateway import (IngestRequest, QueryRequest,
                                             StormGateway)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tenants, n, d = 4, 1024, 6

    # Per-tenant regression problems, preprocessed the way regression.fit
    # does (standardize -> concat [x, y] -> unit-ball scale). The gateway
    # ingests sketch-space rows; raw data never leaves the "edge".
    config = regression.StormRegressorConfig(rows=1024)
    problems, streams = [], []
    for t in range(tenants):
        # Host generators: the card and the CPU see the same draws.
        x, y, _ = datasets.make_regression(generator(10 + t, "cpu"), n, d,
                                           noise=0.2, condition=3)
        x, y = x.to(dev), y.to(dev)
        xs = (x - x.mean(0)) / (x.std(0, unbiased=False) + 1e-8)
        ys = (y - y.mean()) / (y.std(unbiased=False) + 1e-8)
        z, _ = lsh.scale_to_unit_ball(torch.cat([xs, ys[:, None]], dim=-1),
                                      config.norm_slack)
        problems.append((x, y))
        streams.append(z.cpu().numpy())

    params = lsh.init_srp(generator(0, "cpu"), config.rows, config.planes,
                          d + 1 + 2, device=dev)
    gw = StormGateway(params, tenants, query_slots=16, ingest_slots=256,
                      device=dev)

    # Mixed traffic: every tenant streams 256-row chunks; a probe query for
    # theta = 0 rides along mid-stream (answered against the live counters).
    rng = np.random.default_rng(0)
    chunks = [[s[o:o + 256] for o in range(0, n, 256)] for s in streams]
    probe = np.zeros((1, d + 1), np.float32)
    rid = 0
    for round_ in range(len(chunks[0])):
        order = rng.permutation(tenants)
        for t in order:
            gw.submit(IngestRequest(rid=rid, tenant=int(t),
                                    z=chunks[t][round_]))
            rid += 1
        if round_ == 1:
            for t in range(tenants):
                gw.submit(QueryRequest(rid=rid, tenant=t, thetas=probe))
                rid += 1
    mid = gw.run_until_idle()
    print(f"gateway: {gw.ticks} ticks, {gw.rows_ingested} rows ingested, "
          f"{gw.points_served} query points served "
          f"(tick programs traced {gw.trace_count}x)")
    mid_losses = {}
    for r in sorted(mid, key=lambda r: r.tenant):
        mid_losses[r.tenant] = float(r.losses[0])
        print(f"  mid-stream loss at theta=0, tenant {r.tenant}: "
              f"{mid_losses[r.tenant]:.4f}")

    # The served counters ARE the one-shot sketch: bit-identical check.
    # The standalone build takes the insert kernel's path (its plain
    # version on the CPU), as the gateway's banked insert does: the scan
    # engine projects in another order, which may flip a sign tie.
    t0 = sketch.sketch_dataset(params, torch.from_numpy(streams[0]).to(dev),
                               batch=config.batch, engine="kernel",
                               device=dev)
    same = bool(torch.equal(gw.bank.counts[0], t0.counts))
    print(f"tenant 0 served counters == standalone sketch_dataset: {same}")

    # Fit every tenant offline from its served sketch alone.
    mse, var = [], []
    for t, (x, y) in enumerate(problems):
        fit = regression.fit(generator(100 + t, "cpu"), x, y, config,
                             prebuilt=(gw.sketch_of(t), params, None),
                             device=dev)
        mse.append(float(fit.mse(x, y)))
        var.append(float(torch.var(y, unbiased=False)))
        print(f"tenant {t}: MSE from served sketch = {mse[-1]:.4f} "
              f"(var y = {var[-1]:.4f})")
    return {"ticks": gw.ticks, "rows_ingested": gw.rows_ingested,
            "points_served": gw.points_served,
            "trace_count": gw.trace_count, "mid_losses": mid_losses,
            "same_counters": same, "mse": mse, "var_y": var}


if __name__ == "__main__":
    main()
