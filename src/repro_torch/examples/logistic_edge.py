"""Edge classification with the registered logistic surrogate — and the
same cohort trained remotely through the serving gateway's fit request
(port of ``examples/logistic_edge.py``).

The logistic spec (``repro_torch.core.losses.LOGISTIC``) is an exp-concave
monotone transform of the margin estimate: ``log1p(2^p * mean f(-t)^p)``
shares the margin loss's argmin but with log-calibrated values. It trains
through the unchanged ``erm.fit_surrogate_many`` spine (kernels 4 and 6 on
the card), locally or via a
:class:`~repro_torch.serve.storm_gateway.StormGateway` ``FitRequest``.

Run: PYTHONPATH=src python -m repro_torch.examples.logistic_edge [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import erm, lsh
from repro_torch.device import generator, resolve_device
from repro_torch.serve.storm_gateway import (FitRequest, IngestRequest,
                                             StormGateway)


def make_problem(rng, n, d):
    w = rng.normal(size=(d,)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(x @ w).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _accuracy(x, y, theta) -> float:
    return float(torch.mean((torch.sign(x @ theta) == y).to(torch.float32)))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n, d, tenants = 1000, 6, 3
    problems = [tuple(t.to(dev) for t in make_problem(rng, n, d))
                for _ in range(tenants)]

    # 1. Local: every tenant's logistic model from one banked fit.
    cfg = erm.ERMConfig(rows=1024, planes=2)
    many = erm.fit_surrogate_many(
        "logistic", generator(0, "cpu"),
        [x for x, _ in problems], [y for _, y in problems], config=cfg,
        device=dev)
    local = []
    for t, (x, y) in enumerate(problems):
        local.append(_accuracy(x, y, many.theta[t]))
        print(f"tenant {t}: local logistic accuracy {local[-1]:.3f}")

    # 2. Served: stream each tenant's (pre-augmented) margin points into a
    #    single-sided gateway, then ask IT to train the cohort from the
    #    counters it serves — same spine, one FitRequest.
    params = lsh.init_srp(generator(1, "cpu"), cfg.rows, cfg.planes, d + 2,
                          device=dev)
    gw = StormGateway(params, tenants, paired=False, ingest_slots=256,
                      device=dev)
    spec_encode = erm.resolve("logistic").encode
    for t, (x, y) in enumerate(problems):
        z = spec_encode(x, y)                       # -y * x margin points
        z_scaled, _ = lsh.scale_to_unit_ball(z, cfg.norm_slack)
        gw.submit(IngestRequest(rid=t, tenant=t,
                                z=lsh.augment_data(z_scaled).cpu().numpy()))
    gw.run_until_idle()
    gw.submit(FitRequest(rid=99, tenants=list(range(tenants)),
                         surrogate="logistic", seed=0,
                         steps=150))
    fit = gw.tick().fits[0]
    served = []
    for t, (x, y) in enumerate(problems):
        theta = torch.as_tensor(np.asarray(fit.theta[t]), device=dev)
        served.append(_accuracy(x, y, theta))
        print(f"tenant {t}: gateway-fit logistic accuracy {served[-1]:.3f}")
    print(f"gateway tick programs traced {gw.trace_count}x "
          f"(fits never touch the tick caches)")
    return {"local_accuracy": local, "gateway_accuracy": served,
            "trace_count": gw.trace_count}


if __name__ == "__main__":
    main()
