"""A tenant trains over the wire while its eps budget drains to exhaustion
(port of ``examples/private_serving.py``).

The privacy layer end to end: the server runs a
:class:`~repro_torch.serve.storm_gateway.StormGateway` under a finite
:class:`~repro_torch.core.privacy.ReleasePolicy`, so every query/fit round is
served from ONE noisy release of the tenant's counters per tick
(privatize-on-read; re-reads of unchanged counters are free; on the card
the fits read the release through the queries' f32 variants). The client
ingests a private stream, trains a regression surrogate from the released
counters round after round, and watches its remaining eps drop through the
``budget`` wire frame — until the ledger refuses the release and the
``*_sync`` helper surfaces the terminal ``budget_exceeded`` frame as
:class:`~repro_torch.serve.wire.BudgetExceeded` (not retryable: unlike
backpressure, waiting cannot mint new budget).

Run: PYTHONPATH=src python -m repro_torch.examples.private_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import lsh
from repro_torch.core.privacy import ReleasePolicy
from repro_torch.device import generator, resolve_device
from repro_torch.serve.storm_gateway import StormGateway
from repro_torch.serve.wire import (BudgetExceeded, StormWireClient,
                                    StormWireServer)

D = 8  # sketch-space dim


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # Each fit over the cohort of one costs one release (eps 1.0); the
    # lifetime budget funds exactly four.
    policy = ReleasePolicy(epsilon_total=4.0, epsilon_release=1.0,
                           mechanism="laplace", on_exhaust="refuse")
    params = lsh.init_srp(generator(0, "cpu"), rows=256, planes=4, dim=D + 2,
                          device=dev)
    gw = StormGateway(params, tenants=2, query_slots=16, ingest_slots=256,
                      privacy=policy, privacy_seed=0, device=dev)
    server = StormWireServer(gw, port=0).start()
    client = StormWireClient(*server.address)
    rids = itertools.count()
    print(f"server on {server.address[0]}:{server.address[1]} — "
          f"eps_total={policy.epsilon_total}, "
          f"eps/release={policy.epsilon_release}, "
          f"on_exhaust={policy.on_exhaust}")

    rng = np.random.default_rng(1)
    center = rng.normal(size=D).astype(np.float32)
    center *= 0.5 / np.linalg.norm(center)

    rounds, refused_at, retryable = [], None, None
    try:
        for round_idx in itertools.count(1):
            # New private rows close the previous release window: the next
            # read is a NEW release and costs eps_release.
            z = center + 0.15 * rng.normal(size=(64, D)).astype(np.float32)
            client.ingest(next(rids), 0, np.clip(z, -0.9, 0.9))
            header, _ = client.recv()
            if header["type"] != "ingest_ok":
                raise RuntimeError(f"ingest answered {header}")

            try:
                theta, fleet_losses = client.fit_sync(
                    next(rids), [0], surrogate="prp_regression",
                    seed=round_idx, steps=40)
            except BudgetExceeded as exc:
                refused_at, retryable = round_idx, exc.header["retryable"]
                print(f"round {round_idx}: TERMINAL — {exc} "
                      f"(retryable={retryable})")
                break

            budget = client.budget()
            loss = float(np.min(np.asarray(fleet_losses)[0]))
            spent = budget["spent"].get("0", 0.0)
            rounds.append({"loss": loss, "spent": spent,
                           "remaining": budget["remaining"].get("0")})
            print(f"round {round_idx}: fit loss {loss:+.4f}  "
                  f"spent {spent:.1f}  "
                  f"remaining {budget['remaining'].get('0')}")

        budget = client.budget()
        print(f"final ledger: spent={budget['spent']} "
              f"exhausted={budget['exhausted']} "
              f"({budget['releases']} releases served)")
        # An on_exhaust="stale" policy would instead keep serving the last
        # cached release (results tagged "stale": true on the wire).
    finally:
        client.close()
        server.stop()
    return {"rounds": rounds, "refused_at": refused_at,
            "retryable": retryable, "spent": budget["spent"],
            "exhausted": budget["exhausted"],
            "releases": budget["releases"]}


if __name__ == "__main__":
    main()
