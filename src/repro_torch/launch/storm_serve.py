"""STORM sketch-serving launcher: the micro-batched gateway driven by
synthetic traffic (port of ``repro.launch.storm_serve``'s synthetic drive).

Generates mixed per-tenant read/write traffic and pumps it through the
fixed-tick gateway in-process, synchronously or with two ticks in flight
(``--pipelined``: pack tick t+1 on the host while tick t runs on the card):

    PYTHONPATH=src python -m repro_torch.launch.storm_serve --tenants 8 --ticks 32
    PYTHONPATH=src python -m repro_torch.launch.storm_serve --device cpu

``--hot-capacity`` serves the tenants through the tiered store. The wire
front-end (``--listen``) and privacy (``--epsilon-total``) are not ported
yet and exit with an error.
"""

from __future__ import annotations

import argparse
import itertools
import time
from collections import deque
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import lsh
from repro_torch.core.sketch import counter_dtype
from repro_torch.device import generator, resolve_device
from repro_torch.serve.storm_gateway import (
    FitRequest, IngestRequest, QueryRequest, StormGateway,
)


def synth_traffic(
    rng: np.random.Generator,
    rids: Iterator[int],
    tenants: int,
    dim: int,
    ingest_rate: int,
    query_rate: int,
) -> List[Union[IngestRequest, QueryRequest]]:
    """One round of mixed per-tenant traffic with collision-free rids.

    Each tenant sends ``Poisson(ingest_rate)`` rows of ``0.4/sqrt(dim)``-
    scaled normals and ``Poisson(query_rate)`` standard-normal query
    points; ``rids`` is one monotonic counter shared by both classes. The
    same ``rng`` state gives the reference launcher's requests.
    """
    reqs: List[Union[IngestRequest, QueryRequest]] = []
    for t in range(tenants):
        n_rows = int(rng.poisson(ingest_rate))
        if n_rows:
            z = rng.normal(size=(n_rows, dim)).astype(np.float32)
            z *= 0.4 / np.sqrt(dim)
            reqs.append(IngestRequest(rid=next(rids), tenant=t, z=z))
        n_q = int(rng.poisson(query_rate))
        if n_q:
            thetas = rng.normal(size=(n_q, dim)).astype(np.float32)
            reqs.append(QueryRequest(rid=next(rids), tenant=t,
                                     thetas=thetas))
    return reqs


def _maybe_fit(gw, args: argparse.Namespace, rids: Iterator[int],
               round_idx: int) -> None:
    """Submit a cohort FitRequest every ``--fit-every`` traffic rounds."""
    if args.fit_every <= 0 or (round_idx + 1) % args.fit_every:
        return
    cohort = list(range(min(args.fit_cohort, args.tenants)))
    gw.submit(FitRequest(rid=next(rids), tenants=cohort,
                         surrogate=args.fit_surrogate, seed=args.seed,
                         steps=args.fit_steps))


def _drive_synthetic(gw, args: argparse.Namespace) -> dict:
    """The synthetic drive; returns what it printed, as numbers."""
    rng = np.random.default_rng(args.seed)
    rids = itertools.count()

    gw.tick()  # an idle warm-up tick, as the reference launcher runs
    t0 = time.perf_counter()
    completed = 0
    if args.pipelined:
        inflight = deque()
        for i in range(args.ticks):
            gw.submit_many(synth_traffic(rng, rids, args.tenants, args.dim,
                                         args.ingest_rate, args.query_rate))
            _maybe_fit(gw, args, rids, i)
            inflight.append(gw.tick_start())
            if len(inflight) >= 2:
                completed += len(gw.tick_finish(inflight.popleft()).results)
        while inflight:
            completed += len(gw.tick_finish(inflight.popleft()).results)
        completed += len(gw.run_until_idle(pipelined=True))
    else:
        for i in range(args.ticks):
            gw.submit_many(synth_traffic(rng, rids, args.tenants, args.dim,
                                         args.ingest_rate, args.query_rate))
            _maybe_fit(gw, args, rids, i)
            completed += len(gw.tick().results)
        completed += len(gw.run_until_idle())
    dt = time.perf_counter() - t0

    label = "pipelined" if args.pipelined else "synchronous"
    print(f"served {gw.ticks - 1} {label} ticks over {args.tenants} tenants "
          f"on {gw.params.projections.device} in {dt:.2f}s: {completed} "
          f"queries answered ({gw.points_served} points, "
          f"{gw.points_served / dt:.0f} pts/s), {gw.rows_ingested} rows "
          f"ingested ({gw.rows_ingested / dt:.0f} rows/s)")
    print(f"tick bodies run {gw.trace_count} signatures in all "
          f"(fixed padded shapes)")
    if args.fit_every > 0:
        print(f"cohort fits: {gw.fits_run} x {args.fit_surrogate} over "
              f"{min(args.fit_cohort, args.tenants)} tenants "
              f"({args.fit_steps} DFO steps each, drained between ticks)")
    if hasattr(gw, "tiers"):
        tier = gw.queue_stats()["tier"]
        print(f"tiered bank: T={gw.tenants} hot={tier['hot_capacity']} "
              f"dtype={gw.tiers.dtype} "
              f"resident {tier['resident_bytes']:,} B, "
              f"cold {tier['cold_bytes']:,} B host, "
              f"{tier['swap_count']} swaps "
              f"({gw.promotions} promote / {gw.demotions} demote)")
    else:
        print(f"bank: S={gw.tenants} R={gw.params.rows} "
              f"B={gw.params.buckets} ({gw.bank.memory_bytes():,} bytes)")
    return {"seconds": dt, "completed": completed,
            "points": gw.points_served, "rows": gw.rows_ingested,
            "trace_count": gw.trace_count, "fits": gw.fits_run}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--dim", type=int, default=8, help="sketch-space dim")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--planes", type=int, default=4)
    ap.add_argument("--query-slots", type=int, default=32,
                    help="per-tenant theta capacity per tick")
    ap.add_argument("--ingest-slots", type=int, default=128,
                    help="per-tenant row capacity per tick")
    ap.add_argument("--ticks", type=int, default=32)
    ap.add_argument("--ingest-rate", type=int, default=64,
                    help="mean new rows per tenant per tick")
    ap.add_argument("--query-rate", type=int, default=16,
                    help="mean new query points per tenant per tick")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fit-every", type=int, default=0,
                    help="submit a cohort FitRequest every N traffic rounds "
                         "(0 = never)")
    ap.add_argument("--fit-cohort", type=int, default=4,
                    help="cohort size for --fit-every (tenants 0..N-1)")
    ap.add_argument("--fit-surrogate", default="prp_regression",
                    help="registered surrogate name for --fit-every")
    ap.add_argument("--fit-steps", type=int, default=50,
                    help="DFO steps per serving-side fit")
    ap.add_argument("--pipelined", action="store_true",
                    help="two ticks in flight (overlap host packing with "
                         "the device)")
    ap.add_argument("--max-pending-rows", type=int, default=None,
                    help="per-tenant ingest-queue cap (backpressure)")
    ap.add_argument("--max-pending-points", type=int, default=None,
                    help="per-tenant query-queue cap (backpressure)")
    ap.add_argument("--hot-capacity", type=int, default=None,
                    help="tiered store: resident slots (fewer than "
                         "--tenants spills cold tenants to host memory)")
    ap.add_argument("--count-dtype", choices=("int32", "int16", "int8"),
                    default="int16",
                    help="tiered resident counter dtype (--hot-capacity "
                         "only)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--listen", metavar="HOST:PORT", default=None,
                    help="not ported yet: the wire front-end")
    ap.add_argument("--epsilon-total", type=float, default=None,
                    help="not ported yet: privatize-on-read serving")
    args = ap.parse_args(argv)
    if args.listen is not None:
        ap.error("--listen: the wire front-end is not ported yet (ROADMAP "
                 "Queue 1, item 10: the wire slice)")
    if args.epsilon_total is not None:
        ap.error("--epsilon-total: privatize-on-read serving is not ported "
                 "yet (ROADMAP Queue 1, item 10: the privacy slice)")
    dev = resolve_device(args.device)
    params = lsh.init_srp(generator(args.seed, dev), args.rows, args.planes,
                          args.dim + 2, device=dev)
    if args.hot_capacity is not None:
        from repro_torch.serve.tiered_gateway import TieredStormGateway

        gw = TieredStormGateway(params, args.tenants, args.hot_capacity,
                                query_slots=args.query_slots,
                                ingest_slots=args.ingest_slots,
                                count_dtype=counter_dtype(args.count_dtype),
                                max_pending_rows=args.max_pending_rows,
                                max_pending_points=args.max_pending_points,
                                device=dev)
    else:
        gw = StormGateway(params, args.tenants,
                          query_slots=args.query_slots,
                          ingest_slots=args.ingest_slots,
                          max_pending_rows=args.max_pending_rows,
                          max_pending_points=args.max_pending_points,
                          device=dev)
    return _drive_synthetic(gw, args)


if __name__ == "__main__":
    main()
