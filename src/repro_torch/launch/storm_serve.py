"""STORM sketch-serving launcher: the micro-batched gateway over a bank
(port of ``repro.launch.storm_serve``). Two modes:

* **synthetic drive** (default): mixed per-tenant read/write traffic pumped
  through the fixed-tick gateway in-process, synchronously or with two
  ticks in flight (``--pipelined``: pack tick t+1 on the host while tick t
  runs on the card):

      PYTHONPATH=src python -m repro_torch.launch.storm_serve --tenants 8 --ticks 32
      PYTHONPATH=src python -m repro_torch.launch.storm_serve --device cpu

* **wire front-end** (``--listen HOST:PORT``): serves the framed protocol
  of ``serve.wire`` to socket clients; the engine thread keeps ``--depth``
  ticks in flight and queue overflow becomes explicit backpressure errors:

      PYTHONPATH=src python -m repro_torch.launch.storm_serve --tenants 8 \\
          --listen 127.0.0.1:7077 --max-pending-rows 4096

``--hot-capacity`` serves the tenants through the tiered store.
``--epsilon-total`` (with ``--epsilon-release``, ``--delta``,
``--mechanism``, ``--on-exhaust``) serves privatize-on-read under a finite
``ReleasePolicy``; without it the gateway is the non-private one.
"""

from __future__ import annotations

import argparse
import itertools
import threading
import time
from collections import deque
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import lsh
from repro_torch.core.privacy import ReleasePolicy
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
    stats = gw.queue_stats()
    if "privacy" in stats:
        p = stats["privacy"]
        print(f"privacy: {p['mechanism']} eps_total={p['epsilon_total']} "
              f"eps/release={p['epsilon_release']} "
              f"on_exhaust={p['on_exhaust']} -> {p['releases']} releases, "
              f"{len(p['exhausted'])} tenants exhausted, "
              f"{p['queries_refused']} queries refused")
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
            "trace_count": gw.trace_count, "fits": gw.fits_run,
            "privacy": stats.get("privacy")}


def _drive_listen(gw, args: argparse.Namespace,
                  stop: Optional[threading.Event] = None) -> dict:
    """Serve the wire protocol until Ctrl-C (or ``stop`` is set), printing
    the gateway's state every 2 s; returns the last state."""
    from repro_torch.serve.wire import StormWireServer

    host, _, port = args.listen.rpartition(":")
    server = StormWireServer(gw, host or "127.0.0.1", int(port),
                             depth=args.depth).start()
    addr = server.address
    print(f"listening on {addr[0]}:{addr[1]} "
          f"(S={gw.tenants}, I={gw.ingest_slots}, Q={gw.query_slots}, "
          f"caps rows={gw.max_pending_rows} "
          f"points={gw.max_pending_points})", flush=True)
    stop = stop if stop is not None else threading.Event()
    try:
        while not stop.wait(2.0):
            s = gw.queue_stats()
            line = (f"ticks={s['ticks']} pending={s['pending_requests']} "
                    f"rows={s['rows_ingested']} "
                    f"points={s['points_served']} "
                    f"traces={s['trace_count']}")
            if "privacy" in s:
                line += (f" releases={s['privacy']['releases']} "
                         f"exhausted={len(s['privacy']['exhausted'])}")
            print(line, flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    s = gw.queue_stats()
    return {"address": addr, "ticks": s["ticks"],
            "rows": s["rows_ingested"], "points": s["points_served"],
            "trace_count": s["trace_count"], "privacy": s.get("privacy")}


def main(argv: Optional[Sequence[str]] = None,
         stop: Optional[threading.Event] = None) -> dict:
    """Parse ``argv`` and run; ``stop`` ends a ``--listen`` server (Ctrl-C
    does from a terminal). Returns what the drive printed, as numbers."""
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
                    help="serve the wire protocol instead of synthetic "
                         "traffic (port 0 = ephemeral)")
    ap.add_argument("--depth", type=int, default=2,
                    help="in-flight ticks in the wire engine loop")
    ap.add_argument("--epsilon-total", type=float, default=None,
                    help="per-tenant lifetime eps budget (a finite value "
                         "enables privatize-on-read serving; omit for the "
                         "non-private gateway)")
    ap.add_argument("--epsilon-release", type=float, default=1.0,
                    help="eps charged per count release (one release per "
                         "tenant per tick covers all its coalesced queries)")
    ap.add_argument("--delta", type=float, default=1e-6,
                    help="gaussian-mechanism delta (--mechanism gaussian)")
    ap.add_argument("--mechanism", choices=("laplace", "gaussian"),
                    default="laplace")
    ap.add_argument("--on-exhaust", choices=("refuse", "stale"),
                    default="refuse",
                    help="exhausted tenants: terminal budget_exceeded "
                         "refusal, or serve the last cached release")
    args = ap.parse_args(argv)
    policy = None
    if args.epsilon_total is not None:
        policy = ReleasePolicy(epsilon_total=args.epsilon_total,
                               epsilon_release=args.epsilon_release,
                               delta=args.delta, mechanism=args.mechanism,
                               on_exhaust=args.on_exhaust)
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
                                privacy=policy, privacy_seed=args.seed,
                                device=dev)
    else:
        gw = StormGateway(params, args.tenants,
                          query_slots=args.query_slots,
                          ingest_slots=args.ingest_slots,
                          max_pending_rows=args.max_pending_rows,
                          max_pending_points=args.max_pending_points,
                          privacy=policy, privacy_seed=args.seed,
                          device=dev)
    if args.listen is not None:
        return _drive_listen(gw, args, stop)
    return _drive_synthetic(gw, args)


if __name__ == "__main__":
    main()
