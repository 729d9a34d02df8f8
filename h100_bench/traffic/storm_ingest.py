"""Closed-loop edge clients streaming rows into a STORM gateway's tenants.

The mix's parameters (``traffic/<mix>.json``, ``kind: storm_ingest``):

* ``clients``, ``outstanding``: a closed loop; each client keeps that many
  ingest requests unacknowledged;
* ``tenant``: ``"own"`` (client ``c`` sends to tenant ``c``) or
  ``"zipf"`` with ``zipf_s`` (each request picks its tenant);
* ``size``: ``{"fixed": rows}`` or ``{"loguniform": [lo, hi]}`` rows a
  request;
* ``schedule``: how many (tenant, size) pairs are drawn: the same multiset
  for every seed (quantiles of the two laws), in an order the seed shuffles;
* ``query_every_ticks``, ``query_points``, ``query_sigma``: every that many
  ticks each client sends one query of that many points (a DFO step: a
  centre and ``(points - 1) / 2`` antithetic pairs);
* ``depth``: ticks in flight;
* ``pool_rows``: the host pool of rows, made from the seed, that requests
  cycle through (a cursor per tenant);
* ``check_queries``: query requests drawn from the seed for the check.

The configuration (``configs/<config>.json``) gives the rows' law (the
airfoil-matched regression), the hash family and the gateway's shapes.

End-to-end: ``rows_per_s``, the rows of requests acknowledged inside the
window over the window; ``ingest_p95_ms``, the 95th percentile over every
ingest request submitted inside the window of submit to acknowledging tick
report (requests still unacknowledged when the window closes are waited
for after it, and their wait counts). Correct: the gateway's counters after
the drain against the reference's, every cell, and the sampled queries'
estimates against the reference's at the tick that served them, every
point; both exact.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, List

import numpy as np
import torch

from h100_bench.harness import Window
from h100_bench.reference import storm_ref


def airfoil_rows(gen: torch.Generator, n: int, d: int, noise: float,
                 condition: float) -> torch.Tensor:
    """``[x, y]`` rows of a linear-Gaussian regression whose feature
    covariance has the given conditioning (the UCI-matched generator),
    scaled into the unit ball: rows over the 0.9 quantile of the norms
    times 1.05 are clipped onto the sphere."""
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    eigs = torch.logspace(0.0, math.log10(condition), d, device=dev)
    eigs = eigs / eigs.mean()
    rot, _ = torch.linalg.qr(normal(d, d))
    x = (normal(n, d) * torch.sqrt(eigs)) @ rot.T
    theta = normal(d)
    y = x @ theta + noise * normal(n)
    z = torch.cat([x, y[:, None]], dim=1)
    norms = torch.linalg.vector_norm(z, dim=-1)
    c = torch.sort(norms).values[int(0.9 * (n - 1))] * 1.05
    z = z / c
    nrm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return z / torch.clamp(nrm, min=1.0)


def schedule(mix: dict, tenants: int, rng: np.random.Generator):
    """``(tenants, sizes)`` of ``mix["schedule"]`` requests: the same
    multiset for every seed, in the seed's order."""
    n = mix["schedule"]
    u = (np.arange(n) + 0.5) / n
    size = mix["size"]
    if "fixed" in size:
        sizes = np.full(n, size["fixed"], np.int64)
    else:
        lo, hi = size["loguniform"]
        sizes = np.floor(lo * (hi / lo) ** u).astype(np.int64)
    if mix["tenant"] == "zipf":
        p = 1.0 / np.arange(1, tenants + 1) ** mix["zipf_s"]
        edges = np.cumsum(p / p.sum())
        who = np.minimum(np.searchsorted(edges, u), tenants - 1)
    else:
        who = np.full(n, -1, np.int64)  # the client's own tenant
    return who[rng.permutation(n)], sizes[rng.permutation(n)]


class Session:
    """Set-up of one storm cell: pool, hash family, warmed gateway."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        from repro_torch.core import lsh
        from repro_torch.serve import storm_gateway as gw_mod

        t0 = time.perf_counter()
        self.gw_mod = gw_mod
        self.config, self.mix, self.device = config, mix, device
        self.seed = seed
        g = config["gateway"]
        data = config["rows"]
        self.tenants = g["tenants"]
        self.slots = g["ingest_slots"]
        gen = torch.Generator(device=device).manual_seed(seed)
        dim = data["d"] + 3  # [x, y] and the two PRP coordinates
        self.projections = torch.randn((g["rows"], g["planes"], dim),
                                       generator=gen, device=device)
        pool = airfoil_rows(gen, mix["pool_rows"], data["d"], data["noise"],
                            data["condition"])
        self.pool = pool.cpu().numpy()
        self.rng = np.random.default_rng(seed)
        self.who, self.sizes = schedule(mix, self.tenants, self.rng)
        self.params = lsh.LSHParams(projections=self.projections)
        t1 = time.perf_counter()

        def make():
            return gw_mod.StormGateway(
                self.params, self.tenants, paired=True,
                query_slots=g["query_slots"], ingest_slots=self.slots,
                count_dtype=g["count_dtype"], device=device)

        # Warm-up on a gateway of the same shapes, thrown away: ingest-only,
        # ingest + query and query-only ticks at full slots.
        warm = make()
        dim_in = data["d"] + 1
        for k in range(6):
            for t in range(self.tenants):
                warm.submit(gw_mod.IngestRequest(
                    rid=k * self.tenants + t, tenant=t,
                    z=self.pool[:self.slots]))
                if k % 3 == 1:
                    warm.submit(gw_mod.QueryRequest(
                        rid=-1 - t, tenant=t,
                        thetas=np.ones((mix["query_points"], dim_in),
                                       np.float32)))
            warm.run_until_idle(pipelined=True, depth=mix["depth"])
        warm.submit(gw_mod.QueryRequest(
            rid=-100, tenant=0,
            thetas=np.ones((mix["query_points"], dim_in), np.float32)))
        warm.run_until_idle()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        del warm
        t2 = time.perf_counter()
        self.gw = make()
        self.setup_phases = {"data": t1 - t0, "warm-up": t2 - t1,
                             "gateway": time.perf_counter() - t2}

    def _thetas(self) -> np.ndarray:
        """One DFO step's points: a centre and antithetic pairs around it,
        each with the target coordinate -1 appended."""
        d = self.config["rows"]["d"]
        pairs = (self.mix["query_points"] - 1) // 2
        centre = self.rng.normal(size=d)
        u = self.rng.normal(size=(pairs, d))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        s = self.mix["query_sigma"]
        pts = np.concatenate([centre[None], centre + s * u, centre - s * u])
        return np.concatenate([pts, -np.ones((pts.shape[0], 1))],
                              axis=1).astype(np.float32)

    def window(self, seconds: float, spans) -> Window:
        gw_mod, gw, mix = self.gw_mod, self.gw, self.mix
        clients, keep = mix["clients"], mix["outstanding"]
        pool_n = self.pool.shape[0]
        cursor = [t * (pool_n // self.tenants) for t in range(self.tenants)]
        owner: Dict[int, int] = {}
        sent: Dict[int, float] = {}
        latency: List[float] = []
        ingests, queries = [], []      # the check's log
        answers: Dict[int, np.ndarray] = {}
        outstanding = [0] * clients
        rows_in_window = 0
        nxt = 0
        rid = 0
        ticks = 0
        inflight = collections.deque()
        closed = False

        def take(rep, now):
            nonlocal rows_in_window
            for done in rep.ingest_done:
                latency.append(now - sent.pop(done.rid))
                outstanding[owner.pop(done.rid)] -= 1
                if not closed:
                    rows_in_window += done.rows
            for res in rep.results:
                answers[res.rid] = res.losses

        t0 = time.perf_counter()
        t_end = t0 + seconds
        ticks0 = gw.ticks
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            with spans.span("submit"):
                for c in range(clients):
                    while outstanding[c] < keep:
                        k = nxt % len(self.sizes)
                        nxt += 1
                        t = c % self.tenants if self.who[k] < 0 else \
                            int(self.who[k])
                        size = int(self.sizes[k])
                        if cursor[t] + size > pool_n:
                            cursor[t] = 0
                        start = cursor[t]
                        cursor[t] += size
                        gw.submit(gw_mod.IngestRequest(
                            rid=rid, tenant=t,
                            z=self.pool[start:start + size]))
                        ingests.append((rid, t, start, size, ticks))
                        owner[rid], sent[rid] = c, now
                        outstanding[c] += 1
                        rid += 1
                if ticks % mix["query_every_ticks"] == 0:
                    for c in range(clients):
                        th = self._thetas()
                        gw.submit(gw_mod.QueryRequest(
                            rid=rid, tenant=c % self.tenants, thetas=th))
                        queries.append((rid, c % self.tenants, th, ticks))
                        rid += 1
            with spans.span("tick_start"):
                inflight.append(gw.tick_start())
            ticks += 1
            if len(inflight) >= mix["depth"]:
                with spans.span("tick_finish"):
                    rep = gw.tick_finish(inflight.popleft())
                take(rep, time.perf_counter())
        window_s = time.perf_counter() - t0
        closed = True
        ticks_in_window = gw.ticks - ticks0
        # The drain: every request sent in the window is waited for.
        while inflight:
            with spans.span("tick_finish"):
                rep = gw.tick_finish(inflight.popleft())
            take(rep, time.perf_counter())
        while gw.pending:
            rep = gw.tick()
            take(rep, time.perf_counter())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        g = self.config["gateway"]
        counters = {"ticks": ticks_in_window, "rows": rows_in_window,
                    "tenants": self.tenants, "ingest_slots": self.slots,
                    "inserted_rows": gw.rows_ingested,
                    "row_width": self.config["rows"]["d"] + 1,
                    "hash_rows": g["rows"], "planes": g["planes"]}
        attempted = len(ingests)
        failed = attempted - len(latency)
        lat = sorted(latency)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else None
        metrics = {"rows_per_s": rows_in_window / window_s,
                   "ingest_p95_ms": None if p95 is None else p95 * 1e3}
        bank = gw.bank
        log = {"ingests": ingests, "queries": queries, "answers": answers,
               "counts": bank.counts.clone(), "n": bank.n.clone()}
        return Window(metrics, attempted, failed, counters, log)

    # -- the check ----------------------------------------------------------

    def _served_prefix(self, ingests, ticks_needed):
        """Per tenant, rows packed by the end of each tick: the gateway's
        contract (FIFO per tenant, ``ingest_slots`` rows a tick, requests
        sent before a tick's start), worked out from the log."""
        by_tick = collections.defaultdict(list)
        for rid, t, start, size, tick in ingests:
            by_tick[tick].append((t, size))
        pending = [0] * self.tenants
        packed = [0] * self.tenants
        after = {}
        tick = 0
        last = max([i[4] for i in ingests] + [0])
        while tick <= max(last, max(ticks_needed, default=0)) or any(pending):
            for t, size in by_tick.get(tick, ()):
                pending[t] += size
            tick += 1  # the tick that starts now is tick number `tick`
            for t in range(self.tenants):
                take = min(self.slots, pending[t])
                pending[t] -= take
                packed[t] += take
            if tick in ticks_needed:
                after[tick] = list(packed)
        return after

    def _plan(self, log):
        """What the check compares, from the log alone: the sampled queries
        (drawn from the seed, the window's last among them), the rows each
        one's tenant had packed by the tick that served it, every pool
        row's multiplicity in each tenant's table and in each sampled
        query's prefix, and each tenant's row count."""
        rng = np.random.default_rng([self.seed, 1])
        qs = log["queries"]
        want = self.mix["check_queries"]
        pick = sorted(set(rng.choice(len(qs), size=min(want, len(qs)),
                                     replace=False).tolist())
                      | ({len(qs) - 1} if qs else set()))
        sample = [qs[i] for i in pick]
        prefix = self._served_prefix(log["ingests"],
                                     {q[3] + 1 for q in sample})
        pool_n = self.pool.shape[0]
        diff = np.zeros((self.tenants + len(sample), pool_n + 1), np.int64)
        # Final counters: every row sent. A query: its tenant's first rows,
        # as many as were packed by the tick that served it.
        seen = [0] * self.tenants
        qlimit = [prefix[q[3] + 1][q[1]] for q in sample]
        for rid, t, start, size, tick in log["ingests"]:
            diff[t, start] += 1
            diff[t, start + size] -= 1
            for j, q in enumerate(sample):
                if q[1] != t or seen[t] >= qlimit[j]:
                    continue
                part = min(size, qlimit[j] - seen[t])
                diff[self.tenants + j, start] += 1
                diff[self.tenants + j, start + part] -= 1
            seen[t] += size
        mult = np.cumsum(diff, axis=1)[:, :pool_n]
        return sample, qlimit, mult, mult[:self.tenants].sum(axis=1)

    def _reference(self, sample, qlimit, mult, dtype=torch.float32):
        """The reference's counters (tenants, then the sampled queries'
        prefixes) and the sampled queries' estimates, with the hash in
        ``dtype``."""
        w = storm_ref.kernel_layout(self.projections)
        z = torch.from_numpy(self.pool).to(self.device)
        counts = storm_ref.weighted_counts(
            z, w, torch.from_numpy(mult).to(self.device, torch.int32),
            dtype=dtype)
        est = [storm_ref.race_estimate(
            counts[self.tenants + j], qlimit[j],
            storm_ref.query_codes(torch.from_numpy(th).to(self.device), w,
                                  dtype))
            for j, (_, _, th, _) in enumerate(sample)]
        return counts, est

    def _free(self):
        """Let go of the program's state before the reference runs."""
        if hasattr(self, "gw"):
            del self.gw
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def lower(self, win: Window) -> None:
        """The control: the program's outputs in ``win.log`` (counters, row
        counts, the sampled queries' answers) replaced by the reference's
        with the hash in bf16, the next precision below the configuration's
        float32."""
        self._free()
        log = win.log
        sample, qlimit, mult, ref_n = self._plan(log)
        counts, est = self._reference(sample, qlimit, mult, torch.bfloat16)
        log["counts"] = counts[:self.tenants]
        log["n"] = torch.from_numpy(ref_n)
        log["answers"] = dict(log["answers"])
        for (rid, *_), e in zip(sample, est):
            log["answers"][rid] = e.cpu().numpy()

    def judge(self, win: Window) -> list:
        """The numbers compared, each with its limit: counter cells (and
        row counts) off, and query points off, both exact."""
        self._free()
        log = win.log
        sample, qlimit, mult, ref_n = self._plan(log)
        ref, est = self._reference(sample, qlimit, mult)
        counts, n = log["counts"], log["n"]
        cells_off = int((counts.to(ref.device, torch.int64)
                         != ref[:self.tenants]).sum().item())
        cells_off += int((n.cpu().numpy().astype(np.int64) != ref_n).sum())
        points_off = 0
        for (rid, *_), want_est in zip(sample, est):
            got_est = torch.from_numpy(log["answers"][rid]).to(self.device)
            points_off += int((got_est != want_est).sum().item())
        return [("counter_cells_off", cells_off, 0),
                ("query_points_off", points_off, 0)]
