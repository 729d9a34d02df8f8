"""Tiered serving gateway: hot/cold tenant store around the fused tick (port
of ``repro.serve.tiered_gateway``).

:class:`TieredStormGateway` serves ``num_tenants`` GLOBAL tenants through a
:class:`~repro_torch.serve.storm_gateway.StormGateway` whose bank holds only
``hot_capacity`` resident slots. The inner gateway packs each tick against
the resident bank; this layer owns the tenant <-> slot indirection and a
:class:`~repro_torch.core.tiered.TieredBank` for everyone else:

* **Resident traffic** forwards at once, remapped ``tenant -> slot``;
  completions are rewritten back to global ids through the rid table.
* **Cold traffic** parks in a FIFO side queue and asks for a promotion.
  Promotions are scheduled in ``tick_start``, AFTER the tick's body was
  launched: the slot swap runs behind it on the same stream, the host
  waits for nothing, the evicted table lands in pinned host memory and is
  flushed in that tick's ``tick_finish`` (the loop's one sync point), and
  the promoted tenant's queued requests pack into the very next tick.
* **Victim policy** is pluggable (``score_fn``; default LRU by tick), and a
  tenant with queued, unpacked traffic in the inner gateway is never
  evicted.
* **Fit requests** address global tenants and read each tenant where it
  lives (hot slot, or an exact upload of its cold table), so a cohort can
  mix residencies without promoting anyone. Their counters are gathered on
  the device at the end of ``tick_start`` and the fits run in
  ``tick_finish``.

``trace_count`` is the inner gateway's three tick bodies plus the bank's
one swap body: <= 4 for the gateway's life under any hot/cold mix, <= 5
with a finite :class:`~repro_torch.core.privacy.ReleasePolicy` (the inner
gateway's private query body). Privacy is scoped by GLOBAL tenant: one
shared view keyed by global tenant backs the inner gateway, so budgets,
release windows and refusals follow tenants across promote/demote; a
demoted tenant's stale lane is dropped, and a private fit reads a cold
tenant's exact host copy plus noise. With ``hot_capacity >= num_tenants``
no swap ever runs and every tick equals the flat gateway's; with
evictions, a tenant's sketch after any promote/demote history equals its
always-resident counterpart bit for bit. With ``mesh=`` the resident slots
split over the mesh as the inner gateway's tenants do, and a promotion or
demotion reads and writes the shard that holds its slot.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import losses, lsh
from repro_torch.core import privacy as privacy_lib
from repro_torch.core import sketch as sketch_lib
from repro_torch.core.tiered import TieredBank
from repro_torch.device import DeviceLike
from repro_torch.sharding.mesh import Mesh, home_device
from repro_torch.serve.storm_gateway import (
    Backpressure,
    FitRequest,
    IngestRequest,
    InflightTick,
    QueryRequest,
    QueryResult,
    StormGateway,
    TickReport,
    drain,
)


class TieredStormGateway:
    """Fixed-tick gateway over a tiered (hot/cold) tenant store."""

    def __init__(
        self,
        params: lsh.LSHParams,
        num_tenants: int,
        hot_capacity: int,
        *,
        paired: bool = True,
        query_slots: int = 32,
        ingest_slots: int = 128,
        count_dtype=torch.int16,
        mode: str = "auto",
        mesh: Optional[Mesh] = None,
        axis: str = "bank",
        max_pending_rows: Optional[int] = None,
        max_pending_points: Optional[int] = None,
        promote_per_tick: int = 2,
        score_fn=None,
        privacy: Optional[privacy_lib.ReleasePolicy] = None,
        privacy_seed: int = 0,
        device: DeviceLike = None,
    ):
        """Args mirror :class:`StormGateway` plus the tier knobs:

          num_tenants: global tenant count T (requests address these ids).
          hot_capacity: resident slots H: the inner gateway's bank size and
            the only device-side counter footprint.
          count_dtype: resident counter dtype (int16/int8 shrink the bank).
          promote_per_tick: most cold tenants promoted per tick (one swap
            each).
          score_fn: eviction priority (``tiered.TenantStats -> comparable``;
            lowest evicts first); ``None`` keeps LRU by tick.
          privacy: optional :class:`~repro_torch.core.privacy.ReleasePolicy`;
            the budget is per GLOBAL tenant (one shared view).
          privacy_seed: seed of the release noise stream.
          mesh / axis: optional device mesh splitting the resident slots
            (the inner gateway's tenants) over ``axis``; ``hot_capacity``
            must be a multiple of the shard count.
        """
        if num_tenants < 1:
            raise ValueError(f"need at least one tenant; got {num_tenants}")
        dev = home_device(mesh, device)
        self.num_tenants = num_tenants
        self.tiers = TieredBank(
            num_tenants=num_tenants, hot_capacity=hot_capacity,
            rows=params.rows, buckets=params.buckets, dtype=count_dtype,
            score_fn=score_fn, device=dev,
        )
        self.privacy = privacy
        self._private = privacy is not None and not privacy.noiseless
        self.private_view = (privacy_lib.PrivateBankView(
            privacy, seed=privacy_seed) if self._private else None)
        counts, n = self.tiers.init_resident()
        self.gw = StormGateway(
            params, self.tiers.hot_capacity, paired=paired,
            query_slots=query_slots, ingest_slots=ingest_slots, mode=mode,
            bank=sketch_lib.SketchBank(counts=counts, n=n),
            # Caps are enforced HERE, per global tenant: the inner queues
            # only hold traffic this layer already admitted.
            max_pending_rows=None, max_pending_points=None,
            privacy=privacy, privacy_seed=privacy_seed,
            private_view=self.private_view, privacy_key_of=self._slot_key,
            mesh=mesh, axis=axis, device=dev,
        )
        self.max_pending_rows = max_pending_rows
        self.max_pending_points = max_pending_points
        self.promote_per_tick = promote_per_tick
        self._cold_q: Deque[Union[IngestRequest, QueryRequest]] = deque()
        self._fit_q: Deque[FitRequest] = deque()
        self._cold_rows = [0] * num_tenants
        self._cold_points = [0] * num_tenants
        self._rid_tenant: Dict[int, int] = {}
        self._gathered: Dict[int, list] = {}  # tick -> (req, sub-bank)
        self.fits_run = 0
        self.promotions = 0
        self.demotions = 0
        self.deferred_promotions = 0

    # -- tenant-space accounting --------------------------------------------

    def _slot_key(self, slot: int) -> int:
        """Ledger key of a resident slot: its GLOBAL tenant (a free slot,
        which carries no traffic, maps to a negative key no tenant has)."""
        tenant = self.tiers.slot_tenant[slot]
        return tenant if tenant is not None else -1 - slot

    def _inner_pending(self, tenant: int) -> tuple:
        """(rows, points) queued but unpacked in the inner gateway."""
        slot = self.tiers.slot_of.get(tenant)
        if slot is None:
            return 0, 0
        return self.gw._pending_rows[slot], self.gw._pending_points[slot]

    def _check_cap(self, tenant: int, kind: str, requested: int) -> None:
        rows, points = self._inner_pending(tenant)
        if kind == "ingest":
            pending = self._cold_rows[tenant] + rows
            limit = self.max_pending_rows
        else:
            pending = self._cold_points[tenant] + points
            limit = self.max_pending_points
        if limit is not None and pending + requested > limit:
            raise Backpressure(tenant, kind, pending, requested, limit)

    # -- request plumbing ---------------------------------------------------

    def submit(self, req: Union[IngestRequest, QueryRequest, FitRequest]
               ) -> None:
        if isinstance(req, FitRequest):
            cohort = [int(t) for t in req.tenants]
            if not cohort:
                raise ValueError("fit cohort is empty")
            for t in cohort:
                if not 0 <= t < self.num_tenants:
                    raise ValueError(f"fit tenant {t} out of range "
                                     f"[0, {self.num_tenants})")
            spec = losses.get_surrogate(req.surrogate)
            if spec.paired != self.gw.paired:
                raise ValueError(
                    f"surrogate '{spec.name}' insert flavor does not match "
                    f"this gateway (paired={self.gw.paired})")
            self._fit_q.append(dataclasses.replace(req, tenants=cohort))
            return
        if not isinstance(req, (IngestRequest, QueryRequest)):
            raise TypeError(f"unknown request type {type(req).__name__}")
        if not 0 <= req.tenant < self.num_tenants:
            raise ValueError(f"tenant {req.tenant} out of range "
                             f"[0, {self.num_tenants})")
        if isinstance(req, IngestRequest):
            size, kind = np.asarray(req.z).shape[0], "ingest"
        else:
            size, kind = np.asarray(req.thetas).shape[0], "query"
        self._check_cap(req.tenant, kind, size)
        slot = self.tiers.slot_of.get(req.tenant)
        if slot is not None:
            self._forward(req, slot)
            self.tiers.touch(req.tenant, self.gw.ticks)
        else:
            self._cold_q.append(req)
            if kind == "ingest":
                self._cold_rows[req.tenant] += size
            else:
                self._cold_points[req.tenant] += size

    def _forward(self, req, slot: int) -> None:
        """Hand a request to the inner gateway in slot space, remembering
        its GLOBAL tenant for the finish-time reports."""
        self._rid_tenant[req.rid] = req.tenant
        self.gw.submit(dataclasses.replace(req, tenant=slot))

    def submit_many(self, reqs: Sequence[Union[IngestRequest, QueryRequest,
                                               FitRequest]]) -> None:
        for r in reqs:
            self.submit(r)

    @property
    def pending(self) -> int:
        return self.gw.pending + len(self._cold_q) + len(self._fit_q)

    @property
    def ticks(self) -> int:
        return self.gw.ticks

    # Delegations so callers treat both gateways alike.
    @property
    def tenants(self) -> int:
        return self.num_tenants

    @property
    def params(self):
        return self.gw.params

    @property
    def paired(self) -> bool:
        return self.gw.paired

    @property
    def rows_ingested(self) -> int:
        return self.gw.rows_ingested

    @property
    def points_served(self) -> int:
        return self.gw.points_served

    @property
    def ingest_slots(self) -> int:
        return self.gw.ingest_slots

    @property
    def query_slots(self) -> int:
        return self.gw.query_slots

    @property
    def trace_count(self) -> int:
        """Tick bodies + the swap body: <= 4 for the gateway's life (<= 5
        with a finite privacy policy)."""
        return self.gw.trace_count + self.tiers.trace_count

    # -- promotion scheduling -----------------------------------------------

    def _protected(self) -> set:
        """Tenants whose slots must survive this round of eviction."""
        return {tenant for tenant, slot in self.tiers.slot_of.items()
                if (self.gw._pending_rows[slot] > 0
                    or self.gw._pending_points[slot] > 0)}

    def _schedule_promotions(self, tick: int) -> None:
        """Promote up to ``promote_per_tick`` cold tenants with traffic.

        Runs right after the tick's body was launched: each swap follows it
        on the stream, the residency map advances now, and the promoted
        tenant's parked requests move to the inner queues, packed by the
        NEXT ``tick_start``.
        """
        if not self._cold_q:
            return
        wanted: List[int] = []
        for req in self._cold_q:
            if req.tenant not in wanted and len(wanted) < self.promote_per_tick:
                wanted.append(req.tenant)
        promoted = set()
        for tenant in wanted:
            protect = self._protected() | promoted
            if self.tiers.victim(protect) is None and \
                    self.tiers._free_slot() is None:
                # Every slot is protected: defer, never stall the tick.
                self.deferred_promotions += 1
                continue
            _, _, victim = self.tiers.promote(
                tenant, *self.gw.bank_blocks(), tick=tick, protect=protect)
            self.promotions += 1
            if victim is not None:
                self.demotions += 1
                if self._private:
                    # The victim's lane is about to be reused: its stale
                    # release is gone; its window survives.
                    self.private_view.drop_resident(victim)
            promoted.add(tenant)
        if not promoted:
            return
        remaining: Deque[Union[IngestRequest, QueryRequest]] = deque()
        for req in self._cold_q:
            if req.tenant in promoted:
                if isinstance(req, IngestRequest):
                    self._cold_rows[req.tenant] -= np.asarray(req.z).shape[0]
                else:
                    self._cold_points[req.tenant] -= np.asarray(
                        req.thetas).shape[0]
                self._forward(req, self.tiers.slot_of[req.tenant])
            else:
                remaining.append(req)
        self._cold_q = remaining

    # -- the tick -----------------------------------------------------------

    def tick_start(self) -> InflightTick:
        """Pack resident traffic, launch the tick, then the promotions.

        The inner pack and launch go first, so the swaps run behind the
        tick's body on the stream: the tick reads the slots it packed
        against. LRU clocks advance for every tenant the tick packs.
        """
        for tenant, slot in list(self.tiers.slot_of.items()):
            if (self.gw._pending_rows[slot] > 0
                    or self.gw._pending_points[slot] > 0):
                self.tiers.touch(tenant, self.gw.ticks + 1)
        inflight = self.gw.tick_start()
        self._schedule_promotions(inflight.tick)
        self._gathered[inflight.tick] = self._gather_fits()
        return inflight

    def _gather_fits(self) -> list:
        """Take the fit queue: each request with its cohort's counters, read
        where each tenant lives (no host wait), and its status. Under
        privacy the members' releases, planned on the shared view by global
        tenant: a fresh one reads the tenant's table wherever it lives
        (hot slot or exact cold copy), a stale one its lane (a stale plan
        implies residency: lanes drop on demotion)."""
        out = []
        gw = self.gw
        blocks = gw.bank_blocks()
        while self._fit_q:
            req = self._fit_q.popleft()
            table = lambda j, req=req: self.tiers.device_table(  # noqa: E731
                req.tenants[j], *blocks)[0]
            if self._private:
                out.append(gw._gather_private(
                    req, list(req.tenants), table,
                    lambda j, req=req: gw._release[
                        self.tiers.slot_of[req.tenants[j]]]))
                continue
            tables = [self.tiers.device_table(t, *blocks)
                      for t in req.tenants]
            out.append((req, sketch_lib.SketchBank(
                counts=torch.stack([c for c, _ in tables]).to(torch.int32),
                n=torch.stack([n for _, n in tables])), "ok"))
        return out

    def tick_finish(self, inflight: InflightTick) -> TickReport:
        """Inner finish, reports rewritten to global ids, this tick's
        evictions landed; the tick's fits run last."""
        rep = self.gw.tick_finish(inflight)
        for res in rep.results:
            res.tenant = self._rid_tenant.pop(res.rid, res.tenant)
        for done in rep.ingest_done:
            done.tenant = self._rid_tenant.pop(done.rid, done.tenant)
        self.tiers.flush_evictions(through_tick=inflight.tick)
        fits = self.gw._fit_results(self._gathered.pop(inflight.tick, []))
        rep.fits.extend(fits)
        self.fits_run += len(fits)
        return rep

    def tick(self) -> TickReport:
        return self.tick_finish(self.tick_start())

    def run_until_idle(self, max_ticks: int = 10_000, *,
                       pipelined: bool = False,
                       depth: int = 2) -> List[QueryResult]:
        """Tick until idle (cold tenants promote as ticks pass); all results.

        The same drain loop as :meth:`StormGateway.run_until_idle`;
        ``pending`` includes the cold side queue.
        """
        return drain(self, max_ticks, pipelined, depth)

    # -- reads --------------------------------------------------------------

    def sketch_of(self, tenant: int) -> sketch_lib.Sketch:
        """Tenant's sketch wherever it lives (host copy when cold)."""
        return self.tiers.sketch_of(tenant, *self.gw.bank_blocks())

    @property
    def resident_bank(self) -> sketch_lib.SketchBank:
        """The device-resident hot bank (slot-major, NOT tenant-major; on a
        mesh a gathered copy, as ``StormGateway.bank``)."""
        return self.gw.bank

    def rollup(self, assignment, num_groups: Optional[int] = None
               ) -> sketch_lib.SketchBank:
        """Cohort roll-up over ALL tenants without promoting anyone."""
        return self.tiers.rollup(assignment, *self.gw.bank_blocks(),
                                 num_groups=num_groups)

    def queue_stats(self) -> dict:
        """Gateway state in GLOBAL tenant space, plus tier occupancy."""
        inner = self.gw.queue_stats()
        t = self.num_tenants
        depth = [0] * t
        rows = [0] * t
        points = [0] * t
        for slot, tenant in enumerate(self.tiers.slot_tenant):
            if tenant is None:
                continue
            depth[tenant] += inner["pending_depth"][slot]
            rows[tenant] += inner["pending_rows"][slot]
            points[tenant] += inner["pending_points"][slot]
        for req in self._cold_q:
            depth[req.tenant] += 1
        for tenant in range(t):
            rows[tenant] += self._cold_rows[tenant]
            points[tenant] += self._cold_points[tenant]
        tier = self.tiers.stats()
        tier.update(promotions=self.promotions, demotions=self.demotions,
                    deferred_promotions=self.deferred_promotions,
                    cold_queued=len(self._cold_q))
        stats = {
            "tenants": t,
            "ticks": self.gw.ticks,
            "pending_requests": self.pending,
            "pending_depth": depth,
            "pending_rows": rows,
            "pending_points": points,
            "pending_fits": len(self._fit_q),
            "rows_ingested": self.gw.rows_ingested,
            "points_served": self.gw.points_served,
            "fits_run": self.fits_run,
            "trace_count": self.trace_count,
            "tier": tier,
        }
        if self._private:
            stats["privacy"] = self.gw.privacy_stats()
        return stats
