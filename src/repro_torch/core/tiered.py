"""Two-tier tenant store: hot resident SketchBank + cold host spill (port of
``repro.core.tiered``).

:class:`TieredBank` caps the device footprint at ``hot_capacity`` narrow
slots and spills every other tenant to host memory, with an explicit
promote/demote API that the serving gateway overlaps with its tick.

Residency contract:
  - Tenant ids are global ``[0, num_tenants)``; slots are device indices
    ``[0, hot_capacity)``. ``slot_of`` is the host-side source of truth and
    changes at dispatch time; the device catches up in stream order, so the
    next tick reads the new table.
  - The device tensors are OWNED BY THE CALLER (the gateway). Every mutating
    method takes the current ``(counts, n)`` pair, updates it IN PLACE (one
    slot read and overwrite) and returns it, so callers written for the
    reference's functional API work unchanged. A gateway on a mesh passes
    its per-shard blocks instead (lists of tensors in slot order, each on
    its shard's device): a swap then reads and writes the shard that holds
    the slot, and reads of a tenant land on the first block's device.
  - The swap is one body over fixed shapes: ``trace_count`` counts its
    distinct (shape, dtype) signatures and stays at 1 for a bank's life.
  - On the card an evicted table goes device->host with
    ``non_blocking=True`` into pinned memory, with an event behind the copy;
    :meth:`flush_evictions` waits on those events, and the gateway calls it
    only in ``tick_finish``, for the evictions queued up to that tick (not
    those that a pipelined next tick queued behind its own body). A tenant
    promoted again before its eviction has been flushed is uploaded from
    that same pinned buffer, on the same stream, so the upload runs after
    the eviction has landed and the host waits for nothing. Cold tables are pinned too, so every promotion is an
    asynchronous upload.

Counters cross between the tiers bit for bit: a swap copies a slot out and
writes another table in, and cold tables are exact host copies; a tenant
that bounces hot -> cold -> hot holds exactly the sketch it would have held
had it stayed resident.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import torch

from repro_torch.core.sketch import (
    Sketch, SketchBank, _narrow_back, _widen, counter_dtype,
)
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Blocks = Union[Tensor, Sequence[Tensor]]


def _slot(counts: Blocks, n: Blocks, slot: int) -> Tuple[Tensor, Tensor]:
    """Views of resident slot ``slot`` in the bank or in its per-shard
    blocks (equal contiguous blocks in slot order)."""
    if isinstance(counts, Tensor):
        return counts[slot], n[slot]
    shard, i = divmod(slot, counts[0].shape[0])
    return counts[shard][i], n[shard][i]


def _home(counts: Blocks) -> torch.device:
    """Where reads of a tenant land: the bank's (first block's) device."""
    return (counts if isinstance(counts, Tensor) else counts[0]).device


def _after(event, device: torch.device) -> None:
    """Order ``device``'s stream behind ``event`` (an eviction's copy, which
    may have run on another device's stream), without a host wait."""
    if event is not None:
        torch.cuda.current_stream(device).wait_event(event)


class TenantStats(NamedTuple):
    """Per-resident activity record handed to an eviction ``score_fn``.

    ``last_touch`` is the newest tick that packed this tenant's traffic (or
    promoted it); ``touches`` counts the touches of its current residency.
    Both reset when the slot changes hands.
    """

    tenant: int
    slot: int
    last_touch: int
    touches: int


def lru_score(stats: TenantStats) -> int:
    """Default eviction priority: least-recently-touched goes first."""
    return stats.last_touch


def frequency_score(stats: TenantStats) -> Tuple[int, int]:
    """Evict the least-touched resident, breaking ties by recency."""
    return (stats.touches, stats.last_touch)


class TieredBank:
    """Policy + spill store for a fixed-capacity resident tenant bank.

    Args:
      num_tenants: global tenant count ``T``.
      hot_capacity: resident slots ``H`` (``H >= T``: every tenant stays
        resident and the tier is a no-op wrapper).
      rows / buckets: sketch shape ``(R, B)``.
      dtype: resident counter dtype (the cold store mirrors it).
      score_fn: eviction priority ``TenantStats -> comparable``; the
        unprotected resident with the LOWEST score goes (ties to the lowest
        slot). ``None`` means :func:`lru_score`.
      device: where the resident bank lives (``None``: the card).

    Initial residency is the identity prefix: tenants ``0..H-1`` occupy
    slots ``0..H-1``; the rest start cold with all-zero tables.
    """

    def __init__(self, num_tenants: int, hot_capacity: int, rows: int,
                 buckets: int, dtype=torch.int16,
                 score_fn: Optional[Callable[[TenantStats], object]] = None,
                 device: DeviceLike = None):
        if hot_capacity < 1:
            raise ValueError(f"hot_capacity must be >= 1, got {hot_capacity}")
        if num_tenants < 1:
            raise ValueError(f"num_tenants must be >= 1, got {num_tenants}")
        self.device = resolve_device(device)
        self.num_tenants = num_tenants
        self.hot_capacity = min(hot_capacity, num_tenants)
        self.rows = rows
        self.buckets = buckets
        self.dtype = counter_dtype(dtype)
        self.slot_tenant: List[Optional[int]] = list(range(self.hot_capacity))
        self.slot_of: Dict[int, int] = {
            t: s for s, t in enumerate(self.slot_tenant)}
        self._last_touch: List[int] = [0] * self.hot_capacity
        self._touches: List[int] = [0] * self.hot_capacity
        self.score_fn: Callable[[TenantStats], object] = score_fn or lru_score
        # Cold tier: tenant -> (counts (R, B), n ()) host tensors, pinned on
        # the card. Absent means all-zero (never demoted with content).
        self._cold: Dict[int, Tuple[Tensor, Tensor]] = {}
        # Evictions in flight: tenant -> (counts, n, event behind the copy,
        # tick that queued it; None for a demotion outside the tick loop).
        self._pending: Dict[int, Tuple[Tensor, Tensor, object,
                                       Optional[int]]] = {}
        self._cold_rollup_cache: Optional[tuple] = None
        self.swap_count = 0
        self._signatures: set = set()

    @property
    def trace_count(self) -> int:
        """Distinct swap signatures run: stays <= 1 for the bank's life."""
        return len(self._signatures)

    # -- construction ------------------------------------------------------

    def init_resident(self) -> Tuple[Tensor, Tensor]:
        """Zeroed device tensors for the resident bank: ``(H, R, B)``, ``(H,)``."""
        return (
            torch.zeros((self.hot_capacity, self.rows, self.buckets),
                        dtype=self.dtype, device=self.device),
            torch.zeros((self.hot_capacity,), dtype=torch.int32,
                        device=self.device),
        )

    def _host(self, shape, dtype) -> Tensor:
        """A host buffer, pinned when the bank lives on the card."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def load_cold(self, tenant: int, counts: Tensor, n: int) -> None:
        """Park ``tenant``'s table in the cold store (a host copy)."""
        if tenant in self.slot_of:
            raise ValueError(f"tenant {tenant} is resident")
        c = self._host((self.rows, self.buckets), self.dtype)
        c.copy_(counts)
        cn = self._host((), torch.int32)
        cn.fill_(int(n))
        self._pending.pop(tenant, None)
        self._cold[tenant] = (c, cn)
        self._cold_rollup_cache = None

    # -- residency queries -------------------------------------------------

    def is_resident(self, tenant: int) -> bool:
        return tenant in self.slot_of

    def resident_tenants(self) -> List[int]:
        return [t for t in self.slot_tenant if t is not None]

    def touch(self, tenant: int, tick: int) -> None:
        """Record packed traffic for the eviction policy (residents only)."""
        slot = self.slot_of.get(tenant)
        if slot is not None:
            self._last_touch[slot] = max(self._last_touch[slot], tick)
            self._touches[slot] += 1

    def tenant_stats(self, tenant: int) -> Optional[TenantStats]:
        """The activity record a ``score_fn`` would see (None if cold)."""
        slot = self.slot_of.get(tenant)
        if slot is None:
            return None
        return TenantStats(tenant=tenant, slot=slot,
                           last_touch=self._last_touch[slot],
                           touches=self._touches[slot])

    def victim(self, protect: Iterable[int] = ()) -> Optional[int]:
        """The tenant to evict next (lowest score; ties to the lowest slot);
        ``None`` if every occupied slot is protected."""
        protected = set(protect)
        best_slot = None
        best_score = None
        for slot, tenant in enumerate(self.slot_tenant):
            if tenant is None or tenant in protected:
                continue
            score = self.score_fn(TenantStats(
                tenant=tenant, slot=slot,
                last_touch=self._last_touch[slot],
                touches=self._touches[slot]))
            if best_slot is None or score < best_score:
                best_slot, best_score = slot, score
        return None if best_slot is None else self.slot_tenant[best_slot]

    def lru_victim(self, protect: Iterable[int] = ()) -> Optional[int]:
        """Legacy name for :meth:`victim`."""
        return self.victim(protect)

    def _free_slot(self) -> Optional[int]:
        for slot, tenant in enumerate(self.slot_tenant):
            if tenant is None:
                return slot
        return None

    # -- the swap ----------------------------------------------------------

    def _swap(self, counts: Blocks, n: Blocks, slot: int,
              incoming: Optional[tuple]):
        """The one promote/demote body: copy slot ``slot`` out to the host,
        then overwrite it with ``incoming`` (host tensors and the event
        behind their eviction, or None) or zeros.

        Returns the evicted ``(counts, n, event)``; the copies are
        asynchronous on the card and the event marks their end.
        """
        c, m = _slot(counts, n, slot)
        self._signatures.add((tuple(c.shape), c.dtype))
        out_c = self._host((self.rows, self.buckets), c.dtype)
        out_n = self._host((), torch.int32)
        out_c.copy_(c, non_blocking=True)
        out_n.copy_(m, non_blocking=True)
        if incoming is None:
            c.zero_()
            m.zero_()
        else:
            _after(incoming[2], c.device)
            c.copy_(incoming[0], non_blocking=True)
            m.copy_(incoming[1], non_blocking=True)
        event = None
        if c.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(c.device))
        self.swap_count += 1
        return out_c, out_n, event

    def _incoming(self, tenant: int) -> Optional[tuple]:
        """``tenant``'s host table for an upload with the event its upload
        must follow, or None (all zero).

        A pending eviction is uploaded from its own buffer, behind the event
        of its copy out of the old slot (on the same stream, or another
        shard's).
        """
        entry = self._pending.pop(tenant, None)
        if entry is not None:
            return entry[0], entry[1], entry[2]
        cold = self._cold.pop(tenant, None)
        return None if cold is None else (*cold, None)

    def promote(self, tenant: int, counts: Blocks, n: Blocks, *, tick: int,
                protect: Iterable[int] = ()
                ) -> Tuple[Blocks, Blocks, Optional[int]]:
        """Swap ``tenant`` into the resident bank, evicting a victim.

        Updates ``counts``/``n`` in place without waiting for the device and
        moves the residency map now, so the caller can pack the promoted
        tenant into the next tick. The victim's table lands on the host
        asynchronously (:meth:`flush_evictions`).

        Returns ``(counts, n, victim_tenant)``; victim is ``None`` when a
        free slot took the promotion (or the tenant was already resident).
        Raises ``RuntimeError`` when every slot is protected.
        """
        if tenant in self.slot_of:
            self.touch(tenant, tick)
            return counts, n, None
        slot = self._free_slot()
        victim = None
        if slot is None:
            victim = self.victim(protect)
            if victim is None:
                raise RuntimeError(
                    "promote: all resident slots are protected this tick")
            slot = self.slot_of[victim]
        out = self._swap(counts, n, slot, self._incoming(tenant))
        if victim is not None:
            del self.slot_of[victim]
            self._pending[victim] = (*out, tick)
        self.slot_of[tenant] = slot
        self.slot_tenant[slot] = tenant
        self._last_touch[slot] = tick
        self._touches[slot] = 1  # promotion itself is the first touch
        self._cold_rollup_cache = None
        return counts, n, victim

    def demote(self, tenant: int, counts: Blocks, n: Blocks
               ) -> Tuple[Blocks, Blocks]:
        """Spill a resident tenant, leaving its slot free and zeroed."""
        slot = self.slot_of.get(tenant)
        if slot is None:
            return counts, n
        self._pending[tenant] = (*self._swap(counts, n, slot, None), None)
        del self.slot_of[tenant]
        self.slot_tenant[slot] = None
        self._touches[slot] = 0
        self._cold_rollup_cache = None
        return counts, n

    def flush_evictions(self, through_tick: Optional[int] = None) -> int:
        """Land in-flight evictions on the host. Returns how many.

        ``through_tick`` lands only those queued by a promotion at that tick
        or earlier (and every demotion), so finishing tick ``t`` does not
        wait for the swaps queued behind tick ``t + 1``; ``None`` lands all.
        """
        landed = [t for t, entry in self._pending.items()
                  if through_tick is None or entry[3] is None
                  or entry[3] <= through_tick]
        for tenant in landed:
            c, cn, event, _ = self._pending.pop(tenant)
            if event is not None:
                event.synchronize()
            self._cold[tenant] = (c, cn)
        if landed:
            self._cold_rollup_cache = None
        return len(landed)

    # -- reads -------------------------------------------------------------

    def device_table(self, tenant: int, counts: Blocks, n: Blocks
                     ) -> Tuple[Tensor, Tensor]:
        """A copy of ``tenant``'s ``(counts, n)`` on the bank's device (the
        first block's), wherever the tenant lives, without waiting for the
        host: a cold table uploads from its host buffer on the stream,
        behind any eviction still copying into it."""
        home = _home(counts)
        slot = self.slot_of.get(tenant)
        if slot is not None:
            c, m = _slot(counts, n, slot)
            return c.to(home, copy=True), m.to(home, copy=True)
        pending = self._pending.get(tenant)
        entry = pending or self._cold.get(tenant)
        if entry is None:
            return (torch.zeros((self.rows, self.buckets), dtype=self.dtype,
                                device=home),
                    torch.zeros((), dtype=torch.int32, device=home))
        if pending is not None:
            _after(pending[2], home)
        return (entry[0].to(home, non_blocking=True),
                entry[1].to(home, non_blocking=True))

    def sketch_of(self, tenant: int, counts: Blocks, n: Blocks) -> Sketch:
        """A copy of the tenant's current sketch, wherever it lives."""
        return Sketch(*self.device_table(tenant, counts, n))

    def rollup(self, assignment, counts: Blocks, n: Blocks,
               num_groups: Optional[int] = None) -> SketchBank:
        """Cohort roll-up over ALL tenants without faulting a cold table.

        Resident slots fold on the device (:meth:`SketchBank.merge_groups`),
        cold tables on the host (cached until the cold set changes); the
        halves add in int32 and saturate back to the bank's dtype.

        Args:
          assignment: ``(num_tenants,)`` int group ids.
          num_groups: output size; defaults to ``max(assignment) + 1``.
        """
        assignment = torch.as_tensor(assignment, dtype=torch.int64,
                                     device="cpu")
        if tuple(assignment.shape) != (self.num_tenants,):
            raise ValueError(
                f"assignment must be ({self.num_tenants},); "
                f"got {tuple(assignment.shape)}")
        groups = (int(assignment.max()) + 1 if num_groups is None
                  else num_groups)
        # Free slots route to a scratch group past the real ones.
        slot_assign = [groups if t is None else int(assignment[t])
                       for t in self.slot_tenant]
        home = _home(counts)
        blocks = ([counts], [n]) if isinstance(counts, Tensor) else (counts, n)
        wide = torch.zeros((groups, self.rows, self.buckets),
                           dtype=torch.int32, device=home)
        total_n = torch.zeros((groups,), dtype=torch.int32, device=home)
        lo = 0
        for c, m in zip(*blocks):  # each block folds where it lives
            hot = SketchBank(counts=c, n=m).merge_groups(
                slot_assign[lo:lo + c.shape[0]], num_groups=groups + 1)
            wide += _widen(hot.counts[:groups]).to(home)
            total_n += hot.n[:groups].to(home)
            lo += c.shape[0]
        self.flush_evictions()
        cold_c, cold_n = self._cold_rollup(assignment, groups)
        return SketchBank(counts=_narrow_back(wide + cold_c.to(home),
                                              self.dtype),
                          n=total_n + cold_n.to(home))

    def _cold_rollup(self, assignment: Tensor, groups: int
                     ) -> Tuple[Tensor, Tensor]:
        key = (tuple(assignment.tolist()), groups)
        if (self._cold_rollup_cache is not None
                and self._cold_rollup_cache[0] == key):
            return self._cold_rollup_cache[1]
        acc = torch.zeros((groups, self.rows, self.buckets), dtype=torch.int32)
        acc_n = torch.zeros((groups,), dtype=torch.int32)
        for tenant, (c, cn) in self._cold.items():
            g = int(assignment[tenant])
            acc[g] += c.to(torch.int32)
            acc_n[g] += int(cn)
        self._cold_rollup_cache = (key, (acc, acc_n))
        return acc, acc_n

    # -- accounting --------------------------------------------------------

    def resident_bytes(self) -> int:
        """Device bytes held by the hot tier (counters + per-slot n)."""
        return (self.hot_capacity * self.rows * self.buckets
                * self.dtype.itemsize + 4 * self.hot_capacity)

    def cold_bytes(self) -> int:
        """Host bytes actually materialized by spilled tables."""
        return sum(c.numel() * c.dtype.itemsize + 4
                   for c, _ in self._cold.values())

    def stats(self) -> dict:
        return {
            "hot_capacity": self.hot_capacity,
            "num_tenants": self.num_tenants,
            "resident": len(self.slot_of),
            "cold_materialized": len(self._cold),
            "pending_evictions": len(self._pending),
            "swap_count": self.swap_count,
            "resident_bytes": self.resident_bytes(),
            "cold_bytes": self.cold_bytes(),
        }
