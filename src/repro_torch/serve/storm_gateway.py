"""STORM serving gateway: one fused banked insert and one fused banked query
per tick (port of ``repro.serve.storm_gateway``).

The serving unit is a :class:`~repro_torch.core.sketch.SketchBank`: S
tenants' counter tables behind one endpoint under one hash family. The
gateway micro-batches three request classes over fixed engine ticks:

* **ingest**: ``(tenant, z-rows)`` appended to that tenant's counters. All
  pending rows coalesce into ONE banked insert per tick
  (``ops.paired_hash_histogram_banked``, or the single-sided
  ``ops.hash_histogram_banked``, over a mask-padded ``(S, I, dim)`` stack).
* **query**: the sketch loss of a theta batch against a tenant's sketch.
  All pending points coalesce into ONE banked
  ``ops.query_theta_with_weights(bank, ..., sketch_idx)`` call.
* **fit**: one ``erm.fit_many`` over a tenant cohort's served counters,
  run in ``tick_finish``. The cohort's counters are gathered on the device
  in ``tick_start``, right behind the tick's ingest, so a fit reads the
  counters of the tick it rides on at any pipeline depth.

Per-tenant slot capacities (``ingest_slots`` rows, ``query_slots`` points)
fix every buffer shape; masks mark real traffic and overflow waits for the
next tick. A tick runs one of three bodies (ingest + query, ingest only,
query only) over buffers allocated once at construction, so
``trace_count``, the number of distinct (body, shapes, dtype) signatures
that have run, stays <= 3 for any request mix. The bodies have fixed shapes
and never wait for the host, so they can be captured as CUDA graphs.
Within a mixed tick ingest applies first and queries read the post-ingest
counters (read-your-writes).

**Stages.** :meth:`StormGateway.tick_start` packs pending traffic straight
into a pinned host staging buffer, ships it to the device in ONE
asynchronous copy (``[zbuf | zmask | qbuf | qmask]``, only the halves that
carry traffic) and launches the tick body on the current stream without
waiting for anything: the counters are updated in place, and the query
estimates are copied back into pinned host memory asynchronously, behind an
event. :meth:`tick_finish` waits for that event (the serving loop's ONLY
device->host sync, which waits for this tick's work and not for the ticks
launched after it) and reports completions. ``tick()`` is
``tick_finish(tick_start())``; a caller may keep ``depth`` ticks in flight.
The staging buffers form a ring, and a
buffer is refilled only after the event recorded behind its last copy has
passed (the host waits there only when it runs a whole ring ahead of the
device; ``staging_waits`` counts those waits). Packing (the only queue
mutation) happens at start time in dispatch order and every tick runs on
one stream, so the pipelined loop is bit-identical to the synchronous one.

**Privacy.** A finite :class:`~repro_torch.core.privacy.ReleasePolicy`
makes every read a privatize-on-read: ONE noisy release per (tenant,
counter version) covers all the queries a tick coalesces, charged to the
tenant's ledger; an exhausted tenant is refused or served its last release
(``policy.on_exhaust``). It adds ONE tick body, the private query
(``trace_count`` <= 4): on the device, ``released = where(fresh, f32(counts)
+ noise, lane)`` is written into the tenant's lane of an ``(S, R, B)`` f32
buffer, and one banked query over the lanes (the RACE kernels' f32 variant)
runs with the release-time counts. The plans and the noise are host work
(numpy, ``PrivateBankView``); the noise, the fresh flags and the counts
(int32 bits) ride in the same single transfer, ``[zbuf | zmask | qbuf |
qmask | noise | fresh | n_used]``. A tick with traffic runs the ingest
body if it has rows, then the private query body if it has placed points.
Private fits plan their reads in ``tick_start`` and build the released
sub-bank on the device behind the tick. ``None`` or a noiseless policy
builds none of this: the gateway is the non-private one.

**Mesh.** With ``mesh=`` (a :class:`~repro_torch.sharding.mesh.Mesh`
whose axis is ``axis``) the tenants split over the mesh in
``sharding.specs.tenant_placement``'s contiguous blocks, as the reference's
``gateway_specs`` splits them. Each shard owns, on its device, its block of
the bank, of the fused transfer and of the staging ring, and runs the
tick's bodies over its block (on the card one banked insert and one banked
query per shard per tick; every shard has the same shapes, so
``trace_count`` stays <= 3). Shards never talk to each other during a tick:
``tick_start`` packs every shard's buffer, ships each in one asynchronous
copy and launches its body, and :meth:`~StormGateway.tick_finish` waits
for each shard's event behind its estimates' readback. Fits gather their
cohort's tables from the shards that hold them onto the gateway's device
(the mesh's first). Finite-epsilon privacy is meshless-only, as in the
reference. Without a mesh the gateway is one shard holding every tenant.

**Tracing.** While :mod:`repro_torch.tracing` is on, ``tick_start`` is a
span (``gateway.tick_start``, keyed by the tick) holding the wait for a
staging buffer (``gateway.staging_wait``, only when it waits), the host's
writes into the staging (``gateway.stage``) and the enqueueing of the copy
and the tick bodies (``gateway.launch``); ``tick_finish`` holds the wait
for the estimates (``gateway.wait``) and the fits (``gateway.fit``). An
ingest request's submit to the tick that packs its last row is a
``gateway.queue_wait`` span keyed by its rid, and the counters
``gateway.h2d_bytes`` and ``gateway.rows_packed`` count what each tick
copies to the device, ``gateway.staged_bytes`` what its ingest stage
wrote into the staging (rows, and mask entries set or cleared). None of it
changes what the gateway serves.

Correctness contract: a tenant's counters after any interleaving of ticks
equal the lone ``sketch_dataset`` build of its stream bit for bit; query
results equal standalone ``ops.query_theta_with_weights`` calls against the
tenant's lone sketch (under privacy: against its release); a gateway fit
equals the offline ``erm.fit_many`` over the same counters (or released
tables) and seed; a gateway on a mesh serves what the meshless one serves,
bit for bit.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import dfo, erm, fleet, losses, lsh
from repro_torch.core import privacy as privacy_lib
from repro_torch.core import sketch as sketch_lib
from repro_torch.device import DeviceLike, generator as make_generator
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.sharding import specs as sharding_specs
from repro_torch.sharding.mesh import Mesh, home_device

Tensor = torch.Tensor

STAGING_SLOTS = 4  # host staging buffers: one more than the deepest pipeline


class Backpressure(RuntimeError):
    """A submit would exceed a tenant's bounded-queue capacity.

    The caller should drain completions and resubmit.
    """

    def __init__(self, tenant: int, kind: str, pending: int, requested: int,
                 limit: int):
        super().__init__(
            f"tenant {tenant} {kind} queue full: {pending} pending + "
            f"{requested} requested > cap {limit}"
        )
        self.tenant = tenant
        self.kind = kind  # "ingest" | "query"
        self.pending = pending
        self.requested = requested
        self.limit = limit


class TickBudgetExceeded(RuntimeError):
    """``run_until_idle`` exhausted its tick budget with requests pending.

    The results that did complete ride along as ``completed``, and the
    number of still-queued requests as ``pending``.
    """

    def __init__(self, pending: int, completed: List["QueryResult"]):
        super().__init__(f"{pending} requests still pending after the tick "
                         f"budget ({len(completed)} results completed)")
        self.pending = pending
        self.completed = completed


@dataclasses.dataclass
class IngestRequest:
    """Append ``z`` rows to a tenant's counters: pre-scaled sketch-space
    points (``params.dim - 2`` wide) for a paired gateway, pre-augmented
    points (``params.dim`` wide, ``lsh.augment_data``) for a single-sided
    one. Rows beyond the tick capacity spill to later ticks."""

    rid: int
    tenant: int
    z: np.ndarray


@dataclasses.dataclass
class QueryRequest:
    """Evaluate the sketch loss at ``thetas`` (``(q, dim)`` iterates)
    against a tenant's sketch."""

    rid: int
    tenant: int
    thetas: np.ndarray


@dataclasses.dataclass
class FitRequest:
    """Train a tenant cohort from its SERVED counters: one ``erm.fit_many``
    over the named tenants' live sketches, run in ``tick_finish``.

    ``surrogate`` names a registered :mod:`repro_torch.core.losses` spec
    whose insert flavor matches the gateway's (``spec.paired ==
    gw.paired``). ``seed`` seeds the fit's ``torch.Generator``.
    """

    rid: int
    tenants: Sequence[int]          # the cohort, in result-row order
    surrogate: str = "prp_regression"
    seed: int = 0
    restarts: int = 1
    l2: float = 0.0
    steps: int = 100                # DFO steps (serving fits favor short runs)
    num_queries: int = 8
    sigma: float = 0.5
    learning_rate: float = 1.0
    decay: float = 0.995
    refine_steps: Optional[int] = None  # None -> the surrogate's default


@dataclasses.dataclass
class FitResult:
    """Iterate-space cohort fit: row ``i`` is ``tenants[i]``'s model.

    ``status`` under a finite privacy policy: ``"ok"``, ``"stale"`` (a
    cohort member trained from its last cached release) or ``"refused"``
    (an exhausted member without one; ``theta`` and ``fleet_losses`` are
    zeros).
    """

    rid: int
    tenants: List[int]
    theta: np.ndarray         # (S, dim) float32
    fleet_losses: np.ndarray  # (S, F) final sketch-loss per restart member
    status: str = "ok"


@dataclasses.dataclass
class QueryResult:
    """``status``: ``"ok"``, ``"stale"`` (served from the tenant's last
    cached release after its budget ran out) or ``"refused"`` (exhausted;
    ``losses`` are zeros)."""

    rid: int
    tenant: int
    losses: np.ndarray  # (q,) float32, row i for thetas[i]
    status: str = "ok"


@dataclasses.dataclass
class IngestResult:
    """An ingest request's final row reached the counters this tick."""

    rid: int
    tenant: int
    rows: int


@dataclasses.dataclass
class TickReport:
    """What one engine tick did (completed requests only: a split request
    reports once, on the tick that finishes it)."""

    tick: int
    results: List[QueryResult]
    rows_ingested: int
    points_served: int
    ingest_done: List[IngestResult] = dataclasses.field(default_factory=list)
    fits: List[FitResult] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PendingIngest:
    req: IngestRequest
    cursor: int = 0
    submitted_ns: int = 0  # tracing's stamp at submit, while it is on


@dataclasses.dataclass
class _PendingQuery:
    req: QueryRequest
    cursor: int = 0
    out: Optional[np.ndarray] = None
    status: str = "ok"


@dataclasses.dataclass
class InflightTick:
    """One dispatched-but-unread tick.

    Everything queue-related was resolved at :meth:`StormGateway.tick_start`;
    ``est`` holds the query estimates: on the card a pinned host tensor that
    asynchronous copies fill, complete once every event of ``ready`` (one
    per shard) has passed (on the CPU the estimates themselves, ``ready``
    None), and
    ``placements``/``completes``/``ingest_done`` are the host bookkeeping
    that turns the readback into :class:`TickReport` entries; ``fits`` holds
    each fit request with its cohort's counters (int32, or released f32
    tables under privacy), gathered behind the tick's ingest, and its
    status.
    """

    tick: int
    est: Optional[Tensor]
    placements: list  # (pending, req_offset, tenant, slot_offset, count)
    completes: List[_PendingQuery]
    ingest_done: List[IngestResult]
    rows: int
    points: int
    fits: list = dataclasses.field(default_factory=list)  # (req, bank, status)
    ready: Optional[List[torch.cuda.Event]] = None


def run_fit_request(req: FitRequest, bank: sketch_lib.SketchBank,
                    params: lsh.LSHParams) -> FitResult:
    """One cohort fit against a sub-bank (row i = ``tenants[i]``): int32
    counters, or released f32 tables under privacy.

    The request's knobs map onto ONE ``erm.fit_many`` call on the bank's
    device, seeded by ``device.generator(req.seed)``, so a gateway fit
    equals the offline fit over the same counters and seed bit for bit.
    """
    dev = bank.counts.device
    cfg = dfo.DFOConfig(
        steps=req.steps, num_queries=req.num_queries, sigma=req.sigma,
        learning_rate=req.learning_rate, decay=req.decay,
    )
    res = erm.fit_many(
        req.surrogate, bank, params, cfg, restarts=req.restarts, l2=req.l2,
        refine_steps=req.refine_steps,
        generator=make_generator(req.seed, dev), device=dev,
    )
    return FitResult(rid=req.rid, tenants=list(req.tenants),
                     theta=res.theta.cpu().numpy(),
                     fleet_losses=res.fleet_losses.cpu().numpy())


class _StagingRing:
    """Host staging buffers for the fused per-tick transfer.

    On the card they are pinned, so the copy to the device is asynchronous;
    a buffer is handed out again only after the event recorded behind its
    last copy has passed.

    The buffers start zeroed and their ingest halves are never zeroed
    again: for each buffer the ring keeps each local tenant's fill (rows
    packed) from that buffer's last ingest stage, and the next stage into
    it clears only the mask slots that the old fill covered and the new one
    does not (:meth:`clear_stale`). The mask stays exact; rows in masked
    slots keep whatever an earlier tick left there.
    """

    def __init__(self, size: int, tenants: int, device: torch.device):
        self._device = device
        self._pinned = device.type == "cuda"
        self._bufs = [torch.zeros(size, dtype=torch.float32,
                                  pin_memory=self._pinned)
                      for _ in range(STAGING_SLOTS)]
        self._fills = np.zeros((len(self._bufs), tenants), np.int64)
        self._events: List[Optional[torch.cuda.Event]] = [None] * len(
            self._bufs)
        self._next = 0
        self.waits = 0

    def acquire(self) -> int:
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        event = self._events[k]
        if event is not None and not event.query():
            self.waits += 1
            with tracing.span("gateway.staging_wait"):
                event.synchronize()
        return k

    def buffer(self, k: int) -> Tensor:
        return self._bufs[k]

    def clear_stale(self, k: int, zmask: np.ndarray, fill: np.ndarray) -> int:
        """Clear buffer ``k``'s mask slots ``[fill[i], old fill[i])`` of
        each local tenant ``i`` after a stage that filled ``[0, fill[i])``,
        and keep ``fill`` as its fills; returns the slots cleared."""
        old = self._fills[k]
        cleared = 0
        for i in np.flatnonzero(old > fill):
            zmask[i, fill[i]:old[i]] = 0.0
            cleared += int(old[i] - fill[i])
        old[:] = fill
        return cleared

    def copied(self, k: int) -> None:
        """Mark the end of buffer ``k``'s copy on the device's stream."""
        if self._pinned:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
            self._events[k] = event


class _Shard:
    """One shard of a gateway: a contiguous block of ``tenants`` tenants
    from ``lo`` on one device, with its block of the bank (``counts``,
    ``n``: owned, updated in place), its weights, its block of the fused
    transfer (``flat`` and the views the tick bodies read), its staging
    ring and its query routing. A meshless gateway is one shard."""

    def __init__(self, gw: "StormGateway", lo: int, tenants: int,
                 device: torch.device, counts: Tensor, n: Tensor):
        self.lo, self.tenants, self.device = lo, tenants, device
        self.counts = counts.to(device, copy=True)
        self.n = n.to(device, torch.int32, copy=True)
        self.w = gw.w.to(device)
        self.flat = torch.zeros(gw._end, dtype=torch.float32, device=device)
        self.zbuf, self.zmask, self.qbuf, self.qmask = gw._views(self.flat)
        self.staging = _StagingRing(gw._end, tenants, device)
        # Tenant-major query slots: row i reads table i // Q (member-major
        # routing with member_map = arange(tenants)): in range by
        # construction, so the banked query takes it as checked and reads
        # nothing back.
        self.qidx = fleet.member_point_idx(
            torch.arange(tenants, dtype=torch.int32, device=device),
            tenants * gw.query_slots)


class StormGateway:
    """Fixed-tick micro-batching gateway over a :class:`SketchBank`."""

    def __init__(
        self,
        params: lsh.LSHParams,
        tenants: int,
        *,
        paired: bool = True,
        query_slots: int = 32,
        ingest_slots: int = 128,
        count_dtype=torch.int32,
        mode: str = "auto",
        bank: Optional[sketch_lib.SketchBank] = None,
        max_pending_rows: Optional[int] = None,
        max_pending_points: Optional[int] = None,
        privacy: Optional[privacy_lib.ReleasePolicy] = None,
        privacy_seed: int = 0,
        private_view: Optional[privacy_lib.PrivateBankView] = None,
        privacy_key_of: Optional[Callable[[int], int]] = None,
        mesh: Optional[Mesh] = None,
        axis: str = "bank",
        device: DeviceLike = None,
    ):
        """Args:
          params: the ONE hash family shared by every tenant's sketch.
          tenants: bank size S (fixed for the gateway's life).
          paired: PRP sketches (regression, probes) or single-sided
            (classification): sets the insert and the estimator's divisor.
          query_slots: per-tenant theta capacity Q per tick.
          ingest_slots: per-tenant row capacity I per tick.
          count_dtype: counter dtype (a ``torch.dtype`` or its name); narrow
            banks take the insert's narrow tile and add it saturating.
          mode: kernel dispatch of both halves (``auto | kernel | ref``).
          bank: optional warm-start counters ``(S, R, B)`` (copied; their
            dtype overrides ``count_dtype``).
          max_pending_rows / max_pending_points: per-tenant queue caps; a
            submit beyond one raises :class:`Backpressure`. ``None`` leaves
            the queue unbounded.
          privacy: optional :class:`~repro_torch.core.privacy.ReleasePolicy`.
            ``None`` or a noiseless policy leaves the gateway exactly as
            without one (nothing private is built). A finite policy makes
            every read a privatize-on-read (the module note).
          privacy_seed: seed of the release noise stream.
          private_view: a shared
            :class:`~repro_torch.core.privacy.PrivateBankView` (the tiered
            gateway shares one global view with its inner gateway).
          privacy_key_of: maps a bank slot to its ledger key (identity by
            default; the tiered gateway maps slot -> GLOBAL tenant, so
            budgets follow tenants across promote/demote).
          mesh / axis: optional device mesh splitting the tenants over its
            axis ``axis`` (the module note); ``tenants`` must be a multiple
            of the shard count.
          device: where the bank and the tick bodies live, or on a mesh
            where fits run and gathered reads land (default: the mesh's
            first device); ``None`` without a mesh: the card, raising
            without one.
        """
        if tenants < 1:
            raise ValueError(f"need at least one tenant; got {tenants}")
        if mode not in ops.MODES:
            raise ValueError(f"unknown mode {mode!r}; use auto | kernel | ref")
        if (mesh is not None and privacy is not None
                and not privacy.noiseless):
            raise NotImplementedError(
                "finite-epsilon privacy is meshless-only for now; "
                "eps=inf (ReleasePolicy.unlimited() or privacy=None) "
                "runs on a mesh unchanged")
        dev = home_device(mesh, device)
        self.device = dev
        self.mesh = mesh
        # Tenant t lives on shard placement[t], at local slot t - lo.
        placement = (np.zeros((tenants,), np.int32) if mesh is None
                     else sharding_specs.tenant_placement(tenants, mesh, axis))
        devices = (dev,) if mesh is None else mesh.devices
        self._local = tenants // len(devices)
        self._place = [(int(sh), t - int(sh) * self._local)
                       for t, sh in enumerate(placement)]
        self.params = lsh.LSHParams(projections=params.projections.to(dev))
        self.w = ops.from_lsh_params(self.params)
        self.dim = self.params.dim - 2  # query iterate dim (theta_tilde rows)
        self.ingest_dim = self.params.dim - 2 if paired else self.params.dim
        self.tenants = tenants
        self.paired = paired
        self.query_slots = query_slots
        self.ingest_slots = ingest_slots
        self.mode = mode
        self.max_pending_rows = max_pending_rows
        self.max_pending_points = max_pending_points
        if bank is None:
            bank = sketch_lib.SketchBank(
                counts=torch.zeros((tenants, self.params.rows,
                                    self.params.buckets),
                                   dtype=sketch_lib.counter_dtype(count_dtype),
                                   device=dev),
                n=torch.zeros((tenants,), dtype=torch.int32, device=dev),
            )
        if bank.counts.shape[0] != tenants:
            raise ValueError(
                f"bank holds {bank.counts.shape[0]} sketches for "
                f"{tenants} tenants"
            )
        self.count_dtype = bank.counts.dtype
        self._ingest_q: Deque[_PendingIngest] = deque()
        self._query_q: Deque[_PendingQuery] = deque()
        self._fit_q: Deque[FitRequest] = deque()
        self._pending_rows = [0] * tenants
        self._pending_points = [0] * tenants
        self.ticks = 0
        self.rows_ingested = 0
        self.points_served = 0
        self.fits_run = 0
        self.queries_refused = 0
        self.fits_refused = 0
        self._signatures: set = set()

        # Privacy: None or a noiseless policy builds nothing private.
        self.privacy = privacy
        self._private = privacy is not None and not privacy.noiseless
        self._privacy_key_of = privacy_key_of or (lambda slot: slot)
        self.private_view: Optional[privacy_lib.PrivateBankView] = None
        if self._private:
            self.private_view = (private_view if private_view is not None
                                 else privacy_lib.PrivateBankView(
                                     privacy, seed=privacy_seed))
            # Lane i holds slot i's last released table, so a stale read
            # needs no host round trip.
            self._release = torch.zeros(
                (tenants, self.params.rows, self.params.buckets),
                dtype=torch.float32, device=dev)
            # Counter versions (cumulative packed rows, equal to the device
            # n: the host packs every row) keyed by ledger key, seeded from
            # a warm bank.
            self._rows_of: Dict[int, int] = defaultdict(int)
            for slot, n0 in enumerate(bank.n.cpu().tolist()):
                if n0:
                    self._rows_of[self._privacy_key_of(slot)] += int(n0)

        # A shard's block of the fused transfer: [zbuf | zmask | qbuf |
        # qmask], and under privacy (meshless: one shard) [... | noise |
        # fresh | n_used (int32 bits)]; each shard owns its device buffer,
        # the views its tick bodies read, and its part of the bank, which
        # the gateway updates in place.
        s, i_cap, q_cap = self._local, ingest_slots, query_slots
        self._z_end = s * i_cap * self.ingest_dim
        self._zm_end = self._z_end + s * i_cap
        self._q_end = self._zm_end + s * q_cap * self.dim
        self._qm_end = self._q_end + s * q_cap
        self._end = self._qm_end
        if self._private:
            self._nz_end = self._qm_end + s * self.params.rows * \
                self.params.buckets
            self._fr_end = self._nz_end + s
            self._end = self._fr_end + s
        if mesh is None:
            blocks = zip([bank.counts], [bank.n])
        else:
            bank_spec, _ = sharding_specs.gateway_specs(axis)
            blocks = zip(sharding_specs.place(bank.counts, bank_spec, mesh),
                         sharding_specs.place(bank.n, bank_spec, mesh))
        self._shards = [_Shard(self, i * self._local, self._local, d, c, n)
                        for i, (d, (c, n)) in enumerate(zip(devices, blocks))]
        if self._private:
            self._noise, self._fresh, self._n_used = self._release_views(
                self._shards[0].flat)

    def _views(self, flat: Tensor):
        """``(zbuf, zmask, qbuf, qmask)`` views of a shard's fused buffer."""
        s, i_cap, q_cap = self._local, self.ingest_slots, self.query_slots
        return (flat[:self._z_end].view(s, i_cap, self.ingest_dim),
                flat[self._z_end:self._zm_end].view(s, i_cap),
                flat[self._zm_end:self._q_end].view(s * q_cap, self.dim),
                flat[self._q_end:self._qm_end])

    def _release_views(self, flat: Tensor):
        """``(noise (S, R, B), fresh (S,), n_used (S,) int32)`` views of a
        fused buffer of a private gateway."""
        return (flat[self._qm_end:self._nz_end].view(
                    self.tenants, self.params.rows, self.params.buckets),
                flat[self._nz_end:self._fr_end],
                flat[self._fr_end:self._end].view(torch.int32))

    # -- request plumbing ---------------------------------------------------

    def submit(self, req: Union[IngestRequest, QueryRequest, FitRequest]
               ) -> None:
        if isinstance(req, FitRequest):
            cohort = [int(t) for t in req.tenants]
            if not cohort:
                raise ValueError("fit cohort is empty")
            for t in cohort:
                if not 0 <= t < self.tenants:
                    raise ValueError(f"fit tenant {t} out of range "
                                     f"[0, {self.tenants})")
            spec = losses.get_surrogate(req.surrogate)
            if spec.paired != self.paired:
                flavor = ("paired (PRP)", "single-sided")
                raise ValueError(
                    f"surrogate '{spec.name}' expects "
                    f"{flavor[0] if spec.paired else flavor[1]} counters but "
                    f"this gateway ingests "
                    f"{flavor[0] if self.paired else flavor[1]}"
                )
            self._fit_q.append(dataclasses.replace(req, tenants=cohort))
            return
        if not isinstance(req, (IngestRequest, QueryRequest)):
            raise TypeError(f"unknown request type {type(req).__name__}")
        if not 0 <= req.tenant < self.tenants:
            raise ValueError(f"tenant {req.tenant} out of range "
                             f"[0, {self.tenants})")
        if isinstance(req, IngestRequest):
            z = np.asarray(req.z, np.float32)
            if z.ndim != 2 or z.shape[1] != self.ingest_dim:
                raise ValueError(
                    f"ingest rows must be (rows, {self.ingest_dim}); got "
                    f"{z.shape}"
                )
            if self.max_pending_rows is not None and (
                    self._pending_rows[req.tenant] + z.shape[0]
                    > self.max_pending_rows):
                raise Backpressure(req.tenant, "ingest",
                                   self._pending_rows[req.tenant],
                                   z.shape[0], self.max_pending_rows)
            self._pending_rows[req.tenant] += z.shape[0]
            self._ingest_q.append(_PendingIngest(
                dataclasses.replace(req, z=z),
                submitted_ns=tracing.now() if tracing.on() else 0))
        else:
            th = np.asarray(req.thetas, np.float32)
            if th.ndim != 2 or th.shape[1] != self.dim:
                raise ValueError(f"query thetas must be (q, {self.dim}); "
                                 f"got {th.shape}")
            if self.max_pending_points is not None and (
                    self._pending_points[req.tenant] + th.shape[0]
                    > self.max_pending_points):
                raise Backpressure(req.tenant, "query",
                                   self._pending_points[req.tenant],
                                   th.shape[0], self.max_pending_points)
            self._pending_points[req.tenant] += th.shape[0]
            self._query_q.append(_PendingQuery(
                dataclasses.replace(req, thetas=th),
                out=np.zeros((th.shape[0],), np.float32),
            ))

    def submit_many(self, reqs: Sequence[Union[IngestRequest, QueryRequest,
                                               FitRequest]]) -> None:
        for r in reqs:
            self.submit(r)

    @property
    def pending(self) -> int:
        return len(self._ingest_q) + len(self._query_q) + len(self._fit_q)

    def queue_stats(self) -> dict:
        """Host-side gateway state for monitoring.

        ``pending_depth[t]`` is the number of queued REQUESTS of tenant
        ``t`` (ingest + query; a split request counts once).
        """
        depth = [0] * self.tenants
        for st in self._ingest_q:
            depth[st.req.tenant] += 1
        for st in self._query_q:
            depth[st.req.tenant] += 1
        stats = {
            "tenants": self.tenants,
            "ticks": self.ticks,
            "pending_requests": self.pending,
            "pending_depth": depth,
            "pending_rows": list(self._pending_rows),
            "pending_points": list(self._pending_points),
            "pending_fits": len(self._fit_q),
            "rows_ingested": self.rows_ingested,
            "points_served": self.points_served,
            "fits_run": self.fits_run,
            "trace_count": self.trace_count,
        }
        if self._private:
            stats["privacy"] = self.privacy_stats()
        return stats

    def privacy_stats(self) -> dict:
        """The view's JSON-safe budget summary plus the refusal counts."""
        return dict(self.private_view.summary(),
                    queries_refused=self.queries_refused,
                    fits_refused=self.fits_refused)

    @property
    def bank(self) -> sketch_lib.SketchBank:
        """The counter bank. Meshless: the live bank, the gateway's own
        tensors, which later ticks update in place (clone to keep a
        snapshot); on a mesh: the shards' blocks gathered onto the
        gateway's device (a copy)."""
        if self.mesh is None:
            sh = self._shards[0]
            return sketch_lib.SketchBank(counts=sh.counts, n=sh.n)
        counts, n = self.bank_blocks()
        return sketch_lib.SketchBank(
            counts=torch.cat([c.to(self.device) for c in counts]),
            n=torch.cat([m.to(self.device) for m in n]))

    def bank_blocks(self) -> tuple:
        """The live per-shard blocks ``([counts], [n])`` in tenant order,
        each on its shard's device."""
        return ([sh.counts for sh in self._shards],
                [sh.n for sh in self._shards])

    def _table(self, tenant: int) -> tuple:
        """Live views ``(counts, n)`` of a tenant's table on its shard."""
        shard, i = self._place[tenant]
        sh = self._shards[shard]
        return sh.counts[i], sh.n[i]

    def sketch_of(self, tenant: int) -> sketch_lib.Sketch:
        """Tenant ``tenant``'s sketch as a standalone view (on its shard's
        device)."""
        return sketch_lib.Sketch(*self._table(tenant))

    @property
    def trace_count(self) -> int:
        """Distinct (body, shapes, dtype) signatures the tick bodies have
        run: <= 3 for any request mix over the gateway's life, <= 4 with a
        finite privacy policy (the private query body)."""
        return len(self._signatures)

    @property
    def staging_waits(self) -> int:
        """Times ``tick_start`` waited for a staging buffer's last copy."""
        return sum(sh.staging.waits for sh in self._shards)

    # -- the tick bodies ------------------------------------------------------

    def _ingest_half(self, sh: _Shard) -> None:
        """ONE banked insert over a shard's ``(S, I, dim)`` stack, added in
        place.

        Narrow banks take the insert's narrow tile (int32 inside the
        kernel, one saturating cast) and add it saturating; increments are
        non-negative, so ``clamp(counts + clamp(tile))`` equals
        ``clamp(counts + tile)``. Masked slots may hold an earlier tick's
        rows (the staging ring does not zero them) and add ``int(0)``.
        """
        insert = (ops.paired_hash_histogram_banked if self.paired
                  else ops.hash_histogram_banked)
        tile = insert(sh.zbuf, sh.w, sh.zmask, mode=self.mode,
                      out_dtype=self.count_dtype)
        sh.counts.copy_(sketch_lib.saturating_add(sh.counts, tile))
        sh.n += sh.zmask.sum(dim=1).to(torch.int32)

    def _query_half(self, sh: _Shard) -> Tensor:
        """ONE banked query over a shard's ``(S*Q, dim)`` slots; masked
        slots return 0.0."""
        est = ops.query_theta_with_weights(
            sketch_lib.SketchBank(counts=sh.counts, n=sh.n), sh.w, sh.qbuf,
            paired=self.paired, mode=self.mode, sketch_idx=sh.qidx,
            index_checked=True)
        return torch.where(sh.qmask > 0, est, 0.0)

    def _private_query(self, sh: _Shard) -> Tensor:
        """The private query body: this tick's releases into the lanes, then
        ONE banked query over the lanes with the release-time counts.

        A fresh slot's lane becomes ``f32(counts) + noise`` (widened before
        the add); any other lane keeps its last release. Masked slots
        return 0.0.
        """
        released = torch.where(self._fresh[:, None, None] > 0,
                               sh.counts.to(torch.float32) + self._noise,
                               self._release)
        self._release.copy_(released)
        est = ops.query_theta_with_weights(
            sketch_lib.SketchBank(counts=self._release, n=self._n_used),
            sh.w, sh.qbuf, paired=self.paired, mode=self.mode,
            sketch_idx=sh.qidx, index_checked=True)
        return torch.where(sh.qmask > 0, est, 0.0)

    def _run_body(self, sh: _Shard, ingest: bool, query: bool
                  ) -> Optional[Tensor]:
        """Run a shard's tick bodies: one of the three (full, ingest-only,
        query-only), or under privacy the ingest body and then the private
        query body, each where the tick has its traffic."""
        shapes = tuple(tuple(t.shape) for t in (
            sh.counts, sh.n, sh.zbuf, sh.qbuf))
        if self._private:
            est = None
            if ingest:
                self._signatures.add(("ingest", shapes, self.count_dtype))
                self._ingest_half(sh)
            if query:
                self._signatures.add(("private", shapes, self.count_dtype))
                est = self._private_query(sh)
            return est
        name = {(True, True): "full", (True, False): "ingest",
                (False, True): "query"}[(ingest, query)]
        self._signatures.add((name, shapes, self.count_dtype))
        if ingest:
            self._ingest_half(sh)
        return self._query_half(sh) if query else None

    # -- packing --------------------------------------------------------------

    def _pack_ingest(self, zbufs: List[np.ndarray],
                     zmasks: List[np.ndarray]):
        """Pack queued rows into the shards' ingest views (per shard
        ``(S_local, I, dim)`` and ``(S_local, I)``) from slot 0 of each
        tenant; returns the rows packed, the requests done and each
        tenant's fill."""
        i_cap = self.ingest_slots
        fill = [0] * self.tenants
        taken = 0
        done: List[IngestResult] = []
        for st in self._ingest_q:
            t = st.req.tenant
            take = min(i_cap - fill[t], st.req.z.shape[0] - st.cursor)
            if take <= 0:
                continue
            shard, i = self._place[t]
            zbufs[shard][i, fill[t]:fill[t] + take] = st.req.z[
                st.cursor:st.cursor + take]
            zmasks[shard][i, fill[t]:fill[t] + take] = 1.0
            st.cursor += take
            fill[t] += take
            taken += take
            self._pending_rows[t] -= take
        remaining: Deque[_PendingIngest] = deque()
        packed_ns = 0
        for st in self._ingest_q:
            if st.cursor < st.req.z.shape[0]:
                remaining.append(st)
                continue
            done.append(IngestResult(st.req.rid, st.req.tenant,
                                     st.req.z.shape[0]))
            if st.submitted_ns:
                packed_ns = packed_ns or tracing.now()
                tracing.record("gateway.queue_wait", st.submitted_ns,
                               packed_ns, st.req.rid)
        self._ingest_q = remaining
        return taken, done, np.array(fill)

    def _pack_queries(self, qbufs: List[np.ndarray],
                      qmasks: List[np.ndarray]):
        """Pack queued points into the shards' query views (per shard
        ``(S_local, Q, dim)`` and ``(S_local, Q)``)."""
        q_cap = self.query_slots
        fill = [0] * self.tenants
        placements = []  # (pending, req_offset, tenant, slot_offset, count)
        for st in self._query_q:
            t = st.req.tenant
            take = min(q_cap - fill[t], st.req.thetas.shape[0] - st.cursor)
            if take <= 0:
                continue
            shard, i = self._place[t]
            qbufs[shard][i, fill[t]:fill[t] + take] = st.req.thetas[
                st.cursor:st.cursor + take]
            qmasks[shard][i, fill[t]:fill[t] + take] = 1.0
            placements.append((st, st.cursor, t, fill[t], take))
            st.cursor += take
            fill[t] += take
            self._pending_points[t] -= take
        # Fully packed requests leave the queue now (dispatch order) and
        # report at finish, zero-row requests included.
        completes: List[_PendingQuery] = []
        remaining: Deque[_PendingQuery] = deque()
        for st in self._query_q:
            if st.cursor == st.req.thetas.shape[0]:
                completes.append(st)
            else:
                remaining.append(st)
        self._query_q = remaining
        return placements, completes

    # -- the tick -------------------------------------------------------------

    def tick_start(self) -> InflightTick:
        """Pack pending traffic and launch the tick WITHOUT waiting.

        All queue mutation happens here, in dispatch order. The counters
        advance in place on the device's stream; the returned
        :class:`InflightTick` carries the unread estimates and the host
        bookkeeping :meth:`tick_finish` needs.
        """
        with tracing.span("gateway.tick_start", self.ticks + 1):
            return self._tick_start()

    def _tick_start(self) -> InflightTick:
        self.ticks += 1
        tick = self.ticks
        if not self._ingest_q and not self._query_q:
            return InflightTick(tick=tick, est=None, placements=[],
                                completes=[], ingest_done=[], rows=0,
                                points=0, fits=self._gather_fits())
        shards = self._shards
        slots = [sh.staging.acquire() for sh in shards]
        hosts = [sh.staging.buffer(k) for sh, k in zip(shards, slots)]
        views = [[v.numpy() for v in self._views(host)] for host in hosts]
        rows, ingest_done = 0, []
        if self._ingest_q:
            with tracing.span("gateway.stage", tick):
                rows, ingest_done, fill = self._pack_ingest(
                    [v[0] for v in views], [v[1] for v in views])
                staged = rows * (self.ingest_dim + 1)
                for sh, k, v in zip(shards, slots, views):
                    staged += sh.staging.clear_stale(
                        k, v[1], fill[sh.lo:sh.lo + sh.tenants])
            tracing.add("gateway.staged_bytes", staged * 4)
        plans: Dict[int, privacy_lib.ReadPlan] = {}
        refused: List[_PendingQuery] = []
        if self._private:
            # The packed rows are this tick's inserts: versions advance as
            # the device n does (one shard: the mesh is meshless here).
            if rows:
                per_slot = views[0][1].sum(axis=1)
                for slot in np.nonzero(per_slot)[0]:
                    self._rows_of[self._privacy_key_of(int(slot))] += int(
                        per_slot[slot])
            plans = self._plan_private_reads()
            refused = self._refuse_queries(
                {slot for slot, plan in plans.items()
                 if plan.status == "refuse"})
        placements, completes = [], []
        if self._query_q:
            with tracing.span("gateway.stage", tick):
                for host in hosts:
                    host[self._zm_end:self._qm_end].zero_()
                local, q_cap = self._local, self.query_slots
                placements, completes = self._pack_queries(
                    [v[2].reshape(local, q_cap, self.dim) for v in views],
                    [v[3].reshape(local, q_cap) for v in views])
        completes = refused + completes
        for st, _, t, _, _ in placements:
            if t in plans and plans[t].status == "stale":
                st.status = "stale"
        do_ingest, do_query = rows > 0, bool(placements)
        est, ready = None, None
        if do_ingest or do_query:
            lo = 0 if do_ingest else self._zm_end
            hi = self._zm_end
            if do_query:
                hi = self._qm_end
                if self._private:
                    with tracing.span("gateway.stage", tick):
                        self._pack_releases(hosts[0], plans)
                    hi = self._end
            tracing.add("gateway.h2d_bytes", (hi - lo) * 4 * len(shards))
            tracing.add("gateway.rows_packed", rows)
            with tracing.span("gateway.launch", tick):
                ests = []
                for sh, k, host in zip(shards, slots, hosts):
                    sh.flat[lo:hi].copy_(host[lo:hi], non_blocking=True)
                    sh.staging.copied(k)
                    ests.append(self._run_body(sh, do_ingest, do_query))
                if self._private and do_query:
                    for slot, plan in plans.items():
                        if plan.status == "fresh":
                            self.private_view.mark_resident(
                                self._privacy_key_of(slot))
                if do_query:
                    est, ready = self._read_estimates(ests)
        points = sum(take for *_, take in placements)
        return InflightTick(tick=tick, est=est, placements=placements,
                            completes=completes, ingest_done=ingest_done,
                            rows=rows, points=points,
                            fits=self._gather_fits(), ready=ready)

    def _read_estimates(self, ests: List[Tensor]) -> tuple:
        """The shards' estimates in tenant order, and the events behind
        their readback (None on the CPU). On the card each shard's readback
        is queued now into its slice of one pinned buffer: waiting on its
        event waits for that shard's work of this tick only, not for ticks
        launched after it."""
        if not ests[0].is_cuda:
            return (ests[0] if len(ests) == 1 else torch.cat(ests)), None
        est_host = torch.empty((self.tenants * self.query_slots,),
                               dtype=ests[0].dtype, pin_memory=True)
        ready = []
        for sh, e in zip(self._shards, ests):
            lo = sh.lo * self.query_slots
            est_host[lo:lo + e.shape[0]].copy_(e, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(sh.device))
            ready.append(event)
        return est_host, ready

    # -- privatize-on-read planning (finite policy only) --------------------

    def _plan_private_reads(self) -> Dict[int, privacy_lib.ReadPlan]:
        """One plan per slot with >= 1 queued query point (each packs at
        least one point this tick, so it needs at most one release; a slot
        with only empty requests reads nothing and spends nothing). Runs
        after the ingest is packed: plans see this tick's versions."""
        shape = (self.params.rows, self.params.buckets)
        plans: Dict[int, privacy_lib.ReadPlan] = {}
        for slot in range(self.tenants):
            if self._pending_points[slot] <= 0:
                continue
            key = self._privacy_key_of(slot)
            plans[slot] = self.private_view.plan_read(
                key, self._rows_of[key], shape, paired=self.paired)
        return plans

    def _refuse_queries(self, refused_slots) -> List[_PendingQuery]:
        """Complete every pending query of the refused slots, typed, before
        packing: refused requests take no slots, and zero-point requests
        pass (they read nothing)."""
        if not refused_slots:
            return []
        refused: List[_PendingQuery] = []
        remaining: Deque[_PendingQuery] = deque()
        for st in self._query_q:
            pts_left = st.req.thetas.shape[0] - st.cursor
            if st.req.tenant in refused_slots and pts_left > 0:
                st.status = "refused"
                st.out[st.cursor:] = 0.0
                self._pending_points[st.req.tenant] -= pts_left
                refused.append(st)
            else:
                remaining.append(st)
        self._query_q = remaining
        self.queries_refused += len(refused)
        return refused

    def _pack_releases(self, host: Tensor,
                       plans: Dict[int, privacy_lib.ReadPlan]) -> None:
        """The private tail of the staging buffer: each fresh slot's noise,
        every slot's fresh flag and release-time count (0 where unplanned;
        a slot that is not fresh keeps its lane, whatever its noise)."""
        noise, fresh, n_used = (v.numpy() for v in self._release_views(host))
        fresh[:] = 0.0
        n_used[:] = 0
        for slot, plan in plans.items():
            n_used[slot] = plan.n
            if plan.status == "fresh":
                noise[slot] = plan.noise
                fresh[slot] = 1.0

    def _gather_fits(self) -> list:
        """Take the fit queue: each request with its cohort's counters,
        copied on the device behind this tick's ingest (no host read), and
        its status; the fits run in :meth:`tick_finish`. Under privacy the
        counters are the members' releases (:meth:`_gather_private`)."""
        out = []
        while self._fit_q:
            req = self._fit_q.popleft()
            if self._private:
                out.append(self._gather_private(
                    req, [self._privacy_key_of(t) for t in req.tenants],
                    lambda j, req=req: self._table(req.tenants[j])[0],
                    lambda j, req=req: self._release[req.tenants[j]]))
                continue
            tables = [self._table(t) for t in req.tenants]
            out.append((req, sketch_lib.SketchBank(
                counts=torch.stack([c.to(self.device) for c, _ in tables]
                                   ).to(torch.int32),
                n=torch.stack([m.to(self.device) for _, m in tables])), "ok"))
        return out

    def _gather_private(self, req: FitRequest, keys: List[int],
                        table_of: Callable[[int], Tensor],
                        lane_of: Callable[[int], Tensor]) -> tuple:
        """Plan each member's read (ledger key ``keys[j]``) and build the
        released sub-bank on the device: ``f32(table_of(j)) + noise`` for a
        fresh plan, a copy of ``lane_of(j)`` for a stale one. The noise and
        the release-time counts go up from pinned memory without a wait. A
        refused member refuses the whole request (the members before it
        stay planned, as in the reference)."""
        shape = (self.params.rows, self.params.buckets)
        plans = []
        for key in keys:
            plan = self.private_view.plan_read(key, self._rows_of[key], shape,
                                               paired=self.paired)
            if plan.status == "refuse":
                return req, None, "refused"
            plans.append(plan)
        pinned = self.device.type == "cuda"
        noise = torch.empty((len(plans),) + shape, dtype=torch.float32,
                            pin_memory=pinned)
        ns = torch.empty((len(plans),), dtype=torch.int32, pin_memory=pinned)
        noise_np, ns_np = noise.numpy(), ns.numpy()
        for j, plan in enumerate(plans):
            ns_np[j] = plan.n
            if plan.status == "fresh":
                noise_np[j] = plan.noise
        noise = noise.to(self.device, non_blocking=True)
        tables = [table_of(j).to(torch.float32) + noise[j]
                  if plan.status == "fresh" else lane_of(j)
                  for j, plan in enumerate(plans)]
        stale = any(plan.status == "stale" for plan in plans)
        return (req, sketch_lib.SketchBank(
            counts=torch.stack(tables),
            n=ns.to(self.device, non_blocking=True)),
            "stale" if stale else "ok")

    def _refused_fit(self, req: FitRequest) -> FitResult:
        s = len(req.tenants)
        self.fits_refused += 1
        return FitResult(rid=req.rid, tenants=list(req.tenants),
                         theta=np.zeros((s, self.dim), np.float32),
                         fleet_losses=np.zeros((s, req.restarts), np.float32),
                         status="refused")

    def _fit_results(self, fits: list) -> List[FitResult]:
        """One ``erm.fit_many`` per gathered request (a refused one gets
        zeros); the tick bodies and the counters are untouched."""
        out = []
        for req, sub, status in fits:
            if status == "refused":
                out.append(self._refused_fit(req))
                continue
            res = run_fit_request(req, sub, self.params)
            res.status = status
            out.append(res)
        return out

    def tick_finish(self, inflight: InflightTick) -> TickReport:
        """Read back one launched tick's estimates and report completions.

        Waiting for the estimates here (each shard's event) is the ONLY
        device->host sync of the serving loop, and it waits for this tick's
        work alone. Finish ticks
        in dispatch order. The tick's fits run here, over the counters
        gathered behind its ingest.
        """
        with tracing.span("gateway.tick_finish", inflight.tick):
            return self._tick_finish(inflight)

    def _tick_finish(self, inflight: InflightTick) -> TickReport:
        results: List[QueryResult] = []
        if inflight.ready:
            with tracing.span("gateway.wait", inflight.tick):
                for event in inflight.ready:
                    event.synchronize()
        if inflight.est is not None:
            losses_ = inflight.est.numpy().reshape(self.tenants,
                                                   self.query_slots)
            for st, req_off, t, slot_off, take in inflight.placements:
                st.out[req_off:req_off + take] = \
                    losses_[t, slot_off:slot_off + take]
        for st in inflight.completes:
            results.append(QueryResult(st.req.rid, st.req.tenant, st.out,
                                       status=st.status))
        self.rows_ingested += inflight.rows
        self.points_served += inflight.points
        fits = []
        if inflight.fits:
            with tracing.span("gateway.fit", inflight.tick):
                fits = self._fit_results(inflight.fits)
        self.fits_run += len(fits)
        return TickReport(tick=inflight.tick, results=results,
                          rows_ingested=inflight.rows,
                          points_served=inflight.points,
                          ingest_done=inflight.ingest_done,
                          fits=fits)

    def tick(self) -> TickReport:
        """One synchronous tick: ``tick_finish(tick_start())``."""
        return self.tick_finish(self.tick_start())

    def run_until_idle(self, max_ticks: int = 10_000, *,
                       pipelined: bool = False,
                       depth: int = 2) -> List[QueryResult]:
        """Tick until every pending request is served; returns all results.

        ``pipelined=True`` keeps up to ``depth`` ticks in flight (bit-identical
        results and counters). On budget exhaustion raises
        :class:`TickBudgetExceeded` carrying the results that did complete.
        """
        return drain(self, max_ticks, pipelined, depth)


def report_key(rep: TickReport) -> tuple:
    """Everything a tick report says, fit results included, as plain values
    (arrays as their bytes): two runs served the same iff their reports'
    keys are equal. Reports of the JAX gateway key the same way."""
    return (rep.tick, rep.rows_ingested, rep.points_served,
            [(r.rid, r.tenant, r.status, np.asarray(r.losses).tobytes())
             for r in rep.results],
            [(i.rid, i.tenant, i.rows) for i in rep.ingest_done],
            [(f.rid, tuple(f.tenants), f.status, np.asarray(f.theta).tobytes(),
              np.asarray(f.fleet_losses).tobytes()) for f in rep.fits])


def drain(gw, max_ticks: int, pipelined: bool, depth: int
          ) -> List[QueryResult]:
    """The drain loop of both gateways (``gw.run_until_idle``)."""
    out: List[QueryResult] = []
    if pipelined:
        inflight: Deque[InflightTick] = deque()
        while gw.pending or inflight:
            while gw.pending and len(inflight) < depth and max_ticks > 0:
                inflight.append(gw.tick_start())
                max_ticks -= 1
            if not inflight:
                break  # pending traffic but no tick budget left
            out.extend(gw.tick_finish(inflight.popleft()).results)
    else:
        while gw.pending and max_ticks > 0:
            out.extend(gw.tick().results)
            max_ticks -= 1
    if gw.pending:
        raise TickBudgetExceeded(gw.pending, out)
    return out
