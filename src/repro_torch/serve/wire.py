"""Framed wire protocol and socket front-end of the STORM gateway (port of
``repro.serve.wire``; the frames are byte for byte the reference's).

The gateway's unit of work is host numpy arrays, so the wire format is
array-first: every message is one frame

    +----------------+----------------+----------------+---------...
    | header_len u32 | payload_len u32|  JSON header   | raw array bytes
    +----------------+----------------+----------------+---------...

(big-endian length prefixes). The JSON header carries the message ``type``
and routing fields (``rid``, ``tenant``); an array payload's ``shape`` and
``dtype`` (numpy dtype string, e.g. ``"<f4"``) ride in the header and the
payload is the raw C-order bytes. Control messages (acks, errors, stats)
are JSON-only frames with ``payload_len == 0``; tiny arrays MAY instead ride
inline in the header as a ``data`` list, which the decoder accepts too.

Client -> server types: ``ingest`` / ``query`` (array-carrying), ``fit``
(JSON-only: a tenant cohort plus erm knobs), ``stats``, ``budget`` (the
per-tenant eps ledger snapshot). Server -> client types: ``result`` (query
losses; ``"stale": true`` when served from the tenant's last cached
release), ``fit_result`` (the cohort's ``(S, dim)`` thetas as the payload,
per-member ``fleet_losses`` inline; ``"stale": true`` when a member trained
from its cached release), ``ingest_ok`` (the request's last row reached the
counters), ``error`` (validation, or with ``"backpressure": true`` an
admission rejection: drain completions and retry), ``stats_reply`` (the
gateway's ``queue_stats``, with ``telemetry`` when a bridge is attached
and ``trace``, the tracer's ``summary()``, while tracing is on),
``budget_reply``, and ``budget_exceeded``: the TERMINAL refusal of an
exhausted tenant's query or fit (``"retryable": false``).

:class:`StormWireServer` runs the gateway's tick loop on one engine thread
with up to ``depth`` ticks in flight: every device operation (tick
launches, fits, the estimates' readback and its event, the pinned staging)
happens on that thread. Connection handler threads only deserialize frames
and submit to the gateway's host queues under the queue lock, so wire
deserialization, host packing and device execution of consecutive ticks
overlap. Backpressure never blocks the socket reader: an over-cap submit
turns into an ``error`` frame on the spot.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.serve.storm_gateway import (
    Backpressure, FitRequest, IngestRequest, QueryRequest, StormGateway,
)

_PREFIX = struct.Struct("!II")
_MAX_FRAME = 1 << 30  # sanity bound on header+payload (1 GiB)


class BudgetExceeded(RuntimeError):
    """Client-side view of a terminal ``budget_exceeded`` frame.

    Raised by the ``*_sync`` helpers. NOT retryable (unlike
    :class:`~repro_torch.serve.storm_gateway.Backpressure`): the tenant's
    eps budget is spent; only a ``"stale"``-policy server would keep
    serving.
    """

    def __init__(self, header: dict):
        who = header.get("tenant", header.get("tenants"))
        super().__init__(f"epsilon budget exhausted for tenant(s) {who} "
                         f"({header.get('scope', 'query')} refused)")
        self.header = header


# -- framing ----------------------------------------------------------------


def send_frame(sock: socket.socket, header: dict,
               payload: bytes = b"") -> None:
    """Serialize one message as [len(header) | len(payload) | both]."""
    body = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(_PREFIX.pack(len(body), len(payload)) + body + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[Tuple[dict, bytes]]:
    """Read one frame; ``None`` on clean EOF. Raises on a torn frame."""
    prefix = _recv_exact(sock, _PREFIX.size)
    if prefix is None:
        return None
    hlen, plen = _PREFIX.unpack(prefix)
    if hlen + plen > _MAX_FRAME:
        raise ValueError(f"frame too large: {hlen + plen} bytes")
    body = _recv_exact(sock, hlen + plen)
    if body is None:
        raise ConnectionError("peer closed mid-frame")
    return json.loads(body[:hlen]), body[hlen:]


def encode_array(header: dict, arr: np.ndarray) -> bytes:
    """Attach ``arr``'s shape/dtype to ``header``; return payload bytes."""
    arr = np.ascontiguousarray(arr)
    header["shape"] = list(arr.shape)
    header["dtype"] = arr.dtype.str
    return arr.tobytes()


def decode_array(header: dict, payload: bytes) -> np.ndarray:
    """Recover the array from a frame — raw payload or inline ``data``."""
    if payload:
        return np.frombuffer(payload, dtype=np.dtype(header["dtype"])
                             ).reshape(header["shape"]).copy()
    return np.asarray(header["data"], np.float32)


# -- server -----------------------------------------------------------------


class StormWireServer:
    """Socket front-end running the pipelined gateway engine.

    One engine thread owns the tick loop (``tick_start``/``tick_finish``
    with up to ``depth`` ticks in flight) and with it every CUDA call; one
    handler thread per connection deserializes frames and submits requests
    (host queues only). ``lock`` guards the gateway queues (submit against
    pack); the readback wait runs OUTSIDE the lock, so accepting new
    traffic overlaps the device. ``gateway`` is a flat or tiered gateway
    (``submit``, ``pending``, ``tick_start``, ``tick_finish``,
    ``queue_stats``).
    """

    def __init__(self, gateway: StormGateway, host: str = "127.0.0.1",
                 port: int = 0, *, depth: int = 2,
                 idle_sleep_s: float = 0.0002, telemetry=None):
        self.gateway = gateway
        self.telemetry = telemetry  # a TelemetryBridge: joins the stats frame
        self.depth = depth
        self.idle_sleep_s = idle_sleep_s
        self._lock = threading.Lock()  # gateway queues + owner table
        self._owners: Dict[int, "_Conn"] = {}  # rid -> submitting conn
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port))
        self._threads = []

    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()[:2]

    def start(self) -> "StormWireServer":
        for target in (self._accept_loop, self._engine_loop):
            th = threading.Thread(target=target, daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # close() alone leaves the accept thread blocked in accept()
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for th in self._threads:
            th.join(timeout=5)

    # -- engine thread ------------------------------------------------------

    def _engine_loop(self) -> None:
        gw = self.gateway
        inflight = deque()
        while not self._stop.is_set():
            with self._lock:
                while gw.pending and len(inflight) < self.depth:
                    inflight.append(gw.tick_start())
            if not inflight:
                time.sleep(self.idle_sleep_s)
                continue
            report = gw.tick_finish(inflight.popleft())
            self._route(report)

    def _route(self, report) -> None:
        for res in report.results:
            if res.status == "refused":
                # Terminal, not retryable: the tenant's eps budget is spent.
                self._reply(res.rid, {"type": "budget_exceeded",
                                      "rid": res.rid, "tenant": res.tenant,
                                      "scope": "query", "retryable": False})
                continue
            header = {"type": "result", "rid": res.rid, "tenant": res.tenant}
            if res.status == "stale":
                header["stale"] = True
            self._reply(res.rid, header, res.losses)
        for ing in report.ingest_done:
            self._reply(ing.rid, {"type": "ingest_ok", "rid": ing.rid,
                                  "tenant": ing.tenant, "rows": ing.rows})
        for fit in report.fits:
            if fit.status == "refused":
                self._reply(fit.rid, {"type": "budget_exceeded",
                                      "rid": fit.rid,
                                      "tenants": fit.tenants,
                                      "scope": "fit", "retryable": False})
                continue
            header = {"type": "fit_result", "rid": fit.rid,
                      "tenants": fit.tenants,
                      "fleet_losses": fit.fleet_losses.tolist()}
            if fit.status == "stale":
                header["stale"] = True
            self._reply(fit.rid, header, fit.theta)

    def _reply(self, rid: int, header: dict,
               arr: Optional[np.ndarray] = None) -> None:
        with self._lock:
            conn = self._owners.pop(rid, None)
        if conn is not None:
            conn.send(header, arr)

    # -- connection handlers ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            th = threading.Thread(target=self._serve_conn,
                                  args=(_Conn(sock),), daemon=True)
            th.start()
            self._threads.append(th)

    def _serve_conn(self, conn: "_Conn") -> None:
        try:
            while not self._stop.is_set():
                frame = recv_frame(conn.sock)
                if frame is None:
                    return
                self._handle(conn, *frame)
        except (ConnectionError, OSError, ValueError):
            return
        finally:
            conn.close()

    def _handle(self, conn: "_Conn", header: dict, payload: bytes) -> None:
        kind = header.get("type")
        rid = header.get("rid")
        if kind == "stats":
            with self._lock:
                stats = self.gateway.queue_stats()
                if self.telemetry is not None:
                    stats["telemetry"] = self.telemetry.telemetry_stats()
            if tracing.on():
                stats["trace"] = tracing.summary()
            conn.send({"type": "stats_reply", "rid": rid, "stats": stats})
            return
        if kind == "budget":
            # JSON-only: the eps ledger snapshot (None when the gateway
            # runs without a finite privacy policy).
            with self._lock:
                budget = self.gateway.queue_stats().get("privacy")
            conn.send({"type": "budget_reply", "rid": rid, "budget": budget})
            return
        if kind == "fit":
            # JSON-only frame: cohort + erm knobs, no array payload.
            try:
                req = FitRequest(
                    rid=rid,
                    tenants=[int(t) for t in header["tenants"]],
                    surrogate=header.get("surrogate", "prp_regression"),
                    seed=int(header.get("seed", 0)),
                    restarts=int(header.get("restarts", 1)),
                    l2=float(header.get("l2", 0.0)),
                    steps=int(header.get("steps", 100)),
                    num_queries=int(header.get("num_queries", 8)),
                    sigma=float(header.get("sigma", 0.5)),
                    learning_rate=float(header.get("learning_rate", 1.0)),
                    decay=float(header.get("decay", 0.995)),
                    refine_steps=(None if header.get("refine_steps") is None
                                  else int(header["refine_steps"])),
                )
                with self._lock:
                    self.gateway.submit(req)
                    self._owners[rid] = conn
            except (KeyError, TypeError, ValueError) as e:
                conn.send({"type": "error", "rid": rid, "error": str(e),
                           "backpressure": False})
            return
        if kind not in ("ingest", "query"):
            conn.send({"type": "error", "rid": rid,
                       "error": f"unknown message type {kind!r}",
                       "backpressure": False})
            return
        try:
            arr = decode_array(header, payload)
            tenant = int(header["tenant"])
            req = (IngestRequest(rid=rid, tenant=tenant, z=arr)
                   if kind == "ingest"
                   else QueryRequest(rid=rid, tenant=tenant, thetas=arr))
            with self._lock:
                self.gateway.submit(req)
                self._owners[rid] = conn
        except Backpressure as e:
            conn.send({"type": "error", "rid": rid, "error": str(e),
                       "backpressure": True, "tenant": e.tenant,
                       "kind": e.kind, "limit": e.limit})
        except (KeyError, TypeError, ValueError) as e:
            conn.send({"type": "error", "rid": rid, "error": str(e),
                       "backpressure": False})


class _Conn:
    """A client connection with serialized sends (engine + handler threads
    both write to it)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._wlock = threading.Lock()

    def send(self, header: dict, arr: Optional[np.ndarray] = None) -> None:
        payload = b"" if arr is None else encode_array(header, arr)
        try:
            with self._wlock:
                send_frame(self.sock, header, payload)
        except (ConnectionError, OSError):
            pass  # peer vanished; its results are simply dropped

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# -- client -----------------------------------------------------------------


class StormWireClient:
    """Minimal client: non-blocking submits + a blocking ``recv`` of the
    next server frame (the closed-loop load generator's interface). For
    strict request/response usage see :meth:`query_sync`.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def ingest(self, rid: int, tenant: int, z: np.ndarray) -> None:
        header = {"type": "ingest", "rid": rid, "tenant": tenant}
        payload = encode_array(header, np.asarray(z, np.float32))
        send_frame(self.sock, header, payload)

    def query(self, rid: int, tenant: int, thetas: np.ndarray) -> None:
        header = {"type": "query", "rid": rid, "tenant": tenant}
        payload = encode_array(header, np.asarray(thetas, np.float32))
        send_frame(self.sock, header, payload)

    def fit(self, rid: int, tenants, surrogate: str = "prp_regression",
            **knobs) -> None:
        """Ask the gateway to train ``tenants`` from their served counters.

        ``knobs`` pass through to the server-side ``FitRequest`` (``seed``,
        ``restarts``, ``l2``, ``steps``, ``num_queries``, ``sigma``,
        ``learning_rate``, ``decay``, ``refine_steps``).
        """
        header = {"type": "fit", "rid": rid,
                  "tenants": [int(t) for t in tenants],
                  "surrogate": surrogate, **knobs}
        send_frame(self.sock, header)

    def recv(self) -> Tuple[dict, Optional[np.ndarray]]:
        """Next server frame as (header, array-or-None); blocks."""
        frame = recv_frame(self.sock)
        if frame is None:
            raise ConnectionError("server closed the connection")
        header, payload = frame
        arr = (decode_array(header, payload)
               if header["type"] in ("result", "fit_result") else None)
        return header, arr

    def fit_sync(self, rid: int, tenants, surrogate: str = "prp_regression",
                 **knobs) -> Tuple[np.ndarray, np.ndarray]:
        """Submit one fit and block for ITS result: ``(theta, fleet_losses)``
        with row i belonging to ``tenants[i]`` (single-threaded use: raises
        if an unrelated frame arrives first)."""
        self.fit(rid, tenants, surrogate, **knobs)
        header, arr = self.recv()
        if header["type"] == "error":
            raise RuntimeError(header["error"])
        if header["type"] == "budget_exceeded":
            raise BudgetExceeded(header)
        if header.get("rid") != rid or header["type"] != "fit_result":
            raise RuntimeError(f"out-of-order reply {header}")
        return arr, np.asarray(header["fleet_losses"], np.float32)

    def query_sync(self, rid: int, tenant: int,
                   thetas: np.ndarray) -> np.ndarray:
        """Submit one query and block for ITS losses (single-threaded use:
        raises if an unrelated frame arrives first)."""
        self.query(rid, tenant, thetas)
        header, arr = self.recv()
        if header["type"] == "error":
            raise RuntimeError(header["error"])
        if header["type"] == "budget_exceeded":
            raise BudgetExceeded(header)
        if header.get("rid") != rid:
            raise RuntimeError(f"out-of-order reply {header}")
        return arr

    def stats(self) -> dict:
        send_frame(self.sock, {"type": "stats", "rid": -1})
        header, _ = self.recv()
        while header["type"] != "stats_reply":
            header, _ = self.recv()
        return header["stats"]

    def budget(self) -> Optional[dict]:
        """The server's eps-ledger snapshot: per-tenant ``spent`` /
        ``remaining`` (``None`` entries mean unlimited) plus the policy
        echo. Returns ``None`` when the gateway has no finite privacy
        policy. Single-threaded use, like :meth:`stats`."""
        send_frame(self.sock, {"type": "budget", "rid": -2})
        header, _ = self.recv()
        while header["type"] != "budget_reply":
            header, _ = self.recv()
        return header["budget"]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
