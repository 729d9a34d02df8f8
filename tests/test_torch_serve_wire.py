"""The port's wire front-end (``repro_torch.serve.wire``) against
``repro.serve.wire`` (mirrors ``tests/test_serve_wire.py``).

Besides the reference's contracts (arrays round-trip bit for bit, torn
frames fail loudly, a loopback server answers as the in-process gateway
does, backpressure is an error frame on a live connection, results route to
the submitting connection, synthetic rids never collide), the frames are
byte-identical between the packages in both directions: the JAX client
drives the port's server and the port's client drives the JAX server
(``mode="ref"``, whose answers equal the port's on the CPU), and the raw
bytes each side writes for the same message are equal.
"""

import itertools
import socket
import struct

import numpy as np
import pytest

from repro.core import privacy as jprivacy
from repro.serve import storm_gateway as jgw
from repro.serve import wire as jwire
from repro_torch import tracing
from repro_torch.core.privacy import ReleasePolicy
from repro_torch.launch.storm_serve import synth_traffic
from repro_torch.serve.storm_gateway import (
    IngestRequest, QueryRequest, StormGateway,
)
from repro_torch.serve.wire import (
    StormWireClient, StormWireServer, decode_array, encode_array,
    recv_frame, send_frame,
)
from torch_parity import CPU, jax_params

S = 4
D = 5


@pytest.fixture(scope="module")
def hashes():
    return jax_params(0, 64, 3, D + 2)


def _port_server(hashes, **gw_kwargs):
    gw = StormGateway(hashes[1], S, query_slots=4, ingest_slots=16,
                      device=CPU, **gw_kwargs)
    return StormWireServer(gw, port=0).start(), gw


def _jax_server(hashes, **gw_kwargs):
    gw = jgw.StormGateway(hashes[0], S, query_slots=4, ingest_slots=16,
                          mode="ref", **gw_kwargs)
    return jwire.StormWireServer(gw, port=0).start(), gw


def _rows(seed, n=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)) * 0.3).astype(np.float32)


def _theta(seed, n=3):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


class TestFraming:
    def test_array_frame_round_trip(self):
        a, b = socket.socketpair()
        arr = np.arange(12, dtype=np.float32).reshape(3, 4) * 0.5
        header = {"type": "query", "rid": 7, "tenant": 2}
        send_frame(a, header, encode_array(header, arr))
        got_header, payload = recv_frame(b)
        assert got_header["rid"] == 7 and got_header["shape"] == [3, 4]
        np.testing.assert_array_equal(decode_array(got_header, payload), arr)
        a.close()
        b.close()

    def test_inline_data_accepted(self):
        arr = decode_array({"type": "query", "data": [[1.0, 2.0], [3.0, 4.0]]},
                           b"")
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr, [[1, 2], [3, 4]])

    def test_clean_eof_is_none_torn_frame_raises(self):
        a, b = socket.socketpair()
        a.close()
        assert recv_frame(b) is None
        b.close()
        a, b = socket.socketpair()
        a.sendall(struct.pack("!II", 20, 0))  # promises 20 bytes ...
        a.close()  # ... that never arrive
        with pytest.raises(ConnectionError):
            recv_frame(b)
        b.close()

    def test_oversize_frame_rejected(self):
        a, b = socket.socketpair()
        a.sendall(struct.pack("!II", 1 << 31, 0))
        with pytest.raises(ValueError, match="frame too large"):
            recv_frame(b)
        a.close()
        b.close()

    def test_frames_decode_across_packages(self):
        """A frame the port writes, JAX reads, and the other way round."""
        arr = np.arange(10, dtype=np.float32).reshape(2, 5) / 3
        for send, recv, dec in ((send_frame, jwire.recv_frame,
                                 jwire.decode_array),
                                (jwire.send_frame, recv_frame, decode_array)):
            a, b = socket.socketpair()
            header = {"type": "result", "rid": 3, "tenant": 1}
            send(a, header, encode_array(header, arr))
            h, payload = recv(b)
            np.testing.assert_array_equal(dec(h, payload), arr)
            a.close()
            b.close()


def _client_bytes(client_cls, call):
    """The raw bytes a client writes for ``call(client)``, read off a
    socketpair (no server)."""
    a, b = socket.socketpair()
    client = object.__new__(client_cls)
    client.sock = a
    call(client)
    a.close()
    chunks = []
    while True:
        chunk = b.recv(1 << 16)
        if not chunk:
            break
        chunks.append(chunk)
    b.close()
    return b"".join(chunks)


@pytest.mark.parametrize("call", [
    lambda c: c.ingest(0, 1, _rows(1)),
    lambda c: c.query(5, 2, _theta(2)),
    lambda c: c.fit(9, [0, 3], steps=7, seed=2, sigma=0.25),
    lambda c: c.fit(10, (1,), surrogate="prp_regression", refine_steps=None),
], ids=["ingest", "query", "fit", "fit-defaults"])
def test_client_frames_are_byte_identical(call):
    assert _client_bytes(StormWireClient, call) == \
        _client_bytes(jwire.StormWireClient, call)


def _exchange(address, frames):
    """Send each frame on one raw connection and read back the raw reply
    frames, in order (each frame gets exactly one reply)."""
    sock = socket.create_connection(address, timeout=30)
    replies = []
    try:
        for header, arr in frames:
            payload = b"" if arr is None else jwire.encode_array(header, arr)
            jwire.send_frame(sock, header, payload)
            prefix = jwire._recv_exact(sock, 8)
            hlen, plen = struct.unpack("!II", prefix)
            replies.append(prefix + jwire._recv_exact(sock, hlen + plen))
    finally:
        sock.close()
    return replies


def test_server_replies_are_byte_identical(hashes):
    """The same frames to the port's server and to the JAX server: the
    same bytes back (acks, results, errors, budget)."""
    frames = [
        ({"type": "ingest", "rid": 0, "tenant": 1}, _rows(5)),
        ({"type": "query", "rid": 1, "tenant": 1}, _theta(6)),
        ({"type": "query", "rid": 2, "tenant": 3}, _theta(7, 6)),
        ({"type": "ingest", "rid": 3, "tenant": 0}, np.zeros((64, D),
                                                            np.float32)),
        ({"type": "query", "rid": 4, "tenant": S + 5}, _theta(8)),
        ({"type": "bogus", "rid": 5}, None),
        ({"type": "budget", "rid": 6}, None),
    ]
    out = []
    for make in (_port_server, _jax_server):
        server, _ = make(hashes, max_pending_rows=32)
        try:
            out.append(_exchange(server.address, frames))
        finally:
            server.stop()
    assert out[0] == out[1]
    assert b'"backpressure":true' in out[0][3]


def test_private_server_replies_are_byte_identical(hashes):
    """Under the same finite policy and seed: the same release, the same
    terminal refusal and the same budget frame, byte for byte. The one
    result's estimates come from a float table, which JAX sums in f32 and
    the port in float64: its header is byte-identical, its values within
    ``R * 2^-23 * max|release| / (2n) + 2^-22 |est|``."""
    frames = [
        ({"type": "ingest", "rid": 0, "tenant": 0}, _rows(9, 8)),
        ({"type": "query", "rid": 1, "tenant": 0}, _theta(1)),
        ({"type": "ingest", "rid": 2, "tenant": 0}, _rows(10, 4)),
        ({"type": "query", "rid": 3, "tenant": 0}, _theta(2)),
        ({"type": "budget", "rid": 4}, None),
    ]
    out, gws = [], []
    for make, pol in ((_port_server, ReleasePolicy(epsilon_total=1.0)),
                      (_jax_server,
                       jprivacy.ReleasePolicy(epsilon_total=1.0))):
        server, gw = make(hashes, privacy=pol, privacy_seed=7)
        gws.append(gw)
        try:
            out.append(_exchange(server.address, frames))
        finally:
            server.stop()
    assert out[0][:1] + out[0][2:] == out[1][:1] + out[1][2:]
    assert b'"type":"budget_exceeded"' in out[0][3]
    got, want = out[0][1], out[1][1]
    assert got[:-12] == want[:-12]  # prefix and header; 3 f32 follow
    got = np.frombuffer(got[-12:], np.float32).astype(np.float64)
    want = np.frombuffer(want[-12:], np.float32).astype(np.float64)
    release = gws[0]._release[0].numpy()
    np.testing.assert_array_equal(release, np.asarray(gws[1]._release_buf[0]))
    bound = 64 * 2.0 ** -23 * np.abs(release).max() / 16 + 2.0 ** -22 * \
        np.abs(got)
    assert np.all(np.abs(got - want) <= bound)


class TestLoopback:
    def test_wire_matches_inprocess_bit_for_bit(self, hashes):
        z, th = _rows(5), _theta(5)
        ref = StormGateway(hashes[1], S, query_slots=4, ingest_slots=16,
                           device=CPU)
        ref.submit(IngestRequest(rid=0, tenant=1, z=z))
        ref.tick()
        ref.submit(QueryRequest(rid=1, tenant=1, thetas=th))
        want = ref.run_until_idle()[0].losses
        server, gw = _port_server(hashes)
        client = StormWireClient(*server.address)
        try:
            client.ingest(0, 1, z)
            header, _ = client.recv()
            assert header["type"] == "ingest_ok"
            assert (header["rid"], header["rows"]) == (0, 11)
            np.testing.assert_array_equal(client.query_sync(1, 1, th), want)
            assert gw.trace_count <= 3
        finally:
            client.close()
            server.stop()

    @pytest.mark.parametrize("direction", ["jax-client", "port-client"])
    def test_clients_and_servers_interoperate(self, hashes, direction):
        """Each package's client against the other's server: the answers
        equal the in-process port gateway's."""
        z, th = _rows(3, 30), _theta(4, 5)
        ref = StormGateway(hashes[1], S, query_slots=4, ingest_slots=16,
                           device=CPU)
        ref.submit(IngestRequest(rid=0, tenant=2, z=z))
        ref.tick()
        ref.submit(QueryRequest(rid=1, tenant=2, thetas=th))
        want = ref.run_until_idle()[0].losses
        if direction == "jax-client":
            (server, _), client_cls = _port_server(hashes), jwire.StormWireClient
        else:
            (server, _), client_cls = _jax_server(hashes), StormWireClient
        client = client_cls(*server.address)
        try:
            client.ingest(0, 2, z)
            assert client.recv()[0]["type"] == "ingest_ok"
            np.testing.assert_array_equal(client.query_sync(1, 2, th), want)
            theta, losses = client.fit_sync(2, [2, 0], steps=5)
            assert theta.shape == (2, D) and losses.shape == (2, 1)
            assert np.isfinite(theta).all()
            stats = client.stats()
            assert stats["rows_ingested"] == 30 and stats["fits_run"] == 1
            assert client.budget() is None
        finally:
            client.close()
            server.stop()

    def test_backpressure_error_frame_connection_survives(self, hashes):
        server, _ = _port_server(hashes, max_pending_rows=8)
        client = StormWireClient(*server.address)
        try:
            client.ingest(0, 0, np.zeros((64, D), np.float32))
            header, _ = client.recv()
            assert header["type"] == "error" and header["backpressure"] is True
            assert (header["tenant"], header["kind"]) == (0, "ingest")
            client.ingest(1, 0, np.zeros((8, D), np.float32))
            header, _ = client.recv()
            assert (header["type"], header["rid"]) == ("ingest_ok", 1)
        finally:
            client.close()
            server.stop()

    def test_validation_error_is_not_backpressure(self, hashes):
        server, _ = _port_server(hashes)
        client = StormWireClient(*server.address)
        try:
            client.query(0, S + 5, np.zeros((2, D), np.float32))
            header, _ = client.recv()
            assert header["type"] == "error"
            assert header["backpressure"] is False
            send_frame(client.sock, {"type": "bogus", "rid": 1})
            header, _ = client.recv()
            assert "unknown message type" in header["error"]
        finally:
            client.close()
            server.stop()

    def test_results_route_to_submitting_connection(self, hashes):
        server, _ = _port_server(hashes)
        c1 = StormWireClient(*server.address)
        c2 = StormWireClient(*server.address)
        try:
            th = [_theta(20 + i, 2) for i in range(4)]
            c1.query(10, 0, th[0])
            c2.query(20, 1, th[1])
            c1.query(11, 2, th[2])
            c2.query(21, 3, th[3])
            assert sorted(c1.recv()[0]["rid"] for _ in range(2)) == [10, 11]
            assert sorted(c2.recv()[0]["rid"] for _ in range(2)) == [20, 21]
        finally:
            c1.close()
            c2.close()
            server.stop()

    def test_stats_over_the_wire(self, hashes):
        """The stats frame; while tracing is on it carries the tracer's
        summary as ``trace``."""
        server, _ = _port_server(hashes)
        client = StormWireClient(*server.address)
        try:
            client.ingest(0, 0, np.ones((4, D), np.float32) * 0.1)
            assert client.recv()[0]["type"] == "ingest_ok"
            stats = client.stats()
            assert stats["tenants"] == S and stats["rows_ingested"] == 4
            assert stats["trace_count"] <= 3
            assert stats["pending_depth"] == [0] * S
            assert "trace" not in stats
            tracing.reset()
            tracing.enable()
            client.ingest(1, 2, np.ones((3, D), np.float32) * 0.1)
            assert client.recv()[0]["type"] == "ingest_ok"
            trace = client.stats()["trace"]
            assert trace["spans"]["gateway.tick_start"]["count"] >= 1
            assert trace["spans"]["gateway.queue_wait"]["count"] == 1
            assert trace["counters"]["gateway.rows_packed"] == 3
            assert trace["dropped"] == 0
        finally:
            tracing.disable()
            tracing.reset()
            client.close()
            server.stop()


class TestSynthTrafficRids:
    def test_rids_unique_at_500_plus_tenants(self):
        rng = np.random.default_rng(0)
        rids = itertools.count()
        seen = set()
        for _ in range(3):
            for req in synth_traffic(rng, rids, tenants=600, dim=4,
                                     ingest_rate=1, query_rate=1):
                assert req.rid not in seen
                seen.add(req.rid)
        assert len(seen) > 1000
