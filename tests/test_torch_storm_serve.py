"""The port's serving launcher (``repro_torch.launch.storm_serve``) on the
CPU: its synthetic traffic equals the reference launcher's, both loops run
to the same counts, ``--epsilon-total`` serves under a privacy policy and
``--listen`` serves the wire protocol."""

import itertools
import re
import threading
import time

import numpy as np
import pytest

from repro.launch import storm_serve as jserve
from repro_torch.launch import storm_serve

_SMALL = ["--device", "cpu", "--tenants", "3", "--dim", "4", "--rows", "32",
          "--planes", "3", "--ticks", "4", "--ingest-rate", "20",
          "--query-rate", "6", "--ingest-slots", "16", "--query-slots", "8"]


def test_synth_traffic_equals_the_reference():
    got = storm_serve.synth_traffic(np.random.default_rng(5),
                                    itertools.count(), 4, 6, 30, 9)
    want = jserve.synth_traffic(np.random.default_rng(5), itertools.count(),
                                4, 6, 30, 9)
    assert [type(r).__name__ for r in got] == [type(r).__name__ for r in want]
    assert len(got) > 4
    for a, b in zip(got, want):
        assert (a.rid, a.tenant) == (b.rid, b.tenant)
        np.testing.assert_array_equal(getattr(a, "z", None),
                                      getattr(b, "z", None))
        np.testing.assert_array_equal(getattr(a, "thetas", None),
                                      getattr(b, "thetas", None))


@pytest.mark.parametrize("extra", [
    [], ["--hot-capacity", "2"], ["--hot-capacity", "2", "--count-dtype",
                                  "int8"],
])
def test_sync_and_pipelined_loops_serve_the_same_traffic(extra, capsys):
    sync = storm_serve.main(_SMALL + extra)
    piped = storm_serve.main(_SMALL + extra + ["--pipelined"])
    for key in ("completed", "points", "rows"):
        assert sync[key] == piped[key] > 0
    assert sync["trace_count"] <= (4 if extra else 3)
    out = capsys.readouterr().out
    assert "synchronous ticks" in out and "pipelined ticks" in out
    assert ("tiered bank" in out) == bool(extra)


def test_fit_every_runs_cohort_fits(capsys):
    out = storm_serve.main(_SMALL + ["--fit-every", "2", "--fit-cohort", "2",
                                     "--fit-steps", "5"])
    assert out["fits"] == 2
    assert "cohort fits: 2 x prp_regression" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--hot-capacity", "2"]],
                         ids=["flat", "tiered"])
def test_epsilon_total_prints_the_privacy_line(extra, capsys):
    out = storm_serve.main(_SMALL + extra + ["--epsilon-total", "4.0"])
    p = out["privacy"]
    text = capsys.readouterr().out
    assert (f"privacy: laplace eps_total=4.0 eps/release=1.0 "
            f"on_exhaust=refuse -> {p['releases']} releases, "
            f"{len(p['exhausted'])} tenants exhausted, "
            f"{p['queries_refused']} queries refused") in text
    # Each release spends 1.0 of a tenant's 4.0; in the flat run some
    # tenant's reads outlive its four releases and are refused.
    assert p["releases"] > 0
    assert sum(p["spent"].values()) == float(p["releases"])
    assert all(v <= 4.0 for v in p["spent"].values())
    assert (p["queries_refused"] > 0) == (not extra)
    assert out["trace_count"] <= (5 if extra else 4)


def test_listen_answers_a_client_and_stops(capsys):
    from repro_torch.serve.wire import StormWireClient

    stop, result = threading.Event(), {}
    server = threading.Thread(target=lambda: result.update(storm_serve.main(
        _SMALL + ["--listen", "127.0.0.1:0"], stop=stop)))
    server.start()
    text, found = "", None
    deadline = time.monotonic() + 60
    while found is None and time.monotonic() < deadline:
        text += capsys.readouterr().out
        found = re.search(r"listening on 127\.0\.0\.1:(\d+)", text)
        time.sleep(0.05)
    try:
        assert found is not None, text
        client = StormWireClient("127.0.0.1", int(found.group(1)))
        rng = np.random.default_rng(1)
        client.ingest(0, 1, (0.1 * rng.normal(size=(12, 4))).astype(
            np.float32))
        assert client.recv()[0] == {"type": "ingest_ok", "rid": 0,
                                    "tenant": 1, "rows": 12}
        losses = client.query_sync(1, 1, rng.normal(size=(3, 4)).astype(
            np.float32))
        assert losses.shape == (3,) and np.isfinite(losses).all()
        client.close()
    finally:
        stop.set()
        server.join(timeout=30)
    assert not server.is_alive()
    assert result["rows"] == 12 and result["points"] == 3


def test_default_device_is_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        storm_serve.main(_SMALL[2:])
