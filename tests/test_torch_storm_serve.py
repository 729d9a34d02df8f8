"""The port's serving launcher (``repro_torch.launch.storm_serve``) on the
CPU: its synthetic traffic equals the reference launcher's, both loops run
to the same counts, and the options of later slices refuse to run."""

import itertools

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


@pytest.mark.parametrize("flag,slice_name", [
    (["--listen", "127.0.0.1:0"], "wire"),
    (["--epsilon-total", "4.0"], "privacy"),
])
def test_later_slices_exit_with_an_error(flag, slice_name, capsys):
    with pytest.raises(SystemExit) as ei:
        storm_serve.main(_SMALL + flag)
    assert ei.value.code != 0
    assert f"the {slice_name} slice" in capsys.readouterr().err


def test_default_device_is_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        storm_serve.main(_SMALL[2:])
