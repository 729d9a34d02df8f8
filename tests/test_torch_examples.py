"""The seven examples of ``repro_torch.examples`` on the CPU, each against
its own checks and, where the reference's ``examples/*.py`` prints the same
thing, against the reference's output.

The reference examples' output comes from
``torch_parity.reference_example_outputs``: recorded in
``tests/reference_outputs.json`` by ``scripts/reference_outputs.py``
under a digest of the JAX package's sources, the scripts and the versions
of jax, jaxlib and numpy, and printed anew by running the four scripts
whenever that digest changes. Compared exactly where the output does not
depend on the draws (threefry streams cannot be reproduced in torch): the
refusal round, the ledger and the releases of ``private_serving``,
``trace_count`` of ``logistic_edge`` and ``serve_storm`` (and the latter's
ticks, rows and points), the sketch size in bytes of ``quickstart``. The
quality examples are held to bars that the test checks on the reference's
printed numbers too, so that each bar is one the reference meets:
quickstart's STORM MSE
below 0.6 var(y) (the registry path's below 0.6 var(ys)) and its cosine
to OLS above 0.5; every served tenant's MSE below 0.8 var(y); every
logistic accuracy above 0.8. ``edge_regression`` needs 8 XLA host devices
at import, so it is held to its own bar only (MSE below 0.6 var(ys), the
private query within 0.1 of the exact one (about six standard
deviations of its noise)).
"""

import re

import pytest

from repro_torch.examples import (edge_regression, logistic_edge,
                                  private_serving, quickstart, serve_lm,
                                  serve_storm, train_lm)
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import reference_example_outputs

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def reference():
    return reference_example_outputs()


def _floats(pattern, text):
    return [float(m) for m in re.findall(pattern, text)]


def test_edge_regression():
    out = edge_regression.main(CPU)
    assert (out["devices"], out["n"]) == (8, 4096)
    assert out["bytes"] == 2048 * 16 * 4 + 4
    assert out["mse"] < 0.6 * out["var_ys"]
    assert abs(out["private"] - out["exact"]) < 0.1


def test_serve_lm():
    out = serve_lm.main(CPU + ["--requests", "6", "--slots", "4"])
    assert out["completed"] == list(range(6))
    assert all(len(t) == 16 for t in out["tokens"].values())
    assert out["new_tokens"] == 6 * 16


# The preset's lr (3e-4 over 20 steps) moves the loss by less than its
# batch-to-batch noise; at 1e-2 the last five steps' mean falls clear of
# the first five's.
SMOKE_TRAIN = ["--smoke", "--lr", "1e-2"]


def test_train_lm_falls_and_resumes(tmp_path):
    whole = train_lm.main(CPU + SMOKE_TRAIN + ["--ckpt-dir",
                                               str(tmp_path / "whole")])
    assert whole["steps_run"] == 20 and whole["resumed_from"] is None
    losses = whole["losses"]
    assert whole["final_loss"] < whole["first5"]
    assert sum(losses[-5:]) < sum(losses[:5])
    cut = str(tmp_path / "cut")
    first = train_lm.main(CPU + SMOKE_TRAIN + ["--stop-after", "10",
                                               "--ckpt-dir", cut])
    resumed = train_lm.main(CPU + SMOKE_TRAIN + ["--ckpt-dir", cut])
    assert first["steps_run"] == 10
    assert (resumed["resumed_from"], resumed["steps_run"]) == (10, 10)
    # restart-replay is exact: the same losses as the uninterrupted run
    assert first["losses"] + resumed["losses"] == losses
    assert resumed["restores"] == 0


def _quickstart_bar(storm_mse, var_y, generic_mse, var_ys, cos):
    assert storm_mse < 0.6 * var_y
    assert generic_mse < 0.6 * var_ys
    assert cos > 0.5


def test_logistic_edge(reference):
    out = logistic_edge.main(CPU)
    ref = reference["logistic_edge"]
    for acc in out["local_accuracy"] + out["gateway_accuracy"]:
        assert acc > 0.8
    ref_acc = _floats(r"logistic accuracy ([\d.]+)", ref)
    assert len(ref_acc) == 6 and min(ref_acc) > 0.8
    traced = re.search(r"traced (\d+)x", ref)
    assert out["trace_count"] == int(traced.group(1)) == 1


def test_private_serving(reference):
    out = private_serving.main(CPU)
    ref = reference["private_serving"]
    refused = re.search(r"round (\d+): TERMINAL .*\(retryable=(\w+)\)", ref)
    assert out["refused_at"] == int(refused.group(1)) == 5
    assert str(out["retryable"]) == refused.group(2) == "False"
    spent = _floats(r"spent ([\d.]+)  remaining", ref)
    assert [r["spent"] for r in out["rounds"]] == spent == [1, 2, 3, 4]
    final = (f"final ledger: spent={out['spent']} exhausted="
             f"{out['exhausted']} ({out['releases']} releases served)")
    assert final in ref.splitlines()


def test_serve_storm(capsys, reference):
    out = serve_storm.main(CPU)
    printed = capsys.readouterr().out
    ref = reference["serve_storm"]
    assert out["same_counters"]
    assert "served counters == standalone sketch_dataset: True" in ref
    # ticks, rows, points and traced programs do not depend on the draws
    head = next(x for x in ref.splitlines() if x.startswith("gateway:"))
    assert head in printed.splitlines()
    assert (out["ticks"], out["rows_ingested"], out["points_served"],
            out["trace_count"]) == (4, 4096, 4, 2)
    for mse, var in zip(out["mse"], out["var_y"]):
        assert mse < 0.8 * var
    ref_fits = re.findall(r"MSE from served sketch = ([\d.]+) \(var y = "
                          r"([\d.]+)\)", ref)
    assert len(ref_fits) == 4
    for mse, var in ref_fits:
        assert float(mse) < 0.8 * float(var)


def test_quickstart(capsys, reference):
    out = quickstart.main(CPU)
    printed = capsys.readouterr().out
    ref = reference["quickstart"]
    _quickstart_bar(out["storm_mse"], out["var_y"], out["generic_mse"],
                    out["var_ys"], out["cos"])
    generic, var_ys = re.search(
        r"registry-path MSE .*: ([\d.]+) \(var ys = ([\d.]+)\)",
        ref).groups()
    _quickstart_bar(_floats(r"STORM    train MSE: ([\d.]+)", ref)[0],
                    _floats(r"variance of y:      ([\d.]+)", ref)[0],
                    float(generic), float(var_ys),
                    _floats(r"cos\(theta_storm, theta_ols\): ([\d.]+)",
                            ref)[0])
    for line in ("registered surrogates:", "sketch size:", "dataset size:"):
        want = next(x for x in ref.splitlines() if x.startswith(line))
        assert want in printed.splitlines()
    assert out["sketch_bytes"] == 131072
