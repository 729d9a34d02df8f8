"""No process of the benchmark holds JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import harness


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.models.model", "reprolib", "jaxtyping"],
     []),
    (["repro", "repro.core.lsh", "repro_torch"], ["repro", "repro.core.lsh"]),
    (["jax", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jaxlib.xla_client"]),
])
def test_forbidden_names_compare_whole(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_imports_no_jax():
    """Every module a run loads (the harness, each cell's loop, readers and
    reference, and the port's modules they import) in a fresh process."""
    code = (
        "import sys\n"
        "from h100_bench import harness\n"
        "spec = harness.load_spec()\n"
        "for cell in spec['workloads']:\n"
        "    mix = harness.mix_of(cell)\n"
        "    harness.loop_of(mix)\n"
        "    for m in harness.metrics_of(spec, cell['name'], 'per_layer'):\n"
        "        harness.reader_of(m['name'])\n"
        "import repro_torch.serve.storm_gateway, repro_torch.telemetry.bridge\n"
        "import repro_torch.telemetry.taps, repro_torch.models.config\n"
        "import repro_torch.core.lsh, repro_torch.core.probes\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(harness.ROOT), str(harness.ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_reference_alone_loads_no_port():
    code = ("import sys\n"
            "from h100_bench.reference import storm_ref, zamba2_ref, "
            "probe_ref\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro_torch', 'repro', 'jax')))\n")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
