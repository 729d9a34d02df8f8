"""The port stands alone: importing all of ``repro_torch`` and ``chip_smoke``
loads neither JAX nor the ``repro`` package."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True, timeout=120)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.regression" in report["modules"]
    assert "repro_torch.kernels.storm_sketch" in report["modules"]
    leaked = [m for m in report["loaded"]
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert leaked == []
