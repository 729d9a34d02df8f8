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
    for name in ("repro_torch.core.regression",
                 "repro_torch.core.classification",
                 "repro_torch.core.tiered",
                 "repro_torch.kernels.storm_sketch",
                 "repro_torch.kernels.sketch_query",
                 "repro_torch.kernels.srp_hash",
                 "repro_torch.serve.storm_gateway",
                 "repro_torch.serve.tiered_gateway",
                 "repro_torch.serve.wire",
                 "repro_torch.core.privacy",
                 "repro_torch.launch.storm_serve",
                 "repro_torch.core.distributed",
                 "repro_torch.sharding.mesh",
                 "repro_torch.sharding.specs",
                 "repro_torch.sharding.constraints",
                 "repro_torch.sharding.pipeline",
                 "repro_torch.launch.mesh",
                 "repro_torch.train.compression",
                 "repro_torch.models.config",
                 "repro_torch.models.layers",
                 "repro_torch.models.attention",
                 "repro_torch.models.model",
                 "repro_torch.models.ssm",
                 "repro_torch.models.moe",
                 "repro_torch.configs.registry",
                 "repro_torch.configs.qwen2_7b",
                 "repro_torch.core.probes",
                 "repro_torch.serve.engine",
                 "repro_torch.launch.serve",
                 "repro_torch.telemetry",
                 "repro_torch.telemetry.taps",
                 "repro_torch.telemetry.bridge",
                 "repro_torch.telemetry.monitor",
                 "repro_torch.launch.op_analysis",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.roofline",
                 "repro_torch.examples.quickstart",
                 "repro_torch.examples.serve_storm",
                 "repro_torch.examples.logistic_edge",
                 "repro_torch.examples.private_serving",
                 "repro_torch.examples.edge_regression",
                 "repro_torch.examples.serve_lm",
                 "repro_torch.examples.train_lm"):
        assert name in report["modules"]
        assert name in report["loaded"]
    leaked = [m for m in report["loaded"]
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert leaked == []
