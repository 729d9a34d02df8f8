#!/usr/bin/env python3
"""Record the JAX package's outputs that the port's tests compare with.

    PYTHONPATH=src python3 scripts/reference_outputs.py

Writes ``tests/reference_outputs.json``: what
``examples/{quickstart,serve_storm,logistic_edge,private_serving}.py``
print, and ``launch/hlo_analysis.py``'s FLOPs of the smoke prefill of every
architecture that takes tokens and of qwen2-7b's smoke train step (batch
2, sequence 64), all under a digest of the JAX package's sources, the
example scripts and the versions of jax, jaxlib and numpy.
``tests/test_torch_examples.py`` and ``tests/test_torch_op_analysis.py``
read the file while the digest matches, and run the reference themselves
when it does not.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_parity  # noqa: E402
from repro.configs import registry  # noqa: E402

TRAIN_ARCHS = ("qwen2-7b",)


def main() -> int:
    outputs = torch_parity.run_reference_examples(threads_each=2)
    flops = {}
    for arch in registry.ARCH_IDS:
        if not registry.get_config(arch, smoke=True).embeddings_provided:
            flops[f"prefill|{arch}"] = torch_parity.jax_prefill_flops(arch)
    for arch in TRAIN_ARCHS:
        flops[f"train|{arch}"] = torch_parity.jax_train_step_flops(arch)
    torch_parity.REFERENCE_OUTPUTS.write_text(json.dumps(
        {"key": torch_parity.reference_key(), "examples": outputs,
         "flops": flops}, indent=1, sort_keys=True) + "\n")
    print(f"wrote {torch_parity.REFERENCE_OUTPUTS.relative_to(ROOT)}: "
          f"{len(outputs)} examples, {len(flops)} counts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
