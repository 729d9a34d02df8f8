"""Architecture registry + assigned input shapes.

Every assigned architecture is selectable by id (``--arch <id>``); each id
maps to its exact published config and a reduced same-family smoke config.

Shapes (LM family, per the assignment):
  * train_4k:     seq 4,096 x global batch 256    -> train_step
  * prefill_32k:  seq 32,768 x global batch 32    -> prefill_step
  * decode_32k:   KV len 32,768 x global batch 128 -> serve_step (1 token)
  * long_500k:    KV len 524,288 x global batch 1  -> serve_step (1 token),
                  run only for sub-quadratic-decode architectures
                  (skip list + rationale in DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs import (
    gemma3_1b,
    llama3_405b,
    llama32_vision_11b,
    mixtral_8x22b,
    musicgen_medium,
    nemotron_3_nano_30b_a3b,
    phi35_moe,
    qwen2_7b,
    qwen3_32b,
    xlstm_1_3b,
    zamba2_2_7b,
)
from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2-7b": qwen2_7b,
    "gemma3-1b": gemma3_1b,
    "llama3-405b": llama3_405b,
    "qwen3-32b": qwen3_32b,
    "xlstm-1.3b": xlstm_1_3b,
    "zamba2-2.7b": zamba2_2_7b,
    "mixtral-8x22b": mixtral_8x22b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "musicgen-medium": musicgen_medium,
    "llama-3.2-vision-11b": llama32_vision_11b,
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)

# The port's own configurations: the JAX package has no counterpart, so they
# stay out of ARCH_IDS, which mirrors its registry, and out of the dry run's
# cells. ``get_config`` serves them as any other.
_PORT_MODULES = {
    "nemotron-3-nano-30b-a3b": nemotron_3_nano_30b_a3b,
}
PORT_ARCH_IDS: Tuple[str, ...] = tuple(_PORT_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Architectures with sub-quadratic decode state (DESIGN.md §4). All others
# skip long_500k (pure full attention — 500k dense-KV decode).
LONG_CONTEXT_ARCHS = frozenset(
    {"xlstm-1.3b", "zamba2-2.7b", "mixtral-8x22b", "gemma3-1b"}
)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES.get(arch) or _PORT_MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped cells flagged."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name, skipped))
    return out


def skip_reason(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return "pure full attention: 500k dense-KV decode is quadratic-history"
    return None
