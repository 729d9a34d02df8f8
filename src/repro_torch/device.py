"""Device selection: the card by default, the CPU only when asked for.

Every entry point of the port resolves its ``device`` argument here, so the
rule lives in one place: ``None`` means ``cuda``, and asking for ``cuda``
without a card raises instead of running on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when ``cuda`` is asked for and absent.

    On the card, TF32 is switched off for matmuls and convolutions: sign
    codes of fp32 projections must not flip on TF32 rounding.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


def generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded ``torch.Generator`` on the resolved device."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def randn(shape, gen: torch.Generator, device: Optional[torch.device] = None
          ) -> torch.Tensor:
    """Standard normals from ``gen``, moved to ``device`` if it differs."""
    out = torch.randn(shape, generator=gen, device=gen.device,
                      dtype=torch.float32)
    return out if device is None else out.to(device)
