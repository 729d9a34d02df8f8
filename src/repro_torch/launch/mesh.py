"""The production mesh (port of ``repro.launch.mesh``): a function, so
importing this module touches no device."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.device import DeviceLike
from repro_torch.sharding.mesh import Mesh, make_debug_mesh

__all__ = ["make_production_mesh", "make_debug_mesh"]


def make_production_mesh(multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None
                         ) -> Mesh:
    """16 x 16 over ``("data", "model")``; two pods add a leading ``"pod"``
    axis (2 x 16 x 16, 512 devices). ``devices=None`` takes every visible
    card, and raises unless they number 256 (512 with ``multi_pod``); a
    caller may name one card 256 times, as the single controller allows."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    need = 512 if multi_pod else 256
    if len(devices) != need:
        raise ValueError(f"the production mesh {shape} needs {need} devices; "
                         f"got {len(devices)} (name them, repeats allowed)")
    return Mesh(devices, axes, shape)
