"""Carry weights and state between the JAX package and the port as numpy.

``jax.random`` draws threefry streams that torch cannot reproduce, so parity
runs draw the hash family, the DFO sphere directions and the refine samples
once, hand them over as numpy arrays, and the port replays them. This module
takes and returns numpy only; it never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lsh import LSHParams
from repro_torch.core.sketch import Sketch
from repro_torch.device import DeviceLike, resolve_device


def _float_tensor(arr, ndim: int, what: str, device: DeviceLike) -> torch.Tensor:
    a = np.array(arr, dtype=np.float32)  # a writable copy
    if a.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dims; got shape {a.shape}")
    return torch.from_numpy(a).to(resolve_device(device))


def lsh_params(projections, device: DeviceLike = None) -> LSHParams:
    """``(R, p, dim)`` projections -> :class:`LSHParams`."""
    return LSHParams(projections=_float_tensor(projections, 3, "projections",
                                               device))


def sketch(counts, n, device: DeviceLike = None) -> Sketch:
    """``(R, B)`` integer counts and the insert count -> :class:`Sketch`.

    The counter dtype is kept (uint16 included: torch stores it, and every
    counter operation of the port widens to int32 first).
    """
    c = np.array(counts)  # a writable copy
    if c.ndim != 2 or c.dtype.kind not in "iu":
        raise ValueError(f"counts must be a 2-D integer array; got "
                         f"{c.dtype} {c.shape}")
    dev = resolve_device(device)
    return Sketch(counts=torch.from_numpy(c).to(dev),
                  n=torch.tensor(int(n), dtype=torch.int32, device=dev))


def directions(v, device: DeviceLike = None) -> torch.Tensor:
    """Unit sphere directions ``(steps, F, k, dim)`` for ``dfo.minimize_fleet``."""
    return _float_tensor(v, 4, "directions", device)


def refine_samples(s, device: DeviceLike = None) -> torch.Tensor:
    """Standard normals ``(passes, F, m, dim)`` for the quadratic refine."""
    return _float_tensor(s, 4, "refine samples", device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Any port tensor back to numpy (uint16 counters included)."""
    return t.detach().cpu().numpy()


def lsh_params_to_numpy(params: LSHParams) -> np.ndarray:
    return to_numpy(params.projections)


def sketch_to_numpy(sk: Sketch) -> tuple[np.ndarray, int]:
    return to_numpy(sk.counts), int(sk.n)
