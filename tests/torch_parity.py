"""Shared helpers of the ``test_torch_*`` parity tests.

``jax.random`` draws cannot be reproduced by torch, so these helpers draw
what the JAX package draws (hash families, DFO sphere directions, refine
samples) and hand the arrays to the port through ``repro_torch.interop``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import dfo as jdfo
from repro.core import lsh as jlsh
from repro_torch import interop

CPU = "cpu"


def jax_params(seed: int, rows: int, planes: int, dim: int):
    """A JAX hash family and its port counterpart on the CPU."""
    jp = jlsh.init_srp(jax.random.PRNGKey(seed), rows, planes, dim)
    return jp, interop.lsh_params(np.asarray(jp.projections), device=CPU)


def unit_ball_rows(seed: int, n: int, d: int) -> np.ndarray:
    """Rows in the unit ball, made with numpy (a tenth on the sphere)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d)).astype(np.float32)
    z /= np.quantile(np.linalg.norm(z, axis=1), 0.9) * 1.05
    return z / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1.0)


def fleet_draws(keys, steps: int, k: int, dim: int, refine_steps: int = 0,
                m: int = 0):
    """The draws ``repro.core.fleet.run_fleet`` makes from member ``keys``.

    Returns ``(directions (steps, F, k, dim), refine (passes, F, m, dim))``
    as torch tensors on the CPU.
    """
    step_keys = jax.vmap(lambda kk: jax.random.split(kk, steps))(keys)
    step_keys = jnp.swapaxes(step_keys, 0, 1)  # (steps, F, 2)
    v = jax.vmap(jax.vmap(lambda kk: jdfo._sphere(kk, k, dim)))(step_keys)
    refine = np.zeros((refine_steps, keys.shape[0], m, dim), np.float32)
    for i in range(refine_steps):
        rk = jax.vmap(lambda mk: jax.random.fold_in(mk, i + 1))(keys)
        refine[i] = np.asarray(
            jax.vmap(lambda kk: jax.random.normal(kk, (m, dim)))(rk))
    return (interop.directions(np.asarray(v), device=CPU),
            interop.refine_samples(refine, device=CPU))


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy/JAX array -> CPU torch tensor."""
    return torch.from_numpy(np.array(a)).to(dtype)
