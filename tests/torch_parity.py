"""Shared helpers of the ``test_torch_*`` parity tests (and of
``scripts/reference_quality.py`` and ``scripts/reference_outputs.py``).

``jax.random`` draws cannot be reproduced by torch, so these helpers draw
what the JAX package draws (hash families, DFO sphere directions, refine
samples, the margin losses' init noise, the tenants' keys) and hand the
arrays to the port through ``repro_torch.interop``. The reference's
example outputs and ``hlo_analysis`` counts, slow to produce, are read from
``tests/reference_outputs.json`` while the digest it was written under
matches, and produced anew when it does not.
"""

from __future__ import annotations

import hashlib
import importlib.metadata
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dfo as jdfo
from repro.core import fleet as jfleet
from repro.core import lsh as jlsh
from repro_torch import interop

CPU = "cpu"

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module's tests (autouse where a test
    module imports it): their small tensors run as fast on one, and under
    ``pytest -n`` each worker's default of one thread a core would
    oversubscribe the cores several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# XLA's lowest optimization level: the same functions, compiled in about
# half the time (values move by f32 roundings).
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
_COMPILED = {}


def run_fast(key, fn, *args):
    """``fn(*args)`` (array trees only) through a program compiled at
    ``FAST_XLA`` once per ``key`` and the arguments' shapes and dtypes. Far
    cheaper than running the reference op by op, which compiles each
    primitive at each shape on first use."""
    leaves, tree = jax.tree.flatten(args)
    sig = (key, tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
    if sig not in _COMPILED:
        _COMPILED[sig] = jax.jit(fn).lower(*args).compile(
            compiler_options=FAST_XLA)
    return _COMPILED[sig](*args)


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


def tenant_draws(key, tenants: int, dim: int, init_noise: bool):
    """What ``repro.core.erm`` draws per tenant from a fit key, F = 1.

    Returns ``(member keys (S, 2), theta0 noise (S, dim) or None)``: tenant
    ``t`` keys by ``fleet.tenant_key``; with ``init_noise`` that key splits
    into the init draw and the DFO key.
    """
    keys, noise = [], []
    for s in range(tenants):
        kt = jfleet.tenant_key(key, s)
        if init_noise:
            k_init, kt = jax.random.split(kt)
            noise.append(np.asarray(jax.random.normal(k_init, (dim,))))
        keys.append(kt)
    return jnp.stack(keys), (t(np.stack(noise)) if init_noise else None)


def regression_draw(seed: int, n: int, d: int, noise: float,
                    condition: float):
    """``datasets.make_regression``'s distribution drawn with numpy: features
    with covariance eigenvalues log-spaced over ``condition`` (mean 1) under
    a random rotation, ``y = x theta + noise eps``. Returns float32
    ``(x, y)``."""
    rng = np.random.default_rng(seed)
    eigs = np.logspace(0.0, np.log10(condition), d)
    eigs /= eigs.mean()
    rot, _ = np.linalg.qr(rng.normal(size=(d, d)))
    x = (rng.normal(size=(n, d)) * np.sqrt(eigs)) @ rot.T
    y = x @ rng.normal(size=d) + noise * rng.normal(size=n)
    return x.astype(np.float32), y.astype(np.float32)


def regression_fit_pair(key, x: np.ndarray, y: np.ndarray, cfg):
    """JAX's ``regression.fit`` and the port's on the CPU, on the same
    arrays, hash family and DFO draws (drawn from ``key`` as the reference
    draws them). ``cfg`` is the reference's ``StormRegressorConfig``; the
    port runs the same fields. Returns ``{"jax": ..., "port": ...}``, each
    ``{"mse", "r2", "cos_ols", "sketch_loss"}`` on ``(x, y)``, and the
    number of sketch cells the two builds put in other buckets
    (``moved``)."""
    import dataclasses

    from repro.core import regression as jregression
    from repro_torch.core import baselines, dfo, regression

    want = jregression.fit(key, jnp.asarray(x), jnp.asarray(y), cfg)
    k_hash, k_dfo = jax.random.split(key)
    d = x.shape[1]
    params = interop.lsh_params(np.asarray(jlsh.init_srp(
        k_hash, cfg.rows, cfg.planes, d + 3).projections), CPU)
    dirs, refine = fleet_draws(k_dfo[None], cfg.dfo.steps,
                               cfg.dfo.num_queries, d + 1,
                               refine_steps=cfg.refine_steps,
                               m=dfo.refine_sample_count(d + 1))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "dfo"}
    pcfg = regression.StormRegressorConfig(
        **fields, dfo=dfo.DFOConfig(**dataclasses.asdict(cfg.dfo)))
    xt, yt = t(x), t(y)
    got = regression.fit(None, xt, yt, pcfg, params=params, directions=dirs,
                         refine_samples=refine, device=CPU)
    ols = baselines.ols(xt, yt).theta
    var = float(yt.var(correction=0))
    out = {}
    for name, theta, mse, loss in (
        ("jax", t(want.theta), float(want.mse(jnp.asarray(x),
                                               jnp.asarray(y))),
         float(want.fleet_losses[0])),
        ("port", got.theta, float(got.mse(xt, yt)),
         float(got.fleet_losses[0])),
    ):
        out[name] = {"mse": mse, "r2": 1.0 - mse / var,
                     "cos_ols": float(theta @ ols / (theta.norm() * ols.norm()
                                                     + 1e-12)),
                     "sketch_loss": loss}
    moved = np.abs(got.sketch.counts.numpy().astype(np.int64)
                   - np.asarray(want.sketch.counts)).sum() // 2
    return out, int(moved)


def quality_cases(rows_a: int, rows_b: int):
    """The cases of ``scripts/reference_quality.py``: ``(label, seed, n, d,
    noise, condition, config)``, the airfoil-matched draw on ``rows_a`` rows
    and phase 15's d = 40 shape (small steps, defaults) on ``rows_b``."""
    from repro.core import dfo as jdfo
    from repro.core import regression as jregression

    # Phase 15's steps at d = 40 (chip_smoke.py: WIDE_*).
    small = jregression.StormRegressorConfig(
        rows=4096,
        dfo=jdfo.DFOConfig(steps=400, num_queries=32, sigma=0.15,
                           sigma_decay=0.995, learning_rate=0.25, decay=0.995,
                           average_tail=0.5))
    default = jregression.StormRegressorConfig()
    return (("airfoil-matched d=9 default", 0, rows_a, 9, 0.3, 30.0, default),
            ("d=40 small steps", 1, rows_b, 40, 0.2, 10.0, small),
            ("d=40 default", 1, rows_b, 40, 0.2, 10.0, default))


# -- the reference's outputs ------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_EXAMPLES = ("quickstart", "serve_storm", "logistic_edge",
                      "private_serving")
REFERENCE_OUTPUTS = ROOT / "tests" / "reference_outputs.json"
COUNT_BATCH, COUNT_SEQ = 2, 64   # the op-count tests' smoke shapes


def reference_key() -> str:
    """A digest of everything the recorded reference outputs depend on: the
    JAX package's sources, the four example scripts, and the versions of
    jax, jaxlib and numpy."""
    h = hashlib.sha256()
    paths = sorted((ROOT / "src" / "repro").rglob("*.py")) + [
        ROOT / "examples" / f"{name}.py" for name in REFERENCE_EXAMPLES]
    for path in paths:
        h.update(str(path.relative_to(ROOT)).encode())
        h.update(path.read_bytes())
    for dist in ("jax", "jaxlib", "numpy"):
        h.update(f"{dist}=={importlib.metadata.version(dist)}".encode())
    return h.hexdigest()


def _recorded() -> Dict[str, Any]:
    """``tests/reference_outputs.json`` if it was written for
    :func:`reference_key` (the same sources and versions give the same
    outputs), else nothing."""
    if REFERENCE_OUTPUTS.exists():
        stored = json.loads(REFERENCE_OUTPUTS.read_text())
        if stored.get("key") == reference_key():
            return stored
    return {}


def run_reference_examples(threads_each: int = 1) -> Dict[str, str]:
    """Run the four reference examples as scripts, all at once, and return
    what each printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(threads_each))
    if threads_each == 1:
        env["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in REFERENCE_EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"examples/{name}.py: {stderr[-2000:]}")
            out[name] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def reference_example_outputs() -> Dict[str, str]:
    """What the four reference examples print: recorded, or run anew."""
    return _recorded().get("examples") or run_reference_examples()


def jax_prefill_flops(arch: str, b: int = COUNT_BATCH,
                      s: int = COUNT_SEQ) -> float:
    """``hlo_analysis``'s FLOPs of the reference's smoke prefill."""
    from repro.configs import registry as jregistry
    from repro.launch import hlo_analysis
    from repro.models import model as jmodel

    cfg = jregistry.get_config(arch, smoke=True)
    params = jax.eval_shape(lambda k: jmodel.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if "cross_attn" in cfg.cycle:
        batch["cross_states"] = jax.ShapeDtypeStruct(
            (b, cfg.cross_attn_tokens, cfg.d_model), jnp.float32)
    text = jax.jit(lambda p, bt: jmodel.prefill(p, cfg, bt, cache_len=s)
                   ).lower(params, batch).compile(
                       compiler_options=FAST_XLA).as_text()
    return hlo_analysis.analyze_text(text)["flops"]


def jax_train_step_flops(arch: str, b: int = COUNT_BATCH,
                         s: int = COUNT_SEQ) -> float:
    """``hlo_analysis``'s FLOPs of the reference's smoke train step (its
    default ``TrainConfig``: one microbatch)."""
    from repro.configs import registry as jregistry
    from repro.launch import hlo_analysis
    from repro.train import train_step as jts

    cfg = jregistry.get_config(arch, smoke=True)
    tcfg = jts.TrainConfig()
    state = jax.eval_shape(lambda k: jts.init_state(k, cfg, tcfg),
                           jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
             "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    text = jax.jit(lambda st, bt: jts.train_step(st, bt, cfg, tcfg)).lower(
        state, batch).compile(compiler_options=FAST_XLA).as_text()
    return hlo_analysis.analyze_text(text)["flops"]


COUNTERS = {"prefill": jax_prefill_flops, "train": jax_train_step_flops}


def reference_flops(step: str, arch: str) -> float:
    """The reference's count of ``step`` (``"prefill"`` or ``"train"``) at
    the smoke shapes: recorded, or counted anew."""
    recorded = _recorded().get("flops", {}).get(f"{step}|{arch}")
    return recorded if recorded is not None else COUNTERS[step](arch)
