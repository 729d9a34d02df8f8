"""The GPipe schedule (``repro_torch.sharding.pipeline``) against
``repro.sharding.pipeline.pipeline_forward``.

The reference's toy (4 stages of ``tanh(h @ w)``, D 8, microbatches of 3
rows) at M = 6, at M = 2 < S and at M = 1, on numpy draws: JAX's schedule
runs under ``shard_map`` on 4 forced host devices in one subprocess; the
port's on ``Mesh(["cpu"] * 4, "pipe")``. The port's output equals its own
run of every microbatch stage after stage bit for bit (the same products
on the same inputs) and JAX's within 1e-6 absolute (f32 products in the
two frameworks' orders; |y| < 1). A smoke LM (qwen2-7b's, 2 cycles) split
into 2 stages of a cycle each through ``model.apply_cycles`` equals its
sequential run bit for bit, and after the final norm, its whole-batch
``forward`` within 1e-5.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import layers, model
from repro_torch.sharding.mesh import Mesh
from repro_torch.sharding.pipeline import bubble_fraction, pipeline_forward
from torch_parity import CPU, one_torch_thread  # noqa: F401

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
S, B, D = 4, 3, 8
MS = (6, 2, 1)

_JAX_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.sharding.pipeline import pipeline_forward
    data = np.load(sys.argv[1])
    w = jnp.asarray(data["w"])
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    out = {}
    for m in (6, 2, 1):
        out[f"y{m}"] = np.asarray(pipeline_forward(
            lambda wi, h: jnp.tanh(h @ wi), w, jnp.asarray(data[f"x{m}"]),
            mesh, axis="pipe"))
    np.savez(sys.argv[2], **out)
""")


def _draws():
    rng = np.random.default_rng(0)
    w = (0.3 * rng.normal(size=(S, D, D))).astype(np.float32)
    return w, {m: rng.normal(size=(m, B, D)).astype(np.float32) for m in MS}


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    w, xs = _draws()
    np.savez(tmp / "in.npz", w=w, **{f"x{m}": x for m, x in xs.items()})
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _JAX_PROG,
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    out = np.load(tmp / "out.npz")
    return {m: out[f"y{m}"] for m in MS}


def _block(wi, h):
    return torch.tanh(h @ wi)


@pytest.mark.parametrize("m", MS)
def test_toy_pipeline_equals_sequential_and_jax(m, jax_outputs):
    w, xs = _draws()
    w, x = torch.from_numpy(w), torch.from_numpy(xs[m])
    mesh = Mesh([CPU] * S, "pipe")
    got = pipeline_forward(_block, w, x, mesh)
    seq = torch.stack([_sequential(w, x[i]) for i in range(m)])
    assert got.shape == (m, B, D) and torch.equal(got, seq)
    assert float((got - torch.from_numpy(jax_outputs[m])).abs().max()) \
        <= 1e-6
    # per-stage trees: the same schedule
    trees = [{"w": w[s]} for s in range(S)]
    assert torch.equal(pipeline_forward(lambda p, h: _block(p["w"], h),
                                        trees, x, mesh), got)
    assert bubble_fraction(S, m) == (S - 1) / (m + S - 1)


def _sequential(w, h):
    for s in range(w.shape[0]):
        h = _block(w[s], h)
    return h


def test_pipeline_checks_its_inputs():
    w, xs = _draws()
    mesh = Mesh([CPU] * S, "pipe")
    with pytest.raises(ValueError, match="stages"):
        pipeline_forward(_block, torch.from_numpy(w[:3]),
                         torch.from_numpy(xs[6]), mesh)
    with pytest.raises(KeyError):
        pipeline_forward(_block, torch.from_numpy(w),
                         torch.from_numpy(xs[6]), Mesh([CPU] * S, "data"))
    with pytest.raises(ValueError, match="microbatch"):
        pipeline_forward(_block, torch.from_numpy(w),
                         torch.zeros((0, B, D)), mesh)


def test_lm_stages_of_cycles_equal_the_sequential_run():
    cfg = registry.get_config("qwen2-7b", smoke=True)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    assert cfg.num_cycles == 2
    stages = [params["blocks"][:1], params["blocks"][1:]]
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 2, 12)))
    cdt = layers.dtype_of(cfg.compute_dtype)
    x = layers.embed(params["embed"], toks, cdt)            # (M, mb, S, d)
    fn = lambda cycles, h: model.apply_cycles(cycles, cfg, h)
    with torch.no_grad():
        got = pipeline_forward(fn, stages, x, Mesh([CPU] * 2, "pipe"))
        seq = torch.stack([fn(stages[1], fn(stages[0], x[i]))
                           for i in range(3)])
        assert torch.equal(got, seq)
        hidden = layers.rms_norm(got, params["final_norm"], cfg.norm_eps)
        whole, _ = model.forward(params, cfg,
                                 {"tokens": toks.reshape(6, 12)})
    assert float((hidden.reshape(6, 12, -1) - whole).abs().max()) <= 1e-5
