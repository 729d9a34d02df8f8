"""The count-sketch gradient all-reduce (``repro_torch.train.compression``)
against ``repro.train.compression``.

The port's hash family is its own (a counter-based hash of ``(seed, row,
coordinate)``); JAX draws its from threefry. So the comparisons with JAX
inject JAX's ``(buckets, signs)`` arrays (``interop.compression_hashes``);
the reference's own tests (linearity, heavy hitters, error feedback, the
ratio) run on the port's family. Tolerances:

* sketches within f32 rounding of the sums: each bucket within ``(m + 1)
  2^-24`` times the sum of its ``m`` entries' magnitudes (the two
  frameworks add the same terms in other orders);
* estimates: the median of the same rows is the same arithmetic, so from
  one sketch the estimates (every coordinate kept) are equal bit for bit,
  at even ``rows`` too, where ``jnp.median`` takes the mean of the middle
  two (``torch.median`` would take the lower); after the top-k threshold,
  coordinates whose magnitude is not within the sketches' rounding of the
  threshold are kept or dropped alike, with values within that rounding;
* ``compress_allreduce`` over two ``"pod"`` shards (JAX under
  ``shard_map`` with ``psum``, on 2 forced host devices in a subprocess)
  within 1e-6 absolute per shard, estimates and residuals, over two steps
  of error feedback.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jcomp
from repro_torch import interop
from repro_torch.sharding.mesh import Mesh
from repro_torch.train import compression as comp
from repro_torch.train import tree as tree_lib
from torch_parity import CPU, one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
U = 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.array(a))


def _rounding_bound(cfg, vec, hashes):
    """Per bucket: (m + 1) 2^-24 times the sum of its entries' magnitudes,
    m the bucket's entry count."""
    mag = comp.sketch_vector(cfg, vec.abs(), (hashes[0], hashes[1].abs()))
    count = comp.sketch_vector(cfg, torch.ones_like(vec),
                               (hashes[0], hashes[1].abs()))
    return (count + 1) * U * mag


def test_linearity_merge():
    """sketch(a) + sketch(b) == sketch(a + b) within the sums' rounding
    (each side's, and that of the final add): the psum-compatibility."""
    cfg = comp.SketchCompressorConfig(rows=3, cols=512)
    rng = np.random.default_rng(0)
    a, b = (_t(rng.normal(size=200).astype(np.float32)) for _ in range(2))
    hashes = comp._hash_params(cfg, 0, 200, torch.device(CPU))
    sa, sb = comp.sketch_vector(cfg, a), comp.sketch_vector(cfg, b)
    bound = (2 * _rounding_bound(cfg, a.abs() + b.abs(), hashes)
             + U * (sa + sb).abs())
    assert bool(((sa + sb - comp.sketch_vector(cfg, a + b)).abs()
                 <= bound).all())


def test_heavy_hitters_recovered():
    cfg = comp.SketchCompressorConfig(rows=5, cols=8192, top_k_fraction=0.02)
    vec = torch.zeros(1000)
    vec[[7, 123, 999]] = torch.tensor([10.0, -8.0, 5.0])
    vec = vec + 0.01 * _t(np.random.default_rng(2).normal(size=1000).astype(
        np.float32))
    est = comp.unsketch_vector(cfg, comp.sketch_vector(cfg, vec), 1000)
    assert abs(float(est[7]) - 10.0) < 0.5
    assert abs(float(est[123]) + 8.0) < 0.5
    assert int((est != 0).sum()) == 20


def test_error_feedback_accumulates():
    cfg = comp.SketchCompressorConfig(rows=3, cols=1024, top_k_fraction=0.01)
    grads = {"w": _t(np.random.default_rng(3).normal(size=500).astype(
        np.float32)), "b": torch.ones((4, 5), dtype=torch.bfloat16)}
    state = comp.init_state(grads)
    est, state = comp.compress_allreduce(cfg, grads, state)
    assert est["b"].dtype == torch.bfloat16
    assert state.residual["b"].dtype == torch.float32
    # residual = grads - est (what was not transmitted), exactly as computed
    assert torch.equal(state.residual["w"], grads["w"] - est["w"])
    est2, state2 = comp.compress_allreduce(cfg, grads, state)
    flat = torch.cat([(g.float() + r).reshape(-1) for g, r in zip(
        tree_lib.leaves(grads), tree_lib.leaves(state.residual))])
    got = torch.cat([r.reshape(-1) for r in tree_lib.leaves(
        state2.residual)])
    sent = torch.cat([e.float().reshape(-1) for e in tree_lib.leaves(est2)])
    nonzero = sent != 0
    assert torch.equal(got[~nonzero], flat[~nonzero])


def test_ratio():
    cfg = comp.SketchCompressorConfig(rows=5, cols=1 << 18)
    assert comp.compression_ratio(cfg, 7_000_000_000) > 5000
    assert comp.compression_ratio(cfg, 7_000_000_000) == \
        jcomp.compression_ratio(jcomp.SketchCompressorConfig(), 7_000_000_000)


def test_hash_family_is_a_fixed_function_made_in_chunks(monkeypatch):
    """The draws depend on (seed, row, coordinate) alone: a chunked pass
    and a whole one give the same sketch bit for bit; buckets are in range,
    signs +-1 in about equal numbers, and rows differ."""
    cfg = comp.SketchCompressorConfig(rows=4, cols=300)
    b, s = comp._hash_params(cfg, 0, 5000, torch.device(CPU))
    assert b.dtype == torch.int64 and int(b.min()) >= 0 and \
        int(b.max()) < 300
    assert set(s.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(s.mean())) < 0.05
    assert not torch.equal(b[0], b[1])
    b2, s2 = comp._hash_params(cfg, 1000, 3000, torch.device(CPU))
    assert torch.equal(b2, b[:, 1000:3000]) and torch.equal(s2,
                                                            s[:, 1000:3000])
    vec = _t(np.random.default_rng(4).normal(size=5000).astype(np.float32))
    whole = comp.sketch_vector(cfg, vec)
    monkeypatch.setattr(comp, "HASH_CHUNK", 777)
    assert torch.equal(comp.sketch_vector(cfg, vec), whole)
    assert torch.equal(comp.sketch_vector(cfg, vec, (b, s)), whole)


@pytest.mark.parametrize("rows", [5, 4])
def test_injected_jax_hashes_give_jax_sketch_and_estimate(rows):
    cfg = comp.SketchCompressorConfig(rows=rows, cols=64,
                                      top_k_fraction=0.05)
    jcfg = jcomp.SketchCompressorConfig(rows=rows, cols=64,
                                        top_k_fraction=0.05)
    n = 3000
    vec = np.random.default_rng(5).normal(size=n).astype(np.float32)
    vec[[11, 1500, 2999]] = (40.0, -30.0, 25.0)
    hashes = interop.compression_hashes(*jcomp._hash_params(jcfg, n), CPU)
    jsk = np.asarray(jcomp.sketch_vector(jcfg, jnp.asarray(vec)))
    sk = comp.sketch_vector(cfg, _t(vec), hashes)
    bound = _rounding_bound(cfg, _t(vec), hashes)
    assert bool(((sk - _t(jsk)).abs() <= bound).all())

    # every coordinate kept: the median alone, bit for bit from JAX's sketch
    keep_all = comp.SketchCompressorConfig(rows=rows, cols=64,
                                           top_k_fraction=1.0)
    jkeep = jcomp.SketchCompressorConfig(rows=rows, cols=64,
                                         top_k_fraction=1.0)
    med = comp.unsketch_vector(keep_all, _t(jsk), n, hashes)
    assert torch.equal(med, _t(jcomp.unsketch_vector(jkeep, jnp.asarray(jsk),
                                                     n)))
    if rows % 2 == 0:
        vals = _t(jsk).gather(1, hashes[0]) * hashes[1]
        assert not torch.equal(med, vals.median(dim=0).values)

    # the top-k estimate from each side's own sketch
    est = comp.unsketch_vector(cfg, sk, n, hashes)
    jest = _t(jcomp.unsketch_vector(jcfg, jnp.asarray(jsk), n))
    mag = jest.abs()
    thresh = float(mag[mag > 0].min())
    slack = float(bound.max()) * 2
    clear = (mag - thresh).abs() > slack
    assert bool(((est != 0) == (jest != 0))[clear].all())
    assert float((est - jest)[clear].abs().max()) <= slack
    assert bool(clear[[11, 1500, 2999]].all()) and float(est[11]) > 20.0


_JAX_PROG = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro import compat
    from repro.train import compression as c
    inp = pickle.load(sys.stdin.buffer)
    cfg = c.SketchCompressorConfig(**inp["cfg"])
    mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))

    def step(g, r):
        est, st = c.compress_allreduce(
            cfg, jax.tree.map(lambda a: a[0], g),
            c.CompressorState(jax.tree.map(lambda a: a[0], r)),
            axis_name="pod")
        lead = lambda t: jax.tree.map(lambda a: a[None], t)
        return lead(est), lead(st.residual)

    f = jax.jit(compat.shard_map(step, mesh=mesh, in_specs=(P("pod"),
                P("pod")), out_specs=(P("pod"), P("pod"))))
    grads = jax.tree.map(jnp.asarray, inp["grads"])
    res = jax.tree.map(jnp.zeros_like, grads)
    out = []
    for _ in range(2):
        est, res = f(grads, res)
        out.append(jax.tree.map(np.asarray, (est, res)))
    sys.stdout.buffer.write(pickle.dumps(out))
""")


def test_compress_allreduce_over_pods_equals_jax_psum():
    cfg_kw = dict(rows=3, cols=256, top_k_fraction=0.05, seed=17)
    rng = np.random.default_rng(6)
    grads = {"w": rng.normal(size=(2, 500)).astype(np.float32),
             "b": rng.normal(size=(2, 20, 5)).astype(np.float32)}
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _JAX_PROG], env=env,
                         input=pickle.dumps({"cfg": cfg_kw,
                                             "grads": grads}),
                         capture_output=True, timeout=300)
    assert run.returncode == 0, run.stderr.decode()[-2000:]
    want = pickle.loads(run.stdout)

    cfg = comp.SketchCompressorConfig(**cfg_kw)
    n = 500 + 100
    # the flat order is the tree's leaf order: JAX sorts dict keys
    hashes = interop.compression_hashes(*jcomp._hash_params(
        jcomp.SketchCompressorConfig(**cfg_kw), n), CPU)
    mesh = Mesh([CPU] * 2, "pod")
    shards = [{"b": _t(grads["b"][i]), "w": _t(grads["w"][i])}
              for i in range(2)]
    states = [comp.init_state(g) for g in shards]
    for est_want, res_want in want:
        ests, states = comp.compress_allreduce(cfg, shards, states, mesh,
                                               hashes)
        for i in range(2):
            for key in ("w", "b"):
                assert float((ests[i][key] - _t(est_want[key][i])).abs()
                             .max()) <= 1e-6
                assert float((states[i].residual[key]
                              - _t(res_want[key][i])).abs().max()) <= 1e-6
        assert torch.equal(ests[0]["w"], ests[1]["w"])
    with pytest.raises(ValueError, match="one gradient tree"):
        comp.compress_allreduce(cfg, shards[:1], states, mesh)
