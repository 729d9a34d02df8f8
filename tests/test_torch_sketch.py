"""The port's sketch against ``repro.core.sketch`` on shared hashes and data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import lsh as jlsh
from repro.core import sketch as jsk
from repro_torch import interop
from repro_torch.core import distributed, lsh, sketch
from torch_parity import CPU, jax_params, t, unit_ball_rows


def _jax_sketch(jp, z, **kw):
    return jsk.sketch_dataset(jp, jnp.asarray(z), engine="scan", **kw)


@pytest.mark.parametrize("engine", ["scan", "kernel"])
def test_sketch_dataset_equals_jax(engine):
    jp, tp = jax_params(0, 48, 4, 7)
    z = unit_ball_rows(0, 333, 5)
    want = _jax_sketch(jp, z, batch=64)
    got = sketch.sketch_dataset(tp, t(z), batch=64, engine=engine, device=CPU)
    assert int(got.n) == int(want.n) == 333
    # Row masses are exact on every engine; at this seed no projection is a
    # sign tie, so every cell is exact too.
    np.testing.assert_array_equal(got.counts.sum(1).numpy(),
                                  np.full(48, 2 * 333))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8"])
def test_insert_and_prp_insert_equal_jax(dtype):
    # Counts exact: the codes agree (no projection is a sign tie at these
    # draws, which the test checks), so every cell does; int8 saturates.
    jp, tp = jax_params(7, 24, 2, 6)
    z = unit_ball_rows(7, 200, 4)
    x = np.concatenate([z, np.zeros((200, 1), np.float32),
                        np.linalg.norm(z, axis=1, keepdims=True)], 1)
    np.testing.assert_array_equal(lsh.srp_codes(tp, t(x)).numpy(),
                                  np.asarray(jlsh.srp_codes(jp, jnp.asarray(x))))
    jdt = jnp.dtype(dtype)
    for batches in ((200,), (70, 130)):
        want = jsk.init_sketch(24, 4, jdt)
        got = sketch.init_sketch(24, 4, getattr(torch, dtype), device=CPU)
        wantp, gotp = want, got
        start = 0
        for b in batches:
            zb, xb = z[start:start + b], x[start:start + b]
            want = jsk.insert(want, jp, jnp.asarray(xb))
            got = sketch.insert(got, tp, t(xb))
            wantp = jsk.prp_insert(wantp, jp, jnp.asarray(zb))
            gotp = sketch.prp_insert(gotp, tp, t(zb))
            start += b
        for g, w_ in ((got, want), (gotp, wantp)):
            assert g.counts.dtype == getattr(torch, dtype)
            assert int(g.n) == int(w_.n) == 200
            np.testing.assert_array_equal(g.counts.numpy(),
                                          np.asarray(w_.counts))
    if dtype == "int8":
        assert int(gotp.counts.max()) == 127


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_narrow_sketch_saturates_like_jax(dtype):
    jp, tp = jax_params(1, 8, 1, 4)  # two buckets: cells overflow int8 fast
    z = unit_ball_rows(1, 300, 2)
    want = _jax_sketch(jp, z, batch=100, dtype=jnp.dtype(dtype))
    for engine in ("scan", "kernel"):
        got = sketch.sketch_dataset(tp, t(z), batch=100, dtype=dtype,
                                    engine=engine, device=CPU)
        assert got.counts.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
    if dtype == "int8":
        assert int(got.counts.max()) == 127


def test_merge_and_tree_merge_equal_jax():
    jp, tp = jax_params(2, 32, 4, 6)
    shards = np.array_split(unit_ball_rows(2, 301, 4), 3)
    jsks = [_jax_sketch(jp, s, batch=50) for s in shards]
    tsks = [sketch.sketch_dataset(tp, t(s), batch=50, engine="scan",
                                  device=CPU)
            for s in shards]
    want = jdist.tree_merge(jsks)
    got = distributed.tree_merge(tsks)
    assert int(got.n) == int(want.n) == 301
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    pair = sketch.merge(tsks[0], tsks[1])
    np.testing.assert_array_equal(
        pair.counts.numpy(), np.asarray(jsk.merge(jsks[0], jsks[1]).counts))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int8, torch.uint16])
def test_merge_saturates_narrow_counters(dtype):
    hi = torch.iinfo(dtype).max
    a = sketch.Sketch(counts=torch.full((2, 4), hi - 1, dtype=dtype),
                      n=torch.tensor(5, dtype=torch.int32))
    m = sketch.merge(a, a)
    assert m.counts.dtype == dtype
    assert torch.equal(m.counts.to(torch.int32),
                       torch.full((2, 4), hi, dtype=torch.int32))
    assert int(m.n) == 10


def test_uint16_sketch_widens_every_add():
    jp, tp = jax_params(3, 16, 2, 5)
    z = unit_ball_rows(3, 50, 3)
    jcpos, jcneg = jlsh.prp_codes(jp, jnp.asarray(z))
    want = jsk.prp_update(jsk.init_sketch(16, 4, jnp.uint16), jcpos, jcneg)
    start = sketch.init_sketch(16, 4, torch.uint16, device="cpu")
    got = sketch.prp_update(start, *lsh.prp_codes(tp, t(z)))
    assert got.counts.dtype == torch.uint16
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    again = sketch.update(got, lsh.prp_codes(tp, t(z))[0])
    assert int(again.n) == 100
    carried = interop.sketch(np.asarray(want.counts), int(want.n), device="cpu")
    assert carried.counts.dtype == torch.uint16
    assert torch.equal(carried.counts, got.counts)


@pytest.mark.parametrize("paired", [True, False])
def test_query_theta_equals_jax(paired):
    jp, tp = jax_params(4, 64, 4, 7)
    z = unit_ball_rows(4, 500, 5)
    jsk_ = _jax_sketch(jp, z, batch=128)
    tsk = interop.sketch(np.asarray(jsk_.counts), int(jsk_.n), device="cpu")
    th = np.random.default_rng(4).normal(size=(17, 5)).astype(np.float32)
    want = jsk.query_theta(jsk_, jp, jnp.asarray(th), paired=paired)
    got = sketch.query_theta(tsk, tp, t(th), paired=paired)
    # Equal counts and equal codes give bit-equal means (sums < 2^24).
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resolve_engine():
    assert sketch.resolve_engine("auto", torch.device("cpu")) == "scan"
    assert sketch.resolve_engine("auto", torch.device("cuda")) == "kernel"
    assert sketch.resolve_engine("kernel", torch.device("cpu")) == "kernel"
    with pytest.raises(ValueError):
        sketch.resolve_engine("pallas", torch.device("cpu"))


def test_kernel_engine_rejects_row_overrides():
    _, tp = jax_params(0, 8, 2, 5)
    with pytest.raises(ValueError):
        sketch.sketch_dataset(tp, torch.zeros(4, 3), rows=4, engine="kernel",
                              device=CPU)


def test_counter_dtype_and_memory():
    assert sketch.counter_dtype("int16") is torch.int16
    with pytest.raises(ValueError):
        sketch.counter_dtype("float32")
    sk = sketch.init_sketch(2048, 16, torch.int16, device="cpu")
    assert sk.memory_bytes() == jsk.init_sketch(2048, 16,
                                                jnp.int16).memory_bytes()


def test_interop_round_trips():
    jp, tp = jax_params(5, 16, 3, 6)
    np.testing.assert_array_equal(interop.lsh_params_to_numpy(tp),
                                  np.asarray(jp.projections))
    counts = np.arange(32, dtype=np.int16).reshape(4, 8)
    back, n = interop.sketch_to_numpy(interop.sketch(counts, 9, device="cpu"))
    assert back.dtype == np.int16 and n == 9
    np.testing.assert_array_equal(back, counts)
    with pytest.raises(ValueError):
        interop.sketch(counts.astype(np.float32), 9, device="cpu")
