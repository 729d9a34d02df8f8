"""The port's kernels: plain versions against the JAX kernels and references,
wrappers and dispatch on the CPU. The kernels themselves are held against
their plain versions on the card in ``test_torch_kernels_gpu.py``.

The JAX Pallas kernels run as the JAX package's own tests run them on the CPU,
in interpret mode. Codes agree exactly except at fp sign ties of a projection
(summation orders differ); a tie moves one increment to another bucket of the
same row, so row masses stay exact. The seeds below have no tie, and the
tests say so by asserting equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import sketch_query as jquery
from repro.kernels import storm_sketch as jstorm
from repro_torch.core import lsh, sketch
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import sketch_query as query_kernel
from repro_torch.kernels import storm_sketch as histogram_kernel
from torch_parity import t, unit_ball_rows

_DTYPES = {"int32": (torch.int32, jnp.int32), "int16": (torch.int16, jnp.int16),
           "int8": (torch.int8, jnp.int8)}


def _insert_inputs(seed, n, d, p, r, masked):
    rng = np.random.default_rng(seed)
    z = unit_ball_rows(seed, n, d)
    w = rng.normal(size=(p, d + 2, r)).astype(np.float32)
    mask = (rng.uniform(size=n) < 0.7 if masked else np.ones(n)).astype(
        np.float32)
    return z, w, mask


@pytest.mark.parametrize("out", ["int32", "int16", "int8"])
@pytest.mark.parametrize("seed,n,d,p,r,masked", [
    (0, 37, 5, 1, 19, True),
    (1, 130, 6, 4, 45, False),
    (2, 61, 3, 8, 13, True),
])
def test_paired_hash_histogram_equals_jax(seed, n, d, p, r, masked, out):
    z, w, mask = _insert_inputs(seed, n, d, p, r, masked)
    tdt, jdt = _DTYPES[out]
    got = ref.paired_hash_histogram(t(z), t(w), t(mask), tdt)
    want_kernel = jstorm.paired_hash_histogram(
        jnp.asarray(z), jnp.asarray(w), jnp.asarray(mask), block_n=32,
        block_r=16, out_dtype=jdt, interpret=True)
    want_ref = jref.paired_hash_histogram(jnp.asarray(z), jnp.asarray(w),
                                          jnp.asarray(mask), out_dtype=jdt)
    assert got.dtype == tdt and got.shape == (r, 1 << p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_kernel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    if out == "int32":
        np.testing.assert_array_equal(got.sum(1).numpy(),
                                      np.full(r, 2 * int(mask.sum())))


def test_paired_hash_histogram_saturates_int8():
    z, w, mask = _insert_inputs(3, 400, 2, 1, 5, False)
    wide = ref.paired_hash_histogram(t(z), t(w), t(mask))
    narrow = ref.paired_hash_histogram(t(z), t(w), t(mask), torch.int8)
    assert int(wide.max()) > 127
    assert torch.equal(narrow, wide.clamp(max=127).to(torch.int8))


def test_paired_hash_histogram_chunks_exactly(monkeypatch):
    z, w, mask = _insert_inputs(4, 90, 4, 4, 20, True)
    whole = ref.paired_hash_histogram(t(z), t(w), t(mask))
    monkeypatch.setattr(ref, "_CHUNK_CELLS", 20 * 7)  # 7 points per chunk
    assert torch.equal(ref.paired_hash_histogram(t(z), t(w), t(mask)), whole)


def test_paired_srp_hash_positive_side_is_srp_of_augmented():
    z, w, _ = _insert_inputs(5, 50, 5, 4, 30, False)
    cpos, _ = ref.paired_srp_hash(t(z), t(w))
    assert torch.equal(cpos, ref.srp_hash(lsh.augment_data(t(z)), t(w)))


@pytest.mark.parametrize("counts_dtype", ["int32", "int16", "int8"])
@pytest.mark.parametrize("seed,m,d,p,r", [(0, 17, 12, 4, 64), (1, 198, 7, 8, 33),
                                          (2, 5, 3, 1, 100)])
def test_sketch_query_equals_jax(seed, m, d, p, r, counts_dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(p, d, r)).astype(np.float32)
    # Row sums stay below 2^24, where an fp32 sum is exact.
    hi = min(np.iinfo(counts_dtype).max, (1 << 24) // r)
    counts = rng.integers(0, hi, size=(r, 1 << p)).astype(counts_dtype)
    got = ref.sketch_query(t(q), t(w), torch.from_numpy(counts))
    want_kernel = jquery.sketch_query(jnp.asarray(q), jnp.asarray(w),
                                      jnp.asarray(counts), block_m=8,
                                      block_r=16, interpret=True)
    want_ref = jref.sketch_query(jnp.asarray(q), jnp.asarray(w),
                                 jnp.asarray(counts))
    assert got.dtype == torch.float32 and got.shape == (m,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_kernel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))


def test_sketch_query_sums_large_counts_exactly():
    # 2048 rows of 2^23 overflow fp32's exact range; the int64 sum does not.
    w = torch.zeros((1, 2, 2048))
    counts = torch.full((2048, 2), 8_388_609, dtype=torch.int32)
    out = ref.sketch_query(torch.ones((1, 2)), w, counts)
    assert out.item() == np.float32(8_388_609)


def test_wrappers_run_plain_versions_on_cpu():
    z, w, mask = _insert_inputs(6, 40, 4, 4, 16, True)
    before = (histogram_kernel.paired_hash_histogram.launches,
              query_kernel.sketch_query.launches)
    hist = histogram_kernel.paired_hash_histogram(t(z), t(w), t(mask))
    assert torch.equal(hist, ref.paired_hash_histogram(t(z), t(w), t(mask)))
    q = torch.randn(9, 6, generator=torch.Generator().manual_seed(0))
    assert torch.equal(query_kernel.sketch_query(q, t(w), hist),
                       ref.sketch_query(q, t(w), hist))
    # Launches count kernel launches on the card only.
    assert (histogram_kernel.paired_hash_histogram.launches,
            query_kernel.sketch_query.launches) == before


def test_ops_modes_on_cpu():
    z, w, mask = _insert_inputs(7, 30, 3, 2, 8, False)
    auto = ops.paired_hash_histogram(t(z), t(w), t(mask), mode="auto")
    assert torch.equal(auto, ops.paired_hash_histogram(t(z), t(w), t(mask),
                                                       mode="ref"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paired_hash_histogram(t(z), t(w), t(mask), mode="kernel")
    with pytest.raises(ValueError, match="mode"):
        ops.sketch_query(t(z), t(w), auto, mode="interpret")
    with pytest.raises(ValueError):
        ops.sketch_query(t(z), t(w), auto[None])  # banked: not ported yet


def test_ops_sketch_stream_and_query_theta():
    gen = torch.Generator().manual_seed(0)
    params = lsh.init_srp(gen, 32, 4, 7, device="cpu")
    z = t(unit_ball_rows(8, 200, 5))
    mask = torch.ones(200)
    mask[150:] = 0
    sk = ops.sketch_stream(params, z, mask)
    assert int(sk.n) == 150
    assert torch.equal(sk.counts, ops.build_sketch(params, z[:150]).counts)
    narrow = ops.sketch_stream(params, z, mask, dtype=torch.uint16)
    assert torch.equal(narrow.counts.to(torch.int32), sk.counts)
    th = torch.randn(11, 5, generator=gen)
    torch.testing.assert_close(ops.query_theta(sk, params, th),
                               sketch.query_theta(sk, params, th),
                               rtol=0, atol=0)
    assert ops.query_theta(sk, params, th[0]).ndim == 0


def test_build_paths_are_content_addressed():
    srcs = _build.sources()
    assert {s.stem for s in srcs} == {"paired_hash_histogram", "sketch_query"}
    paths = [_build.library_path(s) for s in srcs]
    assert len(set(paths)) == 2
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
