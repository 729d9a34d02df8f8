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
from repro.kernels import srp_hash as jhash
from repro.kernels import storm_sketch as jstorm
from repro_torch.core import lsh, sketch
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import sketch_query as query_kernel
from repro_torch.kernels import srp_hash as hash_kernel
from repro_torch.kernels import storm_sketch as histogram_kernel
from torch_parity import t, unit_ball_rows

_DTYPES = {"int32": (torch.int32, jnp.int32), "int16": (torch.int16, jnp.int16),
           "int8": (torch.int8, jnp.int8)}


def _insert_inputs(seed, n, d, p, r, masked):
    """``masked``: False (all ones), True (0/1) or "weighted": 0/1 with
    integer weights in {0, 1, 2, 3} on the middle third only, the mask
    contract of the inserts (point i adds ``int(mask[i])``)."""
    rng = np.random.default_rng(seed)
    z = unit_ball_rows(seed, n, d)
    w = rng.normal(size=(p, d + 2, r)).astype(np.float32)
    mask = (rng.uniform(size=n) < 0.7 if masked else np.ones(n)).astype(
        np.float32)
    if masked == "weighted":
        mask[n // 3:2 * n // 3] = rng.integers(0, 4, size=2 * n // 3 - n // 3)
    return z, w, mask


@pytest.mark.parametrize("out", ["int32", "int16", "int8"])
@pytest.mark.parametrize("seed,n,d,p,r,masked", [
    (0, 37, 5, 1, 19, True),
    (1, 130, 6, 4, 45, False),
    (2, 61, 3, 8, 13, True),
    (8, 97, 10, 4, 21, "weighted"),
    (9, 70, 4, 5, 11, "weighted"),
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
    if masked == "weighted":  # the weights add, not just the valid slots
        assert int(mask.max()) > 1
        binary = ref.paired_hash_histogram(t(z), t(w), t(np.minimum(mask, 1)),
                                           tdt)
        assert not torch.equal(got, binary)


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("seed,n,d,p,r,masked", [
    (10, 37, 40, 4, 16, True),
    (11, 29, 515, 2, 16, "weighted"),
    (12, 33, 40, 9, 16, False),
])
def test_wide_inserts_equal_jax(seed, n, d, p, r, masked, paired):
    # Rows wider than the narrow kernels' 32 features (and p > 8): the JAX
    # kernels tile d in blocks of 512 (so d = 515 takes two), the card's
    # wide body streams it through shared memory; the plain version here is
    # what the card's kernel is held to bit for bit. Tolerance: exact.
    z, w, mask = _insert_inputs(seed, n, d, p, r, masked)
    if paired:
        got = ref.paired_hash_histogram(t(z), t(w), t(mask))
        want_kernel = jstorm.paired_hash_histogram(
            jnp.asarray(z), jnp.asarray(w), jnp.asarray(mask), block_n=32,
            block_r=16, interpret=True)
        want_ref = jref.paired_hash_histogram(jnp.asarray(z), jnp.asarray(w),
                                              jnp.asarray(mask))
    else:
        x = lsh.augment_data(t(z)).numpy()  # d + 2 columns, as w
        got = ref.hash_histogram(t(x), t(w), t(mask))
        want_kernel = jstorm.hash_histogram(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask), block_n=32,
            block_r=16, interpret=True)
        want_ref = jref.hash_histogram(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(mask))
    assert got.shape == (r, 1 << p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_kernel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    per_point = 2 if paired else 1
    np.testing.assert_array_equal(
        got.sum(1).numpy(), np.full(r, per_point * int(mask.astype(
            np.int32).sum())))


@pytest.mark.parametrize("banked", [False, True], ids=["lone", "banked"])
@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("d,p", [(33, 4), (64, 1), (4096, 4), (10, 9),
                                 (40, 12), (1, 30)])
def test_insert_checks_take_wide_rows_and_many_planes(d, p, paired, banked):
    # What the card's inserts take: any d (the wide body) and p up to 30.
    lead = (2, 5) if banked else (5,)
    x = torch.zeros(lead + (d,))
    w = torch.zeros((p, d + 2 if paired else d, 7))
    mask = torch.ones(lead)
    histogram_kernel._check_cuda(x, w, mask, torch.int32, paired, banked)
    with pytest.raises(ValueError, match="p <= 30"):
        histogram_kernel._check_cuda(x, torch.zeros((31,) + w.shape[1:]),
                                     mask, torch.int32, paired, banked)


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
                                          (2, 5, 3, 1, 100),
                                          # The card's generic body: d > 32
                                          # or p > 8.
                                          (3, 17, 43, 4, 64),
                                          (4, 17, 515, 4, 32),
                                          (5, 34, 12, 9, 33)])
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


def _released_table(rng, shape):
    """A privatized release as the privacy layer makes it: integer counts
    widened to f32 plus Laplace noise, so the cells are not integers."""
    counts = rng.integers(0, 50, size=shape).astype(np.float32)
    return counts + rng.laplace(0.0, 3.0, size=shape).astype(np.float32)


@pytest.mark.parametrize("banked", [False, True], ids=["lone", "banked"])
@pytest.mark.parametrize("seed,m,d,p,r", [(0, 17, 12, 4, 64), (1, 40, 7, 3, 33),
                                          (2, 5, 3, 1, 100)])
def test_sketch_query_reads_noisy_f32_tables(seed, m, d, p, r, banked):
    """The plain queries over a non-integer f32 table against JAX's ref
    gather on the same arrays. JAX sums the row in f32 and the port in
    float64, so the means differ by the f32 sum's rounding only: each
    addition rounds by at most 2^-24 of the running |sum|, hence
    |port - jax| <= R * 2^-23 * mean|x| per point (mean|x| over the
    point's gathered cells). Truncating the cells to integers (the
    integer path) misses by about half a count."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(p, d, r)).astype(np.float32)
    tables = _released_table(rng, (3, r, 1 << p))
    assert np.mean(tables != np.round(tables)) > 0.99
    if banked:
        idx = rng.integers(0, 3, size=m).astype(np.int32)
        got = ref.sketch_query_banked(t(q), t(w), t(tables), t(idx, torch.int32))
        want = jref.sketch_query_banked(jnp.asarray(q), jnp.asarray(w),
                                        jnp.asarray(tables), jnp.asarray(idx))
        scale = jref.sketch_query_banked(jnp.asarray(q), jnp.asarray(w),
                                         jnp.asarray(np.abs(tables)),
                                         jnp.asarray(idx))
    else:
        got = ref.sketch_query(t(q), t(w), t(tables[1]))
        want = jref.sketch_query(jnp.asarray(q), jnp.asarray(w),
                                 jnp.asarray(tables[1]))
        scale = jref.sketch_query(jnp.asarray(q), jnp.asarray(w),
                                  jnp.asarray(np.abs(tables[1])))
    assert got.dtype == torch.float32 and got.shape == (m,)
    bound = r * 2.0 ** -23 * np.asarray(scale, np.float64)
    assert np.all(np.abs(got.numpy().astype(np.float64)
                         - np.asarray(want, np.float64)) <= bound)


@pytest.mark.parametrize("banked", [False, True], ids=["lone", "banked"])
def test_integer_valued_f32_tables_equal_the_integer_path(banked):
    # Sums past 2^24 included: both paths sum exactly and convert once.
    rng = np.random.default_rng(3)
    q = t(rng.normal(size=(33, 6)))
    w = t(rng.normal(size=(4, 6, 2048)))
    counts = torch.from_numpy(rng.integers(-(1 << 23), (1 << 23) + 1,
                                           size=(2, 2048, 16)).astype(np.int32))
    counts[1, :, :] = 8_388_609
    if banked:
        idx = torch.from_numpy(rng.integers(0, 2, size=33).astype(np.int32))
        got = ref.sketch_query_banked(q, w, counts.float(), idx)
        want = ref.sketch_query_banked(q, w, counts, idx)
    else:
        got = ref.sketch_query(q, w, counts[0].float())
        want = ref.sketch_query(q, w, counts[0])
    assert torch.equal(got, want)
    assert torch.equal(ops.sketch_query(q, w, counts[1].float()),
                       torch.full((33,), 8_388_609.0))


def test_wrappers_run_plain_versions_on_cpu():
    z, w, mask = _insert_inputs(6, 40, 4, 4, 16, True)
    before = (histogram_kernel.paired_hash_histogram.launches,
              query_kernel.sketch_query.launches)
    hist = histogram_kernel.paired_hash_histogram(t(z), t(w), t(mask))
    assert torch.equal(hist, ref.paired_hash_histogram(t(z), t(w), t(mask)))
    q = torch.randn(9, 6, generator=torch.Generator().manual_seed(0))
    assert torch.equal(query_kernel.sketch_query(q, t(w), hist),
                       ref.sketch_query(q, t(w), hist))
    noisy = hist.float() + 0.25
    idx = torch.zeros(9, dtype=torch.int32)
    for got in (query_kernel.sketch_query(q, t(w), noisy),
                query_kernel.sketch_query_f32(q, t(w), noisy),
                query_kernel.sketch_query_banked(q, t(w), noisy[None], idx),
                query_kernel.sketch_query_banked_f32(q, t(w), noisy[None],
                                                     idx)):
        assert torch.equal(got, ref.sketch_query(q, t(w), noisy))
    # Launches count kernel launches on the card only.
    assert (histogram_kernel.paired_hash_histogram.launches,
            query_kernel.sketch_query.launches) == before
    assert (query_kernel.sketch_query_f32.launches,
            query_kernel.sketch_query_banked_f32.launches) == (0, 0)


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
        ops.sketch_query(t(z), t(w), auto[None])  # banked needs a sketch_idx


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
    assert {s.stem for s in srcs} == {"paired_hash_histogram",
                                      "hash_histogram", "sketch_query",
                                      "srp_hash"}
    paths = [_build.library_path(s) for s in srcs]
    assert len(set(paths)) == 4
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_paths_cover_the_shared_headers(tmp_path, monkeypatch):
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "hash_histogram.cu"
    before = _build.library_path(src)
    header = tmp_path / "insert_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(src) != before


@pytest.mark.parametrize("seed,n,d,r,p", [
    (0, 1, 11, 33, 1), (1, 300, 12, 256, 4), (2, 513, 70, 33, 8),
    (3, 300, 70, 256, 1), (4, 513, 11, 256, 4), (5, 1, 12, 33, 8),
])
def test_srp_hash_equals_jax(seed, n, d, r, p):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(p, d, r)).astype(np.float32)
    got = ops.srp_hash(t(x), t(w), mode="ref")
    assert got.dtype == torch.int32 and got.shape == (n, r)
    assert int(got.max()) < 1 << p and int(got.min()) >= 0
    want_ref = jref.srp_hash(jnp.asarray(x), jnp.asarray(w))
    want_kernel = jhash.srp_hash(jnp.asarray(x), jnp.asarray(w),
                                 interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_kernel))
    assert torch.equal(ops.srp_hash(t(x), t(w)), got)  # auto on the CPU


def test_srp_hash_wrapper_and_modes_on_cpu():
    x = torch.randn(7, 5, generator=torch.Generator().manual_seed(1))
    w = torch.randn(3, 5, 9, generator=torch.Generator().manual_seed(2))
    before = hash_kernel.srp_hash.launches
    assert torch.equal(hash_kernel.srp_hash(x, w), ref.srp_hash(x, w))
    assert hash_kernel.srp_hash.launches == before  # no card, no launch
    assert torch.equal(ops.srp_hash(x.double(), w), ref.srp_hash(x, w))
    with pytest.raises(ValueError, match="CUDA"):
        ops.srp_hash(x, w, mode="kernel")
    with pytest.raises(ValueError, match="mode"):
        ops.srp_hash(x, w, mode="interpret")
