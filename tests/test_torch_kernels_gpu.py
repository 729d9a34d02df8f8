"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. The file imports no JAX,
so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Every kernel accumulates the projections in its plain version's order, so
the comparisons are bit for bit; each slice of a banked insert also equals
the lone kernel on that tenant.
"""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import sketch_query as query_kernel
from repro_torch.kernels import storm_sketch as histogram_kernel


def _insert_inputs(seed, n, d, p, r, masked, device):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d)).astype(np.float32)
    if n:
        z /= np.quantile(np.linalg.norm(z, axis=1), 0.9) * 1.05
    z /= np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1.0)
    w = rng.normal(size=(p, d + 2, r)).astype(np.float32)
    mask = (rng.uniform(size=n) < 0.7 if masked else np.ones(n)).astype(
        np.float32)
    return (torch.from_numpy(a).to(device) for a in (z, w, mask))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("out", [torch.int32, torch.int16, torch.int8])
@pytest.mark.parametrize("seed,n,d,p,r,masked", [
    (0, 1000, 10, 4, 2048, False), (1, 777, 5, 1, 130, True),
    (2, 1234, 13, 8, 77, True), (3, 301, 32, 5, 64, False),
])
def test_insert_kernel_equals_plain_version(cuda, seed, n, d, p, r, masked,
                                            out):
    z, w, mask = _insert_inputs(seed, n, d, p, r, masked, cuda)
    got = histogram_kernel.paired_hash_histogram(z, w, mask, out)
    assert torch.equal(got, ref.paired_hash_histogram(z, w, mask, out))


def _weighted_mask(seed, lead, device):
    """A 0/1 mask (about half valid, masked slots interleaved) whose every
    third 256-slot tile carries integer weights in {0, 1, 2, 3}: weighted
    and binary tiles meet in one launch."""
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=lead) < 0.5).astype(np.float32)
    n = lead[-1]
    for start in range(256, n, 768):
        stop = min(start + 256, n)
        mask[..., start:stop] = rng.integers(0, 4, size=lead[:-1]
                                             + (stop - start,))
    return torch.from_numpy(mask).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4, 5, 8])
@pytest.mark.parametrize("d", [1, 10, 16, 17, 32])
def test_paired_insert_widths_and_planes_equal_plain_version(cuda, d, p):
    # The exact-width body (d = 10, p <= 4), the generic bodies (DMAX 16 and
    # 32), register counters and the shared histogram; lone and banked.
    z, w, mask = _insert_inputs(d * 10 + p, 3001, d, p, 300, True, cuda)
    got = histogram_kernel.paired_hash_histogram(z, w, mask)
    assert torch.equal(got, ref.paired_hash_histogram(z, w, mask))
    zb = torch.stack([z, z.flip(0)])
    mb = torch.stack([mask, 1 - mask])
    banked = histogram_kernel.paired_hash_histogram_banked(zb, w, mb)
    assert torch.equal(banked, ref.paired_hash_histogram_banked(zb, w, mb))


@pytest.mark.gpu
@pytest.mark.parametrize("d,p", [(10, 4), (17, 8), (3, 2)])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 100_003])
def test_paired_insert_ragged_streams_equal_plain_version(cuda, n, d, p):
    z, w, mask = _insert_inputs(n + d, n, d, p, 257, True, cuda)
    before = histogram_kernel.paired_hash_histogram.launches
    got = histogram_kernel.paired_hash_histogram(z, w, mask)
    assert histogram_kernel.paired_hash_histogram.launches == before + (n > 0)
    assert torch.equal(got, ref.paired_hash_histogram(z, w, mask))
    assert torch.equal(got.to(torch.int64).sum(1),
                       torch.full((257,), 2 * int(mask.sum()),
                                  dtype=torch.int64, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 3, 5])
def test_paired_insert_unaligned_views_equal_plain_version(cuda, offset):
    # A view that starts `offset` rows in: its points are not 16-byte
    # aligned, so the staging copies them 4 bytes at a time.
    z, w, mask = _insert_inputs(offset, 10_001, 10, 4, 512, True, cuda)
    zv, mv = z[offset:], mask[offset:]
    assert zv.is_contiguous() and zv.data_ptr() % 16
    got = histogram_kernel.paired_hash_histogram(zv, w, mv)
    assert torch.equal(got, ref.paired_hash_histogram(zv, w, mv))


@pytest.mark.gpu
def test_gateway_shaped_bank_equals_plain_and_lone(cuda):
    # 16 tenants x 4096 slots, about half masked, interleaved.
    s, n, d, p, r = 16, 4096, 10, 4, 2048
    rng = np.random.default_rng(11)
    z = torch.from_numpy((0.3 * rng.normal(size=(s, n, d))).astype(
        np.float32)).to(cuda)
    w = torch.from_numpy(rng.normal(size=(p, d + 2, r)).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy((rng.uniform(size=(s, n)) < 0.5).astype(
        np.float32)).to(cuda)
    got = histogram_kernel.paired_hash_histogram_banked(z, w, mask)
    assert torch.equal(got, ref.paired_hash_histogram_banked(z, w, mask))
    for i in (0, 7, 15):
        assert torch.equal(got[i], histogram_kernel.paired_hash_histogram(
            z[i].contiguous(), w, mask[i].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("d,p", [(10, 4), (16, 4), (17, 8), (10, 5)])
def test_paired_insert_integer_weighted_mask_equals_plain_version(cuda, d, p):
    z, w, _ = _insert_inputs(d + p, 5000, d, p, 200, False, cuda)
    mask = _weighted_mask(d + p, (5000,), cuda)
    assert int(mask.max()) == 3
    got = histogram_kernel.paired_hash_histogram(z, w, mask)
    assert torch.equal(got, ref.paired_hash_histogram(z, w, mask))
    zb = torch.stack([z, z, z])
    mb = _weighted_mask(d + p + 1, (3, 5000), cuda)
    mb[0] = mask
    banked = histogram_kernel.paired_hash_histogram_banked(zb, w, mb)
    assert torch.equal(banked, ref.paired_hash_histogram_banked(zb, w, mb))
    assert torch.equal(banked[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("d,p,out", [
    (10, 1, torch.int16), (3, 2, torch.int16), (10, 4, torch.int8),
    (10, 5, torch.int8), (17, 8, torch.int8),
])
def test_paired_insert_narrow_outputs_saturate(cuda, d, p, out):
    z, w, _ = _insert_inputs(3 * d + p, 100_003, d, p, 50, False, cuda)
    mask = _weighted_mask(p, (100_003,), cuda)
    got = histogram_kernel.paired_hash_histogram(z, w, mask, out)
    assert int(got.max()) == torch.iinfo(out).max
    assert torch.equal(got, ref.paired_hash_histogram(z, w, mask, out))


def _single_sided_inputs(seed, n, d, p, r, masked, device, tenants=None):
    """Augmented unit-ball rows ``[z, 0, pad]`` (``d`` columns in all)."""
    from repro_torch.core import lsh

    rng = np.random.default_rng(seed)
    lead = (n,) if tenants is None else (tenants, n)
    z = rng.normal(size=lead + (d - 2,)).astype(np.float32)
    if z.size:
        z /= np.quantile(np.linalg.norm(z, axis=-1), 0.9) * 1.05
    z /= np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1.0)
    x = lsh.augment_data(torch.from_numpy(z)).contiguous()
    w = rng.normal(size=(p, d, r)).astype(np.float32)
    mask = (rng.uniform(size=lead) < 0.7 if masked else np.ones(lead)).astype(
        np.float32)
    return x.to(device), torch.from_numpy(w).to(device), \
        torch.from_numpy(mask).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("out", [torch.int32, torch.int16, torch.int8])
@pytest.mark.parametrize("seed,n,d,p,r,masked", [
    (0, 1000, 11, 2, 1024, False), (1, 777, 7, 1, 130, True),
    (2, 1234, 15, 8, 77, True), (3, 301, 32, 5, 64, False),
])
def test_single_sided_insert_kernel_equals_plain_version(cuda, seed, n, d, p,
                                                         r, masked, out):
    x, w, mask = _single_sided_inputs(seed, n, d, p, r, masked, cuda)
    got = histogram_kernel.hash_histogram(x, w, mask, out)
    assert torch.equal(got, ref.hash_histogram(x, w, mask, out))


def _generic_rows(seed, lead, d, device):
    """Rows that are not augmented: about a tenth of the entries +0.0 and a
    tenth -0.0, every 97th row all +0.0 and every 194th (from 48) all -0.0.
    A kernel that skipped a column, or assumed the augmented zero column,
    or started a sum from +0 in a way that a comparison sees, differs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (d,)).astype(np.float32)
    u = rng.uniform(size=x.shape)
    x[u < 0.1] = 0.0
    x[(u >= 0.1) & (u < 0.2)] = -0.0
    x[..., ::97, :] = 0.0
    x[..., 48::194, :] = -0.0
    return torch.from_numpy(x).to(device)


def _single_rows(seed, n, d, p, r, device, tenants=None):
    """Augmented rows where d >= 3, else generic ones; w and a 0/1 mask."""
    if d >= 3:
        return _single_sided_inputs(seed, n, d, p, r, True, device, tenants)
    rng = np.random.default_rng(seed)
    lead = (n,) if tenants is None else (tenants, n)
    w = torch.from_numpy(rng.normal(size=(p, d, r)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=lead) < 0.7).astype(np.float32))
    return _generic_rows(seed, lead, d, device), w.to(device), mask.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("d", [1, 3, 4, 7, 11, 15, 16, 17, 31, 32])
def test_single_sided_insert_widths_and_planes_equal_plain_version(cuda, d,
                                                                   p):
    # The exact-width body (d = 11, p <= 5), the generic bodies (DMAX 16 and
    # 32), register counters and the shared histogram; lone and banked.
    x, w, mask = _single_rows(d * 10 + p, 3001, d, p, 300, cuda)
    got = histogram_kernel.hash_histogram(x, w, mask)
    assert torch.equal(got, ref.hash_histogram(x, w, mask))
    xb = torch.stack([x, x.flip(0)])
    mb = torch.stack([mask, 1 - mask])
    banked = histogram_kernel.hash_histogram_banked(xb, w, mb)
    assert torch.equal(banked, ref.hash_histogram_banked(xb, w, mb))
    assert torch.equal(banked[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("d,p", [(11, 2), (11, 4), (17, 8), (3, 2)])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 100_003])
def test_single_sided_insert_ragged_streams_equal_plain_version(cuda, n, d,
                                                                p):
    x, w, mask = _single_rows(n + d, n, d, p, 257, cuda)
    before = histogram_kernel.hash_histogram.launches
    got = histogram_kernel.hash_histogram(x, w, mask)
    assert histogram_kernel.hash_histogram.launches == before + (n > 0)
    assert torch.equal(got, ref.hash_histogram(x, w, mask))
    assert torch.equal(got.to(torch.int64).sum(1),
                       torch.full((257,), int(mask.sum()),
                                  dtype=torch.int64, device=cuda))
    xb, mb = x[None], mask[None]
    before = histogram_kernel.hash_histogram_banked.launches
    banked = histogram_kernel.hash_histogram_banked(xb, w, mb)
    assert histogram_kernel.hash_histogram_banked.launches == before + (n > 0)
    assert torch.equal(banked[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("d,p", [(11, 2), (13, 4)])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_single_sided_insert_unaligned_views_equal_plain_version(cuda, offset,
                                                                 d, p):
    # Rows that start `offset` floats into their buffer: not 16-byte
    # aligned, so the staging copies them 4 bytes at a time.
    x, w, mask = _single_rows(offset + d, 10_001, d, p, 512, cuda)
    buf = torch.empty(x.numel() + offset, device=cuda)
    xv = buf[offset:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16
    got = histogram_kernel.hash_histogram(xv, w, mask)
    assert torch.equal(got, ref.hash_histogram(x, w, mask))
    xb = torch.empty(2 * x.numel() + offset, device=cuda)[offset:].view(
        (2,) + x.shape)
    xb.copy_(torch.stack([x, x]))
    mb = torch.stack([mask, mask])
    banked = histogram_kernel.hash_histogram_banked(xb, w, mb)
    assert torch.equal(banked, ref.hash_histogram_banked(xb, w, mb))
    assert torch.equal(banked[1], got)


@pytest.mark.gpu
def test_gateway_shaped_single_sided_bank_equals_plain_and_lone(cuda):
    # 16 tenants x 4096 slots, about half masked, interleaved.
    s, n, d, p, r = 16, 4096, 11, 2, 1024
    x, w, _ = _single_sided_inputs(12, n, d, p, r, False, cuda, tenants=s)
    rng = np.random.default_rng(13)
    mask = torch.from_numpy((rng.uniform(size=(s, n)) < 0.5).astype(
        np.float32)).to(cuda)
    got = histogram_kernel.hash_histogram_banked(x, w, mask)
    assert torch.equal(got, ref.hash_histogram_banked(x, w, mask))
    for i in range(s):
        assert torch.equal(got[i], histogram_kernel.hash_histogram(
            x[i].contiguous(), w, mask[i].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("d,p", [(11, 2), (11, 4), (11, 5), (16, 4), (17, 8),
                                 (3, 1)])
def test_single_sided_insert_integer_weighted_mask_equals_plain_version(
        cuda, d, p):
    x, w, _ = _single_rows(d + p, 5000, d, p, 200, cuda)
    mask = _weighted_mask(d + p, (5000,), cuda)
    assert int(mask.max()) == 3
    got = histogram_kernel.hash_histogram(x, w, mask)
    assert torch.equal(got, ref.hash_histogram(x, w, mask))
    assert torch.equal(got.to(torch.int64).sum(1),
                       torch.full((200,), int(mask.to(torch.int64).sum()),
                                  dtype=torch.int64, device=cuda))
    xb = torch.stack([x, x, x])
    mb = _weighted_mask(d + p + 1, (3, 5000), cuda)
    mb[0] = mask
    banked = histogram_kernel.hash_histogram_banked(xb, w, mb)
    assert torch.equal(banked, ref.hash_histogram_banked(xb, w, mb))
    assert torch.equal(banked[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("d,p,out", [
    (11, 1, torch.int16), (3, 1, torch.int16), (11, 2, torch.int8),
    (11, 4, torch.int8), (11, 5, torch.int8), (17, 8, torch.int8),
])
def test_single_sided_insert_narrow_outputs_saturate(cuda, d, p, out):
    x, w, _ = _single_rows(3 * d + p, 100_003, d, p, 50, cuda)
    mask = _weighted_mask(p, (100_003,), cuda)
    got = histogram_kernel.hash_histogram(x, w, mask, out)
    assert int(got.max()) == torch.iinfo(out).max
    assert torch.equal(got, ref.hash_histogram(x, w, mask, out))
    banked = histogram_kernel.hash_histogram_banked(x[None], w, mask[None],
                                                    out)
    assert torch.equal(banked[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("d,p", [(11, 2), (11, 4), (11, 5), (5, 8), (16, 3),
                                 (32, 4), (1, 2)])
def test_single_sided_insert_generic_rows_equal_plain_version(cuda, d, p):
    # Rows that are not augmented, with exact +0.0 and -0.0 entries and
    # all-zero rows: the kernel projects every column it is given.
    x = _generic_rows(d + 7 * p, (20_000,), d, cuda)
    rng = np.random.default_rng(d + p)
    w = torch.from_numpy(rng.normal(size=(p, d, 333)).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy((rng.uniform(size=20_000) < 0.9).astype(
        np.float32)).to(cuda)
    got = histogram_kernel.hash_histogram(x, w, mask)
    want = ref.hash_histogram(x, w, mask)
    assert torch.equal(got, want)
    # All-zero rows project to exactly 0 on every plane: bucket 0.
    zero = torch.zeros(64, d, device=cuda)
    ones = torch.ones(64, device=cuda)
    assert torch.equal(histogram_kernel.hash_histogram(zero, w, ones)[:, 0],
                       torch.full((333,), 64, dtype=torch.int32, device=cuda))
    xb = torch.stack([x, -x])
    mb = torch.stack([mask, mask])
    banked = histogram_kernel.hash_histogram_banked(xb, w, mb)
    assert torch.equal(banked, ref.hash_histogram_banked(xb, w, mb))
    assert torch.equal(banked[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("out", [torch.int32, torch.int16, torch.int8])
@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("seed,s,n,d,p,r", [
    (0, 5, 999, 9, 4, 300), (1, 3, 2048, 11, 2, 1024), (2, 1, 77, 4, 8, 33),
])
def test_banked_insert_kernels_equal_plain_and_lone(cuda, seed, s, n, d, p, r,
                                                    paired, out):
    if paired:
        rng = np.random.default_rng(seed)
        z = rng.normal(size=(s, n, d)).astype(np.float32)
        z /= np.quantile(np.linalg.norm(z, axis=-1), 0.9) * 1.05
        z /= np.maximum(np.linalg.norm(z, axis=-1, keepdims=True), 1.0)
        x = torch.from_numpy(z).to(cuda)
        w = torch.from_numpy(
            rng.normal(size=(p, d + 2, r)).astype(np.float32)).to(cuda)
        mask = torch.from_numpy(
            (rng.uniform(size=(s, n)) < 0.8).astype(np.float32)).to(cuda)
        banked = histogram_kernel.paired_hash_histogram_banked
        lone = histogram_kernel.paired_hash_histogram
        plain = ref.paired_hash_histogram_banked
    else:
        x, w, mask = _single_sided_inputs(seed, n, d, p, r, True, cuda,
                                          tenants=s)
        banked = histogram_kernel.hash_histogram_banked
        lone = histogram_kernel.hash_histogram
        plain = ref.hash_histogram_banked
    mask[-1, n // 2:] = 0  # a ragged last tenant
    got = banked(x, w, mask, out)
    assert got.shape == (s, r, 1 << p) and got.dtype == out
    assert torch.equal(got, plain(x, w, mask, out))
    for i in range(s):
        assert torch.equal(got[i], lone(x[i].contiguous(), w,
                                        mask[i].contiguous(), out))


# The wide body (d > 32 or p > 8): features streamed through shared memory.
_WIDE_POINTS = {33: 3001, 64: 3001, 515: 1001, 4096: 257}


def _wide_case(paired, seed, n, d, p, r, device, masked=True):
    """Inputs and the three functions (lone kernel, banked kernel, plain
    banked version) of one insert: paired on unit-ball rows of d features,
    single-sided on augmented rows of d columns."""
    if paired:
        z, w, mask = _insert_inputs(seed, n, d, p, r, masked, device)
        return (z, w, mask, histogram_kernel.paired_hash_histogram,
                histogram_kernel.paired_hash_histogram_banked,
                ref.paired_hash_histogram, ref.paired_hash_histogram_banked)
    x, w, mask = _single_sided_inputs(seed, n, d, p, r, masked, device)
    return (x, w, mask, histogram_kernel.hash_histogram,
            histogram_kernel.hash_histogram_banked, ref.hash_histogram,
            ref.hash_histogram_banked)


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("p", [1, 4, 8, 9, 12])
@pytest.mark.parametrize("d", [33, 64, 515, 4096])
def test_wide_insert_equals_plain_version(cuda, d, p, paired):
    # Lone and banked, partial masks; every row's mass is the mask's.
    x, w, mask, lone, banked, plain, plain_banked = _wide_case(
        paired, d + p, _WIDE_POINTS[d], d, p, 300, cuda)
    before = lone.launches
    got = lone(x, w, mask)
    assert lone.launches == before + 1
    assert torch.equal(got, plain(x, w, mask))
    per_point = 2 if paired else 1
    assert torch.equal(got.to(torch.int64).sum(1),
                       torch.full((300,), per_point * int(mask.sum()),
                                  dtype=torch.int64, device=cuda))
    xb = torch.stack([x, x.flip(0)])
    mb = torch.stack([mask, 1 - mask])
    got_b = banked(xb, w, mb)
    assert torch.equal(got_b, plain_banked(xb, w, mb))
    assert torch.equal(got_b[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("d,p,n,out", [
    (33, 1, 100_003, torch.int16), (64, 4, 20_001, torch.int8),
    (515, 9, 100_003, torch.int8), (4096, 12, 2_001, torch.int32),
    (40, 9, 50_001, torch.int32),
])
def test_wide_insert_weighted_masks_and_narrow_outputs(cuda, d, p, n, out,
                                                       paired):
    # Integer weights in every third 256-slot tile; int16/int8 saturate.
    x, w, _, lone, banked, plain, _ = _wide_case(paired, d * p, n, d, p, 50,
                                                 cuda, masked=False)
    mask = _weighted_mask(d + p, (n,), cuda)
    assert int(mask.max()) == 3
    got = lone(x, w, mask, out)
    assert torch.equal(got, plain(x, w, mask, out))
    if out != torch.int32:
        assert int(got.max()) == torch.iinfo(out).max
    assert torch.equal(banked(x[None], w, mask[None], out)[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 3])
def test_wide_insert_unaligned_rows_and_empty_tiles(cuda, offset):
    # Rows that start `offset` floats into their buffer, and a mask whose
    # first tiles are all 0 (the wide body skips them).
    x, w, mask = _single_sided_inputs(offset, 5001, 70, 4, 257, True, cuda)
    buf = torch.empty(x.numel() + offset, device=cuda)
    xv = buf[offset:].view(x.shape)
    xv.copy_(x)
    mask[:1000] = 0
    got = histogram_kernel.hash_histogram(xv, w, mask)
    assert torch.equal(got, ref.hash_histogram(x, w, mask))
    z, wp, mp = _insert_inputs(offset, 5001, 70, 9, 257, True, cuda)
    mp[:1000] = 0
    got = histogram_kernel.paired_hash_histogram(z, wp, mp)
    assert torch.equal(got, ref.paired_hash_histogram(z, wp, mp))


# The projection tile (the wide body, and kernel 7's tiled path below): every
# pass layout of p (one pass of p planes up to 8, then passes of 5-8), tails
# of d (chunks of 32 or 16 features), R (tiles of 64 rows) and n.
_TILE_D = (33, 40, 63, 515, 4096)
_TILE_P = (1, 4, 5, 8, 9, 30)
_TILE_R = (1, 33, 1000, 2048)


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("p", _TILE_P)
@pytest.mark.parametrize("d", _TILE_D)
def test_projection_tile_inserts_equal_plain_version(cuda, d, p, paired):
    # R cycles through _TILE_R over the grid; p = 30 only at R = 1, whose
    # table alone has 2^30 buckets. Lone and banked, partial masks.
    r = 1 if p == 30 else _TILE_R[(_TILE_D.index(d) + _TILE_P.index(p)) % 4]
    n = 1001 if d == 4096 else 3001
    x, w, mask, lone, banked, plain, plain_banked = _wide_case(
        paired, 31 * d + p, n, d, p, r, cuda)
    before = lone.launches
    got = lone(x, w, mask)
    assert lone.launches == before + 1
    assert torch.equal(got, plain(x, w, mask))
    xb = torch.stack([x, x.flip(0)])
    mb = torch.stack([mask, 1 - mask])
    got_b = banked(xb, w, mb)
    assert torch.equal(got_b, plain_banked(xb, w, mb))
    assert torch.equal(got_b[0], got)


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("d,p,r,out", [
    (40, 4, 2048, torch.int32), (64, 1, 33, torch.int16),
    (515, 4, 1000, torch.int8), (4096, 5, 33, torch.int32),
])
def test_projection_tile_masks_views_and_outputs(cuda, d, p, r, out, paired):
    # All-zero masks (zero tables, one launch), whole tiles masked out beside
    # integer weights, int16/int8 outputs that saturate, and rows that start
    # one float into their buffer, lone and banked (d % 4 == 0, so only the
    # offset keeps the 16-byte copies off).
    n = 2001 if d == 4096 else 100_003 if out == torch.int16 else 20_001
    x, w, _, lone, banked, plain, plain_banked = _wide_case(
        paired, d + p, n, d, p, r, cuda, masked=False)
    zero = torch.zeros(n, device=cuda)
    before = lone.launches
    assert not lone(x, w, zero, out).any()
    assert lone.launches == before + 1
    mask = _weighted_mask(d * p, (n,), cuda)
    mask[:1000] = 0
    mask[5000:9000] = 0
    buf = torch.empty(2 * x.numel() + 1, device=cuda)
    xb = buf[1:].view((2,) + x.shape)
    xb.copy_(torch.stack([x, x.flip(0)]))
    assert xb.data_ptr() % 16 and xb[0].data_ptr() % 16
    got = lone(xb[0], w, mask, out)
    assert torch.equal(got, plain(x, w, mask, out))
    if out != torch.int32:
        assert int(got.max()) == torch.iinfo(out).max
    mb = torch.stack([mask, zero])
    got_b = banked(xb, w, mb, out)
    assert torch.equal(got_b, plain_banked(xb, w, mb, out))
    assert not got_b[1].any()


@pytest.mark.gpu
def test_wide_rows_sketch_bank_and_serve_on_the_card(cuda):
    # d > 32 through sketch_dataset, sketch_dataset_many and the gateway's
    # ingest: one kernel launch each, equal to the plain versions.
    from repro_torch.core import lsh, sketch
    from repro_torch.kernels import ops
    from repro_torch.serve.storm_gateway import IngestRequest, StormGateway

    gen = torch.Generator(device=cuda).manual_seed(9)
    dim = 40
    params = lsh.init_srp(gen, 256, 4, dim + 2, device=cuda)
    w = ops.from_lsh_params(params)
    zs = [lsh.scale_to_unit_ball(torch.randn(n, dim, generator=gen,
                                             device=cuda))[0].contiguous()
          for n in (3000, 2000)]
    counters = (histogram_kernel.paired_hash_histogram,
                histogram_kernel.paired_hash_histogram_banked)
    for c in counters:
        c.launches = 0
    sk = sketch.sketch_dataset(params, zs[0], engine="kernel", device=cuda)
    assert [c.launches for c in counters] == [1, 0]
    ones = torch.ones(3000, device=cuda)
    assert torch.equal(sk.counts, ref.paired_hash_histogram(zs[0], w, ones))
    bank = sketch.sketch_dataset_many(params, zs, engine="kernel",
                                      device=cuda)
    assert [c.launches for c in counters] == [1, 1]
    for i, z in enumerate(zs):
        assert torch.equal(bank.counts[i], ref.paired_hash_histogram(
            z, w, torch.ones(z.shape[0], device=cuda)))
    gw = StormGateway(params, 2, ingest_slots=1024, device=cuda)
    rng = np.random.default_rng(10)
    rows = [(0.1 * rng.normal(size=(700, dim))).astype(np.float32)
            for _ in range(2)]
    gw.submit_many([IngestRequest(rid=t, tenant=t, z=rows[t])
                    for t in range(2)])
    gw.tick()
    assert counters[1].launches == 2
    for t in range(2):
        zt = torch.from_numpy(rows[t]).to(cuda)
        assert torch.equal(gw.bank.counts[t], ref.paired_hash_histogram(
            zt, w, torch.ones(700, device=cuda)))


@pytest.mark.gpu
@pytest.mark.parametrize("banked", [False, True], ids=["lone", "banked"])
@pytest.mark.parametrize("counts_dtype", [torch.int32, torch.int16, torch.int8])
@pytest.mark.parametrize("p", [1, 4, 9, 16])
@pytest.mark.parametrize("rows", [1, 33, 2048])
@pytest.mark.parametrize("m", [0, 1, 17, 198, 272, 512, 1001, 4096])
def test_query_kernels_shapes_equal_plain_version(cuda, m, rows, p,
                                                  counts_dtype, banked):
    # Point tiles (m not a multiple of one, m = 0, 1), row slices (R = 1,
    # 33, 2048), the staged body (p <= 8) and the generic one (p > 8), narrow
    # counters and negative ones: bit for bit, one launch per non-empty call.
    gen = torch.Generator(device=cuda).manual_seed(m + rows + p)
    s = 2 if banked else 1
    w = torch.randn(p, 12, rows, generator=gen, device=cuda)
    hi = min(torch.iinfo(counts_dtype).max, 1 << 20)
    counts = torch.randint(-hi, hi, (s, rows, 1 << p), generator=gen,
                           device=cuda, dtype=torch.int32).to(counts_dtype)
    q = torch.randn(m, 12, generator=gen, device=cuda)
    if banked:
        idx = torch.randint(0, s, (m,), generator=gen, device=cuda)
        kernel = query_kernel.sketch_query_banked
        before = kernel.launches
        got = kernel(q, w, counts, idx)
        want = ref.sketch_query_banked(q, w, counts, idx)
    else:
        kernel = query_kernel.sketch_query
        before = kernel.launches
        got = kernel(q, w, counts[0])
        want = ref.sketch_query(q, w, counts[0])
    assert kernel.launches == before + (m > 0)
    assert got.shape == (m,) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("counts_dtype", [torch.int32, torch.int16, torch.int8])
@pytest.mark.parametrize("rows", [1, 33, 300, 4096])
@pytest.mark.parametrize("p", [1, 5, 8, 9, 16])
@pytest.mark.parametrize("d", [33, 515])
@pytest.mark.parametrize("m", [1, 17, 34, 65, 1001])
def test_query_kernels_wide_rows_equal_plain_version(cuda, m, d, p, rows,
                                                     counts_dtype):
    # The generic body (d > 32): each tile shape of its plan (4 or 8 warps
    # of 3, 5 or 9 points; several tiles at m = 1001), R that is not a
    # multiple of a block's 16 rows nor of 4 (cp.async in place of TMA),
    # passes over the planes (p > 8), narrow and negative counters; lone and
    # banked, bit for bit, one launch per call, the workspace zero after.
    gen = torch.Generator(device=cuda).manual_seed(m + d + p + rows)
    w = torch.randn(p, d, rows, generator=gen, device=cuda)
    hi = min(torch.iinfo(counts_dtype).max, 1 << 20)
    counts = torch.randint(-hi, hi, (3, rows, 1 << p), generator=gen,
                           device=cuda, dtype=torch.int32).to(counts_dtype)
    q = torch.randn(m, d, generator=gen, device=cuda)
    idx = torch.randint(0, 3, (m,), generator=gen, device=cuda)
    before = (query_kernel.sketch_query.launches,
              query_kernel.sketch_query_banked.launches)
    assert torch.equal(query_kernel.sketch_query(q, w, counts[1]),
                       ref.sketch_query(q, w, counts[1]))
    assert torch.equal(query_kernel.sketch_query_banked(q, w, counts, idx),
                       ref.sketch_query_banked(q, w, counts, idx))
    assert (query_kernel.sketch_query.launches,
            query_kernel.sketch_query_banked.launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert _workspace_is_zero(torch.device("cuda",
                                           torch.cuda.current_device()))


@pytest.mark.gpu
@pytest.mark.parametrize("p,d", [(4, 12), (8, 12), (8, 32)])
@pytest.mark.parametrize("m", [8449, 70_001])
def test_query_kernels_large_batches_equal_plain_version(cuda, m, p, d):
    # Many point tiles leave few blocks along R, so each row slice is as
    # large as the staged weights' cap in shared memory allows.
    gen = torch.Generator(device=cuda).manual_seed(m + p + d)
    w = torch.randn(p, d, 2048, generator=gen, device=cuda)
    counts = torch.randint(0, 1 << 20, (2, 2048, 1 << p), generator=gen,
                           device=cuda, dtype=torch.int32)
    q = torch.randn(m, d, generator=gen, device=cuda)
    idx = torch.randint(0, 2, (m,), generator=gen, device=cuda)
    assert torch.equal(query_kernel.sketch_query(q, w, counts[0]),
                       ref.sketch_query(q, w, counts[0]))
    assert torch.equal(query_kernel.sketch_query_banked(q, w, counts, idx),
                       ref.sketch_query_banked(q, w, counts, idx))


def _f32_tables(gen, shape, device):
    """Non-integer f32 tables of both signs, magnitudes 1e-2 to 1e10."""
    mag = 10.0 ** (torch.rand(shape, generator=gen, device=device) * 12 - 2)
    sign = torch.where(torch.rand(shape, generator=gen, device=device) < 0.3,
                       -1.0, 1.0)
    return (mag * sign).to(torch.float32)


def _within_f32_bound(got, want, scale):
    """|got - want| <= 2^-22 * mean|x| per point (``scale``: the plain
    query over |x|). The plain float64 sum has no fixed order, so the two
    may round to neighbouring f32 values; the kernel's order is fixed."""
    diff = (got.double() - want.double()).abs()
    return bool((diff <= 2.0 ** -22 * scale.double()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("banked", [False, True], ids=["lone", "banked"])
@pytest.mark.parametrize("p", [1, 4, 9])
@pytest.mark.parametrize("rows", [1, 33, 2048])
@pytest.mark.parametrize("m", [0, 1, 17, 272, 512, 4096])
def test_f32_query_kernels_equal_plain_version(cuda, m, rows, p, banked):
    # The f32 variant: the same bits on two launches, within 2^-22 mean|x|
    # of the plain version, one launch per non-empty call.
    gen = torch.Generator(device=cuda).manual_seed(7 * m + rows + p)
    w = torch.randn(p, 12, rows, generator=gen, device=cuda)
    tables = _f32_tables(gen, (3, rows, 1 << p), cuda)
    q = torch.randn(m, 12, generator=gen, device=cuda)
    if banked:
        idx = torch.randint(0, 3, (m,), generator=gen, device=cuda)
        kernel = query_kernel.sketch_query_banked_f32
        call = lambda c: query_kernel.sketch_query_banked(q, w, c, idx)
        plain = lambda c: ref.sketch_query_banked(q, w, c, idx)
    else:
        kernel = query_kernel.sketch_query_f32
        call = lambda c: query_kernel.sketch_query(q, w, c[1])
        plain = lambda c: ref.sketch_query(q, w, c[1])
    before = kernel.launches
    got, again = call(tables), call(tables)
    assert kernel.launches == before + 2 * (m > 0)
    assert got.shape == (m,) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert _within_f32_bound(got, plain(tables), plain(tables.abs()))
    # Integer-valued tables: the f32 body equals the integer body.
    counts = torch.randint(-(1 << 20), 1 << 20, (3, rows, 1 << p),
                           generator=gen, device=cuda, dtype=torch.int32)
    assert torch.equal(call(counts.float()), call(counts))


@pytest.mark.gpu
@pytest.mark.parametrize("p,d", [(4, 12), (8, 32), (4, 40)])
@pytest.mark.parametrize("m", [8449, 70_001])
def test_f32_query_kernels_large_batches_and_wide_rows(cuda, m, p, d):
    # Slices at the staged weights' cap, the generic body (d = 40), and a
    # partial workspace of many (slice, point) entries.
    gen = torch.Generator(device=cuda).manual_seed(m + p + d)
    w = torch.randn(p, d, 2048, generator=gen, device=cuda)
    tables = _f32_tables(gen, (2, 2048, 1 << p), cuda)
    q = torch.randn(m, d, generator=gen, device=cuda)
    idx = torch.randint(0, 2, (m,), generator=gen, device=cuda)
    got = query_kernel.sketch_query_banked(q, w, tables, idx)
    assert torch.equal(got, query_kernel.sketch_query_banked(q, w, tables,
                                                             idx))
    assert _within_f32_bound(got, ref.sketch_query_banked(q, w, tables, idx),
                             ref.sketch_query_banked(q, w, tables.abs(), idx))
    lone = query_kernel.sketch_query(q, w, tables[0])
    assert _within_f32_bound(lone, ref.sketch_query(q, w, tables[0]),
                             ref.sketch_query(q, w, tables[0].abs()))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [12, 40])
def test_f32_and_integer_queries_share_a_clean_workspace(cuda, d):
    # f32 and integer queries in turn on one stream, through the staged body
    # (d = 12) and the generic one (d = 40): each leaves the int64 sums and
    # the tickets at zero for the next.
    gen = torch.Generator(device=cuda).manual_seed(13)
    w = torch.randn(4, d, 2048, generator=gen, device=cuda)
    counts = torch.randint(0, 1 << 20, (4, 2048, 16), generator=gen,
                           device=cuda, dtype=torch.int32)
    dev = torch.device("cuda", torch.cuda.current_device())
    for m in (4096, 17, 512, 1, 272, 4097, 33):
        q = torch.randn(m, d, generator=gen, device=cuda)
        idx = torch.randint(0, 4, (m,), generator=gen, device=cuda)
        noisy = counts.float() + 0.5
        got = query_kernel.sketch_query_banked(q, w, noisy, idx)
        assert _within_f32_bound(got, ref.sketch_query_banked(q, w, noisy,
                                                              idx),
                                 ref.sketch_query_banked(q, w, noisy.abs(),
                                                         idx))
        assert _workspace_is_zero(dev)
        assert torch.equal(query_kernel.sketch_query_banked(q, w, counts, idx),
                           ref.sketch_query_banked(q, w, counts, idx))
        assert _workspace_is_zero(dev)


def _workspace_is_zero(device):
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(device).cuda_stream
    sums, tickets = query_kernel._WORKSPACES[(device.index, stream)]
    return not sums.any() and not tickets.any()


@pytest.mark.gpu
def test_query_workspace_resets_between_calls(cuda):
    # Calls in a row with different m, lone and banked, on two streams: each
    # equals its plain version, and the workspace is all zero after each.
    gen = torch.Generator(device=cuda).manual_seed(11)
    w = torch.randn(4, 12, 2048, generator=gen, device=cuda)
    counts = torch.randint(0, 1 << 20, (4, 2048, 16), generator=gen,
                           device=cuda, dtype=torch.int32)
    dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            for m in (4096, 17, 512, 1, 272, 4097, 33):
                q = torch.randn(m, 12, generator=gen, device=cuda)
                idx = torch.randint(0, 4, (m,), generator=gen, device=cuda)
                got = query_kernel.sketch_query(q, w, counts[m % 4])
                assert torch.equal(got, ref.sketch_query(q, w, counts[m % 4]))
                assert _workspace_is_zero(dev)
                got = query_kernel.sketch_query_banked(q, w, counts, idx)
                assert torch.equal(got,
                                   ref.sketch_query_banked(q, w, counts, idx))
                assert _workspace_is_zero(dev)


@pytest.mark.gpu
def test_query_with_a_wrong_checked_index_leaves_the_workspace_clean(cuda):
    # index_checked=True with an index one past the bank: the caller's
    # fault, read from the next table of a larger buffer here. The result
    # is wrong, but the next call sees a zero workspace and is right.
    gen = torch.Generator(device=cuda).manual_seed(12)
    w = torch.randn(4, 12, 2048, generator=gen, device=cuda)
    store = torch.randint(0, 1 << 20, (5, 2048, 16), generator=gen,
                          device=cuda, dtype=torch.int32)
    counts = store[:4]
    q = torch.randn(272, 12, generator=gen, device=cuda)
    idx = torch.randint(0, 4, (272,), generator=gen, device=cuda,
                        dtype=torch.int32)
    bad = idx.clone()
    bad[5] = 4
    got = query_kernel.sketch_query_banked(q, w, counts, bad,
                                           index_checked=True)
    assert torch.equal(got, ref.sketch_query_banked(q, w, store, bad))
    assert _workspace_is_zero(torch.device("cuda", torch.cuda.current_device()))
    assert torch.equal(query_kernel.sketch_query_banked(q, w, counts, idx),
                       ref.sketch_query_banked(q, w, counts, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("counts_dtype", [torch.int32, torch.int16, torch.int8])
@pytest.mark.parametrize("m", [272, 16, 4096, 1001])
def test_banked_query_kernel_equals_plain_version(cuda, m, counts_dtype):
    gen = torch.Generator(device=cuda).manual_seed(m)
    s = 16
    w = torch.randn(4, 12, 2048, generator=gen, device=cuda)
    hi = min(torch.iinfo(counts_dtype).max, 1 << 20)
    counts = torch.randint(0, hi, (s, 2048, 16), generator=gen, device=cuda,
                           dtype=torch.int32).to(counts_dtype)
    q = torch.randn(m, 12, generator=gen, device=cuda)
    idx = torch.randint(0, s, (m,), generator=gen, device=cuda)
    got = query_kernel.sketch_query_banked(q, w, counts, idx)
    assert torch.equal(got, ref.sketch_query_banked(q, w, counts, idx))
    one = query_kernel.sketch_query(q[:1], w, counts[int(idx[0])].contiguous())
    assert torch.equal(got[:1], one)
    with pytest.raises(ValueError, match="sketch_idx"):
        query_kernel.sketch_query_banked(q, w, counts, idx + s)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [17, 198, 4096, 1001])
def test_query_kernel_equals_plain_version(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn(4, 12, 2048, generator=gen, device=cuda)
    counts = torch.randint(0, 1 << 20, (2048, 16), generator=gen,
                           device=cuda, dtype=torch.int32)
    q = torch.randn(m, 12, generator=gen, device=cuda)
    got = query_kernel.sketch_query(q, w, counts)
    assert torch.equal(got, ref.sketch_query(q, w, counts))


@pytest.mark.gpu
def test_fit_on_the_card_runs_through_both_kernels(cuda):
    from repro_torch.core import dfo, regression
    from repro_torch.data import datasets
    from repro_torch.device import generator

    gen = generator(0, cuda)
    x, y, _ = datasets.make_regression(gen, 5000, 4, noise=0.2)
    cfg = regression.StormRegressorConfig(
        rows=512, dfo=dfo.DFOConfig(steps=50, num_queries=8, sigma=0.5,
                                    learning_rate=2.0, decay=0.995))
    histogram_kernel.paired_hash_histogram.launches = 0
    query_kernel.sketch_query.launches = 0
    fit = regression.fit(gen, x, y, cfg)
    assert fit.theta.device.type == "cuda"
    assert histogram_kernel.paired_hash_histogram.launches == 1
    # 50 DFO steps, 2 calls per refine pass, 1 selection call.
    assert query_kernel.sketch_query.launches == 50 + 2 * 1 + 1
    assert float(fit.mse(x, y)) < float(y.var())


@pytest.mark.gpu
def test_edge_to_model_pipeline_on_the_card(cuda):
    """``TestEdgeToModelPipeline`` (tests/test_torch_regression.py) on the
    card: the same size, configuration and bars, with torch draws. Sketch
    three shards through the insert kernel, merge them, drop the data and
    fit from the counters alone through the query kernel."""
    from repro_torch.core import baselines, dfo, distributed, lsh, regression
    from repro_torch.core import sketch as sketch_lib
    from repro_torch.data import datasets
    from repro_torch.device import generator

    gen = generator(0, cuda)
    x, y, _ = datasets.make_regression(gen, 1500, 6, noise=0.2, condition=8)
    cfg = regression.StormRegressorConfig(
        rows=2048,
        dfo=dfo.DFOConfig(steps=250, num_queries=8, sigma=0.5,
                          sigma_decay=0.995, learning_rate=2.0, decay=0.995,
                          average_tail=0.5),
    )
    xs = (x - x.mean(0)) / (x.std(0, correction=0) + 1e-8)
    ys = (y - y.mean()) / (y.std(correction=0) + 1e-8)
    z = torch.cat([xs, ys[:, None]], dim=-1)
    zs, _ = lsh.scale_to_unit_ball(z, cfg.norm_slack)
    params = lsh.init_srp(gen, cfg.rows, cfg.planes, z.shape[1] + 2,
                          device=cuda)
    histogram_kernel.paired_hash_histogram.launches = 0
    query_kernel.sketch_query.launches = 0
    merged = distributed.tree_merge(
        [sketch_lib.sketch_dataset(params, shard, engine="kernel",
                                   device=cuda)
         for shard in torch.tensor_split(zs, 3)])
    del z, zs, xs, ys  # from here on only the counters
    assert int(merged.n) == x.shape[0]
    assert histogram_kernel.paired_hash_histogram.launches == 3

    fit = regression.fit(gen, x, y, cfg, prebuilt=(merged, params, None),
                         device=cuda)
    assert histogram_kernel.paired_hash_histogram.launches == 3
    assert query_kernel.sketch_query.launches == 250 + 2 * cfg.refine_steps + 1
    mse = float(fit.mse(x, y))
    assert mse < 0.6 * float(y.var(correction=0)), mse
    ols = baselines.ols(x, y).theta
    cos = float(torch.dot(fit.theta, ols) / (fit.theta.norm() * ols.norm()))
    assert cos > 0.5, cos


@pytest.mark.gpu
def test_wide_fits_on_the_card_run_through_the_kernels(cuda):
    # d = 40: the paired insert takes 41 features and the single-sided one
    # 42, both on the wide body; the queries take the generic body. In 41
    # dimensions the default steps (sigma 0.5, learning rate 2) overshoot;
    # smaller steps over more query points and rows (chip_smoke.py phase
    # 15's configuration) beat the mean predictor here.
    from repro_torch.core import classification, dfo, regression
    from repro_torch.data import datasets
    from repro_torch.device import generator

    gen = generator(3, cuda)
    x, y, _ = datasets.make_regression(gen, 20000, 40, noise=0.2)
    cfg = regression.StormRegressorConfig(
        rows=4096, dfo=dfo.DFOConfig(steps=400, num_queries=32, sigma=0.15,
                                     sigma_decay=0.995, learning_rate=0.25,
                                     decay=0.995, average_tail=0.5))
    histogram_kernel.paired_hash_histogram.launches = 0
    query_kernel.sketch_query.launches = 0
    fit = regression.fit(gen, x, y, cfg)
    assert histogram_kernel.paired_hash_histogram.launches == 1
    assert query_kernel.sketch_query.launches == 400 + 2 * 1 + 1
    assert float(fit.mse(x, y)) < float(y.var())

    xc, yc, _ = datasets.make_classification(gen, 20000, 40)
    ccfg = classification.StormClassifierConfig(
        rows=256, planes=2, dfo=dfo.DFOConfig(steps=60, num_queries=8))
    histogram_kernel.hash_histogram.launches = 0
    query_kernel.sketch_query.launches = 0
    cfit = classification.fit(gen, xc, yc, ccfg)
    assert histogram_kernel.hash_histogram.launches == 1
    assert query_kernel.sketch_query.launches == 60 + 1
    assert float(cfit.accuracy(xc, yc)) > 0.5


@pytest.mark.gpu
def test_fit_many_on_the_card_queries_only_through_the_banked_kernel(cuda):
    from repro_torch.core import dfo, regression
    from repro_torch.data import datasets
    from repro_torch.device import generator

    gen = generator(1, cuda)
    xs, ys = [], []
    for n in (3000, 2500, 2000):
        x, y, _ = datasets.make_regression(gen, n, 4, noise=0.2)
        xs.append(x)
        ys.append(y)
    cfg = regression.StormRegressorConfig(
        rows=512, dfo=dfo.DFOConfig(steps=40, num_queries=8, sigma=0.5,
                                    learning_rate=2.0, decay=0.995))
    counters = (histogram_kernel.paired_hash_histogram,
                histogram_kernel.paired_hash_histogram_banked,
                query_kernel.sketch_query, query_kernel.sketch_query_banked)
    for c in counters:
        c.launches = 0
    fit = regression.fit_many(gen, xs, ys, cfg)
    launches = [c.launches for c in counters]
    # One insert per tenant; 40 DFO steps, 2 calls per refine pass and one
    # selection call, each one banked launch; no lone query.
    assert launches == [3, 0, 0, 40 + 2 * 1 + 1]
    assert fit.bank.n.tolist() == [3000, 2500, 2000]
    for i in range(3):
        assert float(fit.select(i).mse(xs[i], ys[i])) < float(ys[i].var())


@pytest.mark.gpu
def test_classification_fit_on_the_card_runs_the_single_sided_insert(cuda):
    from repro_torch.core import classification, dfo
    from repro_torch.data import datasets
    from repro_torch.device import generator

    gen = generator(2, cuda)
    x, y, _ = datasets.make_classification(gen, 20000, 5)
    cfg = classification.StormClassifierConfig(
        rows=256, planes=2, dfo=dfo.DFOConfig(steps=60, num_queries=8))
    histogram_kernel.hash_histogram.launches = 0
    query_kernel.sketch_query.launches = 0
    fit = classification.fit(gen, x, y, cfg)
    assert histogram_kernel.hash_histogram.launches == 1
    assert query_kernel.sketch_query.launches == 60 + 1
    assert float(fit.accuracy(x, y)) > 0.8


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,r,p", [
    (4096, 12, 2048, 4), (1001, 11, 33, 1), (777, 31, 2048, 8),
    (513, 70, 256, 4), (300, 515, 33, 1), (257, 12, 100, 30), (0, 12, 64, 4),
])
def test_srp_hash_kernel_equals_plain_version(cuda, n, d, r, p):
    from repro_torch.kernels import ops
    from repro_torch.kernels import srp_hash as hash_kernel

    gen = torch.Generator(device=cuda).manual_seed(n + d + r + p)
    x = torch.randn(n, d, generator=gen, device=cuda)
    w = torch.randn(p, d, r, generator=gen, device=cuda)
    before = hash_kernel.srp_hash.launches
    got = ops.srp_hash(x, w)
    assert hash_kernel.srp_hash.launches == before + (n > 0)
    assert got.shape == (n, r) and got.dtype == torch.int32
    assert torch.equal(got, ref.srp_hash(x, w))
    with pytest.raises(ValueError, match="p <= 30"):
        hash_kernel.srp_hash(x, torch.randn(31, d, r, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4, 8, 9, 30])
@pytest.mark.parametrize("d", [1, 11, 12, 13, 31, 32, 33, 515, 4099])
def test_srp_hash_paths_equal_plain_version(cuda, d, p):
    # Both paths (the register path's exact widths 11 and 12 and its generic
    # bodies; the projection tile past them) at R in {1, 33, 2048} and n in
    # {0, 1, 63, 100 003}, one launch per non-empty call. Shapes whose plain
    # version would run more than 2e11 multiply-adds are left out.
    from repro_torch.kernels import srp_hash as hash_kernel

    gen = torch.Generator(device=cuda).manual_seed(37 * d + p)
    for r in (1, 33, 2048):
        w = torch.randn(p, d, r, generator=gen, device=cuda)
        for n in (0, 1, 63, 100_003):
            if n * d * r * p > 2e11:
                continue
            x = torch.randn(n, d, generator=gen, device=cuda)
            before = hash_kernel.srp_hash.launches
            got = hash_kernel.srp_hash(x, w)
            assert hash_kernel.srp_hash.launches == before + (n > 0)
            assert got.shape == (n, r) and got.dtype == torch.int32
            assert torch.equal(got, ref.srp_hash(x, w)), (n, r)


@contextlib.contextmanager
def _no_host_sync():
    """Any device->host read (or blocking copy) raises inside."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_banked_query_with_a_host_checked_index_reads_nothing_back(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    s = 8
    w = torch.randn(4, 12, 2048, generator=gen, device=cuda)
    counts = torch.randint(0, 1 << 20, (s, 2048, 16), generator=gen,
                           device=cuda, dtype=torch.int32)
    q = torch.randn(136, 12, generator=gen, device=cuda)
    idx = torch.arange(s, device=cuda, dtype=torch.int32)[:, None].expand(
        s, 17).reshape(-1)
    want = ref.sketch_query_banked(q, w, counts, idx)
    with _no_host_sync():
        got = query_kernel.sketch_query_banked(q, w, counts, idx,
                                               index_checked=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="sketch_idx"):  # unchecked: refused
        query_kernel.sketch_query_banked(q, w, counts, idx + 1)
    with pytest.raises(RuntimeError):  # unchecked, the range is read back
        with _no_host_sync():
            query_kernel.sketch_query_banked(q, w, counts, idx)


@pytest.mark.gpu
def test_a_fit_many_dfo_step_reads_nothing_back(cuda):
    from repro_torch.core import dfo, erm, fleet, lsh, sketch

    gen = torch.Generator(device=cuda).manual_seed(6)
    s, dim = 4, 6
    params = lsh.init_srp(gen, 512, 4, dim + 2, device=cuda)
    zs = [lsh.scale_to_unit_ball(torch.randn(3000, dim, generator=gen,
                                             device=cuda))[0]
          for _ in range(s)]
    bank = sketch.sketch_dataset_many(params, zs, engine="kernel",
                                      device=cuda)
    members = torch.arange(s, dtype=torch.int32, device=cuda)
    loss_fn = erm.surrogate_loss_fn("prp_regression", bank, params,
                                    member_map=members)
    cfg = dfo.DFOConfig(steps=1, num_queries=8)
    theta0, sig, lr = fleet.seed_fleet_many(s, 1, dim, cfg, generator=gen,
                                            device=cuda)
    dirs = dfo.sphere_directions(gen, 1, s, 8, dim, cuda)
    proj = dfo.pin_last_coordinate(-1.0)
    query_kernel.sketch_query_banked.launches = 0
    with _no_host_sync():
        res = dfo.minimize_fleet(loss_fn, theta0, cfg, project=proj,
                                 sigma=sig, learning_rate=lr,
                                 directions=dirs)
    assert query_kernel.sketch_query_banked.launches == 1
    assert torch.isfinite(res.theta).all()


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [True, False])
def test_gateway_tick_start_is_sync_free_and_equals_plain(cuda, paired):
    from repro_torch.core import lsh
    from repro_torch.serve.storm_gateway import (
        IngestRequest, QueryRequest, StormGateway,
    )

    gen = torch.Generator(device=cuda).manual_seed(7)
    s, dim = 4, 5
    params = lsh.init_srp(gen, 256, 3, dim + 2, device=cuda)
    rng = np.random.default_rng(8)
    gws = [StormGateway(params, s, paired=paired, query_slots=8,
                        ingest_slots=64, mode=mode, device=cuda)
           for mode in ("auto", "ref")]
    in_dim = dim if paired else dim + 2
    for tick in range(6):
        reqs = []
        for t in range(s):
            if tick != 3:
                z = (0.3 * rng.normal(size=(50, in_dim))).astype(np.float32)
                reqs.append(IngestRequest(rid=100 * tick + t, tenant=t, z=z))
            if tick != 1:
                th = rng.normal(size=(5, dim)).astype(np.float32)
                reqs.append(QueryRequest(rid=100 * tick + 50 + t, tenant=t,
                                         thetas=th))
        reports = []
        for gw in gws:
            gw.submit_many(reqs)
            with _no_host_sync():
                inflight = gw.tick_start()
            reports.append(gw.tick_finish(inflight))
        assert [r.rid for r in reports[0].results] == \
            [r.rid for r in reports[1].results]
        for a, b in zip(reports[0].results, reports[1].results):
            np.testing.assert_array_equal(a.losses, b.losses)
    assert torch.equal(gws[0].bank.counts, gws[1].bank.counts)
    assert gws[0].trace_count == 3


@pytest.mark.gpu
@pytest.mark.parametrize("paired,in_dim,s,slots", [
    (True, 10, 16, 256),    # the zipf cell's rows (d = 9 and the target)
    (True, 2563, 2, 64),    # the zamba2 bridge's: the wide body
    (False, 12, 16, 256),   # single-sided, narrow body
    (False, 2565, 2, 64),   # single-sided, wide body
])
def test_gateway_over_stale_planted_staging_equals_plain(cuda, paired, in_dim,
                                                         s, slots):
    """The staging ring zeroes no ingest half after construction: masked
    slots keep an earlier tick's rows. With NaN, +-inf and +-1e30 planted
    in every row slot of the buffer each tick reuses, and fills that grow,
    shrink and go to 0 over three rounds of the ring, the kernels' gateway
    counts what the plain versions' does, bit for bit, tick by tick."""
    from repro_torch.core import lsh
    from repro_torch.serve import storm_gateway as port_gw

    dim = in_dim + 2 if paired else in_dim
    gen = torch.Generator(device=cuda).manual_seed(in_dim)
    params = lsh.init_srp(gen, 2048, 4, dim, device=cuda)
    gws = [port_gw.StormGateway(params, s, paired=paired, query_slots=4,
                                ingest_slots=slots, mode=mode, device=cuda)
           for mode in ("kernel", "ref")]
    rng = np.random.default_rng(in_dim)
    garbage = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30], np.float32)
    phases = [1.0, 0.6, 0.02, 0.0, 0.3, 1.0]
    ticks = 3 * port_gw.STAGING_SLOTS + 1
    for tick in range(ticks):
        reqs = []
        for t in range(s):
            n = int(slots * phases[(tick + t) % len(phases)])
            if n:
                z = 0.3 * rng.normal(size=(n, in_dim)) / np.sqrt(in_dim)
                reqs.append(port_gw.IngestRequest(
                    rid=tick * s + t, tenant=t, z=z.astype(np.float32)))
        for gw in gws:
            for sh in gw._shards:
                k = sh.staging._next
                zbuf = gw._views(sh.staging.buffer(k))[0].numpy()
                zbuf[...] = np.resize(np.roll(garbage, tick), zbuf.shape)
            gw.submit_many(reqs)
            gw.tick()
        assert torch.equal(gws[0].bank.counts, gws[1].bank.counts), tick
        assert torch.equal(gws[0].bank.n, gws[1].bank.n), tick
    assert int(gws[0].bank.n.sum()) > 0


# The LM probes' width: qwen2-7b's pooled hidden states (d_model = 3584)
# plus the target column, hashed over d_model + 3 = 3587 dimensions with
# R = 2048 and p = 4. Kernels 1 and 4 take the wide body there, kernels 2
# and 6 the generic one.
_PROBE_D, _PROBE_R, _PROBE_P = 3584 + 1, 2048, 4


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2048, 2047])
def test_inserts_at_d_model_scale_equal_plain_version(cuda, n):
    z, w, mask = _insert_inputs(n, n, _PROBE_D, _PROBE_P, _PROBE_R, True,
                                cuda)
    before = histogram_kernel.paired_hash_histogram.launches
    got = histogram_kernel.paired_hash_histogram(z, w, mask)
    assert histogram_kernel.paired_hash_histogram.launches == before + 1
    assert torch.equal(got, ref.paired_hash_histogram(z, w, mask))
    # The bridge's ingest: two tap slots of one gateway window each.
    zb = torch.stack([z[:256], z[256:512]])
    mb = torch.stack([mask[:256], torch.ones_like(mask[:256])])
    got_b = histogram_kernel.paired_hash_histogram_banked(zb, w, mb)
    assert torch.equal(got_b, ref.paired_hash_histogram_banked(zb, w, mb))
    assert torch.equal(got_b[0], histogram_kernel.paired_hash_histogram(
        zb[0], w, mb[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [17, 34])
def test_queries_at_d_model_scale_equal_plain_version(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn(_PROBE_P, _PROBE_D + 2, _PROBE_R, generator=gen,
                    device=cuda)
    counts = torch.randint(0, 1 << 12, (2, _PROBE_R, 1 << _PROBE_P),
                           generator=gen, device=cuda, dtype=torch.int32)
    q = torch.randn(m, _PROBE_D + 2, generator=gen, device=cuda)
    # A fit's fleet step: members in tenant-major order.
    idx = torch.arange(m, device=cuda, dtype=torch.int32) * 2 // m
    before = (query_kernel.sketch_query.launches,
              query_kernel.sketch_query_banked.launches)
    assert torch.equal(query_kernel.sketch_query(q, w, counts[0]),
                       ref.sketch_query(q, w, counts[0]))
    assert torch.equal(query_kernel.sketch_query_banked(q, w, counts, idx),
                       ref.sketch_query_banked(q, w, counts, idx))
    assert (query_kernel.sketch_query.launches,
            query_kernel.sketch_query_banked.launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert _workspace_is_zero(torch.device("cuda",
                                           torch.cuda.current_device()))
    # The f32 variant at the same shape: two launches give the same bits,
    # within 2^-22 mean|x| of the plain version; an integer-valued f32
    # table gives the integer body's result.
    tables = _f32_tables(gen, (2, _PROBE_R, 1 << _PROBE_P), cuda)
    for call, plain in (
        (lambda c: query_kernel.sketch_query(q, w, c[0]),
         lambda c: ref.sketch_query(q, w, c[0])),
        (lambda c: query_kernel.sketch_query_banked(q, w, c, idx),
         lambda c: ref.sketch_query_banked(q, w, c, idx)),
    ):
        got = call(tables)
        assert torch.equal(got, call(tables))
        assert _within_f32_bound(got, plain(tables), plain(tables.abs()))
        assert torch.equal(call(counts.float()), call(counts))
    assert _workspace_is_zero(torch.device("cuda",
                                           torch.cuda.current_device()))


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [True, False])
def test_drift_scorers_take_card_tensors(cuda, paired):
    # window_delta of two card snapshots stays on the card; both scorers
    # take it and give the numpy scores bit for bit.
    from repro_torch.telemetry import counter_distance, counter_kl, window_delta

    gen = torch.Generator(device=cuda).manual_seed(21)
    snaps = [torch.randint(0, 9, (2048, 16), generator=gen, device=cuda,
                           dtype=torch.int32) for _ in range(3)]
    snaps[1] += snaps[0]
    snaps[2] += snaps[1]
    a, b = window_delta(snaps[0], snaps[1]), window_delta(snaps[1], snaps[2])
    assert a.is_cuda and b.is_cuda
    na, nb = 40, 33
    for score in (counter_distance, counter_kl):
        assert score(a, na, b, nb, paired=paired) == score(
            a.cpu().numpy(), na, b.cpu().numpy(), nb, paired=paired)


def _train_setup(dtype=None):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    cfg = registry.get_config("gemma3-1b", smoke=True)
    kw = {}
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
        kw = dict(moment_dtype=dtype)
    tcfg = ts.TrainConfig(optimizer=opt_lib.AdamWConfig(
        learning_rate=3e-3, warmup_steps=5, total_steps=60, **kw))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    return cfg, tcfg, batch


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One gemma3-1b-smoke step (tied embeddings, sequences past the local
    window, remat) on the card and on the CPU from the same f32 state.
    cuBLAS and the CPU sum products in other orders: loss within 1e-5
    relative, gradient norm within 1e-4, the whole update within 1e-3
    relative L2. No bound is put on single elements: Adam divides by
    ``sqrt(nu) + eps``, so an element whose gradient is as small as the
    rounding (about 1e-8) moves by a fraction of lr in each device's own
    direction (on the H100, 0.078 lr at most)."""
    from repro_torch.device import resolve_device
    from repro_torch.train import train_step as ts
    from repro_torch.train import tree as tree_lib

    resolve_device(cuda)  # IEEE f32 products, no TF32
    cfg, tcfg, batch = _train_setup()
    host = ts.init_state(torch.Generator().manual_seed(0), cfg, tcfg,
                         device="cpu")
    old = [p.detach().clone() for p in tree_lib.leaves(host.params)]
    card = tree_lib.tree_map(
        lambda t: t.detach().to(cuda, copy=True).requires_grad_(
            t.requires_grad)
        if t.is_floating_point() else t, host)
    host, hm = ts.train_step(host, batch, cfg, tcfg)
    card, cm = ts.train_step(card, batch, cfg, tcfg)
    assert all(p.device.type == "cuda" for p in tree_lib.leaves(card.params))
    assert abs(float(cm["loss"]) - float(hm["loss"])) <= 1e-5 * float(
        hm["loss"])
    assert abs(float(cm["grad_norm"]) - float(hm["grad_norm"])) <= 1e-4 * \
        float(hm["grad_norm"])
    assert float(cm["lr"]) == float(hm["lr"])
    got = [p.detach().cpu() for p in tree_lib.leaves(card.params)]
    want = [p.detach() for p in tree_lib.leaves(host.params)]
    flat = lambda ts_: torch.cat([t.reshape(-1) for t in ts_])
    g, w, o = flat(got), flat(want), flat(old)
    assert float((g - w).norm()) <= 1e-3 * float((w - o).norm())


@pytest.mark.gpu
def test_bf16_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A bf16 state (bf16 parameters and moments, f32 master) trained one
    step on the card, saved and restored onto the card, bit for bit."""
    from repro_torch.train import checkpoint
    from repro_torch.train import train_step as ts
    from repro_torch.train import tree as tree_lib

    cfg, tcfg, batch = _train_setup("bfloat16")
    state = ts.init_state(torch.Generator(cuda).manual_seed(0), cfg, tcfg,
                          device=cuda)
    state, _ = ts.train_step(state, batch, cfg, tcfg)
    checkpoint.save(str(tmp_path), 1, state)
    fresh = ts.init_state(torch.Generator(cuda).manual_seed(1), cfg, tcfg,
                          device=cuda)
    step, restored, _ = checkpoint.restore(str(tmp_path), fresh)
    assert step == 1
    pairs = list(zip(tree_lib.leaf_paths(restored),
                     tree_lib.leaf_paths(state)))
    assert {t.dtype for (_, t), _ in pairs} == {torch.bfloat16,
                                                 torch.float32, torch.int32}
    for (name, a), (name_b, b) in pairs:
        assert name == name_b and a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a.detach(), b.detach()), name


_NON_DENSE = ("xlstm-1.3b", "zamba2-2.7b", "mixtral-8x22b",
              "phi3.5-moe-42b-a6.6b", "musicgen-medium",
              "llama-3.2-vision-11b")


def _lm_batch(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embeddings_provided:
        out["embeds"] = torch.from_numpy(
            (0.1 * rng.normal(size=(b, s, cfg.d_model))).astype(np.float32))
    else:
        out["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(b, s)).astype(np.int32))
    if "cross_attn" in cfg.cycle:
        out["cross_states"] = torch.from_numpy((0.1 * rng.normal(
            size=(b, cfg.cross_attn_tokens, cfg.d_model))).astype(np.float32))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _NON_DENSE)
def test_non_dense_smoke_configs_on_the_card_match_the_cpu(cuda, arch):
    """Each non-dense smoke config in f32, the same parameters on the card
    and on the CPU: forward (hidden and aux), prefill and four decode steps
    within 1e-4 (cuBLAS and the CPU sum products in other orders), and a
    train step's loss within 1e-5 relative with finite gradients."""
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.models import model
    from repro_torch.train import train_step as ts
    from repro_torch.train import tree as tree_lib

    resolve_device(cuda)  # IEEE f32 products, no TF32
    cfg = registry.get_config(arch, smoke=True)
    host = model.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    card = tree_lib.tree_map(lambda t: t.to(cuda), host)
    b, s, prefix = 2, 40, 36
    batch = _lm_batch(cfg, 1, b, s)
    on = lambda bt, dev: {k: v.to(dev) for k, v in bt.items()}
    close = lambda got, want: np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().numpy(), rtol=0, atol=1e-4)
    (hc, ac), (hh, ah) = (model.forward(card, cfg, on(batch, cuda)),
                          model.forward(host, cfg, batch))
    close(hc, hh)
    assert abs(float(ac) - float(ah)) <= 1e-5 * max(float(ah), 1.0)
    pre = {k: (v[:, :prefix] if k in ("tokens", "embeds") else v)
           for k, v in batch.items()}
    sc, lc = model.prefill(card, cfg, on(pre, cuda), cache_len=s)
    sh, lh = model.prefill(host, cfg, pre, cache_len=s)
    close(lc, lh)
    for pos in range(prefix, s):
        inp = ({"embeds": batch["embeds"][:, pos:pos + 1]} if
               cfg.embeddings_provided else {"tokens": batch["tokens"][:, pos]})
        lc, sc = model.decode_step(card, cfg, sc, on(inp, cuda), pos)
        lh, sh = model.decode_step(host, cfg, sh, inp, pos)
        close(lc, lh)
    for g, w in zip(tree_lib.leaves(sc), tree_lib.leaves(sh)):
        assert g.is_cuda and g.dtype == w.dtype
        close(g, w)
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32))
    train = dict(batch, labels=labels)
    lc, gc = ts.loss_and_grads(ts.trainable(card), cfg, on(train, cuda))
    lh, _ = ts.loss_and_grads(ts.trainable(host), cfg, train)
    assert abs(float(lc) - float(lh)) <= 1e-5 * float(lh)
    assert all(bool(torch.isfinite(g).all()) for g in tree_lib.leaves(gc))


@pytest.mark.gpu
def test_glr_chunked_in_bf16_at_zamba2_width_on_the_card(cuda):
    """One 1024-token chunk at zamba2-2.7b's 80 heads of 64 x 64 in bf16:
    the card's f32 chunk products against the CPU's, each output within
    one bf16 ulp (2^-7 relative) plus 1e-5 of the largest; then the
    gradients at a decay that overflows the reference's masked exp are
    finite on the card."""
    from repro_torch.device import resolve_device
    from repro_torch.models import ssm

    resolve_device(cuda)
    b, s, h, n = 1, 1024, 80, 64
    rng = np.random.default_rng(3)
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(torch.bfloat16)
    q, k, v = f(b, s, h, n), f(b, s, h, n), f(b, s, h, n)
    log_f = torch.from_numpy(-rng.uniform(0.0, 0.16, (b, s, h)).astype(
        np.float32))
    gate = torch.from_numpy(rng.uniform(0.001, 0.1, (b, s, h)).astype(
        np.float32))
    args = (q, k, v, log_f, gate)
    yc, stc = ssm.glr_chunked(*(a.to(cuda) for a in args), chunk=1024)
    yh, sth = ssm.glr_chunked(*args, chunk=1024)
    assert yc.dtype == torch.bfloat16 and yc.shape == (b, s, h, n)
    peak = float(yh.float().abs().max())
    gap = (yc.float().cpu() - yh.float()).abs()
    assert bool((gap <= 2.0 ** -7 * yh.float().abs() + 1e-5 * peak).all())
    np.testing.assert_allclose(stc.s.cpu().numpy(), sth.s.numpy(),
                               rtol=1e-4, atol=1e-4 * float(sth.s.abs().max()))
    strong = [a.to(cuda).float().requires_grad_() for a in args]
    with torch.no_grad():
        strong[3].fill_(-3.0)
    y, _ = ssm.glr_chunked(*strong, chunk=1024)
    grads = torch.autograd.grad(y.float().sum(), strong)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.gpu
def test_moe_prefill_at_4096_tokens_on_the_card_matches_the_cpu(cuda):
    """phi3.5-moe-smoke's MoE FFN on one 4096-token group (capacity factor
    1, so 1024 slots of each of 8 experts for 8192 choices: the busier
    experts drop tokens) in f32: the routing of the same logits is the same on
    both devices (experts, slots and drops exactly; the gates, softmax in
    another order, within 1e-6), and the output within 1e-4 of the
    CPU's."""
    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.models import model, moe

    resolve_device(cuda)
    cfg = registry.get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    host = model.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")["blocks"][0]["pos0"]["moe"]
    card = {k: v.to(cuda) for k, v in host.items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 4096, cfg.d_model)).astype(np.float32))
    logits = (x[0] @ host["router"])[None]
    capacity = int(4096 * 2 * 1.0 / cfg.num_experts)
    rh, auxh = moe._top_k_dispatch(logits, 2, capacity)
    rc, auxc = moe._top_k_dispatch(logits.to(cuda), 2, capacity)
    for field in ("expert", "slot", "kept"):
        assert torch.equal(getattr(rh, field), getattr(rc, field).cpu())
    assert not bool(rh.kept.all())  # capacity binds
    np.testing.assert_allclose(rc.gate.cpu().numpy(), rh.gate.numpy(),
                               rtol=0, atol=1e-6)
    assert float(auxc) == pytest.approx(float(auxh), rel=1e-6)
    kw = dict(experts_per_token=2, capacity_factor=1.0,
              compute_dtype=torch.float32)
    out_c, _ = moe.moe_ffn(card, x.to(cuda), **kw)
    out_h, _ = moe.moe_ffn(host, x, **kw)
    np.testing.assert_allclose(out_c.cpu().numpy(), out_h.numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.gpu
def test_glr_sequence_parallel_in_bf16_over_four_names_of_the_card(cuda):
    """xlstm-1.3b's recurrence widths (4 heads of 512 x 1024) in bf16 over
    4096 tokens, sequence-parallel at chunk 1024 over ``(cuda,) * 4`` on a
    ``model`` axis, against the meshless recurrence on the card: each
    output within one bf16 ulp (2^-7 relative) plus 1e-5 of the largest
    (the spans' f32 sums run in another order), the final state within
    1e-4 relative; gradients flow through every span and copy."""
    from repro_torch.device import resolve_device
    from repro_torch.models import ssm
    from repro_torch.sharding.mesh import Mesh

    resolve_device(cuda)
    b, s, h, dk, dv = 1, 4096, 4, 512, 1024
    rng = np.random.default_rng(5)
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (scale * rng.normal(size=shape)).astype(np.float32)).to(
            cuda, torch.bfloat16)
    q, k, v = f(b, s, h, dk), f(b, s, h, dk, scale=dk ** -0.5), f(b, s, h, dv)
    log_f = torch.nn.functional.logsigmoid(
        torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)
                         + 3.0)).to(cuda)
    gate = torch.sigmoid(torch.from_numpy(
        rng.normal(size=(b, s, h)).astype(np.float32))).to(cuda)
    args = (q, k, v, log_f, gate)
    mesh = Mesh([cuda] * 4, "model")
    y, st = ssm.glr_sequence_parallel(*args, mesh, chunk=1024,
                                      normalize=True, return_state=True)
    y0, st0 = ssm.glr_chunked(*args, chunk=1024, normalize=True)
    assert y.dtype == torch.bfloat16 and y.device.type == cuda.type
    peak = float(y0.float().abs().max())
    gap = (y.float() - y0.float()).abs()
    assert bool((gap <= 2.0 ** -7 * y0.float().abs() + 1e-5 * peak).all())
    for a, b0 in ((st.s, st0.s), (st.n, st0.n)):
        assert float((a - b0).norm() / b0.norm()) <= 1e-4
    grad_args = [a.detach().float().requires_grad_() for a in args]
    yg = ssm.glr_sequence_parallel(*grad_args, mesh, chunk=1024,
                                   normalize=True)
    grads = torch.autograd.grad(yg.sum(), grad_args)
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grads)


@pytest.mark.gpu
def test_placement_and_gather_on_a_2x2_mesh_of_one_card(cuda):
    """A tree of card tensors placed on ``(data 2, model 2)`` named on one
    card: tuple entries, replicated dims and a bf16 leaf; each block a copy
    of its own on the card, the bytes per device the specs' count, and the
    gather bit for bit."""
    from repro_torch.sharding import specs
    from repro_torch.sharding.mesh import Mesh
    from repro_torch.sharding.specs import P

    mesh = Mesh([cuda] * 4, ("data", "model"), (2, 2))
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn((64, 48), generator=gen, device=cuda),
            "e": torch.randn((32, 8), generator=gen, device=cuda).to(
                torch.bfloat16),
            "n": [torch.arange(12, device=cuda)]}
    spec = {"w": P(("data", "model"), None), "e": P(None, "model"),
            "n": [P()]}
    placed = specs.device_put(tree, specs.named(mesh, spec))
    assert all(b.device.type == cuda.type for x in
               [placed["w"], placed["e"], placed["n"][0]] for b in x.blocks)
    assert placed["w"].blocks[1].data_ptr() != tree["w"].data_ptr()
    assert specs.shard_bytes(placed) == [64 * 48 * 4 // 4 + 32 * 4 * 2
                                         + 12 * 8] * 4
    back = specs.gather_tree(placed)
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["e"], tree["e"])
    assert torch.equal(back["n"][0], tree["n"][0])


@pytest.mark.gpu
def test_compress_allreduce_on_the_card_matches_the_cpu(cuda):
    """Two ``"pod"`` shards on ``(cuda,) * 2`` against the same run on
    ``("cpu",) * 2``: the hash family is the same integer function on both
    devices; the card's atomic adds order each bucket's sum anyhow, so each
    pod's sketch is within ``(m + 1) 2^-24`` times its bucket's magnitude
    sum of the CPU's, and the estimates agree away from the threshold
    (within twice the largest such bound); the residual identity holds
    exactly as computed on the card."""
    from repro_torch.sharding.mesh import Mesh
    from repro_torch.train import compression as comp

    cfg = comp.SketchCompressorConfig(rows=5, cols=1 << 12,
                                      top_k_fraction=0.01)
    rng = np.random.default_rng(6)
    host = [{"a": torch.from_numpy(rng.normal(size=(1000, 600)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(5000,)).astype(
            np.float32)).to(torch.bfloat16)} for _ in range(2)]
    card = [{k: v.to(cuda) for k, v in g.items()} for g in host]
    n = 600_000 + 5000
    flat = torch.cat([host[0]["a"].reshape(-1), host[0]["b"].float()])
    sk_h = comp.sketch_vector(cfg, flat)
    sk_c = comp.sketch_vector(cfg, flat.to(cuda)).cpu()
    hashes = comp._hash_params(cfg, 0, n, torch.device("cpu"))
    ones = (hashes[0], hashes[1].abs())
    bound = (comp.sketch_vector(cfg, torch.ones(n), ones) + 1) * \
        2.0 ** -24 * comp.sketch_vector(cfg, flat.abs(), ones)
    assert bool(((sk_c - sk_h).abs() <= bound).all())

    runs = {}
    for key, dev, grads in (("host", "cpu", host), ("card", cuda, card)):
        mesh = Mesh([dev] * 2, "pod")
        states = [comp.init_state(g) for g in grads]
        runs[key] = comp.compress_allreduce(cfg, grads, states, mesh)
    (est_h, _), (est_c, st_c) = runs["host"], runs["card"]
    e_h = torch.cat([est_h[0]["a"].reshape(-1), est_h[0]["b"].float()])
    e_c = torch.cat([est_c[0]["a"].reshape(-1),
                     est_c[0]["b"].float()]).cpu()
    slack = 4 * float(bound.max())
    thresh = float(e_h.abs()[e_h != 0].min())
    clear = (e_h.abs() - thresh).abs() > slack
    assert bool(((e_c != 0) == (e_h != 0))[clear].all())
    assert float((e_c - e_h)[clear].abs().max()) <= slack + 2.0 ** -7 * \
        float(e_h.abs().max())
    for g, e, st in zip(card, est_c, st_c):
        assert torch.equal(st.residual["a"], (g["a"] + 0.0) - e["a"] * 2.0)
