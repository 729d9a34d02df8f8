"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. The file imports no JAX,
so it runs where the card is:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Both kernels accumulate the projections in the plain versions' order, so
the comparisons are bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import sketch_query as query_kernel
from repro_torch.kernels import storm_sketch as histogram_kernel


def _insert_inputs(seed, n, d, p, r, masked, device):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d)).astype(np.float32)
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
