"""The port's tenant banks against ``repro``: the banked kernels' plain
versions, ``SketchBank`` and its builders, the banked query, and
``regression.fit_many`` / ``classification.fit_many`` on shared draws.

The JAX Pallas kernels run as the JAX package's own tests run them on the
CPU, in interpret mode. Codes agree exactly except at fp sign ties of a
projection; the seeds below have none, and the tests say so by asserting
equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classification as jclassification
from repro.core import dfo as jdfo
from repro.core import lsh as jlsh
from repro.core import regression as jregression
from repro.core import sketch as jsk
from repro.data import datasets as jdatasets
from repro.kernels import ref as jref
from repro.kernels import sketch_query as jquery
from repro.kernels import storm_sketch as jstorm
from repro_torch import interop
from repro_torch.core import classification, dfo, erm, fleet, lsh, regression
from repro_torch.core import sketch as sketch_lib
from repro_torch.data import datasets
from repro_torch.device import generator
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sketch_query as query_kernel
from repro_torch.kernels import storm_sketch as histogram_kernel
from torch_parity import CPU, fleet_draws, jax_params, t, tenant_draws
from torch_parity import unit_ball_rows


def _port_dfo(cfg):
    return dfo.DFOConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _stack(seed, s, n, d, augment, weighted=False):
    z = np.stack([unit_ball_rows(seed + i, n, d) for i in range(s)])
    if augment:
        z = np.asarray(jlsh.augment_data(jnp.asarray(z)))
    mask = np.ones((s, n), np.float32)
    mask[-1, n - n // 3:] = 0  # a ragged last tenant
    if weighted:  # integer weights in {0, 1, 2, 3} for one tenant's middle
        mask[1, n // 4:n // 2] = np.random.default_rng(seed).integers(
            0, 4, size=n // 2 - n // 4)
    return z, mask


# -- the banked kernels' plain versions against the JAX kernels ----------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("out", ["int32", "int8"])
@pytest.mark.parametrize("paired", [True, False])
def test_banked_inserts_equal_jax(paired, out, weighted):
    s, n, d, p, r = 3, 70, 5, 4, 24
    z, mask = _stack(10, s, n, d, augment=not paired, weighted=weighted)
    d_w = d + 2
    w = np.random.default_rng(10).normal(size=(p, d_w, r)).astype(np.float32)
    tdt, jdt = getattr(torch, out), jnp.dtype(out)
    if paired:
        got = ref.paired_hash_histogram_banked(t(z), t(w), t(mask), tdt)
        jkern, jplain = (jstorm.paired_hash_histogram_banked,
                         jref.paired_hash_histogram_banked)
        lone = ref.paired_hash_histogram
    else:
        got = ref.hash_histogram_banked(t(z), t(w), t(mask), tdt)
        jkern, jplain = (jstorm.hash_histogram_banked,
                         jref.hash_histogram_banked)
        lone = ref.hash_histogram
    want = jkern(jnp.asarray(z), jnp.asarray(w), jnp.asarray(mask),
                 block_n=32, block_r=8, out_dtype=jdt, interpret=True)
    assert got.shape == (s, r, 1 << p) and got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jplain(jnp.asarray(z), jnp.asarray(w),
                                       jnp.asarray(mask), out_dtype=jdt)))
    for i in range(s):
        assert torch.equal(got[i], lone(t(z[i]), t(w), t(mask[i]), tdt))
    if out == "int32":
        per_point = 2 if paired else 1
        np.testing.assert_array_equal(
            got.sum(2).numpy(),
            np.repeat(per_point * mask.sum(1, keepdims=True), r, 1))


@pytest.mark.parametrize("counts_dtype", ["int32", "int16", "int8"])
@pytest.mark.parametrize("seed,s,m,d,p,r", [(11, 4, 37, 9, 4, 48),
                                            # The card's generic body:
                                            # d > 32 or p > 8.
                                            (12, 2, 34, 43, 4, 32),
                                            (13, 3, 17, 12, 9, 33)])
def test_banked_query_equals_jax(seed, s, m, d, p, r, counts_dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d)).astype(np.float32)
    w = rng.normal(size=(p, d, r)).astype(np.float32)
    hi = min(np.iinfo(counts_dtype).max, (1 << 24) // r)
    counts = rng.integers(0, hi, size=(s, r, 1 << p)).astype(counts_dtype)
    idx = rng.integers(0, s, size=m).astype(np.int32)
    got = ref.sketch_query_banked(t(q), t(w), torch.from_numpy(counts),
                                  torch.from_numpy(idx))
    want = jquery.sketch_query_banked(jnp.asarray(q), jnp.asarray(w),
                                      jnp.asarray(counts), jnp.asarray(idx),
                                      block_m=8, block_r=16, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.sketch_query_banked(
            jnp.asarray(q), jnp.asarray(w), jnp.asarray(counts),
            jnp.asarray(idx))))
    # The wrapper checks the index before it reads anything.
    assert torch.equal(query_kernel.sketch_query_banked(
        t(q), t(w), torch.from_numpy(counts), torch.from_numpy(idx)), got)
    with pytest.raises(ValueError, match="sketch_idx"):
        query_kernel.sketch_query_banked(t(q), t(w), torch.from_numpy(counts),
                                         torch.from_numpy(idx) - 1)


def test_banked_wrappers_run_plain_versions_on_cpu():
    z, mask = _stack(12, 2, 40, 4, augment=True)
    w = t(np.random.default_rng(12).normal(size=(2, 6, 16)).astype(np.float32))
    before = [f.launches for f in (histogram_kernel.hash_histogram,
                                   histogram_kernel.hash_histogram_banked,
                                   histogram_kernel.paired_hash_histogram_banked,
                                   query_kernel.sketch_query_banked)]
    bank = histogram_kernel.hash_histogram_banked(t(z), w, t(mask))
    assert torch.equal(bank[0], histogram_kernel.hash_histogram(
        t(z[0]), w, t(mask[0])))
    assert torch.equal(ops.hash_histogram_banked(t(z), w, t(mask), mode="ref"),
                       bank)
    narrow = ops.hash_histogram_banked(t(z), w, t(mask),
                                       out_dtype=torch.uint16)
    assert torch.equal(narrow.to(torch.int32), bank)
    with pytest.raises(ValueError, match="CUDA"):
        ops.hash_histogram_banked(t(z), w, t(mask), mode="kernel")
    after = [f.launches for f in (histogram_kernel.hash_histogram,
                                  histogram_kernel.hash_histogram_banked,
                                  histogram_kernel.paired_hash_histogram_banked,
                                  query_kernel.sketch_query_banked)]
    assert after == before  # launches count kernel launches on the card only


# -- SketchBank and its builders ---------------------------------------------

def test_bank_of_select_merge_and_memory_equal_jax():
    jp, tp = jax_params(20, 32, 4, 7)
    streams = [unit_ball_rows(20 + i, 50 + 20 * i, 5) for i in range(3)]
    jsks = [jsk.sketch_dataset(jp, jnp.asarray(z), batch=32, engine="scan")
            for z in streams]
    tsks = [sketch_lib.sketch_dataset(tp, t(z), batch=32, engine="scan",
                                      device=CPU) for z in streams]
    jbank, tbank = jsk.bank_of(jsks), sketch_lib.bank_of(tsks)
    np.testing.assert_array_equal(tbank.counts.numpy(),
                                  np.asarray(jbank.counts))
    np.testing.assert_array_equal(tbank.n.numpy(), np.asarray(jbank.n))
    assert (tbank.size, tbank.rows, tbank.buckets) == (3, 32, 16)
    assert torch.equal(tbank.select(1).counts, tsks[1].counts)
    assert tbank.memory_bytes() == jbank.memory_bytes()
    merged, jmerged = tbank.merge_groups([1, 0, 1]), jbank.merge_groups(
        [1, 0, 1])
    np.testing.assert_array_equal(merged.counts.numpy(),
                                  np.asarray(jmerged.counts))
    np.testing.assert_array_equal(merged.n.numpy(), np.asarray(jmerged.n))
    with pytest.raises(ValueError):
        sketch_lib.bank_of([tsks[0], sketch_lib.init_sketch(8, 16,
                                                            device="cpu")])
    with pytest.raises(ValueError):
        sketch_lib.bank_of([])
    counts, n = interop.bank_to_numpy(tbank)
    back = interop.sketch_bank(counts, n, device=CPU)
    assert torch.equal(back.counts, tbank.counts) and torch.equal(back.n,
                                                                   tbank.n)
    with pytest.raises(ValueError):
        interop.sketch_bank(counts[0], n, device=CPU)


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint16])
def test_merge_groups_saturates_narrow_counters(dtype):
    hi = torch.iinfo(dtype).max
    bank = sketch_lib.SketchBank(counts=torch.full((3, 2, 4), hi - 1,
                                                   dtype=dtype),
                                 n=torch.tensor([1, 2, 3], dtype=torch.int32))
    out = bank.merge_groups(torch.tensor([0, 0, 1]), num_groups=3)
    assert out.counts.dtype == dtype
    assert out.counts.to(torch.int32)[:, 0, 0].tolist() == [hi, hi - 1, 0]
    assert out.n.tolist() == [3, 3, 0]


def test_stack_ragged_equals_jax():
    streams = [unit_ball_rows(30 + i, n, 3) for i, n in enumerate((7, 4, 9))]
    got_z, got_m = sketch_lib.stack_ragged([t(z) for z in streams])
    want_z, want_m = jsk.stack_ragged([jnp.asarray(z) for z in streams])
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    block = t(np.stack([streams[2]] * 2))
    z, m = sketch_lib.stack_ragged(block)
    assert z is block and torch.equal(m, torch.ones(2, 9))
    with pytest.raises(ValueError):
        sketch_lib.stack_ragged(block[0])
    with pytest.raises(ValueError):
        sketch_lib.stack_ragged([t(streams[0]), torch.zeros(3, 4)])


@pytest.mark.parametrize("engine", ["scan", "kernel"])
@pytest.mark.parametrize("paired", [True, False])
def test_sketch_dataset_many_equals_jax(engine, paired):
    d = 5
    jp, tp = jax_params(40, 40, 4, d + 2)
    streams = [unit_ball_rows(40 + i, n, d) for i, n in enumerate((90, 61, 75))]
    if not paired:  # single-sided rows are already augmented
        streams = [np.asarray(jlsh.augment_data(jnp.asarray(z)))
                   for z in streams]
    want = jsk.sketch_dataset_many(jp, [jnp.asarray(z) for z in streams],
                                   batch=32, paired=paired, engine="scan")
    got = sketch_lib.sketch_dataset_many(tp, [t(z) for z in streams],
                                         batch=32, paired=paired,
                                         engine=engine, device=CPU)
    assert got.n.tolist() == [90, 61, 75] == np.asarray(want.n).tolist()
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    for i, z in enumerate(streams):  # each slice is the lone build
        lone = sketch_lib.sketch_dataset(tp, t(z), batch=32, paired=paired,
                                         engine=engine, device=CPU)
        assert torch.equal(got.select(i).counts, lone.counts)


def test_sketch_dataset_many_narrow_and_overrides():
    jp, tp = jax_params(41, 8, 1, 4)
    streams = [unit_ball_rows(41 + i, 300, 2) for i in range(2)]
    want = jsk.sketch_dataset_many(jp, [jnp.asarray(z) for z in streams],
                                   batch=100, dtype=jnp.int8, engine="scan")
    for engine in ("scan", "kernel"):
        got = sketch_lib.sketch_dataset_many(tp, [t(z) for z in streams],
                                             batch=100, dtype="int8",
                                             engine=engine, device=CPU)
        assert got.counts.dtype == torch.int8
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
    with pytest.raises(ValueError):
        sketch_lib.sketch_dataset_many(tp, [t(z) for z in streams], rows=4,
                                       engine="kernel", device=CPU)


@pytest.mark.parametrize("paired", [True, False])
def test_bank_query_and_query_theta_banked_equal_jax(paired):
    jp, tp = jax_params(50, 64, 4, 7)
    streams = [unit_ball_rows(50 + i, 200 + 50 * i, 5) for i in range(3)]
    jbank = jsk.sketch_dataset_many(jp, [jnp.asarray(z) for z in streams],
                                    batch=64, engine="scan")
    tbank = interop.sketch_bank(np.asarray(jbank.counts),
                                np.asarray(jbank.n), device=CPU)
    rng = np.random.default_rng(50)
    th = rng.normal(size=(21, 5)).astype(np.float32)
    idx = rng.integers(0, 3, size=21).astype(np.int32)
    want = jsk.query_theta_banked(jbank, jp, jnp.asarray(th),
                                  jnp.asarray(idx), paired=paired)
    got = sketch_lib.query_theta_banked(tbank, tp, t(th),
                                        torch.from_numpy(idx), paired=paired)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The kernel path's estimate (its plain version here) is the same number.
    w = ops.from_lsh_params(tp)
    fused = ops.query_theta_with_weights(tbank, w, t(th), paired=paired,
                                         sketch_idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(fused.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        ops.query_theta_with_weights(tbank, w, t(th), paired=paired)
    # Point i reads only its own tenant, with that tenant's denominator.
    lone = sketch_lib.query_theta(tbank.select(int(idx[0])), tp, t(th[:1]),
                                  paired=paired)
    assert torch.equal(got[:1], lone)


# -- the banked fleet ------------------------------------------------------------

def test_member_point_idx_and_banked_loss_routing():
    mm = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    assert fleet.member_point_idx(mm, 8).tolist() == [0, 0, 0, 0, 1, 1, 2, 2]
    with pytest.raises(ValueError):
        fleet.member_point_idx(mm, 6)
    jp, tp = jax_params(60, 32, 4, 7)
    bank = sketch_lib.sketch_dataset_many(
        tp, [t(unit_ball_rows(60 + i, 100, 5)) for i in range(3)],
        engine="scan", device=CPU)
    loss = erm.sketch_loss_fn(bank, tp, member_map=torch.arange(3))
    th = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    for i in range(3):
        lone = erm.sketch_loss_fn(bank.select(i), tp)
        assert torch.equal(loss(th)[2 * i:2 * i + 2], lone(th[2 * i:2 * i + 2]))
    with pytest.raises(ValueError):
        erm.sketch_loss_fn(bank, tp)
    one = sketch_lib.bank_of([bank.select(0)])
    single = erm.sketch_loss_fn(one, tp, member_map=torch.zeros(1))
    assert torch.equal(single(th), erm.sketch_loss_fn(bank.select(0), tp)(th))


def test_tenant_key_streams_do_not_overlap():
    gen0 = generator(0, CPU)
    assert fleet.tenant_key(gen0, 0) is gen0
    a = torch.randn(64, generator=fleet.tenant_key(generator(0, CPU), 1))
    b = torch.randn(64, generator=fleet.tenant_key(generator(1, CPU), 0))
    c = torch.randn(64, generator=fleet.tenant_key(generator(0, CPU), 2))
    again = torch.randn(64, generator=fleet.tenant_key(generator(0, CPU), 1))
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, again)


@pytest.mark.parametrize("select", ["best", "average"])
def test_select_theta_many_matches_jax_and_loop(select):
    from repro.core import fleet as jfleet

    rng = np.random.default_rng(61)
    thetas = rng.normal(size=(3, 4, 2)).astype(np.float32)
    traces = rng.normal(size=(3, 4, 5)).astype(np.float32)
    guard = np.array([0.0, -1.0], np.float32)
    targets = np.array([[0.1, -1.0], [0.5, 0.2], [-0.3, 0.4]], np.float32)

    def jl(th):  # banked over arange(S): each tenant block its own target
        tgt = jnp.repeat(jnp.asarray(targets), th.shape[0] // 3, axis=0)
        return jnp.sum((th - tgt) ** 2, -1)

    def tl(th):
        tgt = torch.repeat_interleave(t(targets), th.shape[0] // 3, dim=0)
        return torch.sum((th - tgt) ** 2, -1)

    want = jfleet.select_theta_many(jl, jnp.asarray(thetas),
                                    jnp.asarray(traces), select=select,
                                    basin_tol=0.5, guard=jnp.asarray(guard))
    got = fleet.select_theta_many(tl, t(thetas), t(traces), select=select,
                                  basin_tol=0.5, guard=t(guard))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6)


def test_seed_fleet_many_stacks_tenant_fleets():
    base = dfo.DFOConfig(sigma=0.5, learning_rate=2.0)
    theta0, sigmas, lrs = fleet.seed_fleet_many(
        3, 2, 4, base, theta0=torch.ones(3, 4), generator=generator(7, CPU),
        device=CPU)
    assert theta0.shape == (6, 4) and sigmas.shape == lrs.shape == (6,)
    lone = fleet.seed_fleet(2, 4, base, theta0=torch.ones(4),
                            generator=generator(7, CPU), device=CPU)
    assert torch.equal(theta0[:2], lone[0])  # tenant 0 draws from gen itself
    assert not torch.equal(theta0[3], theta0[1])


# -- fit_many ------------------------------------------------------------------

def _reg_tenants(s, n, d):
    out = [jdatasets.make_regression(jax.random.PRNGKey(10 + i), n - 100 * i,
                                     d, noise=0.3, condition=10)
           for i in range(s)]
    return [o[0] for o in out], [o[1] for o in out]


# The banked DFO fit is chaotic at fp rounding: moving the port's own draws
# by one ulp moves a tenant's final sketch loss by up to 3.6% and its MSE by
# up to 28% (3 tenants of n = 1200, d = 5, R = 1024, 150 steps). The parity
# tests therefore hold the port to JAX exactly where no rounding has
# compounded yet (the counts, and the first DFO steps on equal counts), and
# to the fit's own sensitivity after that.
_FLEET_LOSS_RTOL = 0.05


def test_regression_fit_many_matches_jax_on_shared_draws():
    # The shapes of test_torch_regression.py's lone parity test, 3 tenants.
    s, d = 3, 5
    jxs, jys = _reg_tenants(s, 1200, d)
    key = jax.random.PRNGKey(4)
    cfg = jregression.StormRegressorConfig(
        rows=1024, dfo=jdfo.DFOConfig(steps=150, num_queries=8, sigma=0.5,
                                      sigma_decay=0.995, learning_rate=2.0,
                                      decay=0.995, average_tail=0.5))
    want = jregression.fit_many(key, jxs, jys, cfg)

    k_hash, k_dfo = jax.random.split(key)
    params = interop.lsh_params(np.asarray(
        jlsh.init_srp(k_hash, cfg.rows, cfg.planes, d + 3).projections), CPU)
    keys, _ = tenant_draws(k_dfo, s, d + 1, init_noise=False)
    dirs, refine = fleet_draws(keys, cfg.dfo.steps, cfg.dfo.num_queries,
                               d + 1, refine_steps=cfg.refine_steps,
                               m=dfo.refine_sample_count(d + 1))
    pcfg = regression.StormRegressorConfig(rows=cfg.rows,
                                           dfo=_port_dfo(cfg.dfo))
    got = regression.fit_many(None, [t(x) for x in jxs], [t(y) for y in jys],
                              pcfg, params=params, directions=dirs,
                              refine_samples=refine, device=CPU)
    assert got.tenants == s and got.theta.shape == (s, d)
    assert got.bank.n.tolist() == [1200, 1100, 1000]
    # Counts: row masses exact, a few standardization-rounding ties moved.
    counts = got.bank.counts.numpy()
    np.testing.assert_array_equal(counts.sum(2),
                                  2 * np.array([[1200], [1100], [1000]])
                                  .repeat(cfg.rows, 1))
    moved = np.abs(counts - np.asarray(want.bank.counts)).sum() // 2
    assert moved <= 1e-4 * counts.sum(), moved
    # On JAX's own counts the banked loss closure gives JAX's values,
    # each point read from its own tenant's table.
    from repro.core import erm as jerm

    th = np.random.default_rng(4).normal(size=(s * 17, d + 1))
    th[:, -1] = -1.0
    jloss = jerm.surrogate_loss_fn(
        "prp_regression", want.bank, jlsh.init_srp(k_hash, cfg.rows,
                                                   cfg.planes, d + 3),
        member_map=jnp.arange(s, dtype=jnp.int32))
    tloss = erm.surrogate_loss_fn(
        "prp_regression", interop.sketch_bank(
            np.asarray(want.bank.counts), np.asarray(want.bank.n), device=CPU),
        params, member_map=torch.arange(s))
    got_v = tloss(t(th)).numpy()
    want_v = np.asarray(jloss(jnp.asarray(th, jnp.float32)))
    # Equal but where a query projection is a sign tie (one row moves).
    assert (got_v == want_v).mean() >= 0.9
    np.testing.assert_allclose(got_v, want_v, rtol=1e-3)
    np.testing.assert_allclose(got.fleet_losses.numpy(),
                               np.asarray(want.fleet_losses),
                               rtol=_FLEET_LOSS_RTOL)
    for i in range(s):
        x, y = t(jxs[i]), t(jys[i])
        assert float(got.select(i).mse(x, y)) < float(y.var())
        assert float(want.select(i).mse(jxs[i], jys[i])) < float(y.var())


def test_classification_fit_many_matches_jax_on_shared_draws():
    s, d, n = 2, 3, 400
    data = [jdatasets.make_classification(jax.random.PRNGKey(80 + i), n, d,
                                          margin=0.5) for i in range(s)]
    jxs, jys = [o[0] for o in data], [o[1] for o in data]
    key = jax.random.PRNGKey(81)
    cfg = jclassification.StormClassifierConfig(
        rows=256, planes=2, dfo=jdfo.DFOConfig(steps=60, num_queries=8,
                                               sigma=0.5, learning_rate=1.0,
                                               decay=0.995))
    want = jclassification.fit_many(key, jxs, jys, cfg)
    k_hash, k_rest = jax.random.split(key)
    params = interop.lsh_params(np.asarray(
        jlsh.init_srp(k_hash, cfg.rows, cfg.planes, d + 2).projections), CPU)
    keys, noise = tenant_draws(k_rest, s, d, init_noise=True)
    dirs, _ = fleet_draws(keys, cfg.dfo.steps, cfg.dfo.num_queries, d)
    pcfg = classification.StormClassifierConfig(rows=cfg.rows, planes=2,
                                                dfo=_port_dfo(cfg.dfo))
    got = classification.fit_many(None, [t(x) for x in jxs],
                                  [t(y) for y in jys], pcfg, params=params,
                                  directions=dirs, theta0_noise=noise,
                                  device=CPU)
    np.testing.assert_allclose(got.fleet_losses.numpy(),
                               np.asarray(want.fleet_losses),
                               rtol=_FLEET_LOSS_RTOL)
    accs = got.accuracy(t(np.stack(jxs)), t(np.stack(jys)))
    jaccs = np.asarray(want.accuracy(jnp.stack(jxs), jnp.stack(jys)))
    np.testing.assert_allclose(accs.numpy(), jaccs, atol=0.005)
    assert (accs > 0.8).all()


def test_regression_fit_many_of_one_tenant_is_fit_bit_for_bit():
    x, y, _ = datasets.make_regression(generator(90, CPU), 300, 3, noise=0.2)
    cfg = regression.StormRegressorConfig(
        rows=128, restarts=2, restart_select="average",
        dfo=dfo.DFOConfig(steps=30, num_queries=4, sigma=0.5,
                          learning_rate=2.0, decay=0.995))
    lone = regression.fit(generator(91, CPU), x, y, cfg, device=CPU)
    many = regression.fit_many(generator(91, CPU), [x], [y], cfg, device=CPU)
    one = many.select(0)
    assert torch.equal(one.sketch.counts, lone.sketch.counts)
    for name in ("theta", "intercept", "theta_std", "losses", "fleet_losses"):
        assert torch.equal(getattr(one, name), getattr(lone, name)), name


def test_classification_fit_many_of_one_tenant_is_fit_bit_for_bit():
    x, y, _ = datasets.make_classification(generator(92, CPU), 300, 3)
    cfg = classification.StormClassifierConfig(
        rows=128, planes=2, restarts=3, refine_steps=1,
        dfo=dfo.DFOConfig(steps=30, num_queries=4))
    lone = classification.fit(generator(93, CPU), x, y, cfg, device=CPU)
    many = classification.fit_many(generator(93, CPU), x[None], y[None], cfg,
                                   device=CPU)
    one = many.select(0)
    assert torch.equal(one.sketch.counts, lone.sketch.counts)
    for name in ("theta", "losses", "fleet_losses"):
        assert torch.equal(getattr(one, name), getattr(lone, name)), name


def test_fit_many_tenants_draw_their_own_streams():
    xs, ys = [], []
    for i in range(2):
        x, y, _ = datasets.make_classification(generator(94, CPU), 200, 3)
        xs.append(x)
        ys.append(y)
    cfg = classification.StormClassifierConfig(
        rows=64, planes=2, dfo=dfo.DFOConfig(steps=10, num_queries=4))
    got = classification.fit_many(generator(95, CPU), xs, ys, cfg,
                                  device=CPU)
    # Same data, same sketch: only the tenants' draws tell them apart.
    assert torch.equal(got.bank.counts[0], got.bank.counts[1])
    assert not torch.equal(got.theta[0], got.theta[1])


def test_fit_surrogate_many_runs_every_new_spec():
    xs = [datasets.make_classification(generator(96 + i, CPU), 150, 3)
          for i in range(2)]
    cfg = erm.ERMConfig(rows=64, planes=2,
                        dfo=dfo.DFOConfig(steps=10, num_queries=4))
    for name in ("margin_classification", "logistic", "kmeans"):
        ys = None if name == "kmeans" else [o[1] for o in xs]
        got = erm.fit_surrogate_many(name, generator(98, CPU),
                                     [o[0] for o in xs], ys, cfg, device=CPU)
        assert got.tenants == 2 and got.theta.shape == (2, 3)
        assert got.bank.n.tolist() == [150, 150]
        assert torch.isfinite(got.fleet_losses).all()
    with pytest.raises(ValueError):
        erm.fit_surrogate_many("logistic", None, [xs[0][0]], [], cfg,
                               device=CPU)
