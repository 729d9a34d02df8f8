"""The port's gateways on a device mesh against their meshless runs and the
reference's mesh gateways (``repro.serve.storm_gateway``, ``mesh=``).

Port meshes are ``"cpu"`` shards; the JAX gateways run with ``mode="ref"``
on ``Mesh(jax.devices()[:k])``, ``k = min(2, jax.device_count())`` (the
module asks for two host devices before JAX starts). At the reference
test's shapes (``tests/test_serve_gateway.py``: 4 query slots, 16 ingest
slots) a mesh gateway's reports, counters, ``n`` and fits equal the
meshless gateway's bit for bit, and its reports equal the JAX mesh
gateway's.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.core import privacy as jprivacy  # noqa: E402
from repro.serve import storm_gateway as jgw  # noqa: E402
from repro.serve import tiered_gateway as jtiered  # noqa: E402
from repro_torch.core import lsh, privacy  # noqa: E402
from repro_torch.core import sketch as sketch_lib  # noqa: E402
from repro_torch.serve import storm_gateway as port_gw  # noqa: E402
from repro_torch.serve.storm_gateway import StormGateway, report_key  # noqa: E402
from repro_torch.serve.tiered_gateway import TieredStormGateway  # noqa: E402
from repro_torch.sharding.mesh import Mesh  # noqa: E402
from torch_parity import CPU, jax_params, t  # noqa: E402

S = 4
D = 5  # sketch-space dim (the hash family has D + 2 features)
SLOTS = dict(query_slots=4, ingest_slots=16)
_JDTYPE = {torch.int32: jnp.int32, torch.int16: jnp.int16}


@pytest.fixture(scope="module")
def hashes():
    return jax_params(0, 64, 3, D + 2)


def _jmesh():
    k = min(2, jax.device_count())
    return JMesh(np.array(jax.devices()[:k]), ("bank",))


def _mesh(shards):
    return Mesh([CPU] * shards, "bank")


def _script(seed, tenants=S, rounds=6, augment=False, fits=False):
    """Per-round requests: ingest chunks (some beyond a tick's slots),
    queries (some empty), an idle round and, with ``fits``, cohort fits
    whose members sit on different shards."""
    rng = np.random.default_rng(seed)
    rid = 0
    script = []
    for r in range(rounds):
        reqs = []
        if r == rounds // 2:
            script.append(reqs)
            continue
        for tenant in range(tenants):
            if rng.random() < 0.8:
                z = (0.3 * rng.normal(size=(int(rng.integers(1, 40)), D))
                     ).astype(np.float32)
                if augment:
                    z = z / np.maximum(np.linalg.norm(z, axis=1,
                                                      keepdims=True), 1.0)
                    z = lsh.augment_data(t(z)).numpy()
                reqs.append(("ingest", rid, tenant, z))
                rid += 1
            if rng.random() < 0.7:
                th = rng.normal(size=(int(rng.integers(0, 9)), D)).astype(
                    np.float32)
                reqs.append(("query", rid, tenant, th))
                rid += 1
        if fits and r in (1, rounds - 1):
            reqs.append(("fit", rid, [tenants - 1, 0, 1], None))
            rid += 1
        script.append(reqs)
    return script


def _requests(mod, reqs):
    out = []
    for kind, rid, tenant, arr in reqs:
        if kind == "ingest":
            out.append(mod.IngestRequest(rid=rid, tenant=tenant, z=arr))
        elif kind == "query":
            out.append(mod.QueryRequest(rid=rid, tenant=tenant, thetas=arr))
        else:
            out.append(mod.FitRequest(rid=rid, tenants=tenant, seed=rid,
                                      steps=12, num_queries=4))
    return out


def _drive(gw, mod, script, depth=1):
    """Submit each round and start a tick, finishing with up to ``depth``
    ticks in flight; then drain. Returns the reports."""
    reports, inflight = [], []
    for reqs in script:
        gw.submit_many(_requests(mod, reqs))
        inflight.append(gw.tick_start())
        while len(inflight) >= depth:
            reports.append(gw.tick_finish(inflight.pop(0)))
    while inflight or gw.pending:
        if gw.pending and len(inflight) < depth:
            inflight.append(gw.tick_start())
        else:
            reports.append(gw.tick_finish(inflight.pop(0)))
    return reports


_JAX_RUNS = {}


def _jax_mesh_run(hashes, paired, dtype):
    """The JAX mesh gateway's report keys and bank (computed once)."""
    key = (paired, dtype)
    if key not in _JAX_RUNS:
        gw = jgw.StormGateway(hashes[0], S, paired=paired, mode="ref",
                              count_dtype=_JDTYPE[dtype], mesh=_jmesh(),
                              **SLOTS)
        reps = _drive(gw, jgw, _script(7, augment=not paired))
        _JAX_RUNS[key] = ([report_key(r) for r in reps],
                          np.asarray(gw.bank.counts), np.asarray(gw.bank.n))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("paired,dtype", [
    (True, torch.int32), (True, torch.int16), (False, torch.int32),
])
def test_mesh_gateway_equals_meshless_and_the_jax_mesh(hashes, paired, dtype,
                                                       shards):
    _, tp = hashes
    script = _script(7, augment=not paired)
    flat = StormGateway(tp, S, paired=paired, count_dtype=dtype, device=CPU,
                        **SLOTS)
    want = [report_key(r) for r in _drive(flat, port_gw, script)]
    gw = StormGateway(tp, S, paired=paired, count_dtype=dtype,
                      mesh=_mesh(shards), **SLOTS)
    got = [report_key(r) for r in _drive(gw, port_gw, script)]
    assert got == want
    assert torch.equal(gw.bank.counts, flat.bank.counts)
    assert torch.equal(gw.bank.n, flat.bank.n)
    assert gw.bank.counts.dtype == dtype
    assert gw.queue_stats() == flat.queue_stats()
    assert gw.trace_count <= 3
    # Every shard ran the same bodies over its own block of tenants.
    counts, ns = gw.bank_blocks()
    assert [c.shape[0] for c in counts] == [S // shards] * shards
    jkeys, jcounts, jn = _jax_mesh_run(hashes, paired, dtype)
    assert got == jkeys
    np.testing.assert_array_equal(gw.bank.counts.numpy(), jcounts)
    np.testing.assert_array_equal(gw.bank.n.numpy(), jn)


@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_gateway_fits_gather_across_shards(hashes, shards):
    _, tp = hashes
    script = _script(9, fits=True)
    flat = StormGateway(tp, S, device=CPU, **SLOTS)
    want = _drive(flat, port_gw, script)
    gw = StormGateway(tp, S, mesh=_mesh(shards), **SLOTS)
    got = _drive(gw, port_gw, script)
    fits = [f for rep in got for f in rep.fits]
    assert len(fits) == 2 and fits[0].tenants == [S - 1, 0, 1]
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    assert gw.fits_run == flat.fits_run == 2


@pytest.mark.parametrize("depth", [2, 3])
def test_mesh_gateway_pipelined_equals_sync(hashes, depth):
    _, tp = hashes
    script = _script(21, fits=True)
    sync = StormGateway(tp, S, mesh=_mesh(2), **SLOTS)
    want = _drive(sync, port_gw, script)
    piped = StormGateway(tp, S, mesh=_mesh(2), **SLOTS)
    got = _drive(piped, port_gw, script, depth=depth)
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    assert torch.equal(piped.bank.counts, sync.bank.counts)
    assert torch.equal(piped.bank.n, sync.bank.n)
    assert piped.queue_stats() == sync.queue_stats()
    assert piped.trace_count <= 3


def test_mesh_gateway_warm_start_and_reads(hashes):
    _, tp = hashes
    rng = np.random.default_rng(3)
    counts = torch.from_numpy(rng.integers(0, 9, size=(S, 64, 8)).astype(
        np.int32))
    n = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    gw = StormGateway(tp, S, bank=sketch_lib.SketchBank(counts=counts, n=n),
                      mesh=_mesh(2), **SLOTS)
    assert torch.equal(gw.bank.counts, counts) and torch.equal(gw.bank.n, n)
    for tenant in range(S):
        sk = gw.sketch_of(tenant)
        assert torch.equal(sk.counts, counts[tenant])
        assert int(sk.n) == int(n[tenant])
    blocks, ns = gw.bank_blocks()
    assert torch.equal(blocks[1], counts[2:]) and torch.equal(ns[0], n[:2])
    blocks[0].zero_()  # the shards own copies, not the warm bank
    assert int(counts[0].sum()) > 0
    assert gw.device == torch.device("cpu")


def test_mesh_gateway_rejects_privacy_and_indivisible_banks(hashes):
    jp, tp = hashes
    policy = privacy.ReleasePolicy(epsilon_total=4.0, epsilon_release=1.0)
    with pytest.raises(NotImplementedError, match="meshless-only") as port_err:
        StormGateway(tp, S, mesh=_mesh(2), privacy=policy, **SLOTS)
    with pytest.raises(NotImplementedError, match="meshless-only") as jax_err:
        jgw.StormGateway(jp, S, mesh=_jmesh(), mode="ref",
                         privacy=jprivacy.ReleasePolicy(
                             epsilon_total=4.0, epsilon_release=1.0),
                         **SLOTS)
    assert str(port_err.value) == str(jax_err.value)
    # eps = inf runs on a mesh unchanged.
    gw = StormGateway(tp, S, mesh=_mesh(2),
                      privacy=privacy.ReleasePolicy.unlimited(), **SLOTS)
    assert gw.private_view is None
    with pytest.raises(ValueError, match="divisible") as port_err:
        StormGateway(tp, 3, mesh=_mesh(2), **SLOTS)
    if jax.device_count() >= 2:
        with pytest.raises(ValueError, match="divisible") as jax_err:
            jgw.StormGateway(jp, 3, mesh=_jmesh(), **SLOTS)
        assert str(port_err.value) == str(jax_err.value)


# -- the tiered gateway ----------------------------------------------------------

def _tiered_script(tenants, seed, rounds=10):
    """Per-round requests touching every tenant in turn (so cold tenants
    promote and residents get evicted)."""
    rng = np.random.default_rng(seed)
    rid = 0
    script = []
    for r in range(rounds):
        reqs = []
        for tenant in rng.permutation(tenants)[:3]:
            z = (0.3 * rng.normal(size=(int(rng.integers(1, 30)), D))
                 ).astype(np.float32)
            reqs.append(("ingest", rid, int(tenant), z))
            th = rng.normal(size=(int(rng.integers(1, 6)), D)).astype(
                np.float32)
            reqs.append(("query", rid + 1, int(tenant), th))
            rid += 2
        if r == rounds // 2:
            reqs.append(("fit", rid, [0, tenants - 1], None))
            rid += 1
        script.append(reqs)
    return script


@pytest.mark.parametrize("tenants,hot", [(4, 4), (8, 4)])
def test_tiered_gateway_on_a_mesh_equals_meshless(hashes, tenants, hot):
    _, tp = hashes
    script = _tiered_script(tenants, seed=5)
    kw = dict(count_dtype=torch.int16, promote_per_tick=2, **SLOTS)
    flat = TieredStormGateway(tp, tenants, hot, device=CPU, **kw)
    want = _drive(flat, port_gw, script)
    gt = TieredStormGateway(tp, tenants, hot, mesh=_mesh(2), **kw)
    got = _drive(gt, port_gw, script)
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    for tenant in range(tenants):
        a, b = gt.sketch_of(tenant), flat.sketch_of(tenant)
        assert torch.equal(a.counts, b.counts) and int(a.n) == int(b.n)
    assert torch.equal(gt.resident_bank.counts, flat.resident_bank.counts)
    assignment = [t % 2 for t in range(tenants)]
    assert torch.equal(gt.rollup(assignment).counts,
                       flat.rollup(assignment).counts)
    assert gt.promotions == flat.promotions
    assert gt.trace_count <= 4
    if hot < tenants:
        assert gt.demotions > 0
    else:
        # The reference's own mesh test (tests/test_tiered_gateway.py):
        # every tenant resident, against the JAX tiered mesh gateway.
        jt = jtiered.TieredStormGateway(hashes[0], tenants, hot,
                                        mode="ref", mesh=_jmesh(),
                                        count_dtype=jnp.int16,
                                        promote_per_tick=2, **SLOTS)
        jscript = [[r for r in reqs if r[0] != "fit"] for reqs in script]
        jrep = _drive(jt, jgw, jscript)
        prep = _drive(TieredStormGateway(tp, tenants, hot, mesh=_mesh(2),
                                         **kw), port_gw, jscript)
        assert [report_key(r) for r in prep] == [report_key(r) for r in jrep]


def test_tiered_gateway_on_a_mesh_pipelined_equals_sync(hashes):
    _, tp = hashes
    script = _tiered_script(8, seed=3)
    kw = dict(count_dtype=torch.int16, promote_per_tick=2, mesh=_mesh(2),
              **SLOTS)
    sync = TieredStormGateway(tp, 8, 4, **kw)
    want = _drive(sync, port_gw, script)
    piped = TieredStormGateway(tp, 8, 4, **kw)
    got = _drive(piped, port_gw, script, depth=2)
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    for tenant in range(8):
        assert torch.equal(piped.sketch_of(tenant).counts,
                           sync.sketch_of(tenant).counts)
    assert piped.promotions == sync.promotions
    assert piped.demotions == sync.demotions > 0
