"""The gateway's fill-tracked staging against ``repro.serve.storm_gateway``.

The staging ring never zeroes a buffer's ingest half after construction: a
stage packs its rows from slot 0 and clears only the mask slots that the
buffer's last ingest stage filled and this one did not, so rows in masked
slots keep an earlier tick's values. Over more ticks than the ring has
buffers, with per-tenant fills that grow, shrink to a few rows and go to 0,
the port's gateway (paired and single-sided, meshless and on a CPU mesh,
private) serves what the JAX gateway (``mode="ref"``) serves, bit for bit,
even with NaN, +-inf and 1e30 rows planted in every slot of the buffer a
tick is about to reuse; and after every stage the host mask is exactly ones
on ``[0, fill)`` of each tenant and zeros beyond.
"""

import numpy as np
import pytest
import torch

from repro.core import privacy as jprivacy
from repro.serve import storm_gateway as jgw
from repro_torch.core import lsh
from repro_torch.core.privacy import ReleasePolicy
from repro_torch.serve import storm_gateway as port_gw
from repro_torch.serve.storm_gateway import StormGateway, report_key
from repro_torch.sharding.mesh import Mesh
from torch_parity import CPU, jax_params, t

S = 4
D = 5  # sketch-space dim (the hash family has D + 2 features)
I_SLOTS, Q_SLOTS = 16, 4
# Rows a tenant sends a tick (tenant t reads the row from column t): each
# grows, fills its slots, shrinks to a few rows and goes to 0; tick 5 has
# no ingest at all (a query-only tick), 16 + 9 overflows into tick 8, and
# None is a zero-row request. 13 ticks: every buffer serves three or four.
FILLS = [
    [3, 16, 0, 7],
    [9, 16, 1, 7],
    [16, 2, 0, 16],
    [16, 0, 5, 3],
    [2, 0, 16, 0],
    [0, 0, 0, 0],
    [0, 11, 16, 1],
    [1, 16 + 9, 2, 0],
    [None, 0, 0, 16],
    [12, 0, 0, 16],
    [0, 3, 16, 2],
    [16, 16, 16, 16],
    [16, 16, 16, 16],
]
GARBAGE = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30], np.float32)


@pytest.fixture(scope="module")
def hashes():
    return jax_params(0, 64, 3, D + 2)


def _rows(rng, n, paired):
    z = (0.3 * rng.normal(size=(n, D))).astype(np.float32)
    if paired:
        return z
    z = z / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1.0)
    return lsh.augment_data(t(z)).numpy()


def _script(paired, seed=3):
    """Per tick: ``(kind, rid, tenant, array)`` requests from FILLS, and a
    query for two tenants every third tick and on the query-only tick."""
    rng = np.random.default_rng(seed)
    rid, script = 0, []
    for tick, row in enumerate(FILLS):
        reqs = []
        for tenant, n in enumerate(row):
            if n is None or n:
                z = _rows(rng, n or 0, paired)
                if n and n > 4:  # two requests for one tenant in one tick
                    reqs.append(("ingest", rid, tenant, z[:4]))
                    rid, z = rid + 1, z[4:]
                reqs.append(("ingest", rid, tenant, z))
                rid += 1
        if tick % 3 == 0 or not any(row):
            for tenant in (tick % S, (tick + 2) % S):
                reqs.append(("query", rid, tenant, rng.normal(
                    size=(3, D)).astype(np.float32)))
                rid += 1
        script.append(reqs)
    return script


def _requests(mod, reqs):
    return [mod.IngestRequest(rid=rid, tenant=tn, z=a) if kind == "ingest"
            else mod.QueryRequest(rid=rid, tenant=tn, thetas=a)
            for kind, rid, tn, a in reqs]


def _plant(gw, tick):
    """NaN, +-inf and +-1e30 in every row slot of the buffer each shard
    hands out next (its mask is left as it is)."""
    for sh in gw._shards:
        zbuf = gw._views(sh.staging.buffer(sh.staging._next))[0].numpy()
        zbuf[...] = np.resize(np.roll(GARBAGE, tick), zbuf.shape)


def _staged_mask(gw):
    """The ingest mask each shard's last stage wrote, in tenant order."""
    return np.concatenate([
        gw._views(sh.staging.buffer(
            (sh.staging._next - 1) % port_gw.STAGING_SLOTS))[1].numpy()
        for sh in gw._shards])


def _drive(gw, mod, script, plant=False):
    """One synchronous tick a round, then drained. On the port's gateway
    (``plant``) garbage goes into the buffer it reuses every other tick,
    and the host mask is checked after every ingest stage against each
    tenant's fill, ``min(I, rows pending)``."""
    reports, pending = [], np.zeros(S, np.int64)
    for tick, reqs in enumerate(script):
        gw.submit_many(_requests(mod, reqs))
        if not plant:
            reports.append(gw.tick())
            continue
        for kind, _, tenant, a in reqs:
            if kind == "ingest":
                pending[tenant] += len(a)
        staged = any(k == "ingest" for k, *_ in reqs) or pending.any()
        if tick % 2:
            _plant(gw, tick)
        inflight = gw.tick_start()
        fill = np.minimum(pending, I_SLOTS)
        pending -= fill
        if staged:
            want = (np.arange(I_SLOTS) < fill[:, None]).astype(np.float32)
            np.testing.assert_array_equal(_staged_mask(gw), want)
        reports.append(gw.tick_finish(inflight))
    while gw.pending:
        reports.append(gw.tick())
    return reports


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("shards", [None, 2])
def test_stale_and_planted_staging_serves_what_jax_serves(hashes, paired,
                                                          shards):
    jp, tp = hashes
    kw = dict(paired=paired, query_slots=Q_SLOTS, ingest_slots=I_SLOTS)
    script = _script(paired)
    want_gw = jgw.StormGateway(jp, S, mode="ref", **kw)
    want = _drive(want_gw, jgw, script)
    place = (dict(device=CPU) if shards is None
             else dict(mesh=Mesh([CPU] * shards, "bank")))
    got_gw = StormGateway(tp, S, **place, **kw)
    got = _drive(got_gw, port_gw, script, plant=True)
    assert len(script) > 3 * port_gw.STAGING_SLOTS
    assert [report_key(r) for r in got] == [report_key(r) for r in want]
    np.testing.assert_array_equal(got_gw.bank.counts.numpy(),
                                  np.asarray(want_gw.bank.counts))
    np.testing.assert_array_equal(got_gw.bank.n.numpy(),
                                  np.asarray(want_gw.bank.n))
    assert got_gw.queue_stats() == want_gw.queue_stats()


@pytest.mark.parametrize("on_exhaust", ["refuse", "stale"])
def test_private_row_versions_follow_the_exact_mask(hashes, on_exhaust):
    """A private gateway counts each slot's rows from the staged mask: over
    reused, planted buffers its versions, counters and statuses equal
    JAX's."""
    jp, tp = hashes
    pol = dict(epsilon_total=2.0, on_exhaust=on_exhaust)
    kw = dict(query_slots=Q_SLOTS, ingest_slots=I_SLOTS, privacy_seed=5)
    script = _script(True, seed=4)
    want_gw = jgw.StormGateway(jp, S, mode="ref",
                               privacy=jprivacy.ReleasePolicy(**pol), **kw)
    want = _drive(want_gw, jgw, script)
    got_gw = StormGateway(tp, S, privacy=ReleasePolicy(**pol), device=CPU,
                          **kw)
    got = _drive(got_gw, port_gw, script, plant=True)

    def versions(gw):
        return {k: v for k, v in gw._rows_of.items() if v}

    assert versions(got_gw) == versions(want_gw)
    assert sum(versions(got_gw).values()) == int(got_gw.bank.n.sum()) > 0
    assert [[(r.rid, r.status) for r in rep.results] for rep in got] == \
        [[(r.rid, r.status) for r in rep.results] for rep in want]
    np.testing.assert_array_equal(got_gw.bank.counts.numpy(),
                                  np.asarray(want_gw.bank.counts))
    np.testing.assert_array_equal(got_gw.bank.n.numpy(),
                                  np.asarray(want_gw.bank.n))


def test_a_fresh_gateway_starts_from_zeroed_buffers(hashes):
    """The first stage into each buffer has nothing to clear: buffers are
    zeroed once, at construction, and their fills start at 0."""
    _, tp = hashes
    gw = StormGateway(tp, S, query_slots=Q_SLOTS, ingest_slots=I_SLOTS,
                      device=CPU)
    ring = gw._shards[0].staging
    assert all(not ring.buffer(k).any()
               for k in range(port_gw.STAGING_SLOTS))
    mask = np.ones((S, I_SLOTS), np.float32)
    assert ring.clear_stale(0, mask, np.array([0, 3, 16, 5])) == 0
    assert mask.all()
    # A later stage into the same buffer clears what the old fill covered
    # and the new one does not: tenant 1's slots 1 and 2, nothing else.
    assert ring.clear_stale(0, mask, np.array([0, 1, 16, 9])) == 2
    assert mask.sum(axis=1).tolist() == [16, 14, 16, 16]
    assert mask[1, :4].tolist() == [1.0, 0.0, 0.0, 1.0]
    # Other buffers keep their own fills.
    assert ring.clear_stale(1, mask, np.zeros(S, np.int64)) == 0
