"""The port's distributed STORM against ``repro.core.distributed`` and
``repro.sharding.specs``.

Port meshes are ``"cpu"`` shards (a device may repeat: the counterpart of
the reference's forced host devices). The JAX mesh paths run on
``Mesh(jax.devices()[:k])`` with ``k = min(2, jax.device_count())``: the
module asks for two host devices before JAX starts, as the reference's
serving tests do. Sketches and single loss evaluations match JAX exactly;
DFO fits match the port's meshless run bit for bit, and JAX's on shared
draws within the fit's own sensitivity (ROADMAP, standing differences).
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.core import dfo as jdfo  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import dfo, distributed, fleet  # noqa: E402
from repro_torch.core import sketch as sketch_lib  # noqa: E402
from repro_torch.sharding import mesh as mesh_lib  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.sharding.mesh import Mesh  # noqa: E402
from torch_parity import CPU, fleet_draws, jax_params, t, unit_ball_rows  # noqa: E402

# The DFO fit's own sensitivity (tests/test_torch_banks.py): a one-ulp move
# of the draws moves a final sketch loss by up to 3.6%.
_FLEET_LOSS_RTOL = 0.05
D = 4  # sketch-space dim; the hash family has D + 2 features


def _jmesh(axis):
    k = min(2, jax.device_count())
    return JMesh(np.array(jax.devices()[:k]), (axis,))


def _cpu_mesh(k, axis):
    return Mesh([CPU] * k, axis)


@pytest.fixture(scope="module")
def hashes():
    return jax_params(0, 64, 3, D + 2)


# -- sharded_sketch ------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("paired", [True, False])
def test_sharded_sketch_equals_jax_and_the_lone_build(paired, shards):
    # The reference test's shapes: init_srp(PRNGKey(0), 16, 3, 5), 64 x 5.
    jp, tp = jax_params(0, 16, 3, 5)
    z = 0.4 * jax.random.normal(jax.random.PRNGKey(1), (64, 5))
    z = z[:, :3] if paired else z
    want = jdist.sharded_sketch(jp, z, _jmesh("data"), axis="data",
                                paired=paired, batch=8)
    zt = t(z)
    got = distributed.sharded_sketch(tp, zt, _cpu_mesh(shards, "data"),
                                     axis="data", paired=paired, batch=8)
    lone = sketch_lib.sketch_dataset(tp, zt, batch=8, paired=paired,
                                     device=CPU)
    assert got.counts.dtype == torch.int32 and got.n.dtype == torch.int32
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert torch.equal(got.counts, lone.counts)
    assert int(got.n) == int(want.n) == int(lone.n) == 64


def test_sharded_sketch_needs_a_divisible_stream(hashes):
    jp, tp = hashes
    z = unit_ball_rows(0, 63, D)
    with pytest.raises(ValueError, match="divisible"):
        distributed.sharded_sketch(tp, t(z), _cpu_mesh(2, "data"))
    if jax.device_count() >= 2:
        with pytest.raises(ValueError, match="divisible"):
            jdist.sharded_sketch(jp, jnp.asarray(z), _jmesh("data"))
    with pytest.raises(KeyError):  # an axis the mesh lacks, as in JAX
        distributed.sharded_sketch(tp, t(z[:62]), _cpu_mesh(2, "data"),
                                   axis="bank")


# -- fleet fits ------------------------------------------------------------------

_CFG = jdfo.DFOConfig(steps=30, num_queries=4, sigma=0.5, sigma_decay=0.99,
                      learning_rate=1.0, decay=0.995, average_tail=0.5)
_REFINE = 1


def _port_cfg(cfg):
    return dfo.DFOConfig(**{f: getattr(cfg, f)
                            for f in cfg.__dataclass_fields__})


def _fleet_case(hashes, f, seed):
    """A JAX sketch (carried across), member-major inits and the member
    keys with the draws they make."""
    jp, tp = hashes
    z = unit_ball_rows(seed, 512, D)
    jsketch = jsk.sketch_dataset(jp, jnp.asarray(z), batch=64)
    sk = interop.sketch(np.asarray(jsketch.counts), int(jsketch.n), CPU)
    rng = np.random.default_rng(seed)
    theta0 = (0.3 * rng.normal(size=(f, D))).astype(np.float32)
    theta0[:, -1] = -1.0
    keys = jax.random.split(jax.random.PRNGKey(seed), f)
    dirs, refine = fleet_draws(keys, _CFG.steps, _CFG.num_queries, D,
                               refine_steps=_REFINE,
                               m=dfo.refine_sample_count(D))
    return jsketch, sk, theta0, keys, dirs, refine


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_fleet_fit_on_a_mesh_equals_the_meshless_fit(hashes, shards):
    _, tp = hashes
    _, sk, theta0, _, dirs, refine = _fleet_case(hashes, 8, 3)
    cfg = _port_cfg(_CFG)
    sig = torch.linspace(0.3, 0.7, 8)
    kw = dict(sigma=sig, refine_steps=_REFINE, directions=dirs,
              refine_samples=refine)
    want = distributed.fleet_fit(sk, tp, t(theta0), cfg, **kw)
    got = distributed.fleet_fit(sk, tp, t(theta0), cfg,
                                mesh=_cpu_mesh(shards, "fleet"), **kw)
    assert got.theta.shape == (8, D) and got.losses.shape == (8, _CFG.steps)
    assert torch.equal(got.theta, want.theta)
    assert torch.equal(got.losses, want.losses)
    # Drawn once for the whole fleet: a generator gives the same bits on
    # every mesh, and the meshless fit equals fleet.run_fleet from it.
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    a = distributed.fleet_fit(sk, tp, t(theta0), cfg, refine_steps=_REFINE,
                              generator=gen())
    b = distributed.fleet_fit(sk, tp, t(theta0), cfg, refine_steps=_REFINE,
                              mesh=_cpu_mesh(shards, "fleet"),
                              generator=gen())
    loss_fn = fleet.make_loss_fn(sk, tp)
    c = fleet.run_fleet(loss_fn, t(theta0), cfg,
                        project=dfo.pin_last_coordinate(-1.0),
                        refine_steps=_REFINE, generator=gen())
    assert torch.equal(a.theta, b.theta) and torch.equal(a.losses, b.losses)
    assert torch.equal(a.theta, c.theta) and torch.equal(a.losses, c.losses)


def test_fleet_fit_matches_the_jax_mesh_on_shared_draws(hashes):
    jp, tp = hashes
    jsketch, sk, theta0, keys, dirs, refine = _fleet_case(hashes, 8, 3)
    want = jdist.fleet_fit(jsketch, jp, jnp.asarray(theta0), keys, _CFG,
                           mesh=_jmesh("fleet"), refine_steps=_REFINE,
                           engine="scan")
    got = distributed.fleet_fit(sk, tp, t(theta0), _port_cfg(_CFG),
                                mesh=_cpu_mesh(2, "fleet"),
                                refine_steps=_REFINE, directions=dirs,
                                refine_samples=refine)
    # The first loss evaluation reads equal counts at equal points.
    np.testing.assert_array_equal(got.losses[:, 0].numpy(),
                                  np.asarray(want.losses)[:, 0])
    np.testing.assert_allclose(got.losses[:, -1].numpy(),
                               np.asarray(want.losses)[:, -1],
                               rtol=_FLEET_LOSS_RTOL)
    np.testing.assert_array_equal(got.theta[:, -1].numpy(), -1.0)


def _bank_case(hashes, s, f, seed):
    jp, _ = hashes
    streams = [jnp.asarray(unit_ball_rows(seed + i, 300 + 40 * i, D))
               for i in range(s)]
    jbank = jsk.sketch_dataset_many(jp, streams, batch=64, engine="scan")
    bank = interop.sketch_bank(np.asarray(jbank.counts), np.asarray(jbank.n),
                               CPU)
    rng = np.random.default_rng(seed)
    theta0 = (0.3 * rng.normal(size=(s * f, D))).astype(np.float32)
    theta0[:, -1] = -1.0
    keys = jax.random.split(jax.random.PRNGKey(seed), s * f)
    dirs, refine = fleet_draws(keys, _CFG.steps, _CFG.num_queries, D,
                               refine_steps=_REFINE,
                               m=dfo.refine_sample_count(D))
    return jbank, bank, theta0, keys, dirs, refine


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_fleet_fit_banked_on_a_mesh_equals_the_meshless_fit(hashes, shards):
    _, tp = hashes
    _, bank, theta0, _, dirs, refine = _bank_case(hashes, 4, 2, 5)
    kw = dict(refine_steps=_REFINE, directions=dirs, refine_samples=refine)
    want = distributed.fleet_fit_banked(bank, tp, t(theta0), _port_cfg(_CFG),
                                        2, **kw)
    got = distributed.fleet_fit_banked(bank, tp, t(theta0), _port_cfg(_CFG),
                                       2, mesh=_cpu_mesh(shards, "bank"),
                                       **kw)
    assert got.theta.shape == (8, D)
    assert torch.equal(got.theta, want.theta)
    assert torch.equal(got.losses, want.losses)
    # Each member reads its own tenant's table: tenant 1's members alone.
    lone = distributed.fleet_fit(
        bank.select(1), tp, t(theta0[2:4]), _port_cfg(_CFG),
        refine_steps=_REFINE, directions=dirs[:, 2:4],
        refine_samples=refine[:, 2:4])
    assert torch.equal(lone.losses, want.losses[2:4])


def test_fleet_fit_banked_matches_the_jax_mesh_on_shared_draws(hashes):
    jp, tp = hashes
    jbank, bank, theta0, keys, dirs, refine = _bank_case(hashes, 4, 2, 5)
    want = jdist.fleet_fit_banked(jbank, jp, jnp.asarray(theta0), keys, _CFG,
                                  2, mesh=_jmesh("bank"),
                                  refine_steps=_REFINE, engine="scan")
    got = distributed.fleet_fit_banked(bank, tp, t(theta0), _port_cfg(_CFG),
                                       2, mesh=_cpu_mesh(2, "bank"),
                                       refine_steps=_REFINE, directions=dirs,
                                       refine_samples=refine)
    np.testing.assert_array_equal(got.losses[:, 0].numpy(),
                                  np.asarray(want.losses)[:, 0])
    np.testing.assert_allclose(got.losses[:, -1].numpy(),
                               np.asarray(want.losses)[:, -1],
                               rtol=_FLEET_LOSS_RTOL)


def test_fleet_fits_reject_what_the_mesh_does_not_divide(hashes):
    jp, tp = hashes
    jsketch, sk, theta0, keys, dirs, _ = _fleet_case(hashes, 3, 1)
    cfg = _port_cfg(_CFG)
    with pytest.raises(ValueError, match="divisible") as port_err:
        distributed.fleet_fit(sk, tp, t(theta0), cfg,
                              mesh=_cpu_mesh(2, "fleet"), directions=dirs)
    if jax.device_count() >= 2:
        with pytest.raises(ValueError, match="divisible") as jax_err:
            jdist.fleet_fit(jsketch, jp, jnp.asarray(theta0), keys, _CFG,
                            mesh=_jmesh("fleet"))
        assert str(port_err.value) == str(jax_err.value)
    jbank, bank, theta0, keys, dirs, _ = _bank_case(hashes, 3, 2, 2)
    with pytest.raises(ValueError, match="divisible") as port_err:
        distributed.fleet_fit_banked(bank, tp, t(theta0), cfg, 2,
                                     mesh=_cpu_mesh(2, "bank"),
                                     directions=dirs)
    if jax.device_count() >= 2:
        with pytest.raises(ValueError, match="divisible") as jax_err:
            jdist.fleet_fit_banked(jbank, jp, jnp.asarray(theta0), keys,
                                   _CFG, 2, mesh=_jmesh("bank"))
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="members for 3 sketches"):
        distributed.fleet_fit_banked(bank, tp, t(theta0[:5]), cfg, 2,
                                     directions=dirs[:, :5])
    with pytest.raises(ValueError, match="directions or a generator"):
        distributed.fleet_fit(sk, tp, t(theta0[:2]), cfg)


@pytest.mark.parametrize("paired", [True, False])
def test_replicated_query_equals_jax(paired):
    jp, tp = jax_params(2, 64, 3, D + 2)
    z = unit_ball_rows(4, 256, D if paired else D + 2)
    jsketch = jsk.sketch_dataset(jp, jnp.asarray(z), batch=64, paired=paired)
    sk = interop.sketch(np.asarray(jsketch.counts), int(jsketch.n), CPU)
    th = np.random.default_rng(5).normal(size=(33, D)).astype(np.float32)
    want = jdist.replicated_query(jsketch, jp, jnp.asarray(th), paired=paired)
    got = distributed.replicated_query(sk, tp, t(th), paired=paired)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- placement -------------------------------------------------------------------

@pytest.mark.parametrize("tenants,shards", [(4, 1), (4, 2), (8, 4), (6, 2)])
def test_tenant_placement_equals_the_reference(tenants, shards):
    port = specs.tenant_placement(tenants, _cpu_mesh(shards, "bank"))
    # The reference reads only mesh.shape[axis]: a stand-in of that shape.
    jm = type("M", (), {"shape": {"bank": shards}})()
    np.testing.assert_array_equal(port, jspecs.tenant_placement(tenants, jm))
    assert port.dtype == np.int32


@pytest.mark.parametrize("loads,shards", [
    ([5, 1, 3, 2, 8, 1], 2), ([1.0] * 8, 4), ([0, 7, 7, 0, 3, 3, 9, 1], 2),
])
def test_rebalance_placement_equals_the_reference(loads, shards):
    got = specs.rebalance_placement(loads, shards)
    want = jspecs.rebalance_placement(loads, shards)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_placement_errors_match_the_reference():
    jm = type("M", (), {"shape": {"bank": 2}})()
    with pytest.raises(ValueError, match="divisible") as port_err:
        specs.tenant_placement(3, _cpu_mesh(2, "bank"))
    with pytest.raises(ValueError, match="divisible") as jax_err:
        jspecs.tenant_placement(3, jm)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="divisible") as port_err:
        specs.rebalance_placement([1, 2, 3], 2)
    with pytest.raises(ValueError, match="divisible") as jax_err:
        jspecs.rebalance_placement([1, 2, 3], 2)
    assert str(port_err.value) == str(jax_err.value)
    for port, ref in ((specs.fleet_specs, jspecs.fleet_specs),
                      (specs.bank_specs, jspecs.bank_specs),
                      (specs.gateway_specs, jspecs.gateway_specs)):
        (sharded, rep), (jsharded, jrep) = port("x"), ref("x")
        assert (sharded.axis, rep.axis) == (tuple(jsharded)[0], None)
        assert tuple(jrep) == ()
    assert [s.axis for s in specs.gateway_input_specs("bank")] == ["bank"] * 4


# -- the mesh ------------------------------------------------------------------

def test_mesh_split_psum_and_gather():
    m = _cpu_mesh(4, "data")
    assert m.shape == {"data": 4} and m.size == 4
    assert m.first == torch.device("cpu")
    x = torch.arange(24).view(8, 3)
    parts = mesh_lib.split(x, m)
    assert [p.tolist() for p in parts] == [x[2 * i:2 * i + 2].tolist()
                                          for i in range(4)]
    assert torch.equal(mesh_lib.gather(parts, m), x)
    outs = mesh_lib.shard_map(lambda dev, blk: blk.sum(0), m, x)
    assert torch.equal(mesh_lib.psum(outs, m), x.sum(0).to(torch.int32))
    big = torch.full((2,), 2 ** 31 - 1, dtype=torch.int32)
    assert mesh_lib.psum([big, torch.ones(2, dtype=torch.int32)],
                         _cpu_mesh(2, "data")).tolist() == [-2 ** 31] * 2
    with pytest.raises(ValueError, match="integer"):
        mesh_lib.psum([torch.ones(2)] * 4, m)
    with pytest.raises(ValueError, match="divisible"):
        mesh_lib.split(torch.zeros(7), m)


def test_make_debug_mesh_needs_a_card_or_named_devices():
    m = mesh_lib.make_debug_mesh([CPU, CPU])
    assert m.devices == (torch.device("cpu"),) * 2 and m.axis == "data"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.make_debug_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(["cuda"])
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    with pytest.raises(ValueError, match="name every device"):
        Mesh([None])
