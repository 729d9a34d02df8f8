"""Placement on a mesh (``repro_torch.sharding.specs``: ``place``,
``device_put``, ``ShardedTensor``, ``gather_tree``) against JAX's.

Each case puts ``arange`` of a shape on a CPU mesh (a grid of ``"cpu"``
devices) by a spec and holds every device's block to the one JAX's
``addressable_shards`` hold on the same mesh shape and spec, exactly: tuple
entries (both orders of ``("data", "model")``), replicated dimensions, a
three-axis mesh. JAX needs several devices for that, so one subprocess on
8 forced host devices computes all of the file's JAX blocks. Then: gathers
round-trip bit for bit, an indivisible dimension raises, a meshless
checkpoint restores onto ``(data 2, model 2)`` and ``(data 4, model 1)``
and gathers back to the saved bits (bf16 leaves included), and the
one-axis layouts of the STORM paths (``P("bank")``, ``P()``) give the
blocks they gave before.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.sharding import mesh as mesh_lib
from repro_torch.sharding import specs
from repro_torch.sharding.mesh import Mesh
from repro_torch.sharding.specs import P
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train import tree as tree_lib
from torch_parity import CPU, one_torch_thread  # noqa: F401

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# (mesh axes, mesh shape, array shape, spec entries)
CASES = [
    (("data", "model"), (2, 2), (8, 6), [["data", "model"], None]),
    (("data", "model"), (2, 2), (8, 6), [["model", "data"], None]),
    (("data", "model"), (2, 2), (4, 6), ["data", "model"]),
    (("data", "model"), (2, 2), (4, 6), ["model"]),
    (("data", "model"), (2, 2), (6, 4), [None, ["data", "model"]]),
    (("data", "model"), (2, 2), (3, 4, 6), [None, "data", None]),
    (("data", "model"), (2, 2), (5, 3), []),
    (("data", "model"), (4, 1), (8, 2), ["data", "model"]),
    (("pod", "data", "model"), (2, 2, 2), (8, 4, 2),
     [["pod", "data"], "model", None]),
    (("pod", "data", "model"), (2, 2, 2), (4, 16), [None, ["pod", "model",
                                                          "data"]]),
]

_JAX_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    out = []
    for axes, grid, shape, entries in json.loads(sys.stdin.read()):
        devs = np.array(jax.devices()[:int(np.prod(grid))]).reshape(grid)
        mesh = Mesh(devs, tuple(axes))
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in entries])
        x = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
        arr = jax.device_put(x, NamedSharding(mesh, spec))
        order = {d.id: i for i, d in enumerate(devs.flat)}
        blocks = [None] * devs.size
        for sh in arr.addressable_shards:
            blocks[order[sh.device.id]] = np.asarray(sh.data).tolist()
        out.append(blocks)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_blocks():
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _JAX_PROG], env=env,
                         input=json.dumps(CASES), capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _spec(entries):
    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])


def _axes(spec):
    """Every axis a spec names."""
    return [a for d in range(len(spec)) for a in spec.axes(d)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_blocks_equal_jax_addressable_shards(case, jax_blocks):
    axes, grid, shape, entries = CASES[case]
    mesh = Mesh([CPU] * int(np.prod(grid)), axes, grid)
    x = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape)
    placed = specs.ShardedTensor(x, specs.NamedSharding(mesh, _spec(entries)))
    assert [b.tolist() for b in placed.blocks] == jax_blocks[case]
    assert [b.tolist() for b in specs.place(x, _spec(entries), mesh)] == \
        jax_blocks[case]
    for b in placed.blocks:
        assert b.is_contiguous() and b.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
    assert torch.equal(placed.gather(), x)
    parts = np.prod([mesh.shape[a] for a in _axes(_spec(entries))])
    assert placed.block_bytes() == [x.numel() * 4 // int(parts)] * mesh.size


def test_indivisible_dims_and_unknown_axes_raise():
    mesh = Mesh([CPU] * 4, ("data", "model"), (2, 2))
    x = torch.zeros((6, 3))
    with pytest.raises(ValueError, match="not divisible"):
        specs.place(x, P(None, "model"), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        specs.ShardedTensor(x, specs.NamedSharding(mesh,
                                                   P(("data", "model"))))
    with pytest.raises(KeyError):
        specs.place(x, P("pod"), mesh)
    with pytest.raises(ValueError, match="twice"):
        specs.place(torch.zeros((4, 4)), P("data", "data"), mesh)
    with pytest.raises(ValueError, match="more entries"):
        specs.place(torch.zeros(4), P(None, "data"), mesh)
    with pytest.raises(ValueError, match="one-axis"):
        mesh.axis
    with pytest.raises(ValueError, match="fill"):
        Mesh([CPU] * 3, ("data", "model"), (2, 2))


def test_one_axis_layouts_unchanged():
    """``P(axis)`` on a one-axis mesh is ``mesh.split``'s blocks (views),
    ``P()`` the tensor itself on every shard: what the fleet, bank and
    gateway paths read."""
    mesh = Mesh([CPU] * 4, "bank")
    x = torch.arange(24).view(8, 3)
    got = specs.place(x, P("bank"), mesh)
    want = mesh_lib.split(x, mesh)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert all(g.data_ptr() == w.data_ptr() for g, w in zip(got, want))
    assert all(r is x for r in specs.place(x, P(), mesh))
    with pytest.raises(KeyError):
        specs.place(x, P("fleet"), mesh)


def test_mesh_grid_coordinates_and_ambient_mesh():
    mesh = Mesh([CPU] * 8, ("pod", "data", "model"), (2, 2, 2))
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert mesh.index({"pod": 1, "model": 1}) == 5
    assert len(mesh.along("model")) == 2
    assert mesh_lib.get_mesh() is None
    with mesh_lib.set_mesh(mesh):
        assert mesh_lib.get_mesh() is mesh
        with mesh_lib.set_mesh(None):
            assert mesh_lib.get_mesh() is None
        assert mesh_lib.get_mesh() is mesh
    assert mesh_lib.get_mesh() is None


@pytest.mark.parametrize("grid", [(2, 2), (4, 1)])
def test_meshless_checkpoint_restores_onto_a_mesh(grid, tmp_path,
                                                  monkeypatch):
    """A state saved without a mesh restores onto ``(data, model)`` meshes
    of two shapes by its specs (with the FSDP threshold lowered so that the
    smoke config's matrices shard over ``data`` too) and gathers back to
    the saved bits, bf16 parameters and f32 master and moments alike."""
    monkeypatch.setattr(specs, "FSDP_MIN_SIZE", 256)
    cfg = registry.get_config("gemma3-1b", smoke=True)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    tcfg = ts.TrainConfig(optimizer=opt_lib.AdamWConfig())
    state = ts.init_state(torch.Generator().manual_seed(0), cfg, tcfg, CPU)
    with torch.no_grad():
        for leaf in tree_lib.leaves(state.opt.mu):
            leaf.normal_()
    checkpoint.save(str(tmp_path), 3, state)

    mesh = Mesh([CPU] * 4, ("data", "model"), grid)
    pspecs = specs.param_specs(state.params, cfg, mesh)
    shardings = specs.named(mesh, ts.TrainStateT(
        params=pspecs, opt=specs.opt_state_specs(state.opt, pspecs),
        step=P()))
    template = specs.eval_shape(lambda: state)
    step, restored, _ = checkpoint.restore(str(tmp_path), template,
                                           shardings=shardings)
    assert step == 3
    placed = tree_lib.leaves(restored)
    assert all(isinstance(x, specs.ShardedTensor) for x in placed)
    named_axes = {a for x in placed for a in _axes(x.sharding.spec)}
    assert named_axes == {"data", "model"}
    back = specs.gather_tree(restored)
    for (path, a), (_, b) in zip(tree_lib.leaf_paths(back),
                                 tree_lib.leaf_paths(state)):
        assert a.dtype == b.dtype and torch.equal(a, b.detach()), path
    by_dev = specs.shard_bytes(restored)
    assert len(by_dev) == 4 and len(set(by_dev)) == 1
    want = sum(x.numel() * x.element_size() // int(np.prod(
        [mesh.shape[a] for a in _axes(s.spec)]))
        for x, s in zip(tree_lib.leaves(state), tree_lib.leaves(shardings)))
    assert by_dev[0] == want
