"""The port's LM sharding rules (``repro_torch.sharding.specs``) against
``repro.sharding.specs``.

For each of the ten architectures at its full config, on the production
shapes 16 x 16 ``(data, model)`` and 2 x 16 x 16 ``(pod, data, model)``,
every port leaf's spec must equal JAX's exactly, with the leading entry of
a leaf stacked on ``num_cycles`` dropped (the port's ``blocks`` and decode
states are lists of cycles): parameters, AdamW state, decode states at
(B 128, cache 32768) and (B 1, cache 32768), batches, and the activation
rules with ``sequence_parallel`` off and on. The trees are shape-only: JAX's
``eval_shape``, carried across as meta tensors (``interop``), and the
port's own decode states through ``specs.eval_shape`` (nothing allocated,
llama3-405b included). The JAX rules read only ``axis_names`` and
``shape``, so a stand-in of that shape serves them; the port's rules read a
production mesh named on one device 256 or 512 times.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.sharding import specs as jspecs
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model
from repro_torch.sharding import specs
from repro_torch.sharding.specs import P
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree as tree_lib
from torch_parity import CPU, one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

POD = (False, True)


class _JaxMesh:
    """What the reference's rules read of a production mesh."""

    def __init__(self, multi_pod):
        self.axis_names = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names, (2, 16, 16) if multi_pod
                              else (16, 16)))


_MESHES = {}


def _port_mesh(multi_pod):
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(
            multi_pod, devices=[CPU] * (512 if multi_pod else 256))
    return _MESHES[multi_pod]


def _jax_specs(tree):
    """``{keystr path: spec tuple}`` of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(p): s for p, s in flat}


def _assert_specs_equal(port_specs, jax_specs, stacked_prefix=None):
    """Every port leaf's spec equals its JAX leaf's; a path under
    ``stacked_prefix`` (a regex for the cycle index) names the stacked
    leaf, whose leading entry is dropped."""
    want = _jax_specs(jax_specs)
    seen = set()
    for path, spec in tree_lib.leaf_paths(port_specs):
        jpath, stacked = (re.subn(stacked_prefix, r"\1", path)
                          if stacked_prefix else (path, 0))
        assert isinstance(spec, specs.PartitionSpec), path
        expect = interop.partition_spec(want[jpath], stacked=bool(stacked))
        assert spec == expect, (path, spec, expect)
        seen.add(jpath)
    assert seen == set(want)


_BLOCKS = r"^(\.?\w*\['blocks'\])\[\d+\]"
_CYCLE = r"^()\[\d+\]"


@pytest.fixture(scope="module")
def shapes():
    """Per arch: the JAX and port shape-only params and AdamW states."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = registry.get_config(arch)
            jcfg = jregistry.get_config(arch)
            jp = jax.eval_shape(lambda k: jmodel.init_params(k, jcfg),
                                jax.random.PRNGKey(0))
            jo = jax.eval_shape(lambda p: jopt.init(jopt.AdamWConfig(), p),
                                jp)
            pp = interop.lm_param_shapes(jp, cfg)
            po = opt_lib.init(opt_lib.AdamWConfig(), pp)
            cache[arch] = (cfg, jcfg, jp, jo, pp, po)
        return cache[arch]

    return get


@pytest.mark.parametrize("multi_pod", POD)
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_lm_specs_equal_jax(arch, multi_pod, shapes):
    cfg, jcfg, jp, jo, pp, po = shapes(arch)
    mesh, jmesh = _port_mesh(multi_pod), _JaxMesh(multi_pod)
    assert mesh.shape == jmesh.shape
    assert all(t.device.type == "meta" for t in tree_lib.leaves(pp))

    jps = jspecs.param_specs(jp, jcfg, jmesh)
    ps = specs.param_specs(pp, cfg, mesh)
    _assert_specs_equal(ps, jps, _BLOCKS)
    _assert_specs_equal(specs.opt_state_specs(po, ps),
                        jspecs.opt_state_specs(jo, jps), _BLOCKS)

    for b in (128, 1):
        js = jax.eval_shape(lambda: jmodel.init_decode_state(jcfg, b, 32768))
        st = specs.eval_shape(model.init_decode_state, cfg, b, 32768, CPU)
        assert [t.shape for t in tree_lib.leaves(st)] == [
            t.shape for t in tree_lib.leaves(
                interop.decode_state_shapes(js, cfg))]
        _assert_specs_equal(specs.decode_state_specs(st, cfg, mesh, b),
                            jspecs.decode_state_specs(js, jcfg, jmesh, b),
                            _CYCLE)

    for b in (256, 3):
        jbatch = {"tokens": jax.ShapeDtypeStruct((b, 128), jnp.int32),
                  "labels": jax.ShapeDtypeStruct((b, 128), jnp.int32),
                  "embeds": jax.ShapeDtypeStruct((b, 128, cfg.d_model),
                                                 jnp.float32),
                  "step": jax.ShapeDtypeStruct((), jnp.int32)}
        batch = interop.lm_param_shapes({**jbatch, "blocks": {}}, cfg)
        del batch["blocks"]
        _assert_specs_equal(specs.batch_specs(batch, mesh),
                            jspecs.batch_specs(jbatch, jmesh))

    for sp in (False, True):
        rules = specs.activation_hint_rules(
            dataclasses.replace(cfg, sequence_parallel=sp), mesh)
        jrules = jspecs.activation_hint_rules(
            dataclasses.replace(jcfg, sequence_parallel=sp), jmesh)
        assert {k: tuple(v) for k, v in rules.items()} == {
            k: tuple(v) for k, v in jrules.items()}


def test_reference_assertions_hold_in_the_port(shapes):
    """The reference's own rule tests: phi3.5's 16 experts over ``model``,
    mixtral's 8 TP inside each expert; qwen3-32b's 8 KV heads cannot split
    16 ways, so the cache's sequence takes ``model``; batches over DP."""
    mesh = _port_mesh(False)
    for arch, expert_sharded in (("phi3.5-moe-42b-a6.6b", True),
                                 ("mixtral-8x22b", False)):
        cfg, *_, pp, _ = shapes(arch)
        gate = specs.param_specs(pp, cfg, mesh)["blocks"][0]["pos0"]["moe"][
            "gate"]
        if expert_sharded:
            assert gate[0] == "model", gate
        else:
            assert gate[0] is None and "model" in tuple(gate), gate
    cfg = registry.get_config("qwen3-32b")
    st = specs.eval_shape(model.init_decode_state, cfg, 128, 32768, CPU)
    k = specs.decode_state_specs(st, cfg, mesh, 128)[0]["pos0"].k
    assert k[2] == "model" and k[0] == "data"
    batch = {"tokens": torch.empty((256, 128), dtype=torch.int32,
                                   device="meta")}
    assert specs.batch_specs(batch, mesh)["tokens"][0] == "data"


def test_xlstm_state_at_batch_one_splits_its_halves():
    """Finding of the reference: an mLSTM state's ``s`` is rank 5 stacked,
    so at B = 1 it takes the KV-cache branch (its dk read as T) and shards
    over ``(data, model)``, while its ``n`` (rank 4) shards over ``model``
    alone. The port keeps the reference's ranks, so its halves split the
    same way."""
    cfg = registry.get_config("xlstm-1.3b")
    mesh = _port_mesh(False)
    st = specs.eval_shape(model.init_decode_state, cfg, 1, 32768, CPU)
    assert st[0]["pos0"].s.shape == (1, 4, 512, 1024)
    out = specs.decode_state_specs(st, cfg, mesh, 1)[0]["pos0"]
    assert tuple(out.s) == (None, None, ("data", "model"), None)
    assert tuple(out.n) == (None, None, "model")
    big = specs.decode_state_specs(
        specs.eval_shape(model.init_decode_state, cfg, 128, 32768, CPU),
        cfg, mesh, 128)[0]["pos0"]
    assert tuple(big.s) == ("data", None, "model", None)
    assert tuple(big.n) == ("data", None, "model")


def test_fsdp_threshold_reads_the_stacked_size(shapes):
    """gemma3-1b's ``pos0`` ``wq`` is (1152, 1024) a cycle, 2.4e6 elements
    stacked over its 2 cycles (FSDP on) but 1.2e6 alone; its ``wk`` (1152,
    256) is 5.9e5 stacked (replicated)."""
    cfg, *_, pp, _ = shapes("gemma3-1b")
    ps = specs.param_specs(pp, cfg, _port_mesh(False))["blocks"][1]["pos0"]
    assert tuple(ps["attn"]["wq"]) == ("data", "model")
    assert tuple(ps["attn"]["wk"]) == (None, None)


def test_eval_shape_allocates_nothing_and_matches_the_reference(shapes):
    cfg, *_, pp, _ = shapes("gemma3-1b")
    got = dict(tree_lib.leaf_paths(
        specs.eval_shape(model.init_params, None, cfg, CPU)))
    want = dict(tree_lib.leaf_paths(pp))
    assert set(got) == set(want)
    for path, a in got.items():
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (want[path].shape, want[path].dtype)
    assert sum(a.numel() for a in got.values()) == cfg.param_count()


def test_specs_tree_places_and_names():
    """``named`` maps every spec of a tree, ``None`` subtrees kept; a spec
    compares and iterates as its entries and keeps ``axis`` for the
    one-axis layouts."""
    mesh = _port_mesh(False)
    tree = {"a": P(("data",), None), "b": None, "c": [P(), P("model")]}
    assert tree["a"] == P("data", None) and P((), "x") == P(None, "x")
    out = specs.named(mesh, tree)
    assert out["b"] is None and out["c"][1].spec == P("model")
    assert out["a"].mesh is mesh
    assert tuple(P(("data", "model"), None)) == (("data", "model"), None)
    assert P("bank").axis == "bank" and P().axis is None
    assert P(("data", "model"), None).axis is None
    with pytest.raises(TypeError):
        P(3)
