"""``repro_torch.launch.op_analysis`` against hand counts and against the
reference's ``launch/hlo_analysis.py`` on the same programs.

Tolerances: none; every comparison is exact. The hand-checkable programs,
fake against real tensors, and the prefill FLOPs of every non-MoE smoke
config that takes tokens are equal. The MoE configs differ by exactly the
reference's one-hot dispatch and combine products, and the dense smoke
train step by exactly the reference's second recompute of each query
chunk's attention products (both computed from their shapes below).
The reference's counts come from ``torch_parity.reference_flops``:
recorded in ``tests/reference_outputs.json`` under a digest of the JAX
package's sources and the versions of jax, jaxlib and numpy, and counted
anew when that digest changes.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import registry
from repro_torch.launch import dryrun, op_analysis
from repro_torch.models import layers, model
from repro_torch.sharding import specs
from repro_torch.sharding.mesh import Mesh, gather, psum
from repro_torch.sharding.pipeline import pipeline_forward
from repro_torch.train import train_step as ts
from repro_torch.train import tree as tree_lib
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import COUNT_BATCH, COUNT_SEQ, reference_flops

B, S = COUNT_BATCH, COUNT_SEQ
TOKEN_ARCHS = [a for a in registry.ARCH_IDS
               if not registry.get_config(a, smoke=True).embeddings_provided]
DENSE_TOKEN_ARCHS = [a for a in TOKEN_ARCHS
                     if not registry.get_config(a, smoke=True).is_moe]
MOE_ARCHS = [a for a in TOKEN_ARCHS
             if registry.get_config(a, smoke=True).is_moe]


def _bytes(*shape, dtype):
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("dtype,key", [(torch.bfloat16, "flops:bf16"),
                                       (torch.float32, "flops:f32")])
def test_matmul_plus_add(dtype, key):
    x = torch.ones(4, 8, dtype=dtype)
    w = torch.ones(8, 16, dtype=dtype)
    b = torch.ones(16, dtype=dtype)
    c = op_analysis.analyze(lambda x, w, b: x @ w + b, x, w, b)
    flops = 2 * 4 * 8 * 16
    assert c["flops"] == c[key] == flops
    assert c["flops:bf16"] + c["flops:f32"] == flops
    e = lambda *s: _bytes(*s, dtype=dtype)
    # mm reads x and w and writes (4, 16); add reads that and b, writes one
    assert c["hbm_bytes"] == (e(4, 8) + e(8, 16) + e(4, 16)
                              + e(4, 16) + e(16) + e(4, 16))
    assert c["min_bytes"] == e(4, 8) + e(8, 16) + e(16) + e(4, 16)
    assert c["launches"] == 2
    # the product's output is alive while the sum is written
    assert c["peak_bytes"] == 2 * e(4, 16)
    assert c["collective_bytes"] == 0


def test_views_are_free():
    x = torch.ones(6, 8)
    c = op_analysis.analyze(
        lambda x: x.view(2, 3, 8).transpose(0, 1)[1:].expand(2, 2, 8)
        .unsqueeze(0).detach(), x)
    assert c["launches"] == 0 and c["hbm_bytes"] == 0 and c["flops"] == 0
    assert c["peak_bytes"] == 0


def test_peak_follows_frees():
    def program():
        a = torch.ones(1000)          # 4000 B
        b = torch.ones(2000)          # 8000 B: 12000 live
        del a
        c = torch.ones(500)           # 2000 B: 10000 live
        d = b[:100] * 2               # 400 B
        del b, c
        return d + 1                  # 800 B live at the end

    c = op_analysis.analyze(program)
    assert c["peak_bytes"] == 12000
    assert c["launches"] == 5
    assert c["min_bytes"] == 400


def test_min_bytes_counts_what_an_update_writes():
    """An input returned unchanged writes nothing, one updated in place or
    copied with a region replaced writes what changed, anything else is
    written whole."""
    cache = torch.zeros(4, 16, 8)             # 2048 B
    slot = torch.ones(4, 1, 8)                # 128 B
    idx = torch.tensor([3])
    kept = torch.ones(5)                      # 20 B, returned unchanged
    reads = 2048 + 128 + 8 + 20

    c = op_analysis.analyze(lambda c, s, i, k: (c.index_copy(1, i, s), k),
                            cache, slot, idx, kept)
    assert c["min_bytes"] == reads + 128
    c = op_analysis.analyze(lambda c, s, i, k: (c.index_copy_(1, i, s), k),
                            cache.clone(), slot, idx, kept)
    assert c["min_bytes"] == reads + 128
    lanes = torch.tensor([1, 5, 0, 9])[:, None, None]   # 32 B
    c = op_analysis.analyze(
        lambda c, s, i: c.scatter(1, i.expand(4, 1, 8), s), cache, slot,
        lanes)
    assert c["min_bytes"] == 2048 + 128 + 32 + 128
    c = op_analysis.analyze(lambda c, s: c.mul_(2).add_(s), cache.clone(),
                            slot)
    assert c["min_bytes"] == 2048 + 128 + 2048   # at most its size
    c = op_analysis.analyze(lambda c, s, i: (c.index_copy(1, i, s) + 1),
                            cache, slot, idx)
    assert c["min_bytes"] == 2048 + 128 + 8 + 2048


@pytest.mark.parametrize("per_lane", [False, True])
def test_decode_min_bytes_at_a_long_cache(per_lane):
    """A decode step reads the weights, its state and its inputs once, and
    writes the logits and one K and one V slot a lane a layer: the cache
    is not counted as rewritten."""
    cfg = registry.get_config("qwen2-7b", smoke=True)
    b, t = 4, 4096
    params = dryrun.params_specs(cfg)
    state = specs.eval_shape(lambda: model.init_decode_state(cfg, b, t,
                                                             "cpu"))
    toks = torch.empty(b, dtype=torch.int32, device="meta")
    pos = torch.empty((b,) if per_lane else (), dtype=torch.int32,
                      device="meta")
    c = op_analysis.analyze(model.decode_step, params, cfg, state,
                            {"tokens": toks}, pos)
    size = lambda tree: sum(x.numel() * x.element_size()
                            for x in tree_lib.leaves(tree))
    item = _bytes(1, dtype=layers.dtype_of(cfg.compute_dtype))
    slots = cfg.num_layers * 2 * b * cfg.num_kv_heads * cfg.head_dim * item
    logits = b * cfg.vocab_size * item
    reads = size(params) + size(state) + toks.nbytes + pos.nbytes
    assert size(state) > 100 * slots
    assert c["min_bytes"] == reads + logits + slots


def test_trips_multiply_all_but_the_peak():
    x = torch.ones(4, 8)
    w = torch.ones(8, 8)
    with op_analysis.OpCounter() as once:
        (x @ w).relu()
    with op_analysis.OpCounter() as thrice:
        thrice.trips = 3
        (x @ w).relu()
    for k, v in once.counts.items():
        want = v if k == "peak_bytes" else 3 * v
        assert thrice.counts[k] == want, k


def test_mesh_transfers_are_counted():
    mesh = Mesh(["cpu"] * 4, "bank")
    parts = [torch.ones(3, 5, dtype=torch.int32) for _ in range(4)]
    c = op_analysis.analyze(lambda: (psum(parts, mesh), gather(parts, mesh)))
    moved = 3 * 3 * 5 * 4  # three shards' parts reach the first device
    assert c["coll:all-reduce"] == c["coll:all-gather"] == moved
    assert c["collective_bytes"] == 2 * moved


def test_pipeline_hand_overs_are_counted():
    mesh = Mesh(["cpu"] * 2, "pipe")
    x = torch.ones(3, 2, 4)  # 3 microbatches of 32 bytes
    stages = [torch.tensor(2.0), torch.tensor(3.0)]
    c = op_analysis.analyze(pipeline_forward, lambda p, h: h * p, stages, x,
                            mesh)
    # stage 1 takes each microbatch from stage 0; its outputs go home
    assert c["coll:collective-permute"] == c["coll:all-gather"] == 3 * 32


def _smoke_bf16(arch):
    return dataclasses.replace(registry.get_config(arch, smoke=True),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def test_fake_equals_real_cpu():
    """A decode step and a train step counted on fake tensors and on real
    CPU tensors of the same shapes: every count equal."""
    cfg = _smoke_bf16("qwen2-7b")
    tcfg = ts.TrainConfig()

    def counts(fake):
        mode = FakeTensorMode() if fake else None
        with (mode or torch.no_grad()):
            state = ts.init_state(torch.Generator().manual_seed(0), cfg, tcfg,
                                  "cpu")
            dstate = model.init_decode_state(cfg, B, S, "cpu")
            toks = torch.zeros(B, S, dtype=torch.int32)
            pos = torch.zeros((), dtype=torch.int32)
        if fake:
            # the optimizer reads the host step counters as numbers
            state = dryrun._host_step_counters(state)
        with (mode or torch.enable_grad()):
            dec = op_analysis.analyze(
                model.decode_step, state.params, cfg, dstate,
                {"tokens": toks[:, 0]}, pos)
            train = op_analysis.analyze(
                ts.train_step, state, {"tokens": toks, "labels": toks},
                cfg, tcfg)
        return dec, train

    assert counts(True) == counts(False)


def _port_prefill_flops(arch):
    cfg = registry.get_config(arch, smoke=True)
    shape = registry.ShapeSpec("prefill", S, B, "prefill")
    batch = dryrun.input_specs(cfg, shape)
    if "cross_states" in batch:
        batch["cross_states"] = batch["cross_states"].to(torch.float32)
    return op_analysis.analyze(model.prefill, dryrun.params_specs(cfg), cfg,
                               batch, S)["flops"]


@pytest.mark.parametrize("arch", DENSE_TOKEN_ARCHS)
def test_prefill_flops_equal_hlo_analysis(arch):
    assert _port_prefill_flops(arch) == reference_flops("prefill", arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_differs_by_the_one_hot_products(arch):
    """The reference dispatches tokens to expert slots and combines them
    back through one-hot einsums, ``bsd,bsec->becd`` and ``becd,bsec->bsd``
    (``models/moe.py:124, 132``), which are products in its HLO; the port
    routes with index gathers and scatters (no products), so it counts
    exactly those two products fewer per MoE layer."""
    cfg = registry.get_config(arch, smoke=True)
    g = min(4096, S)
    groups = B * (S // g)
    e, k = cfg.num_experts, cfg.experts_per_token
    capacity = max(1, int(g * k * cfg.moe_capacity_factor / e))
    per_product = 2 * groups * g * e * capacity * cfg.d_model
    moe_layers = cfg.num_cycles * sum(
        kind in ("attn", "local_attn", "cross_attn") for kind in cfg.cycle)
    one_hot = moe_layers * 2 * per_product
    assert reference_flops("prefill", arch) - _port_prefill_flops(arch) == one_hot


def test_dense_train_step_against_hlo_analysis():
    """qwen2-7b's smoke train step (remat "nothing", one microbatch): the
    port counts the reference's trip-aware HLO count less one more
    recompute of every query chunk's two attention products. The reference
    wraps each query chunk of its chunked attention in a ``jax.checkpoint``
    of its own (``models/attention.py:192``), nested in the layer's remat,
    so its backward recomputes each (query chunk, key chunk) pair's scores
    and weighted values once more after the layer's recompute: 10 products
    a pair against the port's 8 (forward 2, the layer's recompute 2,
    backward 4). The port's attention has no per-chunk checkpoint: its
    layer recompute keeps the chunks' scores for the backward instead."""
    arch, b, s = "qwen2-7b", B, S
    want = reference_flops("train", arch)

    cfg = registry.get_config(arch, smoke=True)
    tcfg = ts.TrainConfig()
    batch = dryrun.input_specs(cfg, registry.ShapeSpec("t", s, b, "train"))
    got = dryrun.count_train_step(dryrun.train_state_specs(cfg, tcfg), batch,
                                  cfg, tcfg)["flops"]
    c = min(cfg.attn_chunk, s)
    pairs = (s // c) ** 2
    per_product = 2 * b * cfg.num_heads * c * c * cfg.head_dim
    nested = cfg.num_layers * pairs * 2 * per_product
    print(f"port / reference train-step FLOPs: {got / want:.4f} "
          f"({got:.0f} / {want:.0f}; the nested recompute {nested})")
    assert want - got == nested
