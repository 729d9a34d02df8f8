"""Shape-only dry run of every (architecture x input shape x mesh) cell
(port of ``repro.launch.dryrun``): the step's counts, the bytes a device
holds and the collective term, with nothing allocated and no device
claimed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all --jobs 8

Results go into the JSON of ``--out`` cell by cell, so a crashed sweep
resumes where it left off. Render them with ``python -m
repro_torch.launch.roofline``.

The reference lowers each cell with XLA on 512 fake host devices and reads
``memory_analysis()`` and the compiled HLO (``launch/hlo_analysis.py``).
The port runs the step itself, eagerly, on meta tensors (built by
``specs.eval_shape``, which runs the initializers under a
``FakeTensorMode``), under ``op_analysis.OpCounter``; the same counts come
out of real tensors of the same shapes on any device. Meshes: ``1`` (one
H100, what the port runs on), ``16x16`` and ``2x16x16`` (the reference's;
``launch.mesh.make_production_mesh`` named on the host: the meshes only
place by the rules).

Per-device numbers. The single controller computes on one device from
gathered leaves (``sharding/specs.py``), so a device's FLOPs and bytes are
the step's counts over the mesh's size: the reference's own reading
(``roofline.py:6-8``: per-device numbers equal the global over chips).

Train cells count one microbatch's forward and backward (remat's
recompute included) ``microbatches`` times (``OpCounter.trips``, the
reference's trip count), its addition into the sums ``microbatches - 1``
times and the AdamW update once. A device holds
``state_gib`` (params and AdamW state by ``param_specs`` and
``opt_state_specs``, serving cells the params and, decoding, the decode
state by ``decode_state_specs``: exact) plus ``act_gib`` (the step's
``peak_bytes`` over the mesh's size); this replaces ``memory_analysis()``
and its XLA-CPU bf16 correction. The collective term has two parts. The
transfers the step's mesh code makes itself (``mesh.psum``, ``gather``,
the pipeline's hand-overs) are traced by ``OpCounter``; a model step
makes none. The transfers a partitioner would insert to place the step by
the rules are reckoned from them, since the single controller computes
from gathered leaves and makes none of them (the port has no GSPMD): a
parameter sharded
over ``k`` devices is gathered once per forward and once more per backward
((k - 1)/k of its bytes each time), its gradient reduce-scattered once a
step ((k - 1)/k), and a parameter replicated over the ``r`` data-parallel
devices all-reduces its gradient (2 (r - 1)/r). Activation collectives on
the ``model`` axis are not counted.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.configs import registry
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.sharding import specs
from repro_torch.sharding.constraints import activation_rules
from repro_torch.sharding.mesh import Mesh, set_mesh
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train import tree as tree_lib

MESHES = {"1": 1, "16x16": 256, "2x16x16": 512}
# The reference's --mesh choices, and the one card and all three meshes.
MESH_CHOICES = {"1": ("1",), "single": ("16x16",), "multi": ("2x16x16",),
                "both": ("16x16", "2x16x16"),
                "all": ("1", "16x16", "2x16x16")}

# Sequences per device per microbatch for train_4k (global batch 256).
# microbatches = global_batch / (dp_extent * this); the 405B runs 1 seq per
# device per accumulation step.
TRAIN_MICRO_SEQS = {
    "llama3-405b": 1, "qwen3-32b": 2, "mixtral-8x22b": 2,
    "phi3.5-moe-42b-a6.6b": 4, "qwen2-7b": 4, "llama-3.2-vision-11b": 4,
    "musicgen-medium": 8, "xlstm-1.3b": 8, "zamba2-2.7b": 4, "gemma3-1b": 8,
}

# Optimizer dtype policy per arch: the 405B drops f32 master copies and
# accumulates grads in bf16 — the difference between (2+2+2) and (2+4+4+4)
# bytes/param of optimizer state (EXPERIMENTS.md §Dry-run memory table).
OPT_OVERRIDES = {
    "llama3-405b": dict(master_dtype="bfloat16", grad_dtype="bfloat16"),
    "mixtral-8x22b": dict(master_dtype="bfloat16", grad_dtype="bfloat16"),
}


def _meta(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: registry.ShapeSpec
                ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.step in ("train", "prefill"):
        batch: Dict[str, torch.Tensor] = {}
        if cfg.embeddings_provided:
            batch["embeds"] = _meta((b, s, cfg.d_model), bf16)
        else:
            batch["tokens"] = _meta((b, s), i32)
        if "cross_attn" in cfg.cycle:
            batch["cross_states"] = _meta((b, cfg.cross_attn_tokens,
                                           cfg.d_model), bf16)
        if shape.step == "train":
            batch["labels"] = _meta((b, s), i32)
        return batch
    # decode: one new token against a seq_len cache
    if cfg.embeddings_provided:
        return {"embeds": _meta((b, 1, cfg.d_model), bf16)}
    return {"tokens": _meta((b,), i32)}


def _best_remat_group(num_cycles: int) -> Optional[int]:
    """Divisor g of L minimizing the saved-residual count (g + L/g)."""
    best, best_cost = None, None
    for g in range(2, num_cycles + 1):
        if num_cycles % g:
            continue
        cost = g + num_cycles // g
        if best_cost is None or cost < best_cost:
            best, best_cost = g, cost
    if best is None or best_cost >= num_cycles:
        return None
    return best


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    error: Optional[str] = None
    memory: Optional[Dict[str, float]] = None
    cost: Optional[Dict[str, float]] = None
    roofline_inputs: Optional[Dict[str, float]] = None
    microbatches: int = 1


def make_mesh(mesh_name: str) -> Mesh:
    """The cell's mesh, named on the host (it only places by the rules)."""
    host = torch.device("cpu")
    if mesh_name == "1":
        return Mesh([host], ("data", "model"), (1, 1))
    return make_production_mesh(multi_pod=mesh_name == "2x16x16",
                                devices=[host] * MESHES[mesh_name])


def _host_step_counters(state: ts.TrainStateT) -> ts.TrainStateT:
    """The step counters live on the host as real int32 tensors (the
    optimizer reads them as Python floats), as in a real state."""
    zero = lambda: torch.zeros((), dtype=torch.int32)
    return state._replace(step=zero(), opt=state.opt._replace(step=zero()))


def train_state_specs(cfg: ModelConfig, tcfg: ts.TrainConfig
                      ) -> ts.TrainStateT:
    """A meta train state with trainable params and host step counters."""
    state = specs.eval_shape(lambda: ts.init_state(
        torch.Generator().manual_seed(0), cfg, tcfg, "cpu"))
    ts.trainable(state.params)
    return _host_step_counters(state)


def params_specs(cfg: ModelConfig) -> Any:
    return specs.eval_shape(lambda: model.init_params(
        torch.Generator().manual_seed(0), cfg, "cpu"))


def count_train_step(state: ts.TrainStateT, batch: Dict[str, torch.Tensor],
                     cfg: ModelConfig, tcfg: ts.TrainConfig
                     ) -> Dict[str, float]:
    """``ts.train_step``'s counts: one microbatch's forward and backward
    counted ``tcfg.microbatches`` times (the scan's trip count), its
    addition into the sums once for each microbatch after the first, the
    rest once. At one microbatch this is
    ``op_analysis.analyze(ts.train_step, ...)``."""
    m = tcfg.microbatches
    if m <= 1:
        return op_analysis.analyze(ts.train_step, state, batch, cfg, tcfg)
    acc_dtype = dtype_of(tcfg.optimizer.grad_dtype)
    with op_analysis.OpCounter(inputs=(state, batch)) as counter:
        mb = ts._split_microbatches(batch, m)[0]
        # The first microbatch's loss and gradients, held as the sums while
        # every later microbatch runs (allocated, not written: peak only).
        loss_sum = torch.empty((), dtype=torch.float32,
                               device=state.params["embed"].device)
        acc = [torch.empty(p.shape, dtype=acc_dtype, device=p.device)
               for p in tree_lib.leaves(state.params)]
        counter.trips = m
        loss, grads = ts._value_and_grad(state.params, cfg, mb,
                                         tcfg.aux_weight)
        grads = [g.to(acc_dtype) for g in grads]
        counter.trips = m - 1
        loss_sum = loss_sum + loss
        torch._foreach_add_(acc, grads)
        del loss, grads
        counter.trips = 1
        loss, grads = ts.mean_of(loss_sum, acc, state.params, m)
        del loss_sum, acc
        out, metrics = ts.apply_update(state, grads, tcfg)
        metrics["loss"] = loss
        del grads
    counts = dict(counter.counts)
    counts["min_bytes"] = float(counter.min_bytes((out, metrics)))
    return counts


def _rule_collectives(params: Any, pspecs: Any, mesh: Mesh, step: str,
                      microbatches: int, grad_bytes: int) -> Dict[str, float]:
    """The collective bytes a device moves, reckoned from the placement
    rules (see the module docstring)."""
    dp = specs.dp_axes(mesh)
    r = math.prod(mesh.shape[a] for a in dp)
    table = dict(tree_lib.leaf_paths(pspecs))
    out = {f"coll:{k}": 0.0 for k in op_analysis.COLLECTIVES}
    passes = 2 * microbatches if step == "train" else 1
    for path, leaf in tree_lib.leaf_paths(params):
        spec = table[path]
        axes = [a for d in range(len(spec)) for a in spec.axes(d)]
        k = math.prod(mesh.shape[a] for a in axes)
        out["coll:all-gather"] += (passes * (k - 1) / k * leaf.numel()
                                   * leaf.element_size())
        if step == "train":
            g = leaf.numel() * grad_bytes
            out["coll:reduce-scatter"] += (k - 1) / k * g
            if not any(a in dp for a in axes):
                out["coll:all-reduce"] += 2 * (r - 1) / r * g
    out["collective_bytes"] = sum(out.values())
    return out


def _cell_config(arch: str, shape: registry.ShapeSpec,
                 overrides: Optional[Dict[str, Any]], smoke: bool):
    cfg = registry.get_config(arch, smoke=smoke)
    overrides = dict(overrides or {})
    micro_seqs = overrides.pop("micro_seqs", None)
    cfg = dataclasses.replace(cfg, **overrides)
    if (shape.step == "train" and cfg.remat_group is None
            and "remat_group" not in overrides):
        cfg = dataclasses.replace(
            cfg, remat_group=_best_remat_group(cfg.num_cycles))
    return cfg, micro_seqs


_SERVE_COUNTS: Dict[Any, Dict[str, float]] = {}


def run_cell(arch: str, shape_name: str, mesh_name: str = "16x16",
             overrides: Optional[Dict[str, Any]] = None, *,
             shape: Optional[registry.ShapeSpec] = None,
             microbatches: Optional[int] = None,
             optimizer: Optional[opt_lib.AdamWConfig] = None,
             smoke: bool = False) -> CellResult:
    """One cell. ``shape`` replaces the registry's ``shape_name``;
    ``microbatches`` and ``optimizer`` replace the dry run's policy
    (``TRAIN_MICRO_SEQS``, ``OPT_OVERRIDES`` with bf16 moments);
    ``overrides`` are config fields (``micro_seqs`` too, as the
    reference's); ``smoke`` takes the arch's reduced config."""
    t0 = time.time()
    shape = shape or registry.SHAPES[shape_name]
    try:
        cfg, micro_seqs = _cell_config(arch, shape, overrides, smoke)
        mesh = make_mesh(mesh_name)
        n = MESHES[mesh_name]
        micro = 1
        with set_mesh(mesh), activation_rules(
                specs.activation_hint_rules(cfg, mesh)):
            if shape.step == "train":
                dp_extent = math.prod(mesh.shape[a]
                                      for a in specs.dp_axes(mesh))
                seqs = micro_seqs or TRAIN_MICRO_SEQS.get(arch, 8)
                micro = microbatches or max(
                    1, shape.global_batch // (dp_extent * seqs))
                tcfg = ts.TrainConfig(
                    optimizer=optimizer or opt_lib.AdamWConfig(
                        moment_dtype="bfloat16",
                        **OPT_OVERRIDES.get(arch, {})),
                    microbatches=micro)
                state = train_state_specs(cfg, tcfg)
                params = state.params
                pspecs = specs.param_specs(params, cfg, mesh)
                held = (specs.spec_bytes(params, pspecs, mesh)
                        + specs.spec_bytes(state.opt, specs.opt_state_specs(
                            state.opt, pspecs), mesh))
                counts = count_train_step(state, input_specs(cfg, shape),
                                          cfg, tcfg)
                grad_dt = (tcfg.optimizer.grad_dtype if micro > 1
                           else cfg.param_dtype)
                grad_bytes = dtype_of(grad_dt).itemsize
            else:
                params = params_specs(cfg)
                pspecs = specs.param_specs(params, cfg, mesh)
                held = specs.spec_bytes(params, pspecs, mesh)
                batch = input_specs(cfg, shape)
                # A serving step's counts do not depend on the mesh: count
                # once per (config, shape).
                key = (repr(cfg), shape)
                if shape.step == "decode":
                    dstate = specs.eval_shape(lambda: model.init_decode_state(
                        cfg, shape.global_batch, shape.seq_len, "cpu"))
                    held += specs.spec_bytes(dstate, specs.decode_state_specs(
                        dstate, cfg, mesh, shape.global_batch), mesh)
                if key not in _SERVE_COUNTS:
                    _SERVE_COUNTS[key] = (
                        op_analysis.analyze(model.prefill, params, cfg,
                                            batch, shape.seq_len)
                        if shape.step == "prefill" else
                        # a scalar position: every lane writes one slot,
                        # the reference's fleet-aligned decode
                        op_analysis.analyze(model.decode_step, params, cfg,
                                            dstate, batch,
                                            _meta((), torch.int32)))
                counts = _SERVE_COUNTS[key]
                grad_bytes = 0
        roof = {k: v / n for k, v in counts.items()
                if k not in ("launches", "peak_bytes")}
        roof["launches"] = counts["launches"]
        for k, v in _rule_collectives(params, pspecs, mesh, shape.step,
                                      micro, grad_bytes).items():
            roof[k] += v
        memory = {"state_gib": held / 2**30,
                  "act_gib": counts["peak_bytes"] / n / 2**30}
        memory["peak_gib"] = memory["state_gib"] + memory["act_gib"]
        return CellResult(arch, shape.name, mesh_name, True, time.time() - t0,
                          memory=memory, cost=counts, roofline_inputs=roof,
                          microbatches=micro)
    except Exception as e:  # record the failure, keep sweeping
        return CellResult(arch, shape.name, mesh_name, False,
                          time.time() - t0,
                          error=f"{type(e).__name__}: {e}\n"
                                f"{traceback.format_exc()[-2000:]}")


def _load(out: str) -> Dict[str, Any]:
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    return {}


def _store(out: str, results: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, out)


def _run_meshes(job) -> List[Dict[str, Any]]:
    """Every mesh of one (arch, shape): the serving counts are shared."""
    arch, shape, mesh_names = job
    return [dataclasses.asdict(run_cell(arch, shape, m)) for m in mesh_names]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--shape", choices=list(registry.SHAPES))
    ap.add_argument("--mesh", choices=list(MESH_CHOICES), default="all")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_h100.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    args = ap.parse_args(argv)

    results = _load(args.out)
    if args.all:
        cells = [(a, s) for a, s, _ in registry.cells(include_skipped=True)]
    else:
        if not (args.arch and args.shape):
            ap.error("name --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    todo = []
    for arch, shape in cells:
        reason = registry.skip_reason(arch, shape)
        meshes = []
        for mesh_name in MESH_CHOICES[args.mesh]:
            cell_key = f"{arch}|{shape}|{mesh_name}"
            if reason:
                results[cell_key] = {"arch": arch, "shape": shape,
                                     "mesh": mesh_name, "ok": None,
                                     "skipped": reason}
                continue
            prior = results.get(cell_key)
            if prior and prior.get("ok") and not args.force:
                print(f"[skip-cached] {cell_key}", flush=True)
                continue
            meshes.append(mesh_name)
        if meshes:
            todo.append((arch, shape, tuple(meshes)))
    _store(args.out, results)

    def record(res: Dict[str, Any]) -> None:
        key = f"{res['arch']}|{res['shape']}|{res['mesh']}"
        results[key] = res
        _store(args.out, results)
        status = "OK" if res["ok"] else f"FAIL: {(res['error'] or '')[:200]}"
        extra = ""
        if res["ok"]:
            roof = res["roofline_inputs"]
            extra = (f" peak={res['memory']['peak_gib']:.2f}GiB"
                     f" flops={roof['flops']:.3e}"
                     f" coll={roof['collective_bytes']:.3e}B")
        print(f"[done] {key} -> {status} ({res['seconds']:.0f}s){extra}",
              flush=True)

    if args.jobs > 1 and len(todo) > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            for done in pool.imap_unordered(_run_meshes, todo):
                for res in done:
                    record(res)
    else:
        for job in todo:
            print(f"[run] {job[0]}|{job[1]}|{','.join(job[2])}", flush=True)
            for res in _run_meshes(job):
                record(res)
    return results


if __name__ == "__main__":
    main()
