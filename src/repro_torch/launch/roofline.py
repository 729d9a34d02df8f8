"""Roofline report on one H100: three terms per (arch x shape x mesh) from
the dry run's JSON (port of ``repro.launch.roofline``).

    compute_s    = flops:bf16 / 989e12 + flops:f32 / 67e12   (per device)
    memory_s     = min_bytes / 3.35e12                        (HBM3)
    collective_s = collective bytes / 450e9                   (NVLink, each way)

The peaks are the H100 SXM data sheet's (dense bf16 on the tensor cores;
f32 products without them, since the port keeps TF32 off: ``device.py``).
Every input is counted from shapes (``launch/dryrun.py``,
``launch/op_analysis.py``), none measured: per-device numbers are the
step's counts over the mesh's size. ``memory_s`` reads the least bytes the
step must move (its inputs read once, its outputs written once); beside it
``hbm/min`` is what the eager port moves over that least. The NVLink term
is optimistic beyond 8 cards, where the traffic leaves the NVLink domain
for the network. MODEL_FLOPS uses 6 N_active D for training, 2 N_active D
for forward-only steps; its ratio to the counted FLOPs exposes remat's
recompute and attention.

    PYTHONPATH=src python -m repro_torch.launch.roofline --in results/dryrun_h100.json
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor cores / card
PEAK_F32_FLOPS = 67e12    # f32 without tensor cores / card
HBM_BW = 3.35e12          # B/s / card
LINK_BW = 450e9           # NVLink, B/s each way / card
HBM_BYTES = 80e9          # / card

CARD = "H100 80GB HBM3, 700 W"
MESH_CHIPS = {"1": 1, "16x16": 256, "2x16x16": 512}


def model_flops_per_device(arch: str, shape_name: str, chips: int) -> float:
    from repro_torch.configs import registry

    cfg = registry.get_config(arch)
    shape = registry.SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    return mult * n * tokens / chips


def compute_seconds(roof: Dict[str, float]) -> float:
    """The products at their dtype's peak (any other dtype at f32's)."""
    bf16 = roof.get("flops:bf16", 0.0) + roof.get("flops:f16", 0.0)
    return bf16 / PEAK_BF16_FLOPS + (roof["flops"] - bf16) / PEAK_F32_FLOPS


def cell_report(key: str, cell: Dict) -> Optional[Dict]:
    if not cell.get("ok"):
        return None
    arch, shape, mesh = cell["arch"], cell["shape"], cell["mesh"]
    chips = MESH_CHIPS[mesh]
    roof = cell["roofline_inputs"]
    compute_s = compute_seconds(roof)
    memory_s = roof["min_bytes"] / HBM_BW
    collective_s = roof["collective_bytes"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(arch, shape, chips)
    ratio = mf / roof["flops"] if roof["flops"] else 0.0
    # roofline fraction: useful model flops per second achievable given the
    # bottleneck term vs the card's bf16 peak
    step_time = max(terms.values())
    frac = (mf / step_time) / PEAK_BF16_FLOPS if step_time > 0 else 0.0
    peak_gib = cell["memory"]["peak_gib"]
    return {
        "arch": arch, "shape": shape, "mesh": mesh,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops_ratio": ratio, "roofline_frac": frac,
        "hbm_over_min": (roof["hbm_bytes"] / roof["min_bytes"]
                         if roof["min_bytes"] else 0.0),
        "peak_gib": peak_gib, "fits": peak_gib * 2**30 <= HBM_BYTES,
        "coll_breakdown": {k[5:]: v for k, v in roof.items()
                           if k.startswith("coll:") and v},
    }


_MOVE_DOWN = {
    "compute": ("cut recompute (relax the remat policy, tune the sqrt-L "
                "group), skip fully masked attention chunks, and run the "
                "f32 attention products in bf16 on the tensor cores (f32 "
                "products run at 67 of the 989 TFLOP/s)"),
    "memory": ("fuse the eager chain (one kernel for attention, one for "
               "AdamW) so the step moves closer to min_bytes (the hbm/min "
               "column), and keep bf16 end to end"),
    "collective": ("reshard to cut per-layer all-gathers: larger FSDP "
                   "shards, overlapped collectives, or gradient compression "
                   "across pods (beyond 8 cards the traffic leaves NVLink: "
                   "this term is optimistic there)"),
}


def render(results: Dict, mesh_filter: Optional[str] = None) -> str:
    rows = []
    skipped = []
    failed = []
    for key, cell in sorted(results.items()):
        if cell.get("skipped"):
            skipped.append((cell["arch"], cell["shape"], cell["skipped"]))
            continue
        if mesh_filter is not None and cell.get("mesh") != mesh_filter:
            continue
        rep = cell_report(key, cell)
        if rep:
            rows.append(rep)
        else:
            failed.append(key)

    out = [f"Counted from shapes against the published peaks of one {CARD} "
           f"card ({PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
           f"{PEAK_F32_FLOPS / 1e12:.0f} f32, {HBM_BW / 1e12:.2f} TB/s HBM, "
           f"{LINK_BW / 1e9:.0f} GB/s NVLink each way, "
           f"{HBM_BYTES / 1e9:.0f} GB): not measured.",
           "",
           "| arch | shape | mesh | compute (s) | memory (s) | hbm/min "
           "| collective (s) | dominant | 6ND/counted | roofline frac "
           "| peak GiB/device | fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4g} | {r['memory_s']:.4g} "
            f"| {r['hbm_over_min']:.1f} "
            f"| {r['collective_s']:.4g} | **{r['dominant']}** "
            f"| {r['model_flops_ratio']:.2f} | {r['roofline_frac']:.1%} "
            f"| {r['peak_gib']:.1f} | {'yes' if r['fits'] else 'no'} |"
        )
    out.append("")
    if failed:
        out.append("Cells that failed to count: " + ", ".join(failed))
        out.append("")
    if skipped:
        seen = set()
        out.append("Skipped cells (DESIGN.md §4):")
        for arch, shape, why in skipped:
            if (arch, shape) not in seen:
                seen.add((arch, shape))
                out.append(f"- {arch} x {shape}: {why}")
    out.append("")
    out.append("Collectives are reckoned from the placement rules (parameter "
               "gathers, gradient reduce-scatters and all-reduces); "
               "activation collectives on the model axis are not counted.")
    out.append("")
    out.append("What moves each dominant term down:")
    for kind, fix in _MOVE_DOWN.items():
        out.append(f"- **{kind}**: {fix}")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/dryrun_h100.json")
    ap.add_argument("--mesh", default=None, choices=list(MESH_CHIPS))
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        results = json.load(f)
    text = render(results, args.mesh)
    print(text)
    return text


if __name__ == "__main__":
    main()
