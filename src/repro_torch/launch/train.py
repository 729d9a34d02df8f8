"""Training launcher: a mesh, a random-init model and the fault-tolerant
loop (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --smoke-config --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke-config

The mesh is the port's one-axis debug mesh over every visible card (or the
named CPU); training runs on its first device, with the mesh ambient and
the reference's activation rules (``specs.activation_hint_rules``)
installed for ``constraints.hint``, as the reference's launcher does. The
single controller keeps activations whole, so the hints check their rule
against the mesh and change no value. Each step's batch is
drawn from a ``torch.Generator`` seeded by ``(11, step)``: deterministic in
the step, as restart-replay needs, but not the reference's threefry stream.
A second run on the same ``--ckpt-dir`` resumes from its newest checkpoint.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.device import generator
from repro_torch.sharding import specs
from repro_torch.sharding.constraints import activation_rules
from repro_torch.sharding.mesh import make_debug_mesh, set_mesh
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train import trainer

DATA_SEED = 11


def data_for_step(step: int, batch: int, seq: int, vocab: int,
                  cross: Optional[Tuple[int, int]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Random tokens and their next-token labels, the same for a step on
    every run (drawn on the CPU). ``cross = (tokens, d_model)`` adds stub
    frontend states ``cross_states (batch, tokens, d_model)``, normals
    times 0.1, for a model with cross-attention blocks (the reference's
    launcher feeds tokens alone, which its cross-attention cannot take)."""
    gen = torch.Generator().manual_seed((DATA_SEED << 32) | step)
    toks = torch.randint(0, vocab, (batch, seq), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    out = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if cross is not None:
        out["cross_states"] = 0.1 * torch.randn((batch,) + tuple(cross),
                                                generator=gen)
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke-config", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch, smoke=args.smoke_config)
    mesh = make_debug_mesh(None if args.device is None else [args.device])
    dev = mesh.first
    tcfg = ts.TrainConfig(
        optimizer=opt_lib.AdamWConfig(learning_rate=args.lr,
                                      total_steps=args.steps),
        microbatches=args.microbatches,
    )
    loop = trainer.LoopConfig(total_steps=args.steps,
                              ckpt_every=max(10, args.steps // 3),
                              ckpt_dir=args.ckpt_dir)
    cross = ((cfg.cross_attn_tokens, cfg.d_model)
             if "cross_attn" in cfg.cycle else None)
    rules = specs.activation_hint_rules(cfg, mesh)
    with set_mesh(mesh), activation_rules(rules):
        report = trainer.train(
            generator(0, dev), cfg, tcfg, loop,
            lambda step: data_for_step(step, args.batch, args.seq,
                                       cfg.vocab_size, cross),
            device=dev)
    line = (f"arch={cfg.name} steps={report.steps_run} "
            f"final_loss={report.final_loss:.4f} "
            f"resumed={report.resumed_from}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
