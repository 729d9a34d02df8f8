"""End-to-end LM training driver: data pipeline -> model -> fault-tolerant
loop with checkpointing, on any --arch from the registry (reduced or full)
(port of ``examples/train_lm.py``).

Default trains a ~100M-parameter dense model for a few hundred steps on a
synthetic token stream (deterministic per step — restart-replay exact):

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --smoke          # CI-sized
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch qwen2-7b --smoke-config

Resume after interruption with the same command (auto-resumes from the
newest intact checkpoint in --ckpt-dir); ``--stop-after N`` interrupts a
run after step N. The stream is drawn from a ``torch.Generator`` seeded by
the step, not the reference's threefry stream.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import registry
from repro_torch.device import generator, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts
from repro_torch.train import trainer

DATA_SEED = 1234


def model_100m() -> ModelConfig:
    """~100M-param llama-style dense config (12L x 768)."""
    return ModelConfig(
        name="dense-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32768, attn_chunk=256, xent_chunk=256,
    )


def synthetic_stream(cfg: ModelConfig, batch: int, seq: int):
    """Deterministic Zipf-ish Markov token stream, seeded by step."""

    def data_for_step(step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed((DATA_SEED << 32) | step)
        # low-entropy structure so the loss visibly falls
        base = torch.randint(0, 256, (batch, seq // 8), generator=gen)
        toks = torch.repeat_interleave(base, 8, dim=1)
        noise = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
        keep = torch.rand((batch, seq), generator=gen) < 0.9
        toks = torch.where(keep, toks, noise).to(torch.int32)
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}

    return data_for_step


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dense-100m",
                    choices=("dense-100m",) + registry.ARCH_IDS)
    ap.add_argument("--smoke-config", action="store_true",
                    help="use the reduced config for --arch")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + 20 steps (CI)")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="stop after this step, as an interruption would")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.smoke:
        cfg = registry.get_config("qwen2-7b", smoke=True)
        args.steps, args.batch, args.seq = 20, 4, 64
    elif args.arch == "dense-100m":
        cfg = model_100m()
    else:
        cfg = registry.get_config(args.arch, smoke=args.smoke_config)

    n_params = cfg.param_count()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps} "
          f"batch={args.batch} seq={args.seq}")

    tcfg = ts.TrainConfig(
        optimizer=opt_lib.AdamWConfig(
            learning_rate=args.lr, warmup_steps=max(10, args.steps // 20),
            total_steps=args.steps,
        )
    )
    loop = trainer.LoopConfig(
        total_steps=min(args.steps, args.stop_after or args.steps),
        ckpt_every=max(10, args.steps // 5),
        ckpt_dir=args.ckpt_dir,
        log_every=10,
    )
    data = synthetic_stream(cfg, args.batch, args.seq)

    report = trainer.train(generator(0, dev), cfg, tcfg, loop, data,
                           device=dev)
    first = sum(report.losses[:5]) / max(len(report.losses[:5]), 1)
    print(f"resumed_from={report.resumed_from} steps_run={report.steps_run}")
    print(f"loss: first5={first:.4f} final={report.final_loss:.4f}")
    print(f"stragglers={report.straggler_steps} restores={report.restores}")
    return {"arch": cfg.name, "params": n_params,
            "resumed_from": report.resumed_from,
            "steps_run": report.steps_run, "losses": report.losses,
            "first5": first, "final_loss": report.final_loss,
            "stragglers": report.straggler_steps,
            "restores": report.restores}


if __name__ == "__main__":
    main()
