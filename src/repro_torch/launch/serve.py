"""Serving launcher: continuous-batching decode of a random-init model (port
of ``repro.launch.serve``; the smoke config of ``--arch``, as the
reference's).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import generator, resolve_device
from repro_torch.models import model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=registry.ARCH_IDS)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=True)
    params = model.init_params(generator(0, dev), cfg, device=dev)
    engine = ServeEngine(params, cfg, slots=args.slots,
                         cache_len=args.cache_len, device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(c.tokens) for c in outs)
    line = (f"served {len(outs)} requests, {total} tokens in {dt:.2f}s "
            f"({total / dt:.1f} tok/s, {engine.steps} engine steps)")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
