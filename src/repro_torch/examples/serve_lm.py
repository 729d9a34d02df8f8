"""Serving driver: continuous-batching engine over a batch of requests
(port of ``examples/serve_lm.py``; the smoke config of ``--arch``, as the
reference's).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 8 --slots 4
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import generator, resolve_device
from repro_torch.models import model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=registry.ARCH_IDS)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = registry.get_config(args.arch, smoke=True)  # reduced backbone
    params = model.init_params(generator(0, dev), cfg, device=dev)
    engine = ServeEngine(params, cfg, slots=args.slots,
                         cache_len=args.cache_len, device=dev)

    rng = np.random.default_rng(0)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=rng.integers(4, 12)).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
        )
        for i in range(args.requests)
    ]

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(c.tokens) for c in done)
    print(f"arch={cfg.name} slots={args.slots} requests={len(done)} "
          f"new_tokens={total_new}")
    print(f"wall={dt:.2f}s engine_steps={engine.steps} "
          f"tokens/s={total_new/dt:.1f}")
    for c in sorted(done, key=lambda c: c.rid)[:4]:
        print(f"  rid={c.rid}: {c.tokens}")
    return {"arch": cfg.name, "requests": len(done),
            "completed": sorted(c.rid for c in done),
            "new_tokens": total_new, "wall_s": dt,
            "engine_steps": engine.steps,
            "tokens": {c.rid: list(c.tokens) for c in done}}


if __name__ == "__main__":
    main()
