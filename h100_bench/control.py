#!/usr/bin/env python3
"""Read a cell's control on the card: the reference, computed in the next
lower precision than the configuration states, in the program's place.

    python3 h100_bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed: the cell's set-up and a window of ``--seconds`` at the cell's
own load (the traffic and sizes the check compares); then each loop's
``lower`` puts the control's outputs in the log in place of the program's,
and the cell's own ``judge`` compares them; one JSON line a seed. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from h100_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, args.workload)
    config = harness.config_of(spec, cell, ROOT)
    mix = harness.mix_of(cell)
    loop = harness.loop_of(mix)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        session = loop.Session(config, mix, seed, device)
        win = session.window(args.seconds, harness.Spans())
        session.lower(win)
        checks = session.judge(win)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": True,
                          "correct": all(v <= lim for _, v, lim in checks),
                          "checks": {n: v for n, v, _ in checks}}),
              flush=True)
        del session, win
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
