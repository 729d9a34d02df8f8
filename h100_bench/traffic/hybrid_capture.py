"""An offline capture job through a hybrid MoE LM (NemotronH): token
batches through the served model's tapped forward, the taps through the
telemetry bridge into a STORM gateway.

The mix's parameters (``traffic/<mix>.json``, ``kind: hybrid_capture``):
``batch`` sequences of ``seq_len`` tokens a batch, back to back, each token
drawn on the card from the seed by Zipf's law (``zipf_s``) over the
vocabulary, the ids permuted from the seed (real text's unigram law, so the
routing is uneven); ``check_sequences`` and ``check_block`` as
``lm_capture``'s.

Everything but the model and the tokens is ``lm_capture.Session``'s: the
gateway, the bridge, the sampled sequences, the standardization, the
insert, the control and the four checks (``feat_gap``, ``target_gap``,
``rows_gap``, ``counter_cells_off``). The weights are
``reference/nemotron_h_ref.py``'s, in the port's tree; the check's forward
is that file's. The ``ModelConfig`` is built before any weight, so a
program without the configuration's fields fails within seconds of the
loop's start.

A routing decision is discrete: where a near tie routes a position apart,
the outputs part for good, and with random weights and 128 experts such
ties are common enough that a free-running f32 forward parts from the bf16
program by far more than rounding. So the check takes the program's routing
of each sampled sequence (its batch re-run whole, at the window's shapes),
runs the reference by that routing, and holds the routing itself to the
reference apart: ``route_gap``, the largest amount by which a chosen
expert's biased score lies below the reference's own k-th. ``rerun_off``
(1 where a re-run's features differ from the window's by a bit, limit 0)
holds the re-run to the window, so that the routing forced on the
reference is the window's own. A ``routing`` line on standard error counts
the choices routed apart.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from h100_bench.harness import Window
from h100_bench.reference import nemotron_h_ref
from h100_bench.traffic import lm_capture


class Session(lm_capture.Session):
    """Set-up of one capture cell: weights, token law, hash family, warmed
    path."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        from repro_torch.models.config import ModelConfig
        from repro_torch.telemetry import taps as taps_lib

        t0 = time.perf_counter()
        m = config["model"]
        self.cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in m.items()})
        self.taps_lib = taps_lib
        self.config, self.mix, self.device = config, mix, device
        self.seed, self.m = seed, m
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.params = nemotron_h_ref.make_params(m, self.gen, device)
        v = m["vocab_size"]
        ranks = torch.arange(1, v + 1, dtype=torch.float64, device=device)
        cdf = torch.cumsum(ranks ** -float(mix["zipf_s"]), 0)
        self.cdf = cdf / cdf[-1]
        self.ids = torch.randperm(v, generator=self.gen, device=device)
        g = config["gateway"]
        self.projections = torch.randn(
            (g["rows"], g["planes"], m["d_model"] + 3), generator=self.gen,
            device=device)
        t = config["taps"]
        self.tap = taps_lib.TapConfig(model=config["name"],
                                      layers=tuple(t["layers"]),
                                      pool=t["pool"], target=t["target"])
        self.rng = np.random.default_rng(seed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        b = mix["batch"]
        # Warm-up: the tapped forward at the cell's shape, and a bridge
        # flush and gateway tick at the cell's shapes, on a gateway thrown
        # away.
        with torch.no_grad():
            feats, targets = taps_lib.extract_tap_features(
                self.params, self.cfg, {"tokens": self._tokens()}, self.tap)
            fh, th = feats.cpu().numpy(), targets.cpu().numpy()
        t2 = time.perf_counter()
        _, _, sink = self._gateway()
        per_flush = max(1, -(-config["bridge"]["window"] // b))
        for step in range(2 * per_flush):
            sink(taps_lib.TapBatch(self.tap.model, step, fh, th,
                                   np.ones((b,), bool)))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t3 = time.perf_counter()
        self.gw, self.bridge, self.sink = self._gateway()
        self.setup_phases = {"weights": t1 - t0, "warm forward": t2 - t1,
                             "warm bridge": t3 - t2,
                             "gateway": time.perf_counter() - t3}
        self.submits = []
        submit = self.gw.submit

        def logged(req):
            self.submits.append((req.tenant, req.z))
            submit(req)

        self.gw.submit = logged

    def _tokens(self) -> torch.Tensor:
        """A batch of ids by Zipf's law over the permuted vocabulary, drawn
        on the card from the seed."""
        b, s = self.mix["batch"], self.mix["seq_len"]
        u = torch.rand((b * s,), dtype=torch.float64, device=self.device,
                       generator=self.gen)
        rank = torch.searchsorted(self.cdf, u, right=True).clamp_(
            max=self.cdf.numel() - 1)
        return self.ids[rank].view(b, s)

    def window(self, seconds: float, spans) -> Window:
        b, s = self.mix["batch"], self.mix["seq_len"]
        batches = []
        step = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        with torch.no_grad():
            while time.perf_counter() < t_end:
                toks = self._tokens()
                with spans.span("forward"):
                    feats, targets = self.taps_lib.extract_tap_features(
                        self.params, self.cfg, {"tokens": toks}, self.tap)
                    fh, th = feats.cpu().numpy(), targets.cpu().numpy()
                first = len(self.submits)
                with spans.span("bridge"):
                    self.sink(self.taps_lib.TapBatch(
                        self.tap.model, step, fh, th, np.ones((b,), bool)))
                batches.append((toks, fh, th, first, len(self.submits)))
                step += 1
        window_s = time.perf_counter() - t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tokens = len(batches) * b * s
        counters = {"batches": len(batches), "batch": b, "seq_len": s}
        bank = self.gw.bank
        log = {"batches": batches, "counts": bank.counts.clone(),
               "n": bank.n.clone(), "submits": list(self.submits)}
        return Window({"tokens_per_s": tokens / window_s}, len(batches) * b,
                      0, counters, log)

    # -- the check ----------------------------------------------------------

    def _program_routing(self, log, where):
        """The routing under test of the sequences at ``where``, into
        ``log["routing"][(i, j)]`` (each MoE layer's ``(seq_len, k)``
        choices): each one's batch re-run whole through the program's tapped
        forward, at the window's shapes, its choices recorded. Whether each
        re-run gives the window's features bit for bit goes to
        ``self.rerun_equal``, which ``rerun_off`` reads."""
        from repro_torch.models import moe

        routing = log.setdefault("routing", {})
        s = self.mix["seq_len"]
        for i in sorted({i for i, j in where if (i, j) not in routing}):
            toks, feats = log["batches"][i][:2]
            with torch.no_grad(), moe.record_choices() as got:
                again, _ = self.taps_lib.extract_tap_features(
                    self.params, self.cfg, {"tokens": toks}, self.tap)
            self.rerun_equal &= np.array_equal(again.cpu().numpy(), feats)
            for ii, j in where:
                if ii == i:
                    routing[(i, j)] = [c[j * s:(j + 1) * s] for c in got]

    def _forward(self, log, where, mm=nemotron_h_ref.f32_mm):
        """The reference's tapped forward of the sequences at ``where``:
        features ``(taps, n, d)`` and targets ``(n,)``. In f32 it routes by
        the routing under test (``log["routing"]``) and keeps, for
        ``route_gap``, how far each choice lies below its own; in a lower
        precision (the control) it routes by itself, and its routing becomes
        the routing under test."""
        toks = torch.stack([log["batches"][i][0][j] for i, j in where])
        routing = log.setdefault("routing", {})
        layers = list(self.tap.layers)
        s = self.mix["seq_len"]
        choices = []
        with torch.no_grad():
            if mm is not nemotron_h_ref.f32_mm:
                out = nemotron_h_ref.forward_taps(
                    self.params, self.m, toks, layers, mm, mm,
                    choices=choices)
                for col, w in enumerate(where):
                    routing[w] = [c[col * s:(col + 1) * s]
                                  for c, _ in choices]
                return out
            forced = [torch.cat([routing[w][n] for w in where])
                      for n in range(len(routing[where[0]]))]
            out = nemotron_h_ref.forward_taps(
                self.params, self.m, toks, layers, mm, mm, choices=choices,
                forced=forced)
        self.excess += [e for _, e in choices]
        return out

    def judge(self, win: Window) -> list:
        """``lm_capture``'s four checks, the taps and targets against the
        reference routed as the program routed, and ``route_gap``: the
        largest excess of a sampled (MoE layer, position) choice, how far
        below the reference's own k-th biased score the program's lowest
        chosen expert lies (0 where the choices agree), so that only near
        ties may route apart; and ``rerun_off``, 1 where a batch re-run for
        its routing gave other features than the window's (limit 0)."""
        self.excess, self.rerun_equal = [], True
        for where in self._sampled(win.log):
            self._program_routing(win.log, where)
        checks = super().judge(win)
        excess = torch.cat(self.excess)
        apart = excess[excess > 0]
        print(f"routing apart {apart.numel()} of {excess.numel()} (MoE "
              f"layer, position) choices of the sampled sequences; their "
              f"excess: median "
              f"{float(apart.median()) if apart.numel() else 0.0!r}, max "
              f"{float(excess.max())!r}; the program re-run equal to the "
              f"window: {self.rerun_equal}", file=sys.stderr, flush=True)
        return checks + [("route_gap", float(excess.max()),
                          self.config["checks"]["route_gap"]),
                         ("rerun_off", int(not self.rerun_equal), 0)]
