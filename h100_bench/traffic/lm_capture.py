"""An offline capture job: token batches through a served LM's tapped
forward, the taps through the telemetry bridge into a STORM gateway.

The mix's parameters (``traffic/<mix>.json``, ``kind: lm_capture``):
``batch`` sequences of ``seq_len`` tokens a batch, tokens drawn from the
seed on the card, batches back to back; ``check_sequences`` sequences
drawn from the seed (the window's last among them) for the check.

The configuration gives the model (``model``: the port's ``ModelConfig``
fields), the taps (``taps``), the gateway (``gateway``) and the bridge
(``bridge``). The weights are made here from the seed in the served dtype
(``reference/zamba2_ref.py``'s layout, the port's tree).

End-to-end: ``tokens_per_s``, the tokens of the batches the bridge accepted
over the time from the window's start to the end of the last batch started
inside it. Correct, stage by stage (``reference/``): the sampled sequences'
tapped features and targets against the f32 forward; every standardized
row the bridge sent against the reference's standardization of the
features the bridge was given; the served counters against the reference's
insert of the rows the bridge sent.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench.harness import Window
from h100_bench.reference import probe_ref, storm_ref, zamba2_ref


class Session:
    """Set-up of one capture cell: weights, hash family, warmed path."""

    def __init__(self, config: dict, mix: dict, seed: int,
                 device: torch.device):
        from repro_torch.models.config import ModelConfig
        from repro_torch.telemetry import taps as taps_lib

        t0 = time.perf_counter()
        self.taps_lib = taps_lib
        self.config, self.mix, self.device = config, mix, device
        self.seed = seed
        m = config["model"]
        self.m = m
        self.cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in m.items()})
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.params = zamba2_ref.make_params(m, self.gen, device)
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
        b, s = mix["batch"], mix["seq_len"]
        # Warm-up: the tapped forward at the cell's shape, and a bridge
        # flush and gateway tick at the cell's shapes, on a gateway thrown
        # away.
        with torch.no_grad():
            toks = torch.randint(0, m["vocab_size"], (b, s), device=device,
                                 generator=self.gen)
            feats, targets = taps_lib.extract_tap_features(
                self.params, self.cfg, {"tokens": toks}, self.tap)
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

    def _gateway(self):
        from repro_torch.core import lsh, probes
        from repro_torch.serve import storm_gateway as gw_mod
        from repro_torch.telemetry import bridge as bridge_lib

        g = self.config["gateway"]
        gw = gw_mod.StormGateway(
            lsh.LSHParams(projections=self.projections),
            len(self.tap.layers), paired=True, query_slots=g["query_slots"],
            ingest_slots=g["ingest_slots"], count_dtype=g["count_dtype"],
            device=self.device)
        bridge = bridge_lib.TelemetryBridge(
            gw, probes.ProbeConfig(rows=g["rows"], planes=g["planes"]),
            window=self.config["bridge"]["window"])
        return gw, bridge, bridge.register(self.tap, self.cfg)

    def window(self, seconds: float, spans) -> Window:
        m, mix = self.m, self.mix
        b, s = mix["batch"], mix["seq_len"]
        batches = []
        step = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        with torch.no_grad():
            while time.perf_counter() < t_end:
                toks = torch.randint(0, m["vocab_size"], (b, s),
                                     device=self.device, generator=self.gen)
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

    def _free(self):
        """Let go of the program's gateway and bridge before the reference
        runs."""
        if hasattr(self, "gw"):
            del self.gw, self.bridge, self.sink
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def _sampled(self, log):
        """Blocks of ``(batch, row)`` of the sampled sequences, drawn from
        the seed, the window's last among them."""
        b = self.mix["batch"]
        total = len(log["batches"]) * b
        rng = np.random.default_rng([self.seed, 1])
        pick = sorted(set(rng.choice(
            total, size=min(self.mix["check_sequences"], total),
            replace=False).tolist()) | {total - 1})
        block = max(1, self.mix["check_block"])
        return [[divmod(i, b) for i in pick[lo:lo + block]]
                for lo in range(0, len(pick), block)]

    def _forward(self, log, where, mm=zamba2_ref.f32_mm):
        """The reference's tapped forward of the sequences at ``where``:
        features ``(taps, n, d)`` and targets ``(n,)``."""
        toks = torch.stack([log["batches"][i][0][j] for i, j in where])
        with torch.no_grad():
            return zamba2_ref.forward_taps(self.params, self.m, toks,
                                           list(self.tap.layers), mm, mm)

    def _standardized(self, log, dtype=torch.float32):
        """The reference's standardization, in ``dtype``, of the features
        the bridge was given, flush by flush (a tenant's moments frozen at
        its first flush): ``(index into log["submits"], rows)``."""
        slack = self.config["bridge"]["norm_slack"]
        batches, submits = log["batches"], log["submits"]
        mom, out, start = {}, [], 0
        for i, (_, _, _, first, end) in enumerate(batches):
            if end == first:
                continue
            fs = torch.from_numpy(np.concatenate(
                [x[1] for x in batches[start:i + 1]], axis=1)).to(self.device)
            ts = torch.from_numpy(np.concatenate(
                [x[2] for x in batches[start:i + 1]])).to(self.device)
            start = i + 1
            for k in range(first, end):
                tenant = submits[k][0]
                if tenant not in mom:
                    mom[tenant] = probe_ref.moments(fs[tenant], ts, slack,
                                                    dtype)
                out.append((k, probe_ref.rows(fs[tenant], ts, mom[tenant],
                                              dtype)))
        return out

    def _inserted(self, log, dtype=torch.float32):
        """The reference's insert, with the hash in ``dtype``, of the rows
        the bridge sent: ``{tenant: (counters, rows)}``."""
        w = storm_ref.kernel_layout(self.projections)
        out = {}
        for t in range(len(self.tap.layers)):
            zs = [z for tt, z in log["submits"] if tt == t]
            if not zs:
                continue
            z = torch.from_numpy(np.concatenate(zs)).to(self.device)
            ones = torch.ones((1, z.shape[0]), dtype=torch.int32,
                              device=self.device)
            out[t] = (storm_ref.weighted_counts(z, w, ones, dtype)[0],
                      z.shape[0])
        return out

    def lower(self, win: Window) -> None:
        """The control: the program's outputs in ``win.log`` replaced, stage
        by stage, by the reference's in the next precision below the
        configuration's bf16: the sampled sequences' taps and targets from
        the forward with its products in fp8 e4m3, the bridge's rows from
        the standardization in bf16, the counters from the insert with the
        hash in bf16."""
        self._free()
        log = win.log
        batches = log["batches"]
        for where in self._sampled(log):
            gf, gt = self._forward(log, where, zamba2_ref.fp8_mm)
            for col, (i, j) in enumerate(where):
                batches[i][1][:, j] = gf[:, col].float().cpu().numpy()
                batches[i][2][j] = float(gt[col])
        submits = log["submits"]
        for k, rows in self._standardized(log, torch.bfloat16):
            submits[k] = (submits[k][0], rows.float().cpu().numpy())
        for t, (counts, rows) in self._inserted(log, torch.bfloat16).items():
            log["counts"][t] = counts.to(log["counts"].dtype)
            log["n"][t] = rows

    def judge(self, win: Window) -> list:
        """``feat_gap`` (worst relative L2 gap of a sampled tap),
        ``target_gap`` (mean absolute gap of the sampled targets, nats: the
        entropy of a near-uniform next-token law moves little, and the
        worst of a few sequences does not part the control from sound
        runs),
        ``rows_gap`` (worst absolute gap of a standardized row's entry) and
        ``counter_cells_off`` (served counter cells and row counts off,
        exact), each with its limit from ``checks``."""
        self._free()
        log, dev = win.log, self.device
        limits = self.config["checks"]
        batches = log["batches"]
        feat_gap, target_gaps = 0.0, []
        for where in self._sampled(log):
            rf, rt = self._forward(log, where)
            gf = torch.from_numpy(np.stack(
                [batches[i][1][:, j] for i, j in where], axis=1)).to(dev)
            gt = torch.from_numpy(np.array(
                [batches[i][2][j] for i, j in where])).to(dev)
            gap = (torch.linalg.vector_norm(gf - rf, dim=-1)
                   / torch.linalg.vector_norm(rf, dim=-1))
            feat_gap = max(feat_gap, float(gap.max()))
            target_gaps += (gt - rt).abs().tolist()
        del self.params
        # The bridge's rows, flush by flush, against the reference's
        # standardization of the features it was given.
        rows_gap = 0.0
        for k, want in self._standardized(log):
            got = torch.from_numpy(log["submits"][k][1]).to(dev)
            rows_gap = max(rows_gap, float((got - want).abs().max()))
        # The served counters against the reference's insert of the rows
        # the bridge sent.
        cells_off = 0
        for t, (want, rows) in self._inserted(log).items():
            cells_off += int((log["counts"][t].to(want.device, torch.int64)
                              != want).sum().item())
            cells_off += int(int(log["n"][t].item()) != rows)
        target_gap = sum(target_gaps) / len(target_gaps)
        return [("feat_gap", feat_gap, limits["feat_gap"]),
                ("target_gap", target_gap, limits["target_gap"]),
                ("rows_gap", rows_gap, limits["rows_gap"]),
                ("counter_cells_off", cells_off, 0)]
