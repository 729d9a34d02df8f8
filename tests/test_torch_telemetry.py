"""The port's telemetry (``repro_torch.telemetry``) against
``repro.telemetry``, and the contracts of ``tests/test_telemetry.py`` on
the port's flat and tiered gateways.

  * taps: the tapped decode step's logits and state equal the untapped
    step's bit for bit; probe targets equal JAX's within 1e-5 on the same
    logits; tap features are the pooled residuals at the named cycles.
  * bridge: a slot's served counters after any number of window flushes
    equal the offline ``sketch_features(..., moments=frozen)`` build on the
    captured rows bit for bit (the gateway's banked insert and the lone
    insert run the same plain arithmetic on the CPU), and
    ``bridge.fit_probes`` equals the offline ``fit_probe_many`` bit for
    bit; the gateway's ``FitRequest`` equals ``erm.fit_many`` over the same
    counters. Telemetry adds no tick body (flat ``trace_count <= 3``,
    tiered ``<= 4``).
  * monitor: the scores equal JAX's on the same counter tables; quiet on an
    in-distribution stream, flags an injected shift.
  * wire: the stats frame carries ``telemetry`` when a bridge is attached.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.telemetry import monitor as jmonitor
from repro.telemetry import taps as jtaps
from repro_torch.configs import registry
from repro_torch.core import dfo, erm, lsh, probes, sketch as sketch_lib
from repro_torch.device import generator
from repro_torch.models import model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.storm_gateway import StormGateway
from repro_torch.serve.tiered_gateway import TieredStormGateway
from repro_torch.serve.wire import StormWireClient, StormWireServer
from repro_torch.telemetry import (
    DriftMonitor, TapBatch, TapConfig, TelemetryBridge, counter_distance,
    counter_kl, probe_target, window_delta,
)
from repro_torch.telemetry.taps import extract_tap_features, tapped_decode_fn
from torch_parity import CPU, t

jax.config.update("jax_platform_name", "cpu")

ROWS, PLANES = 64, 4


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_config("qwen2-7b", smoke=True)
    return cfg, model.init_params(None, cfg, device=CPU)


@pytest.fixture(scope="module")
def pcfg():
    # engine="kernel": the offline comparator runs the lone insert's plain
    # version, the arithmetic of the gateway's banked insert.
    return probes.ProbeConfig(rows=ROWS, planes=PLANES, batch=64,
                              engine="kernel")


@pytest.fixture(scope="module")
def gparams(setup, pcfg):
    cfg, _ = setup
    return lsh.init_srp(generator(7, CPU), pcfg.rows, pcfg.planes,
                        cfg.d_model + 3, device=CPU)


def _stream(cfg, n, seed=0, loc=0.0, taps=1):
    rng = np.random.default_rng(seed)
    feats = np.asarray(rng.normal(loc=loc, size=(taps, n, cfg.d_model)),
                       np.float32)
    targets = np.asarray(rng.normal(size=(n,)), np.float32)
    return feats, targets


def _push(sink, cfg, n, seed=0, loc=0.0, step=0, taps=1):
    feats, targets = _stream(cfg, n, seed=seed, loc=loc, taps=taps)
    sink(TapBatch(model="m", step=step, feats=feats, targets=targets,
                  mask=np.ones(n, bool)))
    return feats, targets


def _gateway(gparams, tenants, **kw):
    kw.setdefault("ingest_slots", 512)
    return StormGateway(gparams, tenants=tenants, device=CPU, **kw)


def _offline(feats, targets, pcfg, gparams, moments=None):
    return probes.sketch_features(None, t(feats), t(targets), pcfg, moments,
                                  params=gparams, device=CPU)


class TestTaps:
    def test_tapped_decode_step_is_bit_neutral(self, setup):
        cfg, params = setup
        state = model.init_decode_state(cfg, 2, 8, device=CPU)
        inputs = {"tokens": torch.tensor([3, 5])}
        pos = torch.tensor([0, 0])
        logits0, state0 = model.decode_step(params, cfg, state, inputs, pos)
        logits1, state1, taps = model.decode_step(
            params, cfg, state, inputs, pos, tap_layers=(0, 1))
        assert torch.equal(logits0, logits1)
        for c0, c1 in zip(state0, state1):
            for name in c0:
                assert torch.equal(c0[name].k, c1[name].k)
                assert torch.equal(c0[name].v, c1[name].v)
        assert taps.shape == (2, 2, 1, cfg.d_model)
        assert taps.dtype == torch.float32

    def test_tap_layer_validation(self, setup):
        cfg, params = setup
        state = model.init_decode_state(cfg, 1, 8, device=CPU)
        with pytest.raises(ValueError, match="tap_layers"):
            model.decode_step(params, cfg, state,
                              {"tokens": torch.tensor([0])},
                              torch.tensor([0]),
                              tap_layers=(cfg.num_cycles,))

    def test_tap_config_validation(self, setup):
        cfg, _ = setup
        with pytest.raises(ValueError, match="pool"):
            TapConfig(model="m", pool="max")
        with pytest.raises(ValueError, match="target"):
            TapConfig(model="m", target="loss")
        assert TapConfig(model="m").resolve_layers(cfg) == (0, 1)

    def test_probe_targets_match_jax(self):
        logits = np.random.default_rng(0).normal(size=(4, 16)).astype(
            np.float32)
        for kind in ("entropy", "max_logprob", "margin"):
            got = probe_target(t(logits), kind)
            want = jtaps.probe_target(jnp.asarray(logits), kind)
            assert got.shape == (4,) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        assert (probe_target(t(logits), "entropy") >= 0).all()
        assert (probe_target(t(logits), "max_logprob") <= 0).all()
        assert (probe_target(t(logits), "margin") >= 0).all()
        with pytest.raises(ValueError, match="target"):
            probe_target(t(logits), "perplexity")

    def test_tapped_decode_fn_pools_the_residual(self, setup):
        cfg, params = setup
        step = tapped_decode_fn(params, cfg, TapConfig(model="m"))
        state = model.init_decode_state(cfg, 2, 8, device=CPU)
        toks, pos = torch.tensor([1, 2]), torch.tensor([0, 0])
        logits, _, feats, targets = step(state, toks, pos)
        _, _, resid = model.decode_step(params, cfg, state,
                                        {"tokens": toks}, pos,
                                        tap_layers=(0, 1))
        assert feats.shape == (cfg.num_cycles, 2, cfg.d_model)
        assert torch.equal(feats, resid[:, :, 0])
        assert torch.equal(targets, probe_target(logits, "entropy"))

    def test_extract_tap_features_is_the_forward_twin(self, setup):
        cfg, params = setup
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (3, 7)))
        tap = TapConfig(model="m", layers=(1,), pool="mean",
                        target="margin")
        feats, targets = extract_tap_features(params, cfg,
                                              {"tokens": toks}, tap)
        hidden, resid = model.forward_taps(params, cfg, {"tokens": toks},
                                           (1,))
        assert torch.equal(feats, resid.mean(dim=2))
        logits = hidden[:, -1] @ model.unembed_table(params, cfg)
        assert torch.equal(targets, probe_target(logits, "margin"))


class TestBridgeBitIdentity:
    def test_single_window_matches_vanilla_sketch_features(
            self, setup, pcfg, gparams):
        cfg, _ = setup
        gw = _gateway(gparams, 1)
        bridge = TelemetryBridge(gw, pcfg, auto_flush=False)
        sink = bridge.register(TapConfig(model="m", layers=(0,)), cfg)
        feats, targets = _push(sink, cfg, 40, seed=3)
        assert bridge.flush() == 40
        live = bridge.probe_state("m", 0)
        off = _offline(feats[0], targets, pcfg, gparams)
        assert torch.equal(live.sketch.counts, off.sketch.counts)
        assert int(live.sketch.n) == int(off.sketch.n) == 40
        for f in ("x_mean", "x_scale", "y_mean", "y_scale", "scale"):
            assert torch.equal(getattr(live, f), getattr(off, f))
        assert gw.trace_count <= 3

    def test_multi_window_matches_frozen_moment_build(
            self, setup, pcfg, gparams):
        """Three window flushes; the offline comparator is ONE
        sketch_features over the concatenated activations under the first
        window's frozen moments."""
        cfg, _ = setup
        gw = _gateway(gparams, 1)
        bridge = TelemetryBridge(gw, pcfg, auto_flush=False)
        sink = bridge.register(TapConfig(model="m", layers=(0,)), cfg)
        chunks = []
        for w in range(3):
            chunks.append(_push(sink, cfg, 20, seed=10 + w, loc=0.3 * w,
                                step=w))
            bridge.flush()  # the first flush freezes the slot's moments
        frozen = bridge.moments_of("m", 0)
        live = bridge.probe_state("m", 0)
        all_feats = np.concatenate([f[0] for f, _ in chunks])
        all_tgts = np.concatenate([y for _, y in chunks])
        off = _offline(all_feats, all_tgts, pcfg, gparams, moments=frozen)
        assert torch.equal(live.sketch.counts, off.sketch.counts)
        assert int(live.sketch.n) == 60
        first = probes.probe_rows(t(chunks[0][0][0]), t(chunks[0][1]),
                                  pcfg)[1]
        assert torch.equal(frozen.x_mean, first.x_mean)
        assert gw.trace_count <= 3
        # The served table is a copy: later ingest leaves it as it was.
        _push(sink, cfg, 5, seed=40)
        bridge.flush()
        assert torch.equal(live.sketch.counts, off.sketch.counts)

    def test_fit_probes_matches_offline_fit_bit_for_bit(
            self, setup, pcfg, gparams):
        cfg, _ = setup
        gw = _gateway(gparams, 1)
        bridge = TelemetryBridge(gw, pcfg, auto_flush=False)
        sink = bridge.register(TapConfig(model="m", layers=(1,)), cfg)
        feats, targets = _push(sink, cfg, 48, seed=5)
        bridge.flush()
        small = dfo.DFOConfig(steps=40, num_queries=8, sigma=0.5,
                              learning_rate=2.0)
        live = bridge.fit_probes(generator(3, CPU), dfo_config=small)
        off_state = _offline(feats[0], targets, pcfg, gparams)
        off = probes.fit_probe_many(generator(3, CPU), [off_state],
                                    cfg.d_model, dfo_config=small,
                                    device=CPU)
        assert torch.equal(live.theta, off.theta)
        assert torch.equal(live.intercept, off.intercept)

    def test_fit_request_path_matches_offline_spine(
            self, setup, pcfg, gparams):
        """The in-loop refresh: the gateway trains the tap cohort from its
        live counters; erm.fit_many over the same counters and seed is the
        oracle."""
        cfg, _ = setup
        gw = _gateway(gparams, 2)
        bridge = TelemetryBridge(gw, pcfg, auto_flush=False)
        sink = bridge.register(TapConfig(model="m", layers=(0, 1)), cfg)
        _push(sink, cfg, 32, seed=6, taps=2)
        bridge.flush()
        req = bridge.fit_request(rid=9, seed=4, steps=10)
        assert req.tenants == [0, 1]
        gw.submit(req)
        fit = gw.tick().fits[0]
        bank = sketch_lib.SketchBank(
            counts=torch.stack([gw.bank.counts[i].to(torch.int32)
                                for i in req.tenants]),
            n=torch.stack([gw.bank.n[i] for i in req.tenants]))
        cfg_d = dfo.DFOConfig(steps=req.steps, num_queries=req.num_queries,
                              sigma=req.sigma,
                              learning_rate=req.learning_rate,
                              decay=req.decay)
        want = erm.fit_many(req.surrogate, bank, gparams, cfg_d,
                            restarts=req.restarts, l2=req.l2,
                            refine_steps=req.refine_steps,
                            generator=generator(req.seed, CPU), device=CPU)
        np.testing.assert_array_equal(fit.theta, want.theta.numpy())
        assert gw.trace_count <= 3

    def test_bridge_over_tiered_gateway(self, setup, pcfg, gparams):
        """Telemetry is ordinary ingest to the tiered store too: counters
        match the offline build and the swap program stays within the
        tiered budget."""
        cfg, _ = setup
        tiered = TieredStormGateway(gparams, 3, 2, ingest_slots=512,
                                    device=CPU)
        bridge = TelemetryBridge(tiered, pcfg, auto_flush=False)
        sink = bridge.register(TapConfig(model="m", layers=(0, 1)), cfg)
        feats, targets = _push(sink, cfg, 30, seed=8, taps=2)
        bridge.flush()
        for j in range(2):
            off = _offline(feats[j], targets, pcfg, gparams)
            live = bridge.probe_state("m", j)
            assert live.sketch.counts.dtype == torch.int32
            assert torch.equal(live.sketch.counts, off.sketch.counts)
        assert tiered.trace_count <= 4


class TestBridgeValidation:
    def test_rejects_unpaired_gateway(self, gparams, pcfg):
        gw = StormGateway(gparams, tenants=1, paired=False, device=CPU)
        with pytest.raises(ValueError, match="paired"):
            TelemetryBridge(gw, pcfg)

    def test_rejects_hash_family_mismatch(self, setup, pcfg):
        cfg, _ = setup
        wrong = lsh.init_srp(generator(0, CPU), 32, 3, cfg.d_model + 3,
                             device=CPU)
        with pytest.raises(ValueError, match="rows/planes"):
            TelemetryBridge(StormGateway(wrong, tenants=1, device=CPU), pcfg)

    def test_rejects_wrong_dim_at_register(self, setup, pcfg):
        cfg, _ = setup
        wrong = lsh.init_srp(generator(0, CPU), pcfg.rows, pcfg.planes,
                             cfg.d_model + 1, device=CPU)
        bridge = TelemetryBridge(StormGateway(wrong, tenants=4, device=CPU),
                                 pcfg)
        with pytest.raises(ValueError, match="d_model"):
            bridge.register(TapConfig(model="m"), cfg)

    def test_rejects_slot_overflow_and_duplicates(self, setup, pcfg,
                                                  gparams):
        cfg, _ = setup
        bridge = TelemetryBridge(_gateway(gparams, 1), pcfg)
        bridge.register(TapConfig(model="a", layers=(0,)), cfg)
        with pytest.raises(ValueError, match="already registered"):
            bridge.register(TapConfig(model="a", layers=(1,)), cfg)
        with pytest.raises(ValueError, match="tenants"):
            bridge.register(TapConfig(model="b", layers=(0, 1)), cfg)

    def test_unregistered_model_and_unflushed_state(self, setup, pcfg,
                                                    gparams):
        cfg, _ = setup
        bridge = TelemetryBridge(_gateway(gparams, 2), pcfg)
        bridge.register(TapConfig(model="m", layers=(0,)), cfg)
        with pytest.raises(KeyError):
            bridge.on_taps(TapBatch(model="ghost", step=0,
                                    feats=np.zeros((1, 1, cfg.d_model),
                                                   np.float32),
                                    targets=np.zeros(1, np.float32),
                                    mask=np.ones(1, bool)))
        with pytest.raises(KeyError):
            bridge.slot_of("m", 1)
        with pytest.raises(ValueError, match="no window"):
            bridge.moments_of("m", 0)
        with pytest.raises(ValueError, match="no flushed"):
            bridge.fit_probes(None)
        with pytest.raises(ValueError, match="no flushed"):
            bridge.fit_request(rid=1)

    def test_masked_lanes_never_reach_the_gateway(self, setup, pcfg,
                                                  gparams):
        cfg, _ = setup
        gw = _gateway(gparams, 1)
        bridge = TelemetryBridge(gw, pcfg, window=3)
        sink = bridge.register(TapConfig(model="m", layers=(0,)), cfg)
        feats, targets = _stream(cfg, 4, seed=1)
        sink(TapBatch(model="m", step=0, feats=feats, targets=targets,
                      mask=np.array([True, False, True, False])))
        assert bridge.telemetry_stats()["models"]["m"]["buffered"] == 2
        sink(TapBatch(model="m", step=1, feats=feats, targets=targets,
                      mask=np.array([False, True, False, False])))
        # Crossing the window of 3 flushed all three real rows.
        assert int(gw.sketch_of(0).n) == 3 and bridge.flushes == 1


class TestDriftMonitor:
    def test_counter_scores_match_jax(self):
        rng = np.random.default_rng(0)
        a = rng.integers(0, 9, size=(6, 16))
        b = rng.integers(0, 9, size=(6, 16))
        for paired in (True, False):
            assert counter_distance(a, 40, b, 33, paired=paired) == \
                jmonitor.counter_distance(a, 40, b, 33, paired=paired)
            assert counter_kl(a, 40, b, 33, paired=paired) == \
                jmonitor.counter_kl(a, 40, b, 33, paired=paired)

    def test_counter_scores_take_window_delta_tensors(self):
        """Both scorers on the int64 tensors window_delta returns equal the
        numpy scores and the reference's bit for bit."""
        rng = np.random.default_rng(3)
        snaps = [torch.from_numpy(rng.integers(0, 9, size=(6, 16))
                                  .astype(np.int32)) for _ in range(3)]
        snaps[1] += snaps[0]
        snaps[2] += snaps[1]
        a, b = window_delta(snaps[0], snaps[1]), window_delta(snaps[1],
                                                              snaps[2])
        assert a.dtype == torch.int64 and a.device.type == "cpu"
        for paired in (True, False):
            for score, jscore in ((counter_distance,
                                   jmonitor.counter_distance),
                                  (counter_kl, jmonitor.counter_kl)):
                got = score(a, 40, b, 33, paired=paired)
                assert got == score(a.numpy(), 40, b.numpy(), 33,
                                    paired=paired)
                assert got == jscore(jnp.asarray(a.numpy()), 40,
                                     jnp.asarray(b.numpy()), 33,
                                     paired=paired)

    def test_counter_distance_basics(self):
        a = np.asarray([[4, 4, 0, 0], [2, 2, 2, 2]], np.int64)
        assert counter_distance(a, 4, a, 4) == 0.0
        assert counter_distance(a, 0, a, 4) == 0.0  # no evidence != drift
        b = np.asarray([[0, 0, 4, 4], [2, 2, 2, 2]], np.int64)
        assert counter_distance(a, 4, b, 4) == pytest.approx(0.5)

    def test_counter_kl_basics(self):
        a = np.asarray([[4, 4, 0, 0], [2, 2, 2, 2]], np.int64)
        assert counter_kl(a, 4, a, 4) == 0.0
        assert counter_kl(a, 0, a, 4) == 0.0
        b = np.asarray([[0, 0, 4, 4], [2, 2, 2, 2]], np.int64)
        kl_ab = counter_kl(a, 4, b, 4)
        assert np.isfinite(kl_ab) and kl_ab > 0.0
        assert counter_kl(b, 4, a, 4) == pytest.approx(kl_ab)
        c = np.asarray([[3, 5, 0, 0], [2, 2, 2, 2]], np.int64)
        assert kl_ab > counter_kl(a, 4, c, 4)

    def test_kl_score_flags_shift_tv_default_bit_exact(
            self, setup, pcfg, gparams):
        """score="kl" is a drop-in: quiet on the null, flags the shift;
        score="tv" (the default) is bit-exactly counter_distance over the
        tracked reference and window deltas."""
        cfg, _ = setup

        def drive(score):
            gw = _gateway(gparams, 1, ingest_slots=256)
            bridge = TelemetryBridge(gw, pcfg, auto_flush=False)
            sink = bridge.register(TapConfig(model="m", layers=(0,)), cfg)
            mon = DriftMonitor(bridge, reference_windows=1,
                               calibration_windows=3, score=score)
            snaps = []
            for w in range(7):
                _push(sink, cfg, 200, seed=100 + w, step=w)
                bridge.flush()
                snaps.append(gw.sketch_of(0).counts.numpy().astype(np.int64))
            assert not mon.status()["any_flagged"]
            _push(sink, cfg, 200, seed=999, loc=2.0, step=99)
            bridge.flush()
            snaps.append(gw.sketch_of(0).counts.numpy().astype(np.int64))
            return mon, snaps

        mon_kl, _ = drive("kl")
        assert mon_kl.status()["any_flagged"]
        assert mon_kl.status()["score"] == "kl"
        mon_tv, snaps = drive("tv")
        assert mon_tv.status()["any_flagged"]
        assert mon_tv.status()["score"] == "tv"
        tr = mon_tv._tracks[0]
        want = counter_distance(snaps[1] - snaps[0], 200,
                                snaps[-1] - snaps[-2], 200, paired=True)
        assert tr.last_score == want
        with pytest.raises(ValueError, match="unknown score"):
            DriftMonitor(mon_tv.bridge, score="js")

    def test_window_delta_is_the_window_sketch(self):
        prev = torch.tensor([[3, 1]], dtype=torch.int32)
        cur = torch.tensor([[5, 4]], dtype=torch.int16)
        got = window_delta(prev, cur)
        assert got.dtype == torch.int64 and got.tolist() == [[2, 3]]

    def test_quiet_on_null_flags_on_shift(self, setup, pcfg, gparams):
        cfg, _ = setup
        gw = _gateway(gparams, 1, ingest_slots=256)
        bridge = TelemetryBridge(gw, pcfg, auto_flush=False)
        sink = bridge.register(TapConfig(model="m", layers=(0,)), cfg)
        mon = DriftMonitor(bridge, reference_windows=1,
                           calibration_windows=3)
        for w in range(7):
            _push(sink, cfg, 200, seed=100 + w, step=w)
            bridge.flush()
        st = mon.status()
        assert not st["any_flagged"]
        assert st["slots"][0]["threshold"] is not None
        assert mon.flagged() == []
        _push(sink, cfg, 200, seed=999, loc=2.0, step=99)
        bridge.flush()
        st = mon.status()
        assert st["any_flagged"]
        flagged = mon.flagged()
        assert flagged and flagged[0]["tenant"] == 0
        assert bridge.telemetry_stats()["drift"]["any_flagged"]

    def test_continuous_refresh_trains_from_served_counters(
            self, setup, pcfg, gparams):
        cfg, _ = setup
        gw = _gateway(gparams, 1, ingest_slots=256)
        bridge = TelemetryBridge(gw, pcfg, auto_flush=False)
        sink = bridge.register(TapConfig(model="m", layers=(0,)), cfg)
        mon = DriftMonitor(bridge, reference_windows=1,
                           calibration_windows=1, refresh_every=2)
        for w in range(6):
            _push(sink, cfg, 64, seed=200 + w, step=w)
            bridge.flush()
        assert mon.refreshes >= 1
        assert mon.last_fit is not None
        assert mon.last_fit.theta.shape[-1] == cfg.d_model

    def test_validation(self, setup, pcfg, gparams):
        bridge = TelemetryBridge(_gateway(gparams, 1), pcfg)
        with pytest.raises(ValueError, match="reference"):
            DriftMonitor(bridge, reference_windows=0)
        with pytest.raises(ValueError, match="calibration"):
            DriftMonitor(bridge, calibration_windows=0)


class TestEngineToGateway:
    def test_served_tokens_unchanged_and_counters_flow(self, setup, pcfg,
                                                       gparams):
        """The full loop: the engine decodes with taps, the bridge ingests
        between steps, tokens match the untapped engine, and the served
        counters equal the offline build of the captured rows."""
        cfg, params = setup
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)
                   for _ in range(4)]
        mk = lambda: [Request(rid=i, prompt=p, max_new_tokens=5)  # noqa
                      for i, p in enumerate(prompts)]
        plain = ServeEngine(params, cfg, slots=2, cache_len=32,
                            device=CPU).run(mk())

        gw = _gateway(gparams, cfg.num_cycles)
        bridge = TelemetryBridge(gw, pcfg, window=8)
        tap = TapConfig(model="qwen2-7b")
        sink = bridge.register(tap, cfg)
        seen = []

        def capture(batch):
            seen.append(batch)
            sink(batch)

        eng = ServeEngine(params, cfg, slots=2, cache_len=32, taps=tap,
                          tap_sink=capture, device=CPU)
        tapped = eng.run(mk())
        assert {c.rid: c.tokens for c in plain} == \
               {c.rid: c.tokens for c in tapped}
        bridge.flush()  # tail window
        stats = bridge.telemetry_stats()
        assert all(s["rows_ingested"] > 0 for s in stats["slots"])
        assert stats["flushes"] > 1
        rows = [b.active() for b in seen]
        feats = np.concatenate([f for f, _ in rows], axis=1)
        targets = np.concatenate([y for _, y in rows])
        assert int(gw.bank.n[0]) == targets.size == sum(
            int(b.mask.sum()) for b in seen)
        for j in range(cfg.num_cycles):
            off = _offline(feats[j], targets, pcfg, gparams,
                           moments=bridge.moments_of("qwen2-7b", j))
            assert torch.equal(bridge.probe_state("qwen2-7b", j)
                               .sketch.counts, off.sketch.counts)
        assert gw.trace_count <= 3

    def test_wire_stats_frame_carries_telemetry(self, setup, pcfg,
                                                gparams):
        cfg, _ = setup
        gw = _gateway(gparams, 1)
        bridge = TelemetryBridge(gw, pcfg, auto_flush=False)
        sink = bridge.register(TapConfig(model="m", layers=(0,)), cfg)
        _push(sink, cfg, 16, seed=9)
        bridge.flush()
        server = StormWireServer(gw, port=0, telemetry=bridge).start()
        try:
            client = StormWireClient(*server.address)
            stats = client.stats()
            assert "telemetry" in stats
            assert stats["telemetry"]["slots"][0]["rows_ingested"] == 16
            client.close()
        finally:
            server.stop()
        plain = StormWireServer(gw, port=0).start()
        try:
            client = StormWireClient(*plain.address)
            assert "telemetry" not in client.stats()
            client.close()
        finally:
            plain.stop()
