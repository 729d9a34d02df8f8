"""The port's ``ServeEngine`` against ``repro.serve.engine``, and the
engine's own contracts (mirroring ``tests/test_serve_engine.py``).

Greedy token streams equal JAX's engine on the four dense smoke configs
with mixed prompt lengths and more requests than slots (lanes recycle,
gemma3's local-layer rings wrap): the same numpy prompts, parameters
carried across with ``interop.lm_params``, f32 on both sides, and an argmax
that takes the first maximal index in both frameworks. Then, port only:
greedy decode is deterministic across fresh engines, a lane reset zeroes
exactly that lane, a recycled lane decodes as a fresh engine does,
``max_steps`` bounds the loop, empty prompts are refused at submission, and
taps change no token.
"""

import jax
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_launch
from repro_torch.models import model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.telemetry.taps import TapConfig
from torch_parity import CPU

jax.config.update("jax_platform_name", "cpu")

DENSE = ("qwen2-7b", "gemma3-1b", "qwen3-32b", "llama3-405b")


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_config("qwen2-7b", smoke=True)
    return cfg, model.init_params(None, cfg, device=CPU)


def _requests(cfg, n=5, seed=1, max_new=6, lens=(3, 4, 5), cls=Request):
    rng = np.random.default_rng(seed)
    return [
        cls(rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                size=lens[i % len(lens)]).astype(np.int32),
            max_new_tokens=max_new)
        for i in range(n)
    ]


def _tokens(completions):
    return {c.rid: c.tokens for c in completions}


def _engine(params, cfg, **kw):
    return ServeEngine(params, cfg, device=CPU, **kw)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_streams_equal_jax_engine(arch):
    jcfg = jregistry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params(jax.tree.map(np.asarray, jp), cfg, CPU)
    # 6 requests over 2 slots, prompts of 2 to 9 tokens, 12 new tokens: up
    # to 21 positions, past gemma3-smoke's window of 16.
    kw = dict(n=6, seed=4, max_new=12, lens=(2, 9, 5))
    want = JServeEngine(jp, jcfg, slots=2, cache_len=32).run(
        _requests(cfg, cls=JRequest, **kw))
    got = _engine(params, cfg, slots=2, cache_len=32).run(
        _requests(cfg, **kw))
    assert _tokens(got) == _tokens(want)
    assert sorted(_tokens(got)) == list(range(6))
    assert all(len(toks) == 12 for toks in _tokens(got).values())


class TestDeterminism:
    def test_greedy_decode_deterministic_across_fresh_engines(self, setup):
        cfg, params = setup
        out_a = _engine(params, cfg, slots=2, cache_len=32).run(
            _requests(cfg))
        out_b = _engine(params, cfg, slots=2, cache_len=32).run(
            _requests(cfg))
        assert _tokens(out_a) == _tokens(out_b)
        assert all(len(t) == 6 for t in _tokens(out_a).values())


class TestLaneHygiene:
    def test_reset_lane_zeroes_exactly_that_lane(self, setup):
        cfg, params = setup
        eng = _engine(params, cfg, slots=2, cache_len=16)
        eng.run(_requests(cfg, n=2, max_new=4))
        dirty = interop.decode_state_to_numpy(eng.state)
        eng._reset_lane(0)
        after = interop.decode_state_to_numpy(eng.state)
        for name in dirty:
            for before, now in zip(dirty[name], after[name]):
                assert before[:, 0].any()
                assert not now[:, 0].any()
                np.testing.assert_array_equal(now[:, 1], before[:, 1])
        assert eng.pos[0] == 0

    def test_recycled_lane_matches_fresh_engine(self, setup):
        """slots=1 forces B through A's lane; B's tokens must equal B run
        on a never-used engine."""
        cfg, params = setup
        req_a, req_b = _requests(cfg, n=2, max_new=5)
        shared = _engine(params, cfg, slots=1, cache_len=32)
        out_shared = _tokens(shared.run([req_a, req_b]))
        req_a2, req_b2 = _requests(cfg, n=2, max_new=5)
        fresh = _engine(params, cfg, slots=1, cache_len=32)
        out_fresh = _tokens(fresh.run([req_b2]))
        assert out_shared[req_b.rid] == out_fresh[req_b2.rid]
        assert out_shared[req_a.rid] == _tokens(
            _engine(params, cfg, slots=1, cache_len=32).run([req_a2])
        )[req_a2.rid]

    def test_lane_reset_runs_once_per_admission_under_churn(self, setup):
        """Churny admit/complete traffic across both lanes: each admission
        resets its lane once, in place (the reference pins one compiled
        reset program; the port has no trace, so it pins the resets)."""
        cfg, params = setup
        eng = _engine(params, cfg, slots=2, cache_len=16)
        before = [id(t) for cycle in eng.state for c in cycle.values()
                  for t in c]
        eng._reset_lane(1)
        assert [id(t) for cycle in eng.state for c in cycle.values()
                for t in c] == before
        eng.run(_requests(cfg, n=7, max_new=2, lens=(2, 3)))
        assert eng.steps > 0
        assert eng.resets == 1 + 7


class TestBoundsAndValidation:
    def test_max_steps_bounds_the_loop(self, setup):
        cfg, params = setup
        eng = _engine(params, cfg, slots=1, cache_len=64)
        done = eng.run(_requests(cfg, n=1, max_new=50), max_steps=3)
        assert eng.steps == 3
        assert done == []  # request still in flight when the budget hit

    def test_empty_prompt_rejected_at_submit(self, setup):
        cfg, params = setup
        eng = _engine(params, cfg, slots=1, cache_len=16)
        bad = Request(rid=7, prompt=np.zeros((0,), np.int32))
        with pytest.raises(ValueError, match="empty prompt"):
            eng.run([bad])
        assert eng.steps == 0 and all(l.req is None for l in eng.lanes)

    def test_cache_end_finishes_a_request(self, setup):
        # A lane stops at cache_len - 1 positions, as the reference's does.
        cfg, params = setup
        eng = _engine(params, cfg, slots=1, cache_len=8)
        (done,) = eng.run(_requests(cfg, n=1, max_new=50, lens=(3,)))
        assert len(done.tokens) == 8 - 3

    def test_params_on_another_device_are_refused(self, setup):
        cfg, params = setup
        meta = dict(params, embed=params["embed"].to("meta"))
        with pytest.raises(ValueError, match="params live on"):
            ServeEngine(meta, cfg, slots=1, cache_len=8, device=CPU)


class TestSampling:
    def test_temperature_draws_from_the_seeded_generator(self, setup):
        cfg, params = setup

        def run(seed):
            reqs = _requests(cfg, n=3, max_new=5)
            for r in reqs:
                r.temperature = 1.0
            return _tokens(_engine(params, cfg, slots=2, cache_len=32,
                                   seed=seed).run(reqs))

        assert run(3) == run(3)
        assert run(3) != run(4)


class TestTapNeutrality:
    def test_tapped_token_streams_match_untapped(self, setup):
        cfg, params = setup
        out_plain = _engine(params, cfg, slots=2, cache_len=32).run(
            _requests(cfg))
        seen = []
        tap = TapConfig(model="qwen2-7b", target="entropy")
        eng = _engine(params, cfg, slots=2, cache_len=32, taps=tap,
                      tap_sink=seen.append)
        out_tapped = eng.run(_requests(cfg))
        assert _tokens(out_plain) == _tokens(out_tapped)
        # The sink saw every step, shaped (num_cycles, slots, d_model).
        assert len(seen) == eng.steps
        assert seen[0].feats.shape == (cfg.num_cycles, 2, cfg.d_model)
        assert seen[0].targets.shape == (2,)
        assert np.isfinite(seen[0].feats).all()
        # Idle lanes are masked: the last steps run one request alone.
        assert seen[-1].mask.sum() == 1


def test_launcher_serves_the_smoke_config():
    line = serve_launch.main(["--device", "cpu", "--requests", "3",
                              "--slots", "2", "--max-new", "4"])
    assert line.startswith("served 3 requests, 12 tokens in ")
