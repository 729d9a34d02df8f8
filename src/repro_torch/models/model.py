"""Model assembly for the dense family: sequence forward (with remat for
training), the training loss, prefill, decode and activation taps (port of
``repro.models.model``).

Parameters are a tree of dicts, laid out as the reference's except that the
per-cycle blocks are a list (one dict per cycle, ``blocks[c]["pos{i}"]``)
instead of arrays stacked on a leading ``num_cycles`` axis: the layer loop
indexes nothing per step. ``interop.lm_params`` unstacks the reference's
tree once. Decode state is the same kind of list: ``state[c]["pos{i}"]`` is
that block's :class:`~.attention.KVCache`.

Public entry points:
  * ``init_params(gen, cfg, device)``
  * ``forward(params, cfg, batch, remat=False)`` -> (final hidden states, aux)
  * ``train_loss(params, cfg, batch)``         -> scalar
  * ``init_decode_state(cfg, batch, cache_len, device)``
  * ``prefill(params, cfg, batch, cache_len)`` -> (state, logits_last)
  * ``decode_step(params, cfg, state, inputs, pos, tap_layers=None)``
  * ``forward_taps(params, cfg, batch, tap_layers)`` -> (hidden, taps)

``batch`` is a dict with ``tokens (B, S)`` (and, for the loss, ``labels
(B, S)`` and an optional ``loss_mask``). Only the block kinds ``attn``
and ``local_attn`` without experts are ported; building any other model
raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.device import DeviceLike, generator as make_generator
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = Dict[str, Any]

_PORTED_KINDS = ("attn", "local_attn")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port cannot build yet."""
    kinds = sorted(set(cfg.cycle) - set(_PORTED_KINDS))
    missing = []
    if kinds:
        missing.append(f"block kinds {kinds}")
    if cfg.is_moe:
        missing.append(f"{cfg.num_experts} experts")
    if cfg.embeddings_provided:
        missing.append("frontend embeddings")
    if missing:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(missing)}: the port serves the "
            f"dense attention family only; ROADMAP Queue 1 item 12c "
            f"(models/moe.py, models/ssm.py, cross_attn and embeds inputs) "
            f"ports the rest")


def _window(kind: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.local_window if kind == "local_attn" else cfg.sliding_window


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    pdt = layers.dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    p: Params = {
        "pre_norm": torch.zeros((d,), dtype=pdt, device=dev),
        "attn": attention.init_attention(
            gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.qkv_bias, cfg.qk_norm, pdt),
    }
    if cfg.d_ff:
        p["ffn_norm"] = torch.zeros((d,), dtype=pdt, device=dev)
        p["mlp"] = {
            "gate": layers.normal((d, cfg.d_ff), d ** -0.5, pdt, gen),
            "up": layers.normal((d, cfg.d_ff), d ** -0.5, pdt, gen),
            "down": layers.normal((cfg.d_ff, d), cfg.d_ff ** -0.5, pdt, gen),
        }
    return p


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    """Random-init parameters, each tensor drawn in f32 from ``gen`` on the
    device and cast to ``cfg.param_dtype`` at once (``gen=None``: seed 0).
    ``device=None`` is the card, raising without one."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = gen if gen is not None else make_generator(0, dev)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    pdt = layers.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    params: Params = {
        "embed": layers.normal((cfg.vocab_size, d), d ** -0.5, pdt, gen),
        "final_norm": torch.zeros((d,), dtype=pdt, device=dev),
        "blocks": [{f"pos{i}": _init_block(gen, cfg)
                    for i in range(len(cfg.cycle))}
                   for _ in range(cfg.num_cycles)],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.normal((d, cfg.vocab_size), d ** -0.5,
                                          pdt, gen)
    return params


def unembed_table(params: Params, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # a view: the product reads it transposed
    return params["unembed"]


def param_count(params: Params) -> int:
    """Elements in a parameter tree (``cfg.param_count()`` when it matches)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_count(p) for p in items)


# ---------------------------------------------------------------------------
# Sequence mode (prefill / offline taps)
# ---------------------------------------------------------------------------


def _apply_ffn(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Post-attention FFN sublayer."""
    if "ffn_norm" not in p:
        return x
    h = layers.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    out = layers.mlp(p["mlp"], h, layers.dtype_of(cfg.compute_dtype))
    return x + out.to(x.dtype)


def _apply_block_seq(kind: str, p: Params, x: Tensor, positions: Tensor,
                     cfg: ModelConfig) -> Tensor:
    cdt = layers.dtype_of(cfg.compute_dtype)
    h = layers.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out = attention.apply_attention(
        p["attn"], h, positions, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, window=_window(kind, cfg),
        chunk=cfg.attn_chunk, compute_dtype=cdt)
    return _apply_ffn(p, x + out.to(x.dtype), cfg)


def _embed_batch(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]
                 ) -> Tuple[Tensor, Tensor]:
    """The batch's token embeddings and their ``(B, S)`` positions."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"].to(params["embed"].device)
    x = layers.embed(params["embed"], tokens, cdt)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    return x, positions


def _cycle(x: Tensor, cycle: Params, positions: Tensor, cfg: ModelConfig
           ) -> Tensor:
    """One cycle of blocks over the residual stream."""
    for i, kind in enumerate(cfg.cycle):
        x = _apply_block_seq(kind, cycle[f"pos{i}"], x, positions, cfg)
    return x


def _cycles_seq(params: Params, cfg: ModelConfig, x: Tensor,
                positions: Tensor) -> List[Tensor]:
    """The residual stream after each cycle (the last is the output)."""
    resid = []
    for cycle in params["blocks"]:
        x = _cycle(x, cycle, positions, cfg)
        resid.append(x)
    return resid


# ---------------------------------------------------------------------------
# Remat: the reference's jax.checkpoint around the cycles
# ---------------------------------------------------------------------------

_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of products
    without batch dims (the weight products, ``mm`` and ``addmm``) and
    recompute the rest, attention's batched ``bmm`` included."""
    if op in _SAVED_BY_DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under the reference's ``_remat_policy(policy)``: ``"nothing"``
    saves only ``fn``'s inputs and recomputes the rest in the backward,
    ``"dots"`` also saves the weight products, anything else saves
    everything (no checkpoint). ``fn`` takes its tensors as arguments, so
    the checkpoint sees every input whose gradient it must return; there is
    no RNG in the forward, so no RNG state is stashed."""
    if policy == "nothing":
        return functools.partial(torch_checkpoint.checkpoint, fn,
                                 use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        return functools.partial(
            torch_checkpoint.checkpoint, fn, use_reentrant=False,
            preserve_rng_state=False, context_fn=functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _dots_policy))
    return fn


def _group(x: Tensor, group: List[Params], positions: Tensor,
           cfg: ModelConfig) -> Tensor:
    """Consecutive cycles, each under its own remat (the inner level of
    ``remat_group``)."""
    body = _remat(_cycle, cfg.remat_policy)
    for cycle in group:
        x = body(x, cycle, positions, cfg)
    return x


def _cycles_remat(params: Params, cfg: ModelConfig, x: Tensor,
                  positions: Tensor) -> Tensor:
    """The cycles as the reference's training forward runs them: each under
    remat, and with ``remat_group`` (when it divides the cycle count) in
    groups of that many cycles under a second remat, so that only the
    group boundaries' residuals stay live between the forward and the
    backward."""
    blocks = params["blocks"]
    size = cfg.remat_group
    if size and size > 1 and cfg.num_cycles % size == 0:
        outer = _remat(_group, cfg.remat_policy)
        for start in range(0, len(blocks), size):
            x = outer(x, blocks[start:start + size], positions, cfg)
        return x
    return _group(x, blocks, positions, cfg)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
            remat: bool = False) -> Tuple[Tensor, Tensor]:
    """Full-sequence forward. Returns ``(hidden (B, S, d), aux)``; ``aux``
    is the reference's auxiliary loss, 0 for the dense family.

    ``remat=True`` is the training forward (:func:`train_loss`): the cycles
    run under ``cfg.remat_policy`` and ``cfg.remat_group`` as the
    reference's ``forward`` always runs them. The default, without remat,
    is the serving path; both give the same values."""
    x, positions = _embed_batch(params, cfg, batch)
    if remat:
        x = _cycles_remat(params, cfg, x, positions)
    else:
        x = _cycles_seq(params, cfg, x, positions)[-1]
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
               aux_weight: float = 0.01) -> Tensor:
    """The chunked next-token cross-entropy of the remat forward plus
    ``aux_weight`` times its auxiliary loss (0 for the dense family). With
    tied embeddings the gradient reaches ``embed`` through both uses."""
    hidden, aux = forward(params, cfg, batch, remat=True)
    mask = batch.get("loss_mask")
    loss = layers.chunked_softmax_xent(
        hidden, unembed_table(params, cfg), batch["labels"].to(hidden.device),
        None if mask is None else mask.to(hidden.device),
        chunk=cfg.xent_chunk)
    return loss + aux_weight * aux


def _check_tap_layers(tap_layers, cfg: ModelConfig) -> Tuple[int, ...]:
    taps = tuple(int(t) for t in tap_layers)
    if not taps:
        raise ValueError("tap_layers must name at least one cycle")
    bad = [t for t in taps if not 0 <= t < cfg.num_cycles]
    if bad:
        raise ValueError(
            f"tap_layers {bad} out of range [0, {cfg.num_cycles}) for "
            f"{cfg.name}"
        )
    return taps


def forward_taps(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
                 tap_layers) -> Tuple[Tensor, Tensor]:
    """Sequence-mode tap extraction: ``(hidden (B, S, d), taps (num_taps, B,
    S, d) float32)``, ``taps[j]`` the residual stream after cycle
    ``tap_layers[j]`` (the full-sequence twin of the tapped
    :func:`decode_step`)."""
    tap_layers = _check_tap_layers(tap_layers, cfg)
    x, positions = _embed_batch(params, cfg, batch)
    resid = _cycles_seq(params, cfg, x, positions)
    hidden = layers.rms_norm(resid[-1], params["final_norm"], cfg.norm_eps)
    taps = torch.stack([resid[j] for j in tap_layers]).to(torch.float32)
    return hidden, taps


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _cache_len(kind: str, cfg: ModelConfig, cache_len: int) -> int:
    window = _window(kind, cfg)
    return cache_len if window is None else min(cache_len, window)


def init_decode_state(cfg: ModelConfig, b: int, cache_len: int,
                      device: DeviceLike = None) -> List[Dict[str, Any]]:
    """Zeroed caches: ``state[c]["pos{i}"]`` is a ``(B, KH, T, D)``
    :class:`~.attention.KVCache` in the compute dtype (``T`` capped at the
    block's window)."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = layers.dtype_of(cfg.compute_dtype)

    def cache(kind):
        shape = (b, cfg.num_kv_heads, _cache_len(kind, cfg, cache_len),
                 cfg.head_dim)
        return attention.KVCache(
            k=torch.zeros(shape, dtype=cdt, device=dev),
            v=torch.zeros(shape, dtype=cdt, device=dev))

    return [{f"pos{i}": cache(kind) for i, kind in enumerate(cfg.cycle)}
            for _ in range(cfg.num_cycles)]


def _apply_block_decode(kind: str, p: Params, state: attention.KVCache,
                        x: Tensor, pos: Tensor, cfg: ModelConfig
                        ) -> Tuple[Tensor, attention.KVCache]:
    cdt = layers.dtype_of(cfg.compute_dtype)
    h = layers.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out, state = attention.decode_attention(
        p["attn"], h, state, pos, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, window=_window(kind, cfg),
        compute_dtype=cdt)
    return _apply_ffn(p, x + out.to(x.dtype), cfg), state


def decode_step(params: Params, cfg: ModelConfig, state, inputs:
                Dict[str, Tensor], pos, tap_layers=None):
    """One-token decode. ``inputs["tokens"]`` is ``(B,)``; ``pos`` is ``(B,)``
    per lane or a scalar. Returns ``(logits (B, vocab), new state)``.

    ``tap_layers`` (cycle indices) adds a third element, ``taps (num_taps,
    B, 1, d) float32``: the residual stream after each named cycle, before
    the final norm. Taps copy values the untapped step computes anyway, so
    logits and state are bit-identical with and without them.
    """
    cdt = layers.dtype_of(cfg.compute_dtype)
    tokens = inputs["tokens"].to(params["embed"].device)
    x = layers.embed(params["embed"], tokens[:, None], cdt)
    pos = torch.as_tensor(pos, device=x.device)
    taps = None if tap_layers is None else _check_tap_layers(tap_layers, cfg)
    new_state, resid = [], []
    for cycle, cycle_state in zip(params["blocks"], state):
        ns = {}
        for i, kind in enumerate(cfg.cycle):
            x, ns[f"pos{i}"] = _apply_block_decode(
                kind, cycle[f"pos{i}"], cycle_state[f"pos{i}"], x, pos, cfg)
        new_state.append(ns)
        resid.append(x)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(unembed_table(params, cfg), x[:, 0, :], cdt)
    if taps is None:
        return logits, new_state
    return logits, new_state, torch.stack(
        [resid[j] for j in taps]).to(torch.float32)


# ---------------------------------------------------------------------------
# Prefill: the sequence forward that also fills the decode caches
# ---------------------------------------------------------------------------


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
            cache_len: int):
    """Process a prompt of S tokens; returns ``(decode state, last-token
    logits)``. The caches hold the prompt's K/V, laid out once in the decode
    layout ``(B, KH, T, D)``: a ring keeps the last ``T`` positions at slot
    ``position % T``."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    x, positions = _embed_batch(params, cfg, batch)
    b, s = x.shape[:2]

    def cache_from_kv(k: Tensor, v: Tensor, kind: str) -> attention.KVCache:
        window = _window(kind, cfg)
        t = _cache_len(kind, cfg, cache_len)
        shape = (b, cfg.num_kv_heads, t, cfg.head_dim)
        ck = torch.zeros(shape, dtype=cdt, device=x.device)
        cv = torch.zeros(shape, dtype=cdt, device=x.device)
        kt = k.transpose(1, 2).to(cdt)  # (B, KH, S, D)
        vt = v.transpose(1, 2).to(cdt)
        keep = min(s, t)
        if window is not None and t <= window:
            slots = torch.arange(s - keep, s, device=x.device) % t
            ck[:, :, slots] = kt[:, :, s - keep:]
            cv[:, :, slots] = vt[:, :, s - keep:]
        else:
            ck[:, :, :keep] = kt[:, :, :keep]
            cv[:, :, :keep] = vt[:, :, :keep]
        return attention.KVCache(k=ck, v=cv)

    states = []
    for cycle in params["blocks"]:
        st = {}
        for i, kind in enumerate(cfg.cycle):
            p = cycle[f"pos{i}"]
            h = layers.rms_norm(x, p["pre_norm"], cfg.norm_eps)
            q, k, v = attention._project_qkv(
                p["attn"], h, positions, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, cfg.rope_theta, cdt)
            out = attention.chunked_attention(
                q, k, v, chunk=cfg.attn_chunk, causal=True,
                window=_window(kind, cfg))
            out = out.reshape(b, s, -1) @ p["attn"]["wo"].to(cdt)
            x = _apply_ffn(p, x + out.to(x.dtype), cfg)
            st[f"pos{i}"] = cache_from_kv(k, v, kind)
        states.append(st)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(unembed_table(params, cfg), x[:, -1, :], cdt)
    return states, logits
