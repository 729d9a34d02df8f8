"""Model assembly: init, the sequence forward (with remat for training),
the training loss, prefill, decode and activation taps for every block kind
of the reference (port of ``repro.models.model``).

Parameters are a tree of dicts, laid out as the reference's except that the
per-cycle blocks are a list (one dict per cycle, ``blocks[c]["pos{i}"]``)
instead of arrays stacked on a leading ``num_cycles`` axis: the layer loop
indexes nothing per step. ``interop.lm_params`` unstacks the reference's
tree once. A ``shared_attn`` position holds ``{}``: its attention and MLP
live once in ``params["shared"]`` and every invocation applies them. Decode
state is the same kind of list: ``state[c]["pos{i}"]`` is that block's
:class:`~.attention.KVCache` (attention kinds; a ``cross_attn`` cache holds
the frontend states' projected keys and values),
:class:`~.ssm.RecurrentState` (``mlstm``) or :class:`~.ssm.MambaState`
(``mamba``); an ``moe`` position holds ``None``.

A config with a ``layer_pattern`` (NemotronH) is one cycle of all its
layers: ``blocks[0]["pos{i}"]`` is layer ``i``, and taps name layers.

Public entry points:
  * ``init_params(gen, cfg, device)``
  * ``forward(params, cfg, batch, remat=False)`` -> (final hidden states, aux)
  * ``train_loss(params, cfg, batch)``         -> scalar
  * ``init_decode_state(cfg, batch, cache_len, device)``
  * ``prefill(params, cfg, batch, cache_len)`` -> (state, logits_last)
  * ``decode_step(params, cfg, state, inputs, pos, tap_layers=None)``
  * ``forward_taps(params, cfg, batch, tap_layers)`` -> (hidden, taps)
  * ``apply_cycles(cycles, cfg, x)``           -> x (a pipeline stage)

``cfg.sequence_parallel`` runs every mLSTM recurrence of the sequence
paths (``forward``, ``forward_taps``, ``train_loss``, ``prefill``) over the
``model`` axis of the ambient mesh (``sharding.mesh.set_mesh``;
``ssm.glr_shardmapped``), raising without one; decode and Mamba2 stay as
they are, as in the reference. ``sharding.constraints.hint`` marks the
residual stream where the reference pins its layout.

``batch`` is a dict with ``tokens (B, S)`` or ``embeds (B, S, d)`` (the
stub frontends' frame or patch embeddings), ``cross_states (B, T, d)`` for
the cross-attention blocks, and, for the loss, ``labels (B, S)`` and an
optional ``loss_mask``. ``aux`` is the sum over MoE layers of the Switch
load-balancing loss (0 without experts).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.device import DeviceLike, generator as make_generator
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import mesh as mesh_lib
from repro_torch.sharding.constraints import hint

Tensor = torch.Tensor
Params = Dict[str, Any]

_ATTN_KINDS = ("attn", "local_attn", "cross_attn", "shared_attn",
               "attn_only")
_SELF_ATTN_KINDS = ("attn", "local_attn", "shared_attn", "attn_only")


def _window(kind: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.local_window if kind == "local_attn" else cfg.sliding_window


def _zeros(n: int, dtype: torch.dtype, dev: torch.device) -> Tensor:
    return torch.zeros((n,), dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _mlp_params(gen: torch.Generator, d: int, d_ff: int,
                dtype: torch.dtype) -> Params:
    return {
        "gate": layers.normal((d, d_ff), d ** -0.5, dtype, gen),
        "up": layers.normal((d, d_ff), d ** -0.5, dtype, gen),
        "down": layers.normal((d_ff, d), d_ff ** -0.5, dtype, gen),
    }


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig) -> Params:
    pdt = layers.dtype_of(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    if kind == "shared_attn":
        return {}  # the parameters live in params["shared"]
    p: Params = {"pre_norm": _zeros(d, pdt, dev)}
    if kind in _ATTN_KINDS:
        p["attn"] = attention.init_attention(
            gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.qkv_bias, cfg.qk_norm, pdt)
        if kind == "attn_only":
            return p  # no FFN after it
        if cfg.is_moe:
            p["ffn_norm"] = _zeros(d, pdt, dev)
            p["moe"] = moe.init_moe(gen, d, cfg.d_ff, cfg.num_experts, pdt)
        elif cfg.d_ff:
            p["ffn_norm"] = _zeros(d, pdt, dev)
            p["mlp"] = _mlp_params(gen, d, cfg.d_ff, pdt)
    elif kind == "mlstm":
        p["mlstm"] = ssm.init_mlstm(gen, d, cfg.ssm_expand, cfg.ssm_heads,
                                    pdt)
    elif kind == "mamba":
        p["mamba"] = ssm.init_mamba2(gen, d, cfg.ssm_expand,
                                     cfg.ssm_state_dim, cfg.ssm_heads,
                                     cfg.ssm_conv_width, pdt,
                                     d_inner=cfg.ssm_inner,
                                     groups=cfg.ssm_groups)
    elif kind == "moe":
        p["moe"] = moe.init_dropless(gen, d, cfg.d_ff, cfg.num_experts,
                                     cfg.moe_shared_d_ff, pdt)
    else:
        raise ValueError(kind)
    return p


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    """Random-init parameters, each tensor drawn in f32 from ``gen`` on the
    device and cast to ``cfg.param_dtype`` at once (``gen=None``: seed 0).
    ``device=None`` is the card, raising without one."""
    dev = resolve_device(device)
    gen = gen if gen is not None else make_generator(0, dev)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    pdt = layers.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    params: Params = {
        "embed": layers.normal((cfg.vocab_size, d), d ** -0.5, pdt, gen),
        "final_norm": _zeros(d, pdt, dev),
        "blocks": [{f"pos{i}": _init_block(gen, kind, cfg)
                    for i, kind in enumerate(cfg.cycle)}
                   for _ in range(cfg.num_cycles)],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.normal((d, cfg.vocab_size), d ** -0.5,
                                          pdt, gen)
    if "shared_attn" in cfg.cycle:
        params["shared"] = {
            "pre_norm": _zeros(d, pdt, dev),
            "attn": attention.init_attention(
                gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                cfg.qkv_bias, cfg.qk_norm, pdt),
            "ffn_norm": _zeros(d, pdt, dev),
            "mlp": _mlp_params(gen, d, cfg.d_ff, pdt),
        }
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
# Sequence mode (training forward / offline taps)
# ---------------------------------------------------------------------------


def _apply_ffn(p: Params, x: Tensor, cfg: ModelConfig
               ) -> Tuple[Tensor, Optional[Tensor]]:
    """The post-mixer FFN or MoE sublayer. Returns ``(x, aux)``, ``aux``
    the MoE's load-balancing loss or ``None``."""
    if "ffn_norm" not in p:
        return x, None
    cdt = layers.dtype_of(cfg.compute_dtype)
    h = layers.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    aux = None
    if cfg.is_moe and "moe" in p:
        out, aux = moe.moe_ffn(
            p["moe"], h, experts_per_token=cfg.experts_per_token,
            capacity_factor=cfg.moe_capacity_factor, compute_dtype=cdt)
    else:
        out = layers.mlp(p["mlp"], h, cdt)
    return hint(x + out.to(x.dtype), "residual"), aux


def _mamba_kw(cfg: ModelConfig) -> Dict[str, Any]:
    """Mamba2's group options: the B/C groups and, with the gate-then-group
    norm, its eps."""
    return dict(groups=cfg.ssm_groups,
                group_norm_eps=cfg.norm_eps if cfg.ssm_group_norm else None)


def _moe_mixer(p: Params, h: Tensor, cfg: ModelConfig, layer: int
               ) -> Tensor:
    """An ``moe`` block's mixer: the dropless layer; ``layer`` is its
    position in the cycle (a pattern config's layer), its row of the
    tracer's tally."""
    return moe.dropless_moe(
        p["moe"], h, experts_per_token=cfg.experts_per_token,
        routed_scale=cfg.moe_routed_scale,
        compute_dtype=layers.dtype_of(cfg.compute_dtype), layer=layer,
        num_layers=len(cfg.cycle))


def _mixer_seq(kind: str, p: Params, h: Tensor, positions: Tensor,
               cross: Optional[Tensor], cfg: ModelConfig,
               layer: int = 0) -> Tensor:
    cdt = layers.dtype_of(cfg.compute_dtype)
    common = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  head_dim=cfg.head_dim, chunk=cfg.attn_chunk,
                  compute_dtype=cdt)
    if kind in _SELF_ATTN_KINDS:
        return attention.apply_attention(
            p["attn"], h, positions, rope_theta=cfg.rope_theta,
            window=_window(kind, cfg), **common)
    if kind == "cross_attn":
        if cross is None:
            raise ValueError(f"{cfg.name} has cross-attention blocks: the "
                             f"batch needs cross_states")
        return attention.cross_attention(p["attn"], h, cross, **common)
    if kind == "mlstm":
        return ssm.mlstm_block(p["mlstm"], h, cfg.ssm_heads, cfg.attn_chunk,
                               cdt, seq_axis=("model" if cfg.sequence_parallel
                                              else None))
    if kind == "mamba":
        return ssm.mamba2_block(p["mamba"], h, cfg.ssm_heads,
                                cfg.ssm_state_dim, cfg.ssm_chunk_len, cdt,
                                **_mamba_kw(cfg))
    if kind == "moe":
        return _moe_mixer(p, h, cfg, layer)
    raise ValueError(kind)


def _apply_block_seq(kind: str, p: Params, shared: Optional[Params],
                     x: Tensor, positions: Tensor, cross: Optional[Tensor],
                     cfg: ModelConfig, layer: int = 0
                     ) -> Tuple[Tensor, Optional[Tensor]]:
    """One block: pre-norm mixer and residual, then the FFN sublayer.
    Returns ``(x, aux or None)``; ``layer`` is the block's position in the
    cycle."""
    if kind == "shared_attn":
        p = shared
    h = layers.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out = _mixer_seq(kind, p, h, positions, cross, cfg, layer)
    return _apply_ffn(p, hint(x + out.to(x.dtype), "residual"), cfg)


def _embed_batch(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor]
                 ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """The batch's input embeddings (``embeds``, or the tokens' rows of the
    table), their ``(B, S)`` positions and the cross states, in the compute
    dtype on the parameters' device. Every sequence-mode entry point starts
    here."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    dev = params["embed"].device
    if "embeds" in batch:
        x = batch["embeds"].to(dev, cdt)
    else:
        x = layers.embed(params["embed"], batch["tokens"].to(dev), cdt)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
        b, s)
    cross = batch.get("cross_states")
    if cross is not None:
        cross = cross.to(dev, cdt)
    return x, positions, cross


def _cycle(x: Tensor, aux: Tensor, cycle: Params, shared: Optional[Params],
           positions: Tensor, cross: Optional[Tensor], cfg: ModelConfig,
           c: int = 0, keep: Tuple[int, ...] = (),
           kept: Optional[Dict[int, Tensor]] = None
           ) -> Tuple[Tensor, Tensor]:
    """Cycle ``c`` of blocks over the residual stream, adding each MoE
    layer's auxiliary loss to ``aux``; the residual at each tap point
    (``cfg.tap_point``) named in ``keep`` goes into ``kept``."""
    for i, kind in enumerate(cfg.cycle):
        x, a = _apply_block_seq(kind, cycle[f"pos{i}"], shared, x, positions,
                                cross, cfg, i)
        if a is not None:
            aux = aux + a
        if keep and cfg.tap_point(c, i) in keep:
            kept[cfg.tap_point(c, i)] = x
    return x, aux


def _cycles_seq(params: Params, cfg: ModelConfig, x: Tensor,
                positions: Tensor, cross: Optional[Tensor],
                keep: Tuple[int, ...] = ()
                ) -> Tuple[Tensor, Dict[int, Tensor], Tensor]:
    """The residual stream's output, the residuals at the tap points named
    in ``keep`` (and no others), and the summed auxiliary loss."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kept: Dict[int, Tensor] = {}
    for c, cycle in enumerate(params["blocks"]):
        x, aux = _cycle(x, aux, cycle, params.get("shared"), positions,
                        cross, cfg, c, keep, kept)
    return x, kept, aux


def apply_cycles(cycles: List[Params], cfg: ModelConfig, x: Tensor,
                 shared: Optional[Params] = None,
                 cross_states: Optional[Tensor] = None) -> Tensor:
    """The residual stream ``x (B, S, d)`` (compute dtype) through
    ``cycles``, a run of ``params["blocks"]``: a pipeline stage's function
    (``sharding.pipeline``), with the embedding, the final norm and the
    unembedding left to the caller; the MoE auxiliary loss is dropped."""
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[
        None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for cycle in cycles:
        x, aux = _cycle(x, aux, cycle, shared, positions, cross_states, cfg)
    return x


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


def _under_mesh(fn):
    """``fn`` run under the ambient mesh of the moment it is wrapped. A
    checkpointed forward is recomputed in the backward on autograd's own
    thread (on the card, one a device), where the caller's ambient mesh is
    not set; the sequence-parallel recurrence reads it there."""
    mesh = mesh_lib.get_mesh()

    def run(*args):
        with mesh_lib.set_mesh(mesh):
            return fn(*args)

    return run


def _remat(fn, policy: str):
    """``fn`` under the reference's ``_remat_policy(policy)``: ``"nothing"``
    saves only ``fn``'s inputs and recomputes the rest in the backward,
    ``"dots"`` also saves the weight products, anything else saves
    everything (no checkpoint). ``fn`` takes its tensors as arguments, so
    the checkpoint sees every input whose gradient it must return; there is
    no RNG in the forward, so no RNG state is stashed. The recompute runs
    under the forward's ambient mesh (:func:`_under_mesh`)."""
    if policy in ("nothing", "dots"):
        fn = _under_mesh(fn)
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


def _group(x: Tensor, aux: Tensor, group: List[Params],
           shared: Optional[Params], positions: Tensor,
           cross: Optional[Tensor], cfg: ModelConfig
           ) -> Tuple[Tensor, Tensor]:
    """Consecutive cycles, each under its own remat (the inner level of
    ``remat_group``)."""
    body = _remat(_cycle, cfg.remat_policy)
    for cycle in group:
        x, aux = body(x, aux, cycle, shared, positions, cross, cfg)
    return x, aux


def _cycles_remat(params: Params, cfg: ModelConfig, x: Tensor,
                  positions: Tensor, cross: Optional[Tensor]
                  ) -> Tuple[Tensor, Tensor]:
    """The cycles as the reference's training forward runs them: each under
    remat, and with ``remat_group`` (when it divides the cycle count) in
    groups of that many cycles under a second remat, so that only the
    group boundaries' residuals stay live between the forward and the
    backward. Returns the output and the summed auxiliary loss."""
    blocks = params["blocks"]
    shared = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    size = cfg.remat_group
    if size and size > 1 and cfg.num_cycles % size == 0:
        outer = _remat(_group, cfg.remat_policy)
        for start in range(0, len(blocks), size):
            x, aux = outer(x, aux, blocks[start:start + size], shared,
                           positions, cross, cfg)
        return x, aux
    return _group(x, aux, blocks, shared, positions, cross, cfg)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
            remat: bool = False) -> Tuple[Tensor, Tensor]:
    """Full-sequence forward. Returns ``(hidden (B, S, d), aux)``, ``aux``
    the MoE layers' summed load-balancing loss (0 without experts).

    ``remat=True`` is the training forward (:func:`train_loss`): the cycles
    run under ``cfg.remat_policy`` and ``cfg.remat_group`` as the
    reference's ``forward`` always runs them. The default, without remat,
    is the serving path; both give the same values."""
    x, positions, cross = _embed_batch(params, cfg, batch)
    x = hint(x, "residual")
    if remat:
        x, aux = _cycles_remat(params, cfg, x, positions, cross)
    else:
        x, _, aux = _cycles_seq(params, cfg, x, positions, cross)
    return layers.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def train_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
               aux_weight: float = 0.01) -> Tensor:
    """The chunked next-token cross-entropy of the remat forward plus
    ``aux_weight`` times its auxiliary loss. With tied embeddings the
    gradient reaches ``embed`` through both uses. A config with ``moe``
    blocks raises: their grouped expert products have no backward in the
    port."""
    if "moe" in cfg.cycle:
        raise NotImplementedError(
            f"{cfg.name}: training is not supported: the dropless MoE's "
            f"grouped expert products (torch._grouped_mm in "
            f"moe.dropless_moe) have no backward in the port")
    hidden, aux = forward(params, cfg, batch, remat=True)
    mask = batch.get("loss_mask")
    loss = layers.chunked_softmax_xent(
        hidden, unembed_table(params, cfg), batch["labels"].to(hidden.device),
        None if mask is None else mask.to(hidden.device),
        chunk=cfg.xent_chunk)
    return loss + aux_weight * aux


def _check_tap_layers(tap_layers, cfg: ModelConfig) -> Tuple[int, ...]:
    """Tap indices: cycles, or a pattern config's layers
    (``cfg.tap_points``)."""
    taps = tuple(int(t) for t in tap_layers)
    if not taps:
        raise ValueError("tap_layers must name at least one cycle")
    bad = [t for t in taps if not 0 <= t < cfg.tap_points]
    if bad:
        raise ValueError(
            f"tap_layers {bad} out of range [0, {cfg.tap_points}) for "
            f"{cfg.name}"
        )
    return taps


def forward_taps(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
                 tap_layers) -> Tuple[Tensor, Tensor]:
    """Sequence-mode tap extraction: ``(hidden (B, S, d), taps (num_taps, B,
    S, d) float32)``, ``taps[j]`` the residual stream after cycle
    ``tap_layers[j]`` (a pattern config's layer; the full-sequence twin of
    the tapped :func:`decode_step`). Only the tapped residuals are kept."""
    tap_layers = _check_tap_layers(tap_layers, cfg)
    x, positions, cross = _embed_batch(params, cfg, batch)
    x = hint(x, "residual")
    final, kept, _ = _cycles_seq(params, cfg, x, positions, cross,
                                 tap_layers)
    hidden = layers.rms_norm(final, params["final_norm"], cfg.norm_eps)
    taps = torch.stack([kept[j] for j in tap_layers]).to(torch.float32)
    return hidden, taps


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _cache_len(kind: str, cfg: ModelConfig, cache_len: int) -> int:
    window = _window(kind, cfg)
    return cache_len if window is None else min(cache_len, window)


def _block_state(kind: str, cfg: ModelConfig, b: int, cache_len: int,
                 dev: torch.device):
    """A zeroed decode state of one block: a KV cache in the compute dtype
    (``T`` capped at the block's window; the cross caches hold
    ``cfg.cross_attn_tokens``), or the recurrences' f32 states."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    if kind in _ATTN_KINDS:
        t = (cfg.cross_attn_tokens if kind == "cross_attn"
             else _cache_len(kind, cfg, cache_len))
        shape = (b, cfg.num_kv_heads, t, cfg.head_dim)
        return attention.KVCache(
            k=torch.zeros(shape, dtype=cdt, device=dev),
            v=torch.zeros(shape, dtype=cdt, device=dev))
    if kind == "mlstm":
        return ssm.mlstm_state_shape(b, cfg.d_model, cfg.ssm_expand,
                                     cfg.ssm_heads, dev)
    if kind == "mamba":
        return ssm.mamba_state_shape(b, cfg.d_model, cfg.ssm_expand,
                                     cfg.ssm_state_dim, cfg.ssm_heads,
                                     cfg.ssm_conv_width, dev,
                                     d_inner=cfg.ssm_inner,
                                     groups=cfg.ssm_groups)
    if kind == "moe":
        return None
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, b: int, cache_len: int,
                      device: DeviceLike = None) -> List[Dict[str, Any]]:
    """Zeroed decode states, ``state[c]["pos{i}"]`` per block."""
    dev = resolve_device(device)
    return [{f"pos{i}": _block_state(kind, cfg, b, cache_len, dev)
             for i, kind in enumerate(cfg.cycle)}
            for _ in range(cfg.num_cycles)]


def _cross_decode(p: Params, h: Tensor, cache: attention.KVCache,
                  cfg: ModelConfig) -> Tensor:
    """One token's cross-attention against the cached frontend K/V. As the
    reference's, it applies no ``q_norm`` (the cache holds keys without
    ``k_norm``, as ``prefill`` lays them)."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    b = h.shape[0]
    g = cfg.num_heads // cfg.num_kv_heads
    q = (h.to(cdt) @ p["wq"].to(cdt)).reshape(b, 1, cfg.num_kv_heads, g,
                                              cfg.head_dim)
    s_ = torch.einsum("bqhgd,bhtd->bhgqt", q, cache.k) * (
        cfg.head_dim ** -0.5)
    pr = torch.softmax(s_.to(torch.float32), dim=-1)
    o = torch.einsum("bhgqt,bhtd->bqhgd", pr.to(cdt), cache.v)
    return o.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ p["wo"].to(cdt)


def _apply_block_decode(kind: str, p: Params, shared: Optional[Params],
                        state, x: Tensor, pos: Tensor, cfg: ModelConfig,
                        layer: int = 0):
    cdt = layers.dtype_of(cfg.compute_dtype)
    if kind == "shared_attn":
        p = shared
    h = layers.rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if kind in _SELF_ATTN_KINDS:
        out, state = attention.decode_attention(
            p["attn"], h, state, pos, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=_window(kind, cfg),
            compute_dtype=cdt)
    elif kind == "cross_attn":
        out = _cross_decode(p["attn"], h, state, cfg)
    elif kind == "mlstm":
        out, state = ssm.mlstm_decode(p["mlstm"], h, state, cfg.ssm_heads,
                                      cdt)
    elif kind == "mamba":
        out, state = ssm.mamba2_decode(p["mamba"], h, state, cfg.ssm_heads,
                                       cfg.ssm_state_dim, cdt,
                                       **_mamba_kw(cfg))
    elif kind == "moe":
        out = _moe_mixer(p, h, cfg, layer)
    else:
        raise ValueError(kind)
    x, _ = _apply_ffn(p, x + out.to(x.dtype), cfg)
    return x, state


def decode_step(params: Params, cfg: ModelConfig, state, inputs:
                Dict[str, Tensor], pos, tap_layers=None):
    """One-token decode. ``inputs`` is ``{"tokens": (B,)}`` or ``{"embeds":
    (B, 1, d)}``; ``pos`` is ``(B,)`` per lane or a scalar. Returns
    ``(logits (B, vocab), new state)``.

    ``tap_layers`` (cycle indices; a pattern config's layers) adds a third
    element, ``taps (num_taps, B, 1, d) float32``: the residual stream
    after each named cycle or layer, before the final norm. Taps copy
    values the untapped step computes anyway, so logits and state are
    bit-identical with and without them.
    """
    cdt = layers.dtype_of(cfg.compute_dtype)
    dev = params["embed"].device
    if "embeds" in inputs:
        x = inputs["embeds"].to(dev, cdt)
    else:
        x = layers.embed(params["embed"], inputs["tokens"].to(dev)[:, None],
                         cdt)
    pos = torch.as_tensor(pos, device=dev)
    shared = params.get("shared")
    taps = None if tap_layers is None else _check_tap_layers(tap_layers, cfg)
    new_state, kept = [], {}
    for c, (cycle, cycle_state) in enumerate(zip(params["blocks"], state)):
        ns = {}
        for i, kind in enumerate(cfg.cycle):
            x, ns[f"pos{i}"] = _apply_block_decode(
                kind, cycle[f"pos{i}"], shared, cycle_state[f"pos{i}"], x,
                pos, cfg, i)
            if taps and cfg.tap_point(c, i) in taps:
                kept[cfg.tap_point(c, i)] = x
        new_state.append(ns)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(unembed_table(params, cfg), x[:, 0, :], cdt)
    if taps is None:
        return logits, new_state
    return logits, new_state, torch.stack(
        [kept[j] for j in taps]).to(torch.float32)


# ---------------------------------------------------------------------------
# Prefill: the sequence forward that also fills the decode states
# ---------------------------------------------------------------------------


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Tensor],
            cache_len: int):
    """Process a prompt of S tokens; returns ``(decode state, last-token
    logits)``. The self-attention caches hold the prompt's K/V, laid out
    once in the decode layout ``(B, KH, T, D)``: a ring keeps the last ``T``
    positions at slot ``position % T``. A cross cache holds the projected
    frontend states (``cross_states.shape[1]`` tokens, without ``k_norm``,
    and the block's queries skip ``q_norm`` here, as the reference's
    prefill does); the recurrences' states are their final
    :class:`~.ssm.RecurrentState` / :class:`~.ssm.MambaState`."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    x, positions, cross = _embed_batch(params, cfg, batch)
    b, s = x.shape[:2]
    shared = params.get("shared")

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

    def heads(t: Tensor, n: int) -> Tensor:
        return t.reshape(b, t.shape[1], n, cfg.head_dim)

    states = []
    for cycle in params["blocks"]:
        st = {}
        for i, kind in enumerate(cfg.cycle):
            p = shared if kind == "shared_attn" else cycle[f"pos{i}"]
            h = layers.rms_norm(x, p["pre_norm"], cfg.norm_eps)
            if kind in _SELF_ATTN_KINDS:
                q, k, v = attention._project_qkv(
                    p["attn"], h, positions, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim, cfg.rope_theta, cdt)
                out = attention.chunked_attention(
                    q, k, v, chunk=cfg.attn_chunk, causal=True,
                    window=_window(kind, cfg))
                out = out.reshape(b, s, -1) @ p["attn"]["wo"].to(cdt)
                st[f"pos{i}"] = cache_from_kv(k, v, kind)
            elif kind == "cross_attn":
                if cross is None:
                    raise ValueError(f"{cfg.name} has cross-attention "
                                     f"blocks: the batch needs cross_states")
                a = p["attn"]
                k = heads(cross @ a["wk"].to(cdt), cfg.num_kv_heads)
                v = heads(cross @ a["wv"].to(cdt), cfg.num_kv_heads)
                q = heads(h.to(cdt) @ a["wq"].to(cdt), cfg.num_heads)
                out = attention.chunked_attention(
                    q, k, v, chunk=cfg.attn_chunk, causal=False, window=None)
                out = out.reshape(b, s, -1) @ a["wo"].to(cdt)
                st[f"pos{i}"] = attention.KVCache(
                    k=k.transpose(1, 2).contiguous(),
                    v=v.transpose(1, 2).contiguous())
            elif kind == "mlstm":
                pp = p["mlstm"]
                q, k, v, lf, gi = ssm._mlstm_gates(pp, h, cfg.ssm_heads, cdt)
                if cfg.sequence_parallel:
                    y, st[f"pos{i}"] = ssm.glr_shardmapped(
                        q, k, v, lf, gi, seq_axis="model",
                        chunk=cfg.attn_chunk, normalize=True,
                        return_state=True)
                else:
                    y, st[f"pos{i}"] = ssm.glr_chunked(
                        q, k, v, lf, gi, chunk=cfg.attn_chunk,
                        normalize=True)
                out = ssm._mlstm_out(pp, h, y, cdt)
            elif kind == "mamba":
                pp = p["mamba"]
                mkw = _mamba_kw(cfg)
                q, k, v, lf, dt, z, hist = ssm._mamba_core_inputs(
                    pp, h, cfg.ssm_heads, cfg.ssm_state_dim, cdt,
                    groups=mkw["groups"])
                y, rec = ssm.glr_chunked(q, k, v, lf, dt,
                                         chunk=cfg.ssm_chunk_len,
                                         normalize=False)
                out = ssm._mamba_out(pp, y, v, z, cdt, **mkw)
                st[f"pos{i}"] = ssm.MambaState(ssm=rec, conv=hist)
            elif kind == "moe":
                out = _moe_mixer(p, h, cfg, i)
                st[f"pos{i}"] = None
            else:
                raise ValueError(kind)
            x, _ = _apply_ffn(p, hint(x + out.to(x.dtype), "residual"), cfg)
        states.append(st)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(unembed_table(params, cfg), x[:, -1, :], cdt)
    return states, logits
