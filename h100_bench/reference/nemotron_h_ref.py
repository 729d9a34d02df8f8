"""NemotronH's forward with taps, in plain f32 PyTorch, and its weights.

The architecture (NVIDIA Nemotron 3 Nano 30B-A3B; HF
``modeling_nemotron_h.py``) as the configuration file's ``model`` block
states it: ``layer_pattern`` names each layer's mixer, and every layer is
``x = x + mixer(RMSNorm(x))``; then a final RMSNorm and the untied head.
RMSNorm is ``x / rms(x) * (1 + scale)`` (HF's ``weight`` is ``1 + scale``).

* ``moe``: scores ``s = sigmoid(x W_r)``; the top ``k`` of ``s + bias``
  (one group: no group step); weights ``s[chosen] / (sum + 1e-20) *
  routed_scale``; output ``sum_i w_i down_i(relu(up_i x)^2) +
  down_s(relu(up_s x)^2)``. Here a loop over the experts, each reading its
  own tokens. The check may route it by given choices (``forced``: the
  routing under test), each weighted by this layer's own scores; then
  :func:`route` also says how far each choice lies below its own top ``k``.
* ``mamba``: products to ``x``, ``z``, ``B C`` (``groups`` B blocks of
  ``N``, then as many C blocks) and ``dt``; a causal depthwise conv (width
  4, with bias) and SiLU on ``x`` and ``B C``; ``dt = softplus(dt_raw +
  dt_bias)`` (no clamp), ``A = -exp(a_log)``; per head the scalar-decay
  recurrence with its group's ``B`` and ``C`` (``heads / groups`` heads a
  group), in chunked (SSD) form, group by group through
  ``zamba2_ref._ssd``; the ``D`` skip; then ``y * silu(z)``, RMS-normalized
  over each group of ``d_inner / groups`` channels; the down product.
* ``attn_only``: causal GQA with no positional embedding (NemotronH's
  attention has no rotary module).

Taps: the residual stream after the named layers at the last position;
target: the entropy of the next-token distribution at the last position.

Weights are the tree the port serves (``blocks[0]["pos{i}"]``, matrix
weights ``(in, out)``), made here from the seed in bf16 on the card. The
forward runs one layer at a time and casts each weight to f32 where it is
used, so it fits beside the served weights. ``mm`` and ``pm`` are the
weight and the activation products: f32 with TF32 off, or a lower
precision for the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference import zamba2_ref
from h100_bench.reference.zamba2_ref import _conv, _leaves, _rms, _set, \
    _skeleton, f32_mm

Tensor = torch.Tensor
ROUTER_BIAS_SCALE = 0.1  # the score-correction bias: N(0, 0.1^2), not zero


def _block_layout(m: dict, kind: str) -> Dict[str, tuple]:
    d = m["d_model"]
    s = d ** -0.5
    if kind == "mamba":
        h, n, w = m["ssm_heads"], m["ssm_state_dim"], m["ssm_conv_width"]
        di = h * m["ssm_head_dim"]
        bc = 2 * m["ssm_groups"] * n
        return {"pre_norm": ((d,), "zeros"), "mamba": {
            "w_x": ((d, di), s), "w_z": ((d, di), s), "w_bc": ((d, bc), s),
            "w_dt": ((d, h), s),
            "conv_x_w": ((w, di), 0.1), "conv_x_b": ((di,), "zeros"),
            "conv_bc_w": ((w, bc), 0.1), "conv_bc_b": ((bc,), "zeros"),
            "a_log": ((h,), "a_log"), "dt_bias": ((h,), "dt_bias"),
            "d_skip": ((h,), "ones"), "out_norm": ((di,), "zeros"),
            "wd": ((di, d), di ** -0.5)}}
    if kind == "moe":
        e, ff, sff = m["num_experts"], m["d_ff"], m["moe_shared_d_ff"]
        return {"pre_norm": ((d,), "zeros"), "moe": {
            "router": ((d, e), s), "router_bias": ((e,), ROUTER_BIAS_SCALE),
            "up": ((e, d, ff), s), "down": ((e, ff, d), ff ** -0.5),
            "shared_up": ((d, sff), s),
            "shared_down": ((sff, d), sff ** -0.5)}}
    if kind == "attn_only":
        hq, hk, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        return {"pre_norm": ((d,), "zeros"), "attn": {
            "wq": ((d, hq * hd), s), "wk": ((d, hk * hd), s),
            "wv": ((d, hk * hd), s), "wo": ((hq * hd, d), (hq * hd) ** -0.5)}}
    raise ValueError(f"no layout for block kind {kind!r}")


def layout(m: dict) -> dict:
    """The parameter tree's leaves as ``(shape, init)``: a scale of
    standard normals, or a fixed init (``zeros``, ``ones``, ``a_log`` =
    log of 1..16 over the heads, ``dt_bias`` = softplus^-1(0.01))."""
    d, v = m["d_model"], m["vocab_size"]
    return {
        "embed": ((v, d), d ** -0.5),
        "final_norm": ((d,), "zeros"),
        "unembed": ((d, v), d ** -0.5),
        "blocks": [{f"pos{i}": _block_layout(m, k)
                    for i, k in enumerate(m["layer_pattern"])}],
    }


def make_params(m: dict, gen: torch.Generator, device: torch.device,
                dtype=torch.bfloat16) -> dict:
    """The weights from ``gen``: every random leaf a view of one flat
    buffer of ``dtype``, filled from standard normals drawn in a few large
    f32 calls and scaled per leaf before the one cast."""
    spec = layout(m)
    params = _skeleton(spec)
    randoms = [(p, shape, init) for p, (shape, init) in _leaves(spec)
               if not isinstance(init, str)]
    total = sum(math.prod(shape) for _, shape, _ in randoms)
    flat = torch.empty((total,), dtype=dtype, device=device)
    bounds, off = [], 0
    for path, shape, scale in randoms:
        size = math.prod(shape)
        bounds.append((off, off + size, scale))
        _set(params, path, flat[off:off + size].view(shape))
        off += size
    j = 0
    for lo in range(0, total, zamba2_ref._CHUNK):
        hi = min(lo + zamba2_ref._CHUNK, total)
        buf = torch.randn((hi - lo,), generator=gen, device=device)
        while j < len(bounds) and bounds[j][0] < hi:
            a, b, scale = bounds[j]
            sa, sb = max(a, lo), min(b, hi)
            buf[sa - lo:sb - lo] *= scale
            if b > hi:
                break
            j += 1
        flat[lo:hi].copy_(buf)
        del buf
    h = m["ssm_heads"]
    fixed = {
        "zeros": lambda shape: torch.zeros(shape, dtype=dtype, device=device),
        "ones": lambda shape: torch.ones(shape, dtype=dtype, device=device),
        "a_log": lambda shape: torch.log(torch.linspace(
            1.0, 16.0, h, device=device)).to(dtype),
        "dt_bias": lambda shape: torch.log(torch.expm1(torch.full(
            shape, 0.01, device=device))).to(dtype),
    }
    for path, (shape, init) in _leaves(spec):
        if isinstance(init, str):
            _set(params, path, fixed[init](shape))
    return params


# -- the forward --------------------------------------------------------------


def route(x: Tensor, p: dict, m: dict, mm: Callable,
          forced: Optional[Tensor] = None) -> Tuple[Tensor, ...]:
    """``(chosen (T, k), weights (T, k), excess (T,))`` of ``x (T, d)``.
    ``forced`` gives the chosen experts in place of the top ``k`` (the
    routing under test); ``excess`` is how far below the reference's k-th
    biased score the lowest chosen expert's lies: 0 where the choice is the
    reference's own."""
    k = m["experts_per_token"]
    scores = torch.sigmoid(mm(x, p["router"].float()))
    biased = scores + p["router_bias"].float()
    top = torch.topk(biased, k, dim=-1)
    kth = top.values[:, -1]
    idx = top.indices if forced is None else forced.to(x.device)
    excess = kth - torch.gather(biased, -1, idx).min(dim=-1).values
    w = torch.gather(scores, -1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m["moe_routed_scale"]
    return idx, w, excess.clamp(min=0.0)


def _moe(p: dict, x: Tensor, m: dict, mm: Callable,
         choices: Optional[list], forced: Optional[list] = None) -> Tensor:
    b, s, d = x.shape
    t = x.reshape(-1, d)
    idx, w, excess = route(t, p, m, mm, forced.pop(0) if forced else None)
    if choices is not None:
        choices.append((idx, excess))
    k = idx.shape[1]
    order = torch.argsort(idx.reshape(-1), stable=True)
    counts = torch.bincount(idx.reshape(-1),
                            minlength=m["num_experts"]).tolist()
    out = torch.zeros_like(t)
    lo = 0
    for e, n in enumerate(counts):
        if n:
            sel = order[lo:lo + n]
            tok = sel // k
            hid = F.relu(mm(t[tok], p["up"][e].float())) ** 2
            ye = mm(hid, p["down"][e].float())
            out.index_add_(0, tok, ye * w.reshape(-1)[sel, None])
            lo += n
    shared = F.relu(mm(t, p["shared_up"].float())) ** 2
    out = out + mm(shared, p["shared_down"].float())
    return out.view(b, s, d)


def _mamba(p: dict, x: Tensor, m: dict, mm: Callable, pm: Callable) -> Tensor:
    b, s, _ = x.shape
    hh, n, g = m["ssm_heads"], m["ssm_state_dim"], m["ssm_groups"]
    per = hh // g
    xi = mm(x, p["w_x"].float())
    z = mm(x, p["w_z"].float())
    bc = mm(x, p["w_bc"].float())
    dt_raw = mm(x, p["w_dt"].float())
    xi = F.silu(_conv(xi, p["conv_x_w"], p["conv_x_b"]))
    bc = F.silu(_conv(bc, p["conv_bc_w"], p["conv_bc_b"]))
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    bm = bc[..., :g * n].view(b, s, g, n)
    cm = bc[..., g * n:].view(b, s, g, n)
    xh = xi.view(b, s, hh, -1)
    y = torch.cat([zamba2_ref._ssd(
        xh[:, :, j * per:(j + 1) * per], dt[:, :, j * per:(j + 1) * per],
        a[j * per:(j + 1) * per], bm[:, :, j], cm[:, :, j], pm,
        chunk=m["ssm_chunk"]) for j in range(g)], dim=2)
    y = y + xh * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, s, -1) * F.silu(z)
    y = _rms(y.view(b, s, g, -1), p["out_norm"].view(g, -1), m["norm_eps"])
    return mm(y.reshape(b, s, -1), p["wd"].float())


def _attn(p: dict, x: Tensor, m: dict, mm: Callable, pm: Callable) -> Tensor:
    b, s, _ = x.shape
    hq, hk, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = mm(x, p["wq"].float()).view(b, s, hq, hd)
    k = mm(x, p["wk"].float()).view(b, s, hk, hd)
    v = mm(x, p["wv"].float()).view(b, s, hk, hd)
    k = k.repeat_interleave(hq // hk, dim=2)
    v = v.repeat_interleave(hq // hk, dim=2)
    scores = pm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * hd ** -0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = pm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(b, s, hq * hd)
    return mm(o, p["wo"].float())


def forward_taps(params: dict, m: dict, tokens: Tensor, taps: List[int],
                 mm: Callable = f32_mm, pm: Callable = f32_mm,
                 choices: Optional[list] = None,
                 forced: Optional[List[Tensor]] = None
                 ) -> Tuple[Tensor, Tensor]:
    """``(feats (len(taps), B, d), targets (B,))`` of ``tokens (B, S)``:
    the residual stream after each tapped layer at the last position, and
    the entropy of the last position's next-token distribution. With a
    ``choices`` list, each MoE layer appends ``(chosen (B S, k), excess
    (B S,))`` of :func:`route`; ``forced``, one ``(B S, k)`` a MoE layer in
    order, routes by those choices (consumed from the list)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = m["norm_eps"]
    try:
        x = params["embed"][tokens.long()].float()
        feats = {}
        for i, kind in enumerate(m["layer_pattern"]):
            p = params["blocks"][0][f"pos{i}"]
            h = _rms(x, p["pre_norm"], eps)
            if kind == "mamba":
                x = x + _mamba(p["mamba"], h, m, mm, pm)
            elif kind == "moe":
                x = x + _moe(p["moe"], h, m, mm, choices, forced)
            elif kind == "attn_only":
                x = x + _attn(p["attn"], h, m, mm, pm)
            else:
                raise ValueError(kind)
            if i in taps:
                feats[i] = x[:, -1].clone()
        hidden = _rms(x[:, -1], params["final_norm"], eps)
        logits = mm(hidden, params["unembed"].float())
        logp = torch.log_softmax(logits, dim=-1)
        entropy = -torch.sum(torch.exp(logp) * logp, dim=-1)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return torch.stack([feats[t] for t in taps]), entropy
