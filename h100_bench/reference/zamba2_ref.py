"""zamba2's forward with taps, in plain f32 PyTorch, and its weights.

The architecture (Zamba2, arXiv:2411.15242) as the configuration file's
``model`` block states it: ``num_layers / len(cycle)`` cycles, each of five
Mamba2 blocks and one call of a single shared attention + SwiGLU block;
RMSNorm ``x / rms(x) * (1 + scale)`` before each mixer and the MLP; RoPE on
split halves. A Mamba2 block: input products to ``x``, ``z``, ``B C`` and
``dt``; a causal depthwise conv (width 4) and SiLU on ``x`` and ``B C``;
``dt = softplus(dt_raw + dt_bias)``, ``A = -exp(a_log)``; per head the
scalar-decay recurrence ``S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T``,
``y_t = C_t S_t + D x_t`` (one B/C group shared by the heads), here in its
chunked (SSD) form; then RMSNorm of ``y`` gated by ``SiLU(z)`` and the down
product. Taps: the residual stream after the named cycles at the last
position; target: the entropy of the next-token distribution at the last
position.

Weights are the same tree the port serves (``blocks[c]["pos{i}"]``, matrix
weights ``(in, out)``), made here from the seed in bf16 (the served type)
on the card, and read in f32 by the reference. ``mm`` and ``pm`` are the
weight and the activation products: f32 with TF32 off, or a lower
precision for the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
_CHUNK = 1 << 28  # standard normals drawn per call while making weights


def _block_layout(m: dict, kind: str) -> Dict[str, tuple]:
    d, di = m["d_model"], m["d_model"] * m["ssm_expand"]
    n, h, w = m["ssm_state_dim"], m["ssm_heads"], m["ssm_conv_width"]
    if kind == "mamba":
        s = d ** -0.5
        return {"pre_norm": ((d,), "zeros"), "mamba": {
            "w_x": ((d, di), s), "w_z": ((d, di), s),
            "w_bc": ((d, 2 * n), s), "w_dt": ((d, h), s),
            "conv_x_w": ((w, di), 0.1), "conv_x_b": ((di,), "zeros"),
            "conv_bc_w": ((w, 2 * n), 0.1), "conv_bc_b": ((2 * n,), "zeros"),
            "a_log": ((h,), "a_log"), "dt_bias": ((h,), "dt_bias"),
            "d_skip": ((h,), "ones"), "out_norm": ((di,), "zeros"),
            "wd": ((di, d), di ** -0.5)}}
    if kind == "shared_attn":
        return {}
    raise ValueError(f"no layout for block kind {kind!r}")


def layout(m: dict) -> dict:
    """The parameter tree's leaves as ``(shape, init)``: a scale of
    standard normals, or a fixed init (``zeros``, ``ones``, ``a_log`` =
    log of 1..16 over the heads, ``dt_bias`` = softplus^-1(0.01))."""
    d, v = m["d_model"], m["vocab_size"]
    hq, hk, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    cycles = m["num_layers"] // len(m["cycle"])
    tree = {
        "embed": ((v, d), d ** -0.5),
        "final_norm": ((d,), "zeros"),
        "unembed": ((d, v), d ** -0.5),
        "blocks": [{f"pos{i}": _block_layout(m, k)
                    for i, k in enumerate(m["cycle"])} for _ in range(cycles)],
    }
    if "shared_attn" in m["cycle"]:
        s = d ** -0.5
        tree["shared"] = {
            "pre_norm": ((d,), "zeros"),
            "attn": {"wq": ((d, hq * hd), s), "wk": ((d, hk * hd), s),
                     "wv": ((d, hk * hd), s),
                     "wo": ((hq * hd, d), (hq * hd) ** -0.5)},
            "ffn_norm": ((d,), "zeros"),
            "mlp": {"gate": ((d, m["d_ff"]), s), "up": ((d, m["d_ff"]), s),
                    "down": ((m["d_ff"], d), m["d_ff"] ** -0.5)},
        }
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


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
    for lo in range(0, total, _CHUNK):
        hi = min(lo + _CHUNK, total)
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


def f32_mm(a: Tensor, b: Tensor) -> Tensor:
    return a @ b


def fp8_mm(a: Tensor, b: Tensor) -> Tensor:
    """The control's product: both operands rounded to float8 e4m3 with one
    scale per tensor (amax to 448), multiplied in f32."""
    def q(t):
        s = t.abs().amax().clamp(min=1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return q(a) @ q(b)


def _rms(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def _conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Causal depthwise conv over time: ``x (B, S, C)``, ``w (W, C)``."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[:, i:i + s] * w[i].float() for i in range(width)) + b.float()


def _ssd(x: Tensor, dt: Tensor, a: Tensor, bm: Tensor, cm: Tensor,
         pm: Callable, chunk: int = 128) -> Tensor:
    """``y_t = C_t S_t``, ``S_t = exp(dt_t a) S_{t-1} + dt_t B_t x_t^T``
    per head: ``x (B, S, H, P)``, ``dt (B, S, H)``, ``a (H,)``, ``B, C
    (B, S, N)``."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    L = min(chunk, s)
    pad = (-s) % L
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    nc = x.shape[1] // L
    x = x.view(b, nc, L, h, p)
    dt = dt.view(b, nc, L, h)
    bm, cm = bm.view(b, nc, L, n), cm.view(b, nc, L, n)
    acum = torch.cumsum(dt * a, dim=2)                        # (b, nc, L, h)
    seg = acum[:, :, :, None, :] - acum[:, :, None, :, :]     # (t, s)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  float("-inf")))
    cb = pm(cm, bm.transpose(-1, -2))                         # (b, nc, t, s)
    wts = cb[..., None] * decay * dt[:, :, None, :, :]        # (b,nc,t,s,h)
    y = pm(wts.permute(0, 1, 4, 2, 3), x.permute(0, 1, 3, 2, 4))
    y = y.permute(0, 1, 3, 2, 4)                              # (b,nc,L,h,p)
    tail = torch.exp(acum[:, :, -1:, :] - acum) * dt          # (b,nc,L,h)
    xb = (x * tail[..., None]).permute(0, 1, 3, 4, 2)         # (b,nc,h,p,L)
    states = pm(xb, bm[:, :, None]).transpose(-1, -2)         # (b,nc,h,n,p)
    carry = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    for c in range(nc):
        inter = pm(cm[:, c, None], carry)                     # (b, h, L, p)
        y[:, c] += inter.permute(0, 2, 1, 3) * torch.exp(acum[:, c])[..., None]
        carry = torch.exp(acum[:, c, -1])[..., None, None] * carry + states[:, c]
    return y.reshape(b, nc * L, h, p)[:, :s]


def _mamba(p: dict, x: Tensor, m: dict, mm: Callable, pm: Callable) -> Tensor:
    eps = m["norm_eps"]
    pp = p["mamba"]
    b, s, _ = x.shape
    hh, n = m["ssm_heads"], m["ssm_state_dim"]
    h = _rms(x, p["pre_norm"], eps)
    xi = mm(h, pp["w_x"].float())
    z = mm(h, pp["w_z"].float())
    bc = mm(h, pp["w_bc"].float())
    dt_raw = mm(h, pp["w_dt"].float())
    xi = F.silu(_conv(xi, pp["conv_x_w"], pp["conv_x_b"]))
    bc = F.silu(_conv(bc, pp["conv_bc_w"], pp["conv_bc_b"]))
    dt = F.softplus(dt_raw + pp["dt_bias"].float())
    a = -torch.exp(pp["a_log"].float())
    xh = xi.view(b, s, hh, -1)
    y = _ssd(xh, dt, a, bc[..., :n], bc[..., n:], pm)
    y = y + xh * pp["d_skip"].float()[None, None, :, None]
    y = _rms(y.reshape(b, s, -1), pp["out_norm"], 1e-6) * F.silu(z)
    return mm(y, pp["wd"].float())


def _rope(x: Tensor, theta: float) -> Tensor:
    s, half = x.shape[1], x.shape[-1] // 2
    freqs = float(theta) ** (-torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _shared(p: dict, x: Tensor, m: dict, mm: Callable, pm: Callable) -> Tensor:
    eps = m["norm_eps"]
    b, s, _ = x.shape
    hq, hk, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    a = p["attn"]
    h = _rms(x, p["pre_norm"], eps)
    q = _rope(mm(h, a["wq"].float()).view(b, s, hq, hd), m["rope_theta"])
    k = _rope(mm(h, a["wk"].float()).view(b, s, hk, hd), m["rope_theta"])
    v = mm(h, a["wv"].float()).view(b, s, hk, hd)
    g = hq // hk
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = pm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * hd ** -0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = pm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(b, s, hq * hd)
    x = x + mm(o, a["wo"].float())
    h2 = _rms(x, p["ffn_norm"], eps)
    mlp = p["mlp"]
    up = F.silu(mm(h2, mlp["gate"].float())) * mm(h2, mlp["up"].float())
    return x + mm(up, mlp["down"].float())


def forward_taps(params: dict, m: dict, tokens: Tensor, taps: List[int],
                 mm: Callable = f32_mm, pm: Callable = f32_mm
                 ) -> Tuple[Tensor, Tensor]:
    """``(feats (len(taps), B, d), targets (B,))`` of ``tokens (B, S)``:
    the residual stream after each tapped cycle at the last position, and
    the entropy of the last position's next-token distribution."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = params["embed"][tokens.long()].float()
        feats = []
        for c, cycle in enumerate(params["blocks"]):
            for i, kind in enumerate(m["cycle"]):
                if kind == "mamba":
                    x = x + _mamba(cycle[f"pos{i}"], x, m, mm, pm)
                else:
                    x = _shared(params["shared"], x, m, mm, pm)
            if c in taps:
                feats.append(x[:, -1].clone())
        hidden = _rms(x[:, -1], params["final_norm"], m["norm_eps"])
        logits = mm(hidden, params["unembed"].float())
        logp = torch.log_softmax(logits, dim=-1)
        entropy = -torch.sum(torch.exp(logp) * logp, dim=-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    order = [feats[sorted(taps).index(t)] for t in taps]
    return torch.stack(order), entropy
