"""Linear-recurrence sequence mixers: mLSTM (xLSTM) and Mamba2 (SSD) (port
of ``repro.models.ssm``, with the sequence-parallel form of the recurrence,
``glr_sequence_parallel`` / ``glr_shardmapped``, over a mesh's ``model``
axis).

Both are one scalar-decay gated linear recurrence per head:

    S_t = f_t * S_{t-1} + i_t * k_t v_t^T          (state:  dk x dv)
    n_t = f_t * n_{t-1} + i_t * k_t                (normalizer, mLSTM only)
    y_t = q_t @ S_t [/ max(|q_t . n_t|, 1)]

computed in chunked form: an intra-chunk term like masked attention plus the
inter-chunk contribution of the carried state, decays in log space. The
chunk's products are batched matrix products over ``(B, H)`` in f32, as the
reference's einsums; the sums run in another order, so results agree with
the reference's to f32 rounding, not bit for bit.

Two points where the port does what the reference means rather than what it
computes:

* The intra-chunk decay weights are ``exp(ratio)`` on the causal triangle
  and 0 above it. The reference takes ``exp`` of every entry and then masks
  (``ssm.py:94-96``); above the triangle ``ratio`` is a sum of ``-log_f >=
  0``, so once a chunk's decay passes about 88 ``exp`` overflows there, and
  the backward's ``0 * inf`` makes every gradient NaN. The port masks
  ``ratio`` to ``-inf`` first: the same forward bits (``exp(-inf) = 0``) and
  a finite backward.
* ``torch.matmul`` refuses mixed dtypes where ``jnp`` promotes. Mamba2's
  decode from an f32 conv history (``mamba_state_shape``) is f32 from the
  conv to the mixer's output in the reference, and bf16 from a bf16 history
  (what ``prefill`` returns in a bf16 model); :func:`_mm` applies the same
  promotion, so the port's dtypes are the reference's in both cases.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.models import layers
from repro_torch.sharding import mesh as mesh_lib

Tensor = torch.Tensor
Params = Dict[str, Tensor]


class RecurrentState(NamedTuple):
    s: Tensor   # (B, H, dk, dv)
    n: Tensor   # (B, H, dk)


def _mm(a: Tensor, w: Tensor) -> Tensor:
    """``a @ w`` in the promoted dtype of the two, as ``jnp`` computes it."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _glr_chunk(s: Tensor, n: Tensor, q: Tensor, k: Tensor, v: Tensor,
               lf: Tensor, gi: Tensor, normalize: bool, raw: bool):
    """One chunk of the recurrence. ``q``, ``k`` ``(B, H, c, dk)``, ``v``
    ``(B, H, c, dv)``, ``lf``, ``gi`` ``(B, H, c)``, all f32; the carry
    ``s`` ``(B, H, dk, dv)``, ``n`` ``(B, H, dk)``. Returns ``(s_new, n_new,
    y (B, H, c, dv), n_dot (B, H, c))``; ``n_dot`` is ``None`` unless
    ``normalize`` or ``raw``."""
    c = q.shape[2]
    lb = torch.cumsum(lf, dim=-1)                               # (B, H, c)
    total = lb[..., -1]                                         # (B, H)
    qf = q * torch.exp(lb)[..., None]
    # Inter-chunk: the decayed queries against the carried state.
    inter = qf @ s
    # Intra-chunk: decay-weighted attention on the causal triangle.
    ratio = lb[..., :, None] - lb[..., None, :]                 # (B, H, c, c)
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    w = torch.exp(torch.where(mask, ratio, float("-inf")))
    a = (q @ k.transpose(-1, -2)) * w * gi[..., None, :]
    y = inter + a @ v
    # The normalizer only where it is read (XLA drops the reference's
    # unread one as dead code; eager code must skip it itself).
    n_dot = None
    if normalize or raw:
        n_dot = (qf @ n[..., None])[..., 0] + a.sum(dim=-1)
    if normalize and not raw:
        y = y / torch.clamp(n_dot.abs(), min=1.0)[..., None]
    # The state update.
    kf = k * (torch.exp(total[..., None] - lb) * gi)[..., None]
    decay = torch.exp(total)
    s_new = decay[..., None, None] * s + kf.transpose(-1, -2) @ v
    n_new = decay[..., None] * n + kf.sum(dim=2)
    return s_new, n_new, y, n_dot


def glr_chunked(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor,
                gate_i: Tensor, state: Optional[RecurrentState] = None, *,
                chunk: int = 256, normalize: bool = False,
                return_raw: bool = False):
    """Chunked gated linear recurrence. ``q``, ``k`` ``(B, S, H, dk)``,
    ``v`` ``(B, S, H, dv)``, ``log_f`` (<= 0) and ``gate_i`` (>= 0) ``(B,
    S, H)``. Returns ``(y (B, S, H, dv) in v's dtype, final state)``.

    ``return_raw=True`` returns ``((y unnormalized, n_dot), state)`` in f32,
    for a caller that adds other contributions before normalizing. The
    sequence is padded to whole chunks with ``log_f = 0`` and zero inputs,
    which leaves the state as it is. With gradients on, each chunk runs
    under a non-reentrant checkpoint, as the reference's ``jax.checkpoint``
    around its step: its ``(c, c)`` products are recomputed in the
    backward, not kept."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    f32 = torch.float32

    def heads_first(a: Tensor) -> Tensor:  # (B, S, H, ...) -> (B, H, S, ...)
        a = a.to(f32)
        if pad:
            a = F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        return a.transpose(1, 2)

    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    lfh, gih = heads_first(log_f), heads_first(gate_i)
    if state is None:
        state = RecurrentState(
            s=torch.zeros((b, h, dk, dv), dtype=f32, device=q.device),
            n=torch.zeros((b, h, dk), dtype=f32, device=q.device))
    st, nt = state
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (qh, kh, vh, lfh, gih, st, nt))
    ys, nds = [], []
    for lo in range(0, s + pad, c):
        sl = slice(lo, lo + c)
        args = (st, nt, qh[:, :, sl], kh[:, :, sl], vh[:, :, sl],
                lfh[:, :, sl], gih[:, :, sl], normalize, return_raw)
        if grad:
            st, nt, y, nd = torch_checkpoint.checkpoint(
                _glr_chunk, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            st, nt, y, nd = _glr_chunk(*args)
        ys.append(y)
        nds.append(nd)
    y = torch.cat(ys, dim=2)[:, :, :s].transpose(1, 2)       # (B, S, H, dv)
    final = RecurrentState(st, nt)
    if return_raw:
        return (y, torch.cat(nds, dim=2)[:, :, :s].transpose(1, 2)), final
    return y.to(v.dtype), final


def glr_sequence_parallel(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor,
                          gate_i: Tensor, mesh: mesh_lib.Mesh, *,
                          seq_axis: str = "model", chunk: int = 256,
                          normalize: bool = False,
                          return_state: bool = False):
    """The recurrence over a sequence cut along ``seq_axis`` (LASP-style;
    the reference's ``glr_sequence_parallel`` inside its ``shard_map``,
    written over the axis's devices by the single controller).

    The recurrence over a span of tokens is an affine map of the state,
    ``S -> a S + B`` (``a = exp(sum log_f)``, ``B`` the span's decayed
    outer products), and affine maps compose associatively. So the
    ``P`` devices along ``seq_axis`` (at the other axes' coordinates of the
    mesh's first device) each run :func:`glr_chunked` over a contiguous
    span of ``S / P`` tokens from a zero state, unnormalized; a
    Hillis-Steele inclusive scan of ``(log a, S, n)`` over ``ceil(log2
    P)`` rounds combines them (round ``r`` moves device ``i``'s value to
    device ``i + 2^r``, the reference's ``ppermute``, as a copy), and the
    exclusive shift gives each span the state before it; each span adds
    ``q exp(cumsum log_f) @ S_before`` (and the normalizer's term) before
    normalizing. ``y`` comes back whole on ``q``'s device; with
    ``return_state`` so does the final state, the last span's inclusive
    value. Gradients flow through every copy.

    The spans' chunks start at their span's start (a span shorter than
    ``chunk`` is one chunk), so sums run in another order than the
    meshless run's: results agree with it to f32 rounding."""
    devs = mesh.along(seq_axis)
    n_dev = len(devs)
    b, s, h, dk = q.shape
    if s % n_dev:
        raise ValueError(f"sequence of {s} tokens not divisible by mesh "
                         f"axis {seq_axis!r} ({n_dev} devices)")
    span = s // n_dev
    home = q.device
    f32 = torch.float32
    raws, incs = [], []
    for i, dev in enumerate(devs):
        part = [t[:, i * span:(i + 1) * span].to(dev)
                for t in (q, k, v, log_f, gate_i)]
        (y_raw, ndot), st = glr_chunked(*part, chunk=chunk,
                                        normalize=normalize, return_raw=True)
        raws.append((part[0], part[3], y_raw, ndot))
        incs.append((part[3].to(f32).sum(dim=1), st.s, st.n))   # (B, H)

    # The inclusive prefix scan of the affine maps.
    shift = 1
    while shift < n_dev:
        nxt = list(incs)
        for i in range(shift, n_dev):
            la_p, s_p, n_p = (t.to(devs[i]) for t in incs[i - shift])
            la, s_c, n_c = incs[i]
            a_c = torch.exp(la)
            nxt[i] = (la_p + la, a_c[..., None, None] * s_p + s_c,
                      a_c[..., None] * n_p + n_c)
        incs = nxt
        shift *= 2

    ys = []
    for i, (dev, (qi, lfi, y_raw, ndot)) in enumerate(zip(devs, raws)):
        # The state before this span: the exclusive prefix.
        if i == 0:
            s_pre = torch.zeros_like(incs[0][1])
            n_pre = torch.zeros_like(incs[0][2])
        else:
            s_pre, n_pre = (t.to(dev) for t in incs[i - 1][1:])
        lb = torch.cumsum(lfi.to(f32), dim=1)                   # (B, s, H)
        qf = (qi.to(f32) * torch.exp(lb)[..., None]).transpose(1, 2)
        y = y_raw + (qf @ s_pre).transpose(1, 2)
        if normalize:
            nd = ndot + (qf @ n_pre[..., None])[..., 0].transpose(1, 2)
            y = y / torch.clamp(nd.abs(), min=1.0)[..., None]
        ys.append(y.to(v.dtype).to(home))
    y = torch.cat(ys, dim=1)
    if not return_state:
        return y
    _, s_fin, n_fin = incs[-1]
    return y, RecurrentState(s_fin.to(home), n_fin.to(home))


def glr_shardmapped(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor,
                    gate_i: Tensor, *, seq_axis: str, chunk: int = 256,
                    normalize: bool = False, return_state: bool = False):
    """:func:`glr_sequence_parallel` over the ambient mesh
    (``sharding.mesh.set_mesh``). Raises without one, or when it lacks
    ``seq_axis``, as the reference's ``shard_map`` does."""
    mesh = mesh_lib.get_mesh()
    if mesh is None:
        raise ValueError("the sequence-parallel recurrence needs an ambient "
                         "mesh (sharding.mesh.set_mesh): the context mesh "
                         "cannot be empty")
    if seq_axis not in mesh.axis_names:
        raise ValueError(f"the ambient mesh has axes {mesh.axis_names}, not "
                         f"{seq_axis!r}")
    return glr_sequence_parallel(q, k, v, log_f, gate_i, mesh,
                                 seq_axis=seq_axis, chunk=chunk,
                                 normalize=normalize,
                                 return_state=return_state)


def glr_decode_step(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor,
                    gate_i: Tensor, state: RecurrentState, *,
                    normalize: bool = False
                    ) -> Tuple[Tensor, RecurrentState]:
    """One token of the recurrence: ``q``, ``k`` ``(B, H, dk)``, ``v``
    ``(B, H, dv)``, ``log_f``, ``gate_i`` ``(B, H)``. Returns ``(y (B, H,
    dv) in v's dtype, new state)``."""
    f32 = torch.float32
    f = torch.exp(log_f.to(f32))[..., None, None]
    gi = gate_i.to(f32)
    kf, vf, qf = k.to(f32), v.to(f32), q.to(f32)
    s_new = f * state.s + gi[..., None, None] * (kf[..., :, None]
                                                 * vf[..., None, :])
    n_new = f[..., 0] * state.n + gi[..., None] * kf
    y = (qf[..., None, :] @ s_new)[..., 0, :]
    if normalize:
        nd = (qf * n_new).sum(dim=-1)
        y = y / torch.clamp(nd.abs(), min=1.0)[..., None]
    return y.to(v.dtype), RecurrentState(s_new, n_new)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, d: int, expand: int, heads: int,
               dtype: torch.dtype) -> Params:
    """The mLSTM mixer's weights ``(in, out)``, drawn from ``gen``; the
    forget bias starts at +3 (long memory, as xLSTM's init)."""
    d_inner = d * expand
    dqk = d_inner // 2  # xLSTM's qk-dim factor 0.5
    s = d ** -0.5
    dev = gen.device
    return {
        "wq": layers.normal((d, dqk), s, dtype, gen),
        "wk": layers.normal((d, dqk), s, dtype, gen),
        "wv": layers.normal((d, d_inner), s, dtype, gen),
        "wo_gate": layers.normal((d, d_inner), s, dtype, gen),
        "w_if": layers.normal((d, 2 * heads), s, dtype, gen),
        "b_if": torch.cat([torch.zeros(heads, device=dev),
                           torch.full((heads,), 3.0, device=dev)]).to(dtype),
        "out_norm": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "wd": layers.normal((d_inner, d), d_inner ** -0.5, dtype, gen),
    }


def _mlstm_gates(params: Params, x: Tensor, heads: int,
                 compute_dtype: torch.dtype):
    """``q``, ``k`` (scaled by ``dk^-1/2``), ``v`` in the compute dtype and
    the f32 gates ``log_f = log_sigmoid``, ``gate_i = sigmoid``."""
    b, s, _ = x.shape
    xc = x.to(compute_dtype)
    d_inner = params["wv"].shape[1]
    dqk = params["wq"].shape[1]
    q = (xc @ params["wq"].to(compute_dtype)).reshape(b, s, heads,
                                                      dqk // heads)
    k = (xc @ params["wk"].to(compute_dtype)).reshape(b, s, heads,
                                                      dqk // heads)
    k = k * ((dqk // heads) ** -0.5)
    v = (xc @ params["wv"].to(compute_dtype)).reshape(b, s, heads,
                                                      d_inner // heads)
    gif = (xc @ params["w_if"].to(compute_dtype)
           + params["b_if"].to(compute_dtype))
    gi, gf = gif[..., :heads], gif[..., heads:]
    log_f = F.logsigmoid(gf.to(torch.float32))
    gate_i = torch.sigmoid(gi.to(torch.float32))
    return q, k, v, log_f, gate_i


def _mlstm_out(params: Params, x: Tensor, y: Tensor,
               compute_dtype: torch.dtype) -> Tensor:
    """The mixer's output from the recurrence's ``y (B, S, H, dv)``: norm,
    sigmoid output gate, down projection."""
    b, s = x.shape[:2]
    y = layers.rms_norm(y.reshape(b, s, -1), params["out_norm"])
    o = torch.sigmoid(x.to(compute_dtype) @ params["wo_gate"].to(
        compute_dtype))
    return _mm(o * y, params["wd"].to(compute_dtype))


def mlstm_block(params: Params, x: Tensor, heads: int, chunk: int,
                compute_dtype: torch.dtype,
                seq_axis: Optional[str] = None) -> Tensor:
    """Sequence-mode mLSTM mixer (the pre-norm residual is the caller's).
    ``seq_axis`` runs the recurrence sequence-parallel over that axis of
    the ambient mesh (:func:`glr_shardmapped`)."""
    q, k, v, log_f, gate_i = _mlstm_gates(params, x, heads, compute_dtype)
    if seq_axis is None:
        y, _ = glr_chunked(q, k, v, log_f, gate_i, chunk=chunk,
                           normalize=True)
    else:
        y = glr_shardmapped(q, k, v, log_f, gate_i, seq_axis=seq_axis,
                            chunk=chunk, normalize=True)
    return _mlstm_out(params, x, y, compute_dtype)


def mlstm_decode(params: Params, x: Tensor, state: RecurrentState,
                 heads: int, compute_dtype: torch.dtype
                 ) -> Tuple[Tensor, RecurrentState]:
    """``x (B, 1, d)`` -> ``(B, 1, d)`` and the updated state."""
    q, k, v, log_f, gate_i = _mlstm_gates(params, x, heads, compute_dtype)
    y, state = glr_decode_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                               gate_i[:, 0], state, normalize=True)
    return _mlstm_out(params, x, y[:, None], compute_dtype), state


def mlstm_state_shape(b: int, d: int, expand: int, heads: int,
                      device: torch.device) -> RecurrentState:
    """A zeroed f32 state."""
    d_inner = d * expand
    dk = (d_inner // 2) // heads
    dv = d_inner // heads
    return RecurrentState(
        s=torch.zeros((b, heads, dk, dv), dtype=torch.float32, device=device),
        n=torch.zeros((b, heads, dk), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Mamba2 block (SSD)
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    ssm: RecurrentState      # (B, H, dstate, headdim)
    conv: Tensor             # (B, conv_w - 1, d_conv_channels)


def init_mamba2(gen: torch.Generator, d: int, expand: int, state_dim: int,
                heads: int, conv_width: int, dtype: torch.dtype,
                d_inner: Optional[int] = None, groups: int = 1) -> Params:
    """The Mamba2 mixer's weights: separate input projections (``w_x``,
    ``w_z``, ``w_bc``, ``w_dt``) and conv filters, ``A = -exp(a_log)`` from
    -1 to -16 over the heads, ``dt`` biased to softplus^-1(0.01).
    ``d_inner`` defaults to ``d * expand``; ``w_bc`` gives ``groups`` B
    blocks of ``state_dim``, then as many C blocks."""
    d_inner = d * expand if d_inner is None else d_inner
    if (d_inner // heads) * heads != d_inner:
        raise ValueError(f"d_inner {d_inner} is not a multiple of {heads} "
                         f"heads")
    bc = 2 * groups * state_dim
    s = d ** -0.5
    dev = gen.device
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=dev)
    return {
        "w_x": layers.normal((d, d_inner), s, dtype, gen),
        "w_z": layers.normal((d, d_inner), s, dtype, gen),
        "w_bc": layers.normal((d, bc), s, dtype, gen),
        "w_dt": layers.normal((d, heads), s, dtype, gen),
        "conv_x_w": layers.normal((conv_width, d_inner), 0.1, dtype, gen),
        "conv_x_b": zeros(d_inner),
        "conv_bc_w": layers.normal((conv_width, bc), 0.1, dtype, gen),
        "conv_bc_b": zeros(bc),
        "a_log": torch.log(torch.linspace(1.0, 16.0, heads, device=dev)
                           ).to(dtype),
        "dt_bias": torch.log(torch.expm1(torch.full((heads,), 0.01,
                                                    device=dev))).to(dtype),
        "d_skip": torch.ones((heads,), dtype=dtype, device=dev),
        "out_norm": zeros(d_inner),
        "wd": layers.normal((d_inner, d), d_inner ** -0.5, dtype, gen),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 history: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv: ``x (B, S, C)``, ``w (W, C)``. Returns ``(y,
    new history)``; the history's dtype joins ``x``'s (``torch.cat``
    promotes as ``jnp.concatenate`` does)."""
    width = w.shape[0]
    if history is None:
        history = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                              dtype=x.dtype, device=x.device)
    xh = torch.cat([history, x], dim=1)
    s = x.shape[1]
    y = sum(xh[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    return y + b[None, None, :], xh[:, -(width - 1):, :]


def _per_head(m: Tensor, groups: int, heads: int) -> Tensor:
    """``(B, S, groups * N)`` -> ``(B, S, heads, N)``: head ``h`` reads group
    ``h // (heads / groups)``. One group is a view (stride 0 over the
    heads); more groups copy."""
    b, s, w = m.shape
    n = w // groups
    return m.reshape(b, s, groups, 1, n).expand(
        b, s, groups, heads // groups, n).flatten(2, 3)


def _mamba_core_inputs(params: Params, x: Tensor, heads: int, state_dim: int,
                       compute_dtype: torch.dtype,
                       conv_history: Optional[Tensor] = None,
                       groups: int = 1):
    """The recurrence's inputs: ``q = C``, ``k = B`` (each of ``groups``
    groups shared by ``heads / groups`` heads), ``v`` the conv'd channels,
    ``log_f = dt * A``, ``dt``, the gate ``z`` and the new conv history."""
    b, s, _ = x.shape
    d_inner = params["w_x"].shape[1]
    headdim = d_inner // heads
    xc = x.to(compute_dtype)
    xi = xc @ params["w_x"].to(compute_dtype)
    z = xc @ params["w_z"].to(compute_dtype)
    bc = xc @ params["w_bc"].to(compute_dtype)
    dt_raw = xc @ params["w_dt"].to(compute_dtype)
    if conv_history is None:
        hist_x, hist_bc = None, None
    else:
        hist_x = conv_history[..., :d_inner]
        hist_bc = conv_history[..., d_inner:]
    conv_x, new_hx = _causal_conv(
        xi, params["conv_x_w"].to(compute_dtype),
        params["conv_x_b"].to(compute_dtype), hist_x)
    conv_bc, new_hbc = _causal_conv(
        bc, params["conv_bc_w"].to(compute_dtype),
        params["conv_bc_b"].to(compute_dtype), hist_bc)
    new_hist = torch.cat([new_hx, new_hbc], dim=-1)
    xi = F.silu(conv_x).reshape(b, s, heads, headdim)
    conv_bc = F.silu(conv_bc)
    gn = groups * state_dim
    dt = F.softplus(dt_raw.to(torch.float32)
                    + params["dt_bias"].to(torch.float32))      # (B, S, H)
    a = -torch.exp(params["a_log"].to(torch.float32))            # (H,)
    log_f = dt * a[None, None, :]
    k = _per_head(conv_bc[..., :gn], groups, heads)
    q = _per_head(conv_bc[..., gn:], groups, heads)
    return q, k, xi, log_f, dt, z, new_hist


def _mamba_out(params: Params, y: Tensor, v: Tensor, z: Tensor,
               compute_dtype: torch.dtype, groups: int = 1,
               group_norm_eps: Optional[float] = None) -> Tensor:
    """The mixer's output from the recurrence's ``y (B, S, H, dv)``: the D
    skip, then RMSNorm gated by ``silu(z)`` (``group_norm_eps`` None: norm
    then gate, as zamba2's; else gate, then RMSNorm over each of
    ``groups`` channel groups with that eps, Mamba2's
    ``norm_before_gate=False``), then the down projection."""
    b, s = y.shape[:2]
    y = y + v * params["d_skip"].to(compute_dtype)[None, None, :, None]
    y = y.reshape(b, s, -1)
    if group_norm_eps is None:
        y = layers.rms_norm(y, params["out_norm"]) * F.silu(z)
    else:
        g = y.to(torch.float32) * F.silu(z.to(torch.float32))
        y = layers.rms_norm(g.reshape(b, s, groups, -1),
                            params["out_norm"].reshape(groups, -1),
                            group_norm_eps).reshape(b, s, -1).to(y.dtype)
    return _mm(y, params["wd"].to(compute_dtype))


def mamba2_block(params: Params, x: Tensor, heads: int, state_dim: int,
                 chunk: int, compute_dtype: torch.dtype, groups: int = 1,
                 group_norm_eps: Optional[float] = None) -> Tensor:
    """Sequence-mode Mamba2 mixer (the pre-norm residual is the caller's)."""
    q, k, v, log_f, dt, z, _ = _mamba_core_inputs(
        params, x, heads, state_dim, compute_dtype, groups=groups)
    y, _ = glr_chunked(q, k, v, log_f, dt, chunk=chunk, normalize=False)
    return _mamba_out(params, y, v, z, compute_dtype, groups, group_norm_eps)


def mamba2_decode(params: Params, x: Tensor, state: MambaState, heads: int,
                  state_dim: int, compute_dtype: torch.dtype,
                  groups: int = 1, group_norm_eps: Optional[float] = None
                  ) -> Tuple[Tensor, MambaState]:
    """``x (B, 1, d)`` -> ``(B, 1, d)`` and the updated state; the output is
    f32 from an f32 conv history, the compute dtype from one in it."""
    q, k, v, log_f, dt, z, hist = _mamba_core_inputs(
        params, x, heads, state_dim, compute_dtype, conv_history=state.conv,
        groups=groups)
    y, ssm = glr_decode_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0],
                             dt[:, 0], state.ssm, normalize=False)
    return (_mamba_out(params, y[:, None], v, z, compute_dtype, groups,
                       group_norm_eps),
            MambaState(ssm=ssm, conv=hist))


def mamba_state_shape(b: int, d: int, expand: int, state_dim: int,
                      heads: int, conv_width: int, device: torch.device,
                      d_inner: Optional[int] = None, groups: int = 1
                      ) -> MambaState:
    """A zeroed state: the recurrence and the conv history in f32."""
    d_inner = d * expand if d_inner is None else d_inner
    headdim = d_inner // heads
    f32 = torch.float32
    return MambaState(
        ssm=RecurrentState(
            s=torch.zeros((b, heads, state_dim, headdim), dtype=f32,
                          device=device),
            n=torch.zeros((b, heads, state_dim), dtype=f32, device=device)),
        conv=torch.zeros((b, conv_width - 1,
                          d_inner + 2 * groups * state_dim),
                         dtype=f32, device=device))
