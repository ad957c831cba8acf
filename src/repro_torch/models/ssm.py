"""Mamba2 (SSD) block (counterpart of ``repro/models/ssm.py``): the chunked
form for prefill, the O(1) recurrent step for decode and the chunk-resumable
form for chunked admission. Used by the zamba2 hybrid.

State-space recurrence per head h with P = head_dim, N = state_dim:

    S_t = dA_t · S_{t-1} + dt_t · B_t ⊗ x_t          S: (N, P)
    y_t = C_t · S_t + D_h · x_t

with dA_t = exp(-exp(A_log_h) · dt_t), dt_t = softplus(dt_raw + bias). B and C
are shared across heads (one group). The chunked form computes a chunk's own
contributions through a causal decay matrix (batched products) and carries
the state from chunk to chunk with a loop, the reference's ``lax.scan``.
The projections are factored per stream (w_z, w_x, w_B, w_C, w_dt), each
with its own depthwise causal conv, as in the reference.

Dtypes and orders follow the reference: ``A_log``, ``D`` and ``dt_bias`` are
f32 in every model; the prefill conv sums its K products in the activation
dtype, the decode conv in f32; the SSD sums are f32. The functions take
and return the state as a dict of the reference's keys (``ssm``,
``conv_x``, ``conv_B``, ``conv_C``); the serving blocks write it into the
engine's tensors in place (``models/transformer.py``). Nothing here reads
a value back from the card, so each step can be captured.

Every function takes ``tp``, the mixer's ``runtime/tensor_parallel
.TensorParallel`` view over a mesh (None: whole weights, the path as it
always was): the five projections are column products gathered whole, the
convs' weights (cut over channels) gathered once a call, the SSD chunk and
step run whole (the gated RMSNorm spans the whole inner dim), and
``out_proj`` is a row product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_dense, rms_norm
from repro_torch.runtime import tensor_parallel as tplib

# the projections (column-cut over a mesh) and the leaves read whole
_PROJ = ("w_z", "w_x", "w_B", "w_C", "w_dt")
_CONV = ("conv_x", "conv_B", "conv_C")


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    return s, inner, inner // s.head_dim


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, *, dtype, device):
    """One layer's parameters from ``gen``: the reference's shapes and scales;
    ``A_log``, ``D`` and ``dt_bias`` in f32 whatever ``dtype``."""
    s, inner, n_heads = _dims(cfg)
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    conv = lambda c: (torch.randn((s.conv_dim, c), generator=gen, **f32) * 0.1).to(dtype)
    return {
        "w_z": init_dense(gen, d, inner, **kw),
        "w_x": init_dense(gen, d, inner, **kw),
        "w_B": init_dense(gen, d, s.state_dim, **kw),
        "w_C": init_dense(gen, d, s.state_dim, **kw),
        "w_dt": init_dense(gen, d, n_heads, **kw),
        "conv_x": conv(inner),
        "conv_B": conv(s.state_dim),
        "conv_C": conv(s.state_dim),
        "conv_bx": torch.zeros(inner, **kw),
        "conv_bB": torch.zeros(s.state_dim, **kw),
        "conv_bC": torch.zeros(s.state_dim, **kw),
        "A_log": torch.zeros(n_heads, **f32),
        "D": torch.ones(n_heads, **f32),
        "dt_bias": torch.zeros(n_heads, **f32),
        "norm_w": torch.zeros(inner, **kw),
        "out_proj": init_dense(gen, inner, d, **kw),
    }


def _conv_sum(buf, w, length: int):
    """Σ_i buf[:, i : i + length] · w[i] in the activation dtype, summed in
    the reference's order (its ``sum`` over i)."""
    out = buf[:, 0:length] * w[0]
    for i in range(1, w.shape[0]):
        out = out + buf[:, i:i + length] * w[i]
    return out


def _causal_conv(x, w, b):
    """Depthwise causal conv over time. x: (B, L, C); w: (K, C)."""
    pad = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    return F.silu(_conv_sum(pad, w, x.shape[1]) + b)


def _project(params, x, tp=None):
    """x: (B, L, d) -> (z, xs, B, C, dt_raw) with per-stream causal convs,
    and the pre-conv (x, B, C) projections."""
    z, px, pb, pc, dt_raw = tplib.project(tp, x, params, _PROJ)
    params = tplib.whole_leaves(tp, params, _CONV)
    xs = _causal_conv(px, params["conv_x"], params["conv_bx"])
    b = _causal_conv(pb, params["conv_B"], params["conv_bB"])
    c = _causal_conv(pc, params["conv_C"], params["conv_bC"])
    return (z, xs, b, c, dt_raw), (px, pb, pc)


def _dt(params, dt_raw):
    """softplus(dt_raw + bias) in f32, and its log decay a·dt (< 0)."""
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    return dt, -torch.exp(params["A_log"]) * dt


def _pad_time(x, pad: int):
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def _chunk_states(dtc, bc, xh, g):
    """Per-chunk states Σ_j exp(G_last - G_j) dt_j B_j ⊗ x_j (B, nc, H, N, P)
    and each chunk's whole decay exp(G_last) (B, nc, H)."""
    decay_to_end = torch.exp(g[:, :, -1:, :] - g)
    sc = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_to_end * dtc, bc, xh)
    return sc, torch.exp(g[:, :, -1, :])


def _carry(sc, chunk_decay, s0):
    """The state entering each chunk, from s0: the reference's scan over
    chunks as a loop. Returns (entering (B, nc, H, N, P), final)."""
    entering = []
    s_prev = s0
    for c in range(sc.shape[1]):
        entering.append(s_prev)
        s_prev = chunk_decay[:, c, :, None, None] * s_prev + sc[:, c]
    return torch.stack(entering, dim=1), s_prev


def _chunked(cfg: ArchConfig, params, x, tp=None):
    """(z, the chunked SSD inputs, the pre-conv projections) of the prefill
    forms: xs, B, C, dt padded to whole chunks of min(chunk, L) and split
    into them, and the cumulative log decay G within each chunk."""
    s, inner, n_heads = _dims(cfg)
    bsz, L, _ = x.shape
    (z, xs, b, c, dt_raw), pre = _project(params, x, tp)
    dt, log_da = _dt(params, dt_raw)
    q = min(s.chunk, L)
    pad = (-L) % q
    nc = (L + pad) // q
    xh = _pad_time(xs, pad).reshape(bsz, nc, q, n_heads, s.head_dim)
    bc = _pad_time(b, pad).reshape(bsz, nc, q, s.state_dim)
    cc = _pad_time(c, pad).reshape(bsz, nc, q, s.state_dim)
    dtc = _pad_time(dt, pad).reshape(bsz, nc, q, n_heads)
    g = torch.cumsum(_pad_time(log_da, pad).reshape(bsz, nc, q, n_heads), dim=2)
    return z, (xh, bc, cc, dtc, g), pre


def _gate_out(cfg: ArchConfig, params, y, z, tp=None):
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    return tplib.out_row(tp, y, params, "out_proj")


def mamba2_forward(cfg: ArchConfig, params, x, tp=None):
    """x: (B, L, d) -> (B, L, d). Chunked SSD."""
    s, inner, n_heads = _dims(cfg)
    bsz, L, _ = x.shape
    z, (xh, bc, cc, dtc, g), _ = _chunked(cfg, params, x, tp)
    nc, q = xh.shape[1], xh.shape[2]
    xf, bf, cf = xh.float(), bc.float(), cc.float()
    # intra-chunk: y_i += sum_{j<=i} (G_i/G_j) dt_j (C_i·B_j) x_j
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)
    causal = (torch.arange(q, device=x.device)[None, :]
              <= torch.arange(q, device=x.device)[:, None])[None, None, :, :, None]
    logw = g[:, :, :, None, :] - g[:, :, None, :, :]               # (B,nc,i,j,H)
    # masked before the exp: above the diagonal logw > 0 may overflow to
    # inf, whose masked gradient 0 * inf is NaN (the reference's form,
    # ROADMAP Queue 3); the values are the same bits
    w = torch.exp(torch.where(causal, logw, float("-inf")))
    w = w * cb[..., None] * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xf)
    sc, chunk_decay = _chunk_states(dtc, bf, xf, g)
    s0 = torch.zeros((bsz, n_heads, s.state_dim, s.head_dim), dtype=torch.float32,
                     device=x.device)
    s_init, _ = _carry(sc, chunk_decay, s0)
    # inter-chunk: y_i += G_i * C_i · S_init
    y_inter = torch.einsum("bcin,bchnp->bcihp", cf, s_init) * torch.exp(g)[..., None]
    y = (y_intra + y_inter).reshape(bsz, nc * q, n_heads, s.head_dim)
    y = y + xh.reshape(bsz, nc * q, n_heads, s.head_dim) * params["D"][None, None, :, None]
    y = y[:, :L].reshape(bsz, L, inner).to(x.dtype)
    return _gate_out(cfg, params, y, z, tp)


def mamba2_final_state(cfg: ArchConfig, params, x, tp=None):
    """The state after consuming x: (B, L, d): the SSD state and the
    pre-conv inputs of the last K-1 positions."""
    s, inner, n_heads = _dims(cfg)
    bsz, L, _ = x.shape
    _, (xh, bc, _, dtc, g), (px, pb, pc) = _chunked(cfg, params, x, tp)
    sc, chunk_decay = _chunk_states(dtc, bc.float(), xh.float(), g)
    s0 = torch.zeros((bsz, n_heads, s.state_dim, s.head_dim), dtype=torch.float32,
                     device=x.device)
    _, s_fin = _carry(sc, chunk_decay, s0)
    k = s.conv_dim - 1
    return {"ssm": s_fin, "conv_x": px[:, L - k:, :], "conv_B": pb[:, L - k:, :],
            "conv_C": pc[:, L - k:, :]}


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) a step)
# ---------------------------------------------------------------------------


def init_mamba2_state(cfg: ArchConfig, bsz: int, *, dtype, device):
    s, inner, n_heads = _dims(cfg)
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    return {"ssm": z(bsz, n_heads, s.state_dim, s.head_dim, dt=torch.float32),
            "conv_x": z(bsz, s.conv_dim - 1, inner),
            "conv_B": z(bsz, s.conv_dim - 1, s.state_dim),
            "conv_C": z(bsz, s.conv_dim - 1, s.state_dim)}


def _conv_step(hist, new, w, b):
    """hist: (B, K-1, C); new: (B, C) -> (out (B, C), hist'), summed in f32."""
    window = torch.cat([hist, new[:, None, :]], dim=1)
    out = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b
    return F.silu(out).to(new.dtype), window[:, 1:, :]


def mamba2_step(cfg: ArchConfig, params, state, x, tp=None):
    """x: (B, d) one token -> (y (B, d), new state)."""
    s, inner, n_heads = _dims(cfg)
    z, px, pb, pc, dt_raw = tplib.project(tp, x, params, _PROJ)
    params = tplib.whole_leaves(tp, params, _CONV)
    xs, cx = _conv_step(state["conv_x"], px, params["conv_x"], params["conv_bx"])
    b, cb = _conv_step(state["conv_B"], pb, params["conv_B"], params["conv_bB"])
    c, cc = _conv_step(state["conv_C"], pc, params["conv_C"], params["conv_bC"])
    dt, log_da = _dt(params, dt_raw)
    da = torch.exp(log_da)                                           # (B,H)
    xhead = xs.reshape(-1, n_heads, s.head_dim).float()
    outer = torch.einsum("bn,bhp->bhnp", b.float(), xhead)
    ssm = da[:, :, None, None] * state["ssm"] + dt[:, :, None, None] * outer
    y = torch.einsum("bn,bhnp->bhp", c.float(), ssm)
    y = y + xhead * params["D"][None, :, None]
    y = y.reshape(-1, inner).to(x.dtype)
    new_state = {"ssm": ssm, "conv_x": cx, "conv_B": cb, "conv_C": cc}
    return _gate_out(cfg, params, y, z, tp), new_state


def mamba2_prefill_chunk(cfg: ArchConfig, params, state, x, *, chunk_len, active=None,
                         tp=None):
    """One prefill chunk resuming from each slot's saved state.

    x: (B, C, d), the chunk's block inputs; state: as ``init_mamba2_state``
    (conv_* hold the pre-conv inputs of the last K-1 consumed positions,
    ssm the (H, N, P) SSD state); chunk_len: (B,) valid tokens; active: (B,)
    bool. Returns (y (B, C, d), state').

    The chunk is ONE SSD chunk resumed from ``state``, as in the reference
    (the O(C²·H) decay matrix is bounded by the serving chunk). Ragged tails
    and inactive slots leave the state as it was: dt is zeroed past
    chunk_len (decay exp(0) = 1, contribution 0) and the conv-history
    gather at eff = 0 returns the old window bit for bit. Outputs past
    chunk_len are values the caller ignores.
    """
    s, inner, n_heads = _dims(cfg)
    bsz, c, _ = x.shape
    k = s.conv_dim
    eff = torch.broadcast_to(torch.as_tensor(chunk_len, device=x.device), (bsz,)).long()
    if active is not None:
        eff = torch.where(active.reshape(bsz), eff, 0)
    z, px, pb, pc, dt_raw = tplib.project(tp, x, params, _PROJ)
    params = tplib.whole_leaves(tp, params, _CONV)
    hist_idx = eff[:, None] + torch.arange(k - 1, device=x.device)   # (B, K-1)

    def conv_resume(hist, pre, w, b):
        # position t sees buf[t : t+K]: _causal_conv's left pad when the
        # history is zeros (a fresh slot)
        buf = torch.cat([hist.to(pre.dtype), pre], dim=1)
        out = F.silu(_conv_sum(buf, w, c) + b)
        new_hist = torch.gather(buf, 1, hist_idx[:, :, None].expand(-1, -1, buf.shape[2]))
        return out, new_hist.to(hist.dtype)

    xs, hx = conv_resume(state["conv_x"], px, params["conv_x"], params["conv_bx"])
    b, hb = conv_resume(state["conv_B"], pb, params["conv_B"], params["conv_bB"])
    cm, hc = conv_resume(state["conv_C"], pc, params["conv_C"], params["conv_bC"])
    dt = F.softplus(dt_raw.float() + params["dt_bias"])             # (B,C,H)
    valid = torch.arange(c, device=x.device)[None, :] < eff[:, None]
    dt = torch.where(valid[..., None], dt, 0.0)
    g = torch.cumsum(-torch.exp(params["A_log"]) * dt, dim=1)       # (B,C,H)

    xh = xs.reshape(bsz, c, n_heads, s.head_dim).float()
    bf, cf = b.float(), cm.float()
    cb = torch.einsum("bin,bjn->bij", cf, bf)
    causal = (torch.arange(c, device=x.device)[:, None]
              >= torch.arange(c, device=x.device)[None, :])[None, :, :, None]
    logw = g[:, :, None, :] - g[:, None, :, :]                      # (B,i,j,H)
    w = torch.exp(torch.where(causal, logw, float("-inf"))) * cb[..., None] * dt[:, None, :, :]
    y = torch.einsum("bijh,bjhp->bihp", w, xh)
    # inter-chunk: the resumed state seen through each position's decay
    y = y + torch.einsum("bin,bhnp->bihp", cf, state["ssm"]) * torch.exp(g)[..., None]
    # carry: S' = exp(G_last)·S + Σ_j exp(G_last - G_j) dt_j B_j ⊗ x_j
    decay_to_end = torch.exp(g[:, -1:, :] - g)
    sc = torch.einsum("bjh,bjn,bjhp->bhnp", decay_to_end * dt, bf, xh)
    ssm = torch.exp(g[:, -1, :])[:, :, None, None] * state["ssm"] + sc

    y = y + xh * params["D"][None, None, :, None]
    y = y.reshape(bsz, c, inner).to(x.dtype)
    new_state = {"ssm": ssm, "conv_x": hx, "conv_B": hb, "conv_C": hc}
    return _gate_out(cfg, params, y, z, tp), new_state
