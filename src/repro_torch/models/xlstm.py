"""xLSTM blocks, sLSTM and mLSTM (counterpart of ``repro/models/xlstm.py``;
arXiv:2405.04517, simplified as the reference simplifies it).

Both blocks use exponential gating with the max-stabiliser state m_t, which
starts at -inf and is guarded with ``isfinite`` as in the reference. Every
form runs the same recurrence as a loop over time, the reference's
``lax.scan``: sLSTM is sequential by nature (its recurrent weights R), and
the reference keeps mLSTM scan-based too. Decode is O(1) a token.

mLSTM (matrix memory, heads H, key/value dim P = d_model/H):
    C_t = f_t · C_{t-1} + i_t · (k_t v_tᵀ)      C: (P, P)
    n_t = f_t · n_{t-1} + i_t · k_t
    h_t = o_t ⊙ (C_tᵀ q_t) / max(|n_tᵀ q_t|, 1)

sLSTM (scalar memory a head-channel, recurrent gate inputs):
    c_t = f_t ⊙ c_{t-1} + i_t ⊙ z_t,  n_t = f_t ⊙ n_{t-1} + i_t
    h_t = o_t ⊙ c_t / n_t

State and gates are f32; ``b_if`` (mLSTM) and ``b`` (sLSTM) are f32 leaves in
every model. The functions take and return the state as a dict of the
reference's keys; the serving blocks write it into the engine's tensors in
place (``models/transformer.py``). The time loop is eager torch ops (a
hand-written recurrence kernel would be later work): a chunk of C tokens
is C steps of a few small kernels a layer.

Every function takes ``tp``, the mixer's ``runtime/tensor_parallel
.TensorParallel`` view over a mesh (None: whole weights): ``w_qkv``,
``w_if`` (its [i | f] columns), ``w_o`` and the sLSTM's ``['w']`` (its four
gates) are column products gathered whole, ``b_if`` and the sLSTM's
recurrent ``['r']`` (heads over 'model') are gathered once a call, outside
the loop over time, and ``out_proj`` is a row product.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import init_dense, rms_norm
from repro_torch.runtime import tensor_parallel as tplib


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ArchConfig, *, dtype, device):
    d, h = cfg.d_model, cfg.num_heads
    kw = dict(dtype=dtype, device=device)
    b_if = torch.cat([torch.zeros(h), 3.0 * torch.ones(h)]).to(device)
    return {
        "w_qkv": init_dense(gen, d, 3 * d, **kw),
        "w_if": init_dense(gen, d, 2 * h, scale=0.02, **kw),
        "b_if": b_if.float(),
        "w_o": init_dense(gen, d, d, **kw),
        "norm_w": torch.zeros(d, **kw),
        "out_proj": init_dense(gen, d, d, **kw),
    }


def _mlstm_gates(params, wif):
    """The gate projection (..., 2H) -> (i_tilde, f_tilde), each (..., H) in
    f32."""
    g = wif.float() + params["b_if"]
    h = g.shape[-1] // 2
    return g[..., :h], g[..., h:]


def init_mlstm_state(cfg: ArchConfig, bsz: int, *, device):
    h = cfg.num_heads
    p = cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((bsz, h, p, p), **f32),
            "n": torch.zeros((bsz, h, p), **f32),
            "m": torch.full((bsz, h), float("-inf"), **f32)}


def _mlstm_update(state, q, k, v, it, ft):
    """One stabilised step. q/k/v: (B, H, P) f32; it/ft: (B, H)."""
    m = state["m"]
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.where(torch.isfinite(m), torch.exp(ft + m - m_new), 0.0)
    qs = q * float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))  # f32, as the reference
    c = f_p[..., None, None] * state["C"] + i_p[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_p[..., None] * state["n"] + i_p[..., None] * k
    hq = torch.einsum("bhpq,bhp->bhq", c, qs)
    denom = torch.clamp(torch.einsum("bhp,bhp->bh", n, qs).abs(), min=1.0)
    return {"C": c, "n": n, "m": m_new}, hq / denom[..., None]


def _mlstm_inputs(cfg: ArchConfig, params, x, tp=None):
    """q, k, v (B, L, H, P), the gates (B, L, H) and o (B, L, d), all f32."""
    b, L, d = x.shape
    h = cfg.num_heads
    qkv, wif, wo = tplib.project(tp, x, params, ("w_qkv", "w_if", "w_o"))
    q, k, v = (t.reshape(b, L, h, d // h) for t in torch.split(qkv.float(), d, dim=-1))
    it, ft = _mlstm_gates(tplib.whole_leaves(tp, params, ("b_if",)), wif)
    o = torch.sigmoid(wo.float())
    return (q, k, v, it, ft), o


def _mlstm_out(cfg: ArchConfig, params, o, hs, dtype, tp=None):
    y = (o * hs).to(dtype)
    y = rms_norm(y, params["norm_w"], cfg.norm_eps)
    return tplib.out_row(tp, y, params, "out_proj")


def _scan(step_fn, state, xs, valid=None):
    """The recurrence over time: xs are (B, L, ...) per-step inputs; returns
    (final state, h (B, L, ...)). With ``valid`` (B, L) bool, a masked step
    leaves every leaf as it was (``torch.where`` picks the old leaf), so a
    chunk resumed this way gives the bits of one unmasked pass."""
    hs = []
    for t in range(xs[0].shape[1]):
        new, h_t = step_fn(state, [x[:, t] for x in xs])
        if valid is not None:
            keep = valid[:, t]
            new = {key: torch.where(keep.reshape((-1,) + (1,) * (val.dim() - 1)), val,
                                    state[key])
                   for key, val in new.items()}
        state = new
        hs.append(h_t)
    return state, torch.stack(hs, dim=1)


def _valid(chunk_len, active, b: int, c: int, device):
    eff = torch.broadcast_to(torch.as_tensor(chunk_len, device=device), (b,)).long()
    if active is not None:
        eff = torch.where(active.reshape(b), eff, 0)
    return torch.arange(c, device=device)[None, :] < eff[:, None]      # (B, C)


def _mlstm_step_fn(state, inp):
    return _mlstm_update(state, *inp)


def mlstm_forward_with_state(cfg: ArchConfig, params, x, state=None, valid=None,
                             tp=None):
    """x: (B, L, d) -> (y (B, L, d), final state), from ``state`` (a fresh
    one if None), steps masked where ``valid`` (B, L) is False."""
    b, L, d = x.shape
    xs, o = _mlstm_inputs(cfg, params, x, tp)
    if state is None:
        state = init_mlstm_state(cfg, b, device=x.device)
    state, hs = _scan(_mlstm_step_fn, state, xs, valid)
    return _mlstm_out(cfg, params, o, hs.reshape(b, L, d), x.dtype, tp), state


def mlstm_forward(cfg: ArchConfig, params, x, tp=None):
    """x: (B, L, d) -> (B, L, d)."""
    return mlstm_forward_with_state(cfg, params, x, tp=tp)[0]


def mlstm_prefill_chunk(cfg: ArchConfig, params, state, x, *, chunk_len, active=None,
                        tp=None):
    """One prefill chunk resuming from each slot's saved (C, n, m). x: (B, C,
    d); chunk_len: (B,) valid tokens; active: (B,) bool. Returns (y (B, C,
    d), state'). Steps past chunk_len leave the state as it was."""
    b, c, _ = x.shape
    return mlstm_forward_with_state(cfg, params, x, state,
                                    _valid(chunk_len, active, b, c, x.device), tp)


def mlstm_step(cfg: ArchConfig, params, state, x, tp=None):
    """x: (B, d) -> (y (B, d), state')."""
    y, state = mlstm_forward_with_state(cfg, params, x[:, None], state, tp=tp)
    return y[:, 0], state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ArchConfig, *, dtype, device):
    d, h = cfg.d_model, cfg.num_heads
    p = d // h
    kw = dict(dtype=dtype, device=device)
    r = torch.randn((h, p, 4 * p), generator=gen, dtype=torch.float32, device=device)
    return {
        "w": init_dense(gen, d, 4 * d, **kw),
        "r": (r / math.sqrt(p)).to(dtype),
        "b": torch.zeros(4 * d, dtype=torch.float32, device=device),
        "norm_w": torch.zeros(d, **kw),
        "out_proj": init_dense(gen, d, d, **kw),
    }


def init_slstm_state(cfg: ArchConfig, bsz: int, *, device):
    h = cfg.num_heads
    p = cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda: torch.zeros((bsz, h, p), **f32)
    return {"c": z(), "n": z(), "m": torch.full((bsz, h, p), float("-inf"), **f32),
            "h": z()}


def _slstm_step_inner(cfg: ArchConfig, params, state, wx):
    """wx: (B, 4d) the step's W x_t. Returns (state', h_t (B, H, P))."""
    h = cfg.num_heads
    p = cfg.d_model // h
    b = wx.shape[0]
    rh = torch.einsum("bhp,hpq->bhq", state["h"], params["r"].float())
    g = wx.float().reshape(b, h, 4 * p) + rh + params["b"].reshape(h, 4 * p)
    z_t, i_t, f_t, o_t = torch.split(g, p, dim=-1)
    z_t = torch.tanh(z_t)
    o_t = torch.sigmoid(o_t)
    m = state["m"]
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.where(torch.isfinite(m), torch.exp(f_t + m - m_new), 0.0)
    c = f_p * state["c"] + i_p * z_t
    n = f_p * state["n"] + i_p
    h_t = o_t * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h_t}, h_t


def slstm_forward_with_state(cfg: ArchConfig, params, x, state=None, valid=None,
                             tp=None):
    """x: (B, L, d) -> (y (B, L, d), final state), as the mLSTM form."""
    b, L, d = x.shape
    (wx,) = tplib.project(tp, x, params, ("w",))
    params = tplib.whole_leaves(tp, params, ("r",))
    if state is None:
        state = init_slstm_state(cfg, b, device=x.device)
    state, hs = _scan(lambda st, inp: _slstm_step_inner(cfg, params, st, inp[0]),
                      state, [wx], valid)
    y = rms_norm(hs.reshape(b, L, d).to(x.dtype), params["norm_w"], cfg.norm_eps)
    return tplib.out_row(tp, y, params, "out_proj"), state


def slstm_forward(cfg: ArchConfig, params, x, tp=None):
    return slstm_forward_with_state(cfg, params, x, tp=tp)[0]


def slstm_prefill_chunk(cfg: ArchConfig, params, state, x, *, chunk_len, active=None,
                        tp=None):
    """As ``mlstm_prefill_chunk``, for the sLSTM state (c, n, m, h)."""
    b, c, _ = x.shape
    return slstm_forward_with_state(cfg, params, x, state,
                                    _valid(chunk_len, active, b, c, x.device), tp)


def slstm_step(cfg: ArchConfig, params, state, x, tp=None):
    y, state = slstm_forward_with_state(cfg, params, x[:, None], state, tp=tp)
    return y[:, 0], state
