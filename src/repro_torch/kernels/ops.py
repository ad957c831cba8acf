"""Dispatch for the ported kernels: counterpart of ``repro/kernels/ops.py``.

Where the work runs follows from where the tensors lie, and nothing else:

  * CPU tensors go to the plain PyTorch versions in ``repro_torch/kernels/ref.py``;
  * CUDA tensors go to the hand-written kernels in ``kernels/csrc/``, or
    the call raises (no plain fallback on the card).

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, so a run can show that it went through the kernels.
Importing this module needs neither ``nvcc`` nor a card: the kernels are
built at their first launch (``repro_torch/kernels/_build.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LAUNCHES = {"flash_attention": 0, "page_score": 0, "paged_attention": 0,
            "chunk_attention": 0, "chunk_attention_paged": 0,
            "paged_attention_partial": 0, "combine_partials": 0,
            "flash_attention_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128, 256)  # 80: zamba2-2.7b; 256: gemma3-1b
_MAX_GROUP = 16  # qwen3-moe: 64 query heads over 4 kv heads
_MAX_TILE_GROUP = 64  # the bf16 chunk kernels' q tile: 64 rows
# paged_attention's split-KV grid: one block on each of the H100's 132 SMs,
# but at least this many keys in a split
_SPLIT_BLOCKS = 132
_SPLIT_MIN_KEYS = 128
# csrc/paged_attention.cu's splits: contiguous unit ranges, merged; page
# stripes of one slot list, merged; page stripes of per-stripe lists, raw
# partials out
_RANGE, _COPLACE, _PARTIALS = 0, 1, 2
# a stripe's list of 32-token units lives in shared memory beside the ring
_MAX_STRIPE_UNITS = 16384
# page_select: a (batch, kv head) row's keys live in one block's shared
# memory (64 KB at the limit, 512k tokens at page 32), beside its K
# winners (K^2 compares place them); the row is scored by a thread-block
# cluster of this many blocks (1 to 8, the portable cluster size)
_MAX_SELECT_PAGES = 16384
_MAX_SELECT_K = 1024
_SELECT_BLOCKS = 8
# per (device, stream), zeroed once when made and left zero by each launch
# (the kernels' last blocks reset them): paged_attention's int32 arrival
# counters, one per (batch, kv head), and the bf16 flash kernel's two
# work-item counters. Launches on one stream never overlap; launches that
# overlap on two streams take separate counters
_COUNTERS: dict = {}
_SCHEDULES: dict = {}
# the backward's arrival counters, one per (batch, kv head), kept like them
_ARRIVALS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors lie on {sorted(kinds)}; expected all on the CPU "
                     f"or all on one CUDA device")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operands(name, tensors, dtype=None):
    for t in tensors:
        _require(t.is_contiguous(), f"{name}: operands must be contiguous")
        if dtype is not None:
            _require(t.dtype == dtype,
                     f"{name}: expected {dtype}, got {t.dtype}")


def _scale(d: int) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_tensor_core(name, g, tensors):
    """What the bf16 chunk kernels' TMA and 64-row q tiles take: 16-byte
    aligned operands and a GQA group of at most 64 (a tile holds 64 // g
    whole chunk positions)."""
    _require(all(t.data_ptr() % 16 == 0 for t in tensors),
             f"{name}: bf16 operands must be 16-byte aligned")
    _require(1 <= g <= _MAX_TILE_GROUP,
             f"{name}: GQA group {g} above {_MAX_TILE_GROUP} for the bf16 kernel")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sink: int = 0, q_offset: int = 0):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D).

    On the card the dtype picks the kernel: bf16 runs on the tensor cores
    (``csrc/flash_attention_sm90.cu``: wgmma fed by TMA, P rounded to bf16
    before P·V, one persistent block an SM taking work items from a
    counter kept per stream), f32 on the FMA units (``csrc/flash_attention.cu``:
    single TF32 products would not hold f32's tolerance, and the serving
    path is bf16; the backward's f32 route holds it on the tensor cores as
    3xTF32). Either raises if its kernel fails to build or launch. Where
    grad mode is on and an input requires grad, the call is an autograd
    node: its forward also saves each row's log-sum-exp, and its backward is
    ``flash_attention_bwd``'s kernels; otherwise (serving, ``no_grad``,
    inference) it is the forward kernel alone, which writes no log-sum-exp.
    On the CPU, autograd differentiates the plain version, as the JAX
    package differentiates its plain body."""
    if _on_cpu(q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        sink=sink, q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, sink, q_offset)
    return _flash_forward(q, k, v, causal, window, sink, q_offset)[0]


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        sink: int = 0, q_offset: int = 0):
    """``flash_attention``'s output and each row's log-sum-exp L (B, Hq, Sq)
    f32 of its scaled, masked scores (natural log, -inf for a row with no
    allowed key): what the autograd forward saves for
    ``flash_attention_bwd``. On the card one launch of the forward kernel,
    which writes L beside the output (the output bit for bit what
    ``flash_attention`` gives); on the CPU the plain versions."""
    if _on_cpu(q, k, v):
        mask = dict(causal=causal, window=window, sink=sink, q_offset=q_offset)
        return (_ref.flash_attention_ref(q, k, v, **mask),
                _ref.flash_attention_lse_ref(q, k, **mask))
    return _flash_forward(q, k, v, causal, window, sink, q_offset, with_lse=True)


def _check_flash(name, q, k, v, window, sink, q_offset):
    b, sq, hq, d = q.shape
    _require(k.dim() == 4 and k.shape == v.shape and k.shape[0] == b
             and k.shape[3] == d, f"{name}: k/v must be (B, Sk, Hkv, D)")
    _require(q.dtype in _DTYPES, f"{name}: dtype {q.dtype} not supported")
    _check_operands(name, (q, k, v), q.dtype)
    _require(d in _HEAD_DIMS, f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % k.shape[2] == 0, f"{name}: Hq must be a multiple of Hkv")
    _require(q_offset >= 0 and window >= 0 and sink >= 0,
             f"{name}: q_offset, window and sink must be >= 0")
    return b, sq, k.shape[1], hq, k.shape[2], d


def _flash_forward(q, k, v, causal, window, sink, q_offset, with_lse=False):
    """One forward launch: (output, the rows' log-sum-exp or None)."""
    b, sq, sk, hq, hkv, d = _check_flash("flash_attention", q, k, v, window, sink,
                                         q_offset)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lse_ptr = lse.data_ptr() if with_lse else None
    lib = _build.library()
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            # TMA reads q, k and v through tensor maps: 16-byte aligned bases
            _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                     "flash_attention: bf16 operands must be 16-byte aligned")
            err = lib.h2eal_flash_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                _counters(q, 2, _SCHEDULES).data_ptr(), b, sq, sk, hq, hkv, d,
                int(causal), window, sink, q_offset, _scale(d), _stream(q))
        else:
            err = lib.h2eal_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, b, sq,
                sk, hq, hkv, d, int(causal), window, sink, q_offset, _scale(d), _stream(q))
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and ``flash_attention_bwd``'s kernels as its
    backward (q, k, v, the output and the rows' log-sum-exp saved)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sink, q_offset):
        o, lse = _flash_forward(q, k, v, causal, window, sink, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, sink=sink, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse, **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, window: int = 0,
                        sink: int = 0, q_offset: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention`` with the same mask
    arguments, from its inputs, its output o, the rows' log-sum-exp ``lse``
    that ``flash_attention_lse`` gives beside o, and the output's gradient do
    (each like q), in the inputs' dtype.

    On the card: one call of ``csrc/flash_attention_bwd.cu``, two launches
    (dq with each row's Δ = Σ dO∘o, then dk and dv; P recomputed in f32 from
    q, k and lse; no atomic adds into the sums, so their order is fixed),
    raising if a kernel fails to build or launch. The route is a rule by
    dtype and head_dim: f32 at head_dim <= 128 on the tensor cores as
    3xTF32 (mma.sync, each product lo·hi + hi·lo + hi·hi of tf32 halves);
    bf16 at head_dim <= 128 on wgmma fed by TMA
    (``csrc/flash_attention_bwd_sm90.cu``, P and dS split into two bf16
    operands each); head_dim 256, either dtype, on the FMA units (a key
    tile's dk and dv do not fit a warpgroup's registers there; no training
    path runs it). Under a window with sink keys the first key tile, which
    every q tile sees, is cut into runs whose partial sums the last run adds
    in a fixed order. On the CPU the plain version, which computes its own
    softmax from q and k (``lse`` unused)."""
    if _on_cpu(q, k, v, o, do, lse):
        return _ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window,
                                            sink=sink, q_offset=q_offset)
    b, sq, sk, hq, hkv, d = _check_flash("flash_attention_bwd", q, k, v, window, sink,
                                         q_offset)
    _require(o.shape == q.shape and do.shape == q.shape,
             "flash_attention_bwd: o and do must be shaped like q")
    _check_operands("flash_attention_bwd", (o, do), q.dtype)
    _require(lse.shape == (b, hq, sq) and lse.dtype == torch.float32
             and lse.is_contiguous(), "flash_attention_bwd: lse must be (B, Hq, Sq) f32")
    # cp.async and TMA read the operands in 16-byte pieces
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, o, do)),
             "flash_attention_bwd: operands must be 16-byte aligned")
    lib = _build.library()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    # key tile 0's partial sums where a window with sink keys cuts its walk
    n_parts = lib.h2eal_flash_attention_bwd_parts(_DTYPES[q.dtype], d, b, sq, hkv, window,
                                                  sink)
    parts = torch.empty(n_parts, dtype=torch.float32, device=q.device) if n_parts else None
    with torch.cuda.device(q.device):
        err = lib.h2eal_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            parts.data_ptr() if n_parts else None,
            _counters(q, b * hkv, _ARRIVALS).data_ptr(), _DTYPES[q.dtype], b, sq, sk, hq,
            hkv, d, int(causal), window, sink, q_offset, _scale(d), _stream(q))
    _build.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def paged_splits(b: int, hkv: int, t: int) -> int:
    """Splits of paged_attention's key axis: the most n with b·hkv·n <= 132
    blocks (one a SM: a block holds a 128 KB ring), capped so that a split
    keeps at least 128 keys; 1 where b·hkv already fills the card or
    t < 256. Split s takes the 32-token units [s·U/n, (s+1)·U/n)."""
    return max(1, min(_SPLIT_BLOCKS // (b * hkv), t // _SPLIT_MIN_KEYS))


def _counters(t: torch.Tensor, n: int, store=_COUNTERS) -> torch.Tensor:
    key = (t.device, _stream(t))
    buf = store.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=t.device)
        store[key] = buf
    return buf


def _check_decode(name, q, k, v, valid, hkv, t):
    b, hq, d = q.shape
    _require(valid.shape == (b, hkv, t) and valid.dtype == torch.bool,
             f"{name}: valid must be (B, Hkv, {t}) bool")
    _require(q.dtype in _DTYPES, f"{name}: dtype {q.dtype} not supported")
    _check_operands(name, (q, k, v), q.dtype)
    _check_operands(name, (valid,))
    _require(d in _HEAD_DIMS, f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hkv == 0 and 1 <= hq // hkv <= _MAX_GROUP,
             f"{name}: GQA group must divide Hq and be <= {_MAX_GROUP}")
    # q is read, and k/v copied in bulk, in 16-byte pieces
    _require(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
             f"{name}: q, k and v must be 16-byte aligned")


def _paged_launch(q, k, v, slots, valid, t, page, c, kv_stride, *, mode=_RANGE,
                  n=None):
    """One launch of csrc/paged_attention.cu; ``kv_stride`` elements of k/v
    per (batch, kv head). Split over ``paged_splits`` unit ranges (range
    mode) or over ``n`` page stripes; merged by the last block of a (batch,
    kv head) through scratch made here, or, in the partials mode, the
    stripes' raw (m, l, o) returned."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    n = paged_splits(b, hkv, t) if mode == _RANGE else n
    rows = n * b * hq
    if mode == _PARTIALS:
        m = torch.empty((n, b, hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        o = torch.empty((n, b, hq, d), dtype=torch.float32, device=q.device)
        outs = (None, o.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        out = torch.empty_like(q)
        part = torch.empty(rows * (d + 2) if n > 1 else 4, dtype=torch.float32,
                           device=q.device)
        po = part.data_ptr()  # o first: 16-byte aligned for the merge's loads
        outs = (out.data_ptr(), po, po + 4 * rows * d, po + 4 * rows * (d + 1))
    name = "paged_attention" if mode == _RANGE else "paged_attention_partial"
    with torch.cuda.device(q.device):
        err = _build.library().h2eal_paged_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if slots is None else slots.data_ptr(), valid.data_ptr(), *outs,
            _counters(q, b * hkv).data_ptr(), _DTYPES[q.dtype], b, hkv, hq // hkv, d,
            t, page, c, kv_stride, n, mode, _scale(d), _stream(q))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return (m, l, o) if mode == _PARTIALS else out


def paged_attention(q, k, v, valid):
    """q: (B, Hq, D); k/v: (B, Hkv, T, D); valid: (B, Hkv, T) bool ->
    (B, Hq, D). On the card: one launch of the split-KV kernel of
    ``csrc/paged_attention.cu`` on rows of 32 keys."""
    if _on_cpu(q, k, v, valid):
        return _ref.paged_attention_ref(q, k, v, valid)
    b, _, d = q.shape
    _require(k.dim() == 4 and k.shape == v.shape and k.shape[0] == b
             and k.shape[3] == d, "paged_attention: k/v must be (B, Hkv, T, D)")
    hkv, t = k.shape[1], k.shape[2]
    _check_decode("paged_attention", q, k, v, valid, hkv, t)
    return _paged_launch(q, k, v, None, valid, t, 32, max(1, -(-t // 32)), t * d)


def _check_pages(name, q, k_pages, v_pages, slots, stripe_lists=False):
    """The page-table operands: (hkv, c, p, n) of k/v_pages (B, Hkv, C, P, D)
    and slots (B, Hkv, N) int32, or (S, B, Hkv, N) with ``stripe_lists``."""
    b, _, d = q.shape
    _require(k_pages.dim() == 5 and k_pages.shape == v_pages.shape
             and k_pages.shape[0] == b and k_pages.shape[4] == d,
             f"{name}: k/v_pages must be (B, Hkv, C, P, D)")
    hkv, c, p = k_pages.shape[1:4]
    dims, shape = (4, "(S, B, Hkv, N)") if stripe_lists else (3, "(B, Hkv, N)")
    _require(slots.dim() == dims and slots.shape[-3:-1] == (b, hkv)
             and slots.dtype == torch.int32, f"{name}: slots must be {shape} int32")
    _check_operands(name, (slots,))
    return hkv, c, p, slots.shape[-1]


def paged_attention_pages(q, k_pages, v_pages, slots, valid):
    """Decode attention over the pages ``slots`` names, read in place: q
    (B, Hq, D); k/v_pages (B, Hkv, C, P, D); slots (B, Hkv, N) int32, clamped
    into [0, C) as ``ref.gather_pages`` clamps them; valid (B, Hkv, N*P)
    bool -> (B, Hq, D), ``paged_attention`` of the gathered buffer. On the
    card: one launch of the same kernel, addressing K/V through the page
    table (no gathered copy); a page with no valid token is not read.
    Counts under ``LAUNCHES["paged_attention"]``: the same TPU kernel."""
    if _on_cpu(q, k_pages, v_pages, slots, valid):
        return _ref.paged_attention_pages_ref(q, k_pages, v_pages, slots, valid)
    hkv, c, p, n = _check_pages("paged_attention_pages", q, k_pages, v_pages, slots)
    _check_decode("paged_attention_pages", q, k_pages, v_pages, valid, hkv, n * p)
    return _paged_launch(q, k_pages, v_pages, slots, valid, n * p, p, c, c * p * q.shape[2])


def _check_stripe_units(name, t):
    _require(-(-t // 32) <= _MAX_STRIPE_UNITS,
             f"{name}: {t} attended tokens, above {32 * _MAX_STRIPE_UNITS}")


def paged_attention_coplace(q, k_pages, v_pages, slots, valid, shards: int):
    """The retrieval heads' decode under co-placement over ``shards`` page
    stripes (stripe s owns the page slots [s·C/S, (s+1)·C/S)): q (B, Hq, D);
    k/v_pages (B, Hkv, C, P, D); the unsplit attended slots (B, Hkv, N)
    int32 and validity (B, Hkv, N*P) bool -> (B, Hq, D) in q's dtype:
    ``combine_partials`` of each stripe's ``paged_attention_partial``
    (``ref.stripe_slots``), cast to q's dtype. On the card: one launch of
    ``csrc/paged_attention.cu`` over (S, Hkv, B) blocks, each stripe's block
    walking the pages it owns, the last block of a (batch, kv head) merging
    the stripes in stripe order. Counts under
    ``LAUNCHES["paged_attention_partial"]``."""
    if _on_cpu(q, k_pages, v_pages, slots, valid):
        return _ref.paged_attention_coplace_ref(q, k_pages, v_pages, slots, valid, shards)
    name = "paged_attention_coplace"
    hkv, c, p, n = _check_pages(name, q, k_pages, v_pages, slots)
    _check_decode(name, q, k_pages, v_pages, valid, hkv, n * p)
    _require(shards >= 1 and c % shards == 0,
             f"{name}: {c} pages do not divide into {shards} stripes")
    _check_stripe_units(name, n * p)
    return _paged_launch(q, k_pages, v_pages, slots, valid, n * p, p, c,
                         c * p * q.shape[2], mode=_COPLACE, n=shards)


def page_score(q, tau_min, tau_max):
    """q: (B, Hq, D); tau_min/max: (B, Hkv, C, D) f32 -> (B, Hkv, C) f32."""
    if _on_cpu(q, tau_min, tau_max):
        return _ref.page_score_ref(q, tau_min, tau_max)
    b, hq, d = q.shape
    _require(tau_min.dim() == 4 and tau_min.shape == tau_max.shape
             and tau_min.shape[0] == b and tau_min.shape[3] == d,
             "page_score: tau must be (B, Hkv, C, D)")
    hkv, c = tau_min.shape[1], tau_min.shape[2]
    _require(q.dtype in _DTYPES, f"page_score: dtype {q.dtype} not supported")
    _check_operands("page_score", (q,))
    _check_operands("page_score", (tau_min, tau_max), torch.float32)
    _require(d in _HEAD_DIMS, f"page_score: head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hkv == 0 and 1 <= hq // hkv <= _MAX_GROUP,
             f"page_score: GQA group must divide Hq and be <= {_MAX_GROUP}")
    out = torch.empty((b, hkv, c), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library().h2eal_page_score(
            q.data_ptr(), tau_min.data_ptr(), tau_max.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hkv, c, hq // hkv, d, _stream(q))
    _build.check(err, "page_score")
    LAUNCHES["page_score"] += 1
    return out


def page_select(q, tau_min, tau_max, page_start, ctx, sel_prev, imp_prev, need=None,
                *, sink: int, local: int, page: int, top_k: int,
                minus_one_masked: bool = False):
    """A retrieval layer's whole select step, ``ref.page_select_ref``: q
    (B, Hq, D); tau_min/max (B, Hkv, C, D) f32; page_start (B, Hkv, C)
    int32; ctx an int or a (B,) int32 tensor; sel_prev (B, Hkv, K) int32;
    imp_prev (B, Hkv, C) f32; need None or (B,) bool -> new tensors (sel
    (B, Hkv, K) int32, imp (B, Hkv, C) f32): the selectable pages scored,
    the stable top-K, the importance, the previous ones kept where ``need``
    is false. ``minus_one_masked`` (the coplace_shmap layout) turns
    selected masked pages into -1; the default layout keeps them as fill.

    On the card: one launch of ``csrc/page_score.cu``'s select mode, a
    cluster of ``_SELECT_BLOCKS`` blocks a (batch, kv head) row, reading τ
    of the selectable pages only and ctx from the card. Counts under
    ``LAUNCHES["page_score"]``: the same TPU kernel."""
    name = "page_select"
    tensors = [q, tau_min, tau_max, page_start, sel_prev, imp_prev]
    tensors += [t for t in (ctx, need) if isinstance(t, torch.Tensor)]
    kw = dict(sink=sink, local=local, page=page, top_k=top_k,
              minus_one_masked=minus_one_masked)
    if _on_cpu(*tensors):
        return _ref.page_select_ref(q, tau_min, tau_max, page_start, ctx, sel_prev,
                                    imp_prev, need, **kw)
    b, hq, d = q.shape
    _require(tau_min.dim() == 4 and tau_min.shape == tau_max.shape
             and tau_min.shape[0] == b and tau_min.shape[3] == d,
             f"{name}: tau must be (B, Hkv, C, D)")
    hkv, c = tau_min.shape[1], tau_min.shape[2]
    _require(q.dtype in _DTYPES, f"{name}: dtype {q.dtype} not supported")
    _require(d in _HEAD_DIMS, f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hkv == 0 and 1 <= hq // hkv <= _MAX_GROUP,
             f"{name}: GQA group must divide Hq and be <= {_MAX_GROUP}")
    _require(1 <= c <= _MAX_SELECT_PAGES,
             f"{name}: {c} pages, above the limit of {_MAX_SELECT_PAGES} (a row's "
             f"keys live in shared memory)")
    _require(1 <= top_k <= _MAX_SELECT_K,
             f"{name}: top_k {top_k} not in [1, {_MAX_SELECT_K}]")
    _require(page_start.shape == (b, hkv, c) and page_start.dtype == torch.int32,
             f"{name}: page_start must be (B, Hkv, C) int32")
    _require(sel_prev.shape == (b, hkv, top_k) and sel_prev.dtype == torch.int32,
             f"{name}: sel_prev must be (B, Hkv, top_k) int32")
    _require(imp_prev.shape == (b, hkv, c) and imp_prev.dtype == torch.float32,
             f"{name}: imp_prev must be (B, Hkv, C) f32")
    ctx_t = ctx if isinstance(ctx, torch.Tensor) else None
    _require(ctx_t is None or (ctx_t.shape == (b,) and ctx_t.dtype == torch.int32),
             f"{name}: ctx must be an int or a (B,) int32 tensor")
    _require(need is None or (need.shape == (b,) and need.dtype == torch.bool),
             f"{name}: need must be None or (B,) bool")
    _check_operands(name, (q,))
    _check_operands(name, (tau_min, tau_max, imp_prev), torch.float32)
    _check_operands(name, [page_start, sel_prev] + tensors[6:])
    # τ rows are read in 16-byte pieces
    _require(tau_min.data_ptr() % 16 == 0 and tau_max.data_ptr() % 16 == 0,
             f"{name}: tau must be 16-byte aligned")
    sel = torch.empty_like(sel_prev)
    imp = torch.empty_like(imp_prev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        err = _build.library().h2eal_page_select(
            q.data_ptr(), tau_min.data_ptr(), tau_max.data_ptr(), page_start.data_ptr(),
            ptr(ctx_t), 0 if ctx_t is not None else int(ctx), sel_prev.data_ptr(),
            imp_prev.data_ptr(), ptr(need), sel.data_ptr(), imp.data_ptr(),
            _DTYPES[q.dtype], b, hkv, c, hq // hkv, d, -(-sink // page) if sink else 0,
            local, page, top_k, int(minus_one_masked), _SELECT_BLOCKS, _stream(q))
    _build.check(err, name)
    LAUNCHES["page_score"] += 1
    return sel, imp


def chunk_attention(q, k, v, valid):
    """q: (B, Cq, Hq, D); k/v: (B, Hkv, T, D); valid: (B, Hkv, Cq, T) bool
    -> (B, Cq, Hq, D); a row with no valid key gives 0.

    On the card the dtype picks the kernel, as for ``flash_attention``:
    bf16 runs on the tensor cores (``csrc/chunk_attention_sm90.cu``), f32
    on the FMA units (``csrc/chunk_attention.cu``)."""
    if _on_cpu(q, k, v, valid):
        return _ref.chunk_attention_ref(q, k, v, valid)
    b, cq, hq, d = q.shape
    _require(k.dim() == 4 and k.shape == v.shape and k.shape[0] == b
             and k.shape[3] == d, "chunk_attention: k/v must be (B, Hkv, T, D)")
    hkv, t = k.shape[1], k.shape[2]
    _require(valid.shape == (b, hkv, cq, t) and valid.dtype == torch.bool,
             "chunk_attention: valid must be (B, Hkv, Cq, T) bool")
    _require(q.dtype in _DTYPES, f"chunk_attention: dtype {q.dtype} not supported")
    _check_operands("chunk_attention", (q, k, v), q.dtype)
    _check_operands("chunk_attention", (valid,))
    _require(d in _HEAD_DIMS, f"chunk_attention: head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hkv == 0, "chunk_attention: Hq must be a multiple of Hkv")
    g = hq // hkv
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            _check_tensor_core("chunk_attention", g, (q, k, v))
            err = lib.h2eal_chunk_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                out.data_ptr(), b, cq, hkv, t, g, d, _scale(d), _stream(q))
        else:
            err = lib.h2eal_chunk_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                out.data_ptr(), b, cq, hkv, t, g, d, _scale(d), _stream(q))
    _build.check(err, "chunk_attention")
    LAUNCHES["chunk_attention"] += 1
    return out


def chunk_attention_paged(q, k_pages, v_pages, page_start, start, k_new, v_new):
    """Chunked-prefill retrieval attention over the pre-append paged cache
    with the page gather fused. q: (B, Cq, Hq, D); k/v_pages: (B, Hr, C, P,
    D); page_start: (B, Hr, C) int32; start: (B,) int32; k/v_new: (B, Cq,
    Hr, D) -> (B, Cq, Hq, D). The chunk KV is cast to the cache dtype first,
    on both routes, so the chunk attends exactly what a post-append read
    would return. On the card bf16 runs on the tensor cores
    (``csrc/chunk_attention_sm90.cu``), f32 on the FMA units."""
    k_new = k_new.to(k_pages.dtype)
    v_new = v_new.to(v_pages.dtype)
    if _on_cpu(q, k_pages, v_pages, page_start, start, k_new, v_new):
        return _ref.chunk_attention_paged_ref(q, k_pages, v_pages, page_start,
                                              start, k_new, v_new)
    b, cq, hq, d = q.shape
    _require(k_pages.dim() == 5 and k_pages.shape == v_pages.shape
             and k_pages.shape[0] == b and k_pages.shape[4] == d,
             "chunk_attention_paged: k/v_pages must be (B, Hr, C, P, D)")
    hr, c, p = k_pages.shape[1:4]
    _require(page_start.shape == (b, hr, c) and page_start.dtype == torch.int32,
             "chunk_attention_paged: page_start must be (B, Hr, C) int32")
    _require(start.shape == (b,) and start.dtype == torch.int32,
             "chunk_attention_paged: start must be (B,) int32")
    _require(k_new.shape == (b, cq, hr, d) and v_new.shape == k_new.shape,
             "chunk_attention_paged: k/v_new must be (B, Cq, Hr, D)")
    _require(q.dtype in _DTYPES,
             f"chunk_attention_paged: dtype {q.dtype} not supported")
    _check_operands("chunk_attention_paged", (q, k_pages, v_pages, k_new, v_new),
                    q.dtype)
    _check_operands("chunk_attention_paged", (page_start, start))
    _require(d in _HEAD_DIMS,
             f"chunk_attention_paged: head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hr == 0, "chunk_attention_paged: Hq must be a multiple of Hr")
    g = hq // hr
    out = torch.empty_like(q)
    lib = _build.library()
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_start.data_ptr(),
            start.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), b, cq,
            hr, c, p, g, d, _scale(d), _stream(q))
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            _check_tensor_core("chunk_attention_paged", g,
                               (q, k_pages, v_pages, k_new, v_new))
            err = lib.h2eal_chunk_attention_paged_bf16(*args)
        else:
            err = lib.h2eal_chunk_attention_paged(*args)
    _build.check(err, "chunk_attention_paged")
    LAUNCHES["chunk_attention_paged"] += 1
    return out


def paged_attention_partial(q, k_pages, v_pages, slots, valid):
    """Partial decode attention of each page stripe, page gather fused.

    q: (B, Hq, D); k/v_pages: (B, Hkv, C, P, D); slots: (S, B, Hkv, N)
    int32 page slots of each stripe, -1 where the stripe attends none;
    valid: (S, B, Hkv, N*P) bool. Returns (m (S, B, Hq), l (S, B, Hq),
    o (S, B, Hq, D)), f32: ``paged_attention_partial_ref`` of each stripe's
    gathered buffer; a row with no valid token gives (-1e30, 0, 0). On the
    card: one launch of ``csrc/paged_attention.cu`` over (S, Hkv, B)
    blocks, each walking the slots >= 0 of its stripe's list."""
    if _on_cpu(q, k_pages, v_pages, slots, valid):
        return _ref.paged_attention_partial_pages_ref(q, k_pages, v_pages, slots,
                                                      valid)
    name = "paged_attention_partial"
    hkv, c, p, n = _check_pages(name, q, k_pages, v_pages, slots, stripe_lists=True)
    s, b = slots.shape[:2]
    _require(valid.shape == (s, b, hkv, n * p) and valid.dtype == torch.bool,
             f"{name}: valid must be (S, B, Hkv, N*P) bool")
    _check_decode(name, q, k_pages, v_pages, valid[0], hkv, n * p)
    _check_operands(name, (valid,))
    _check_stripe_units(name, n * p)
    return _paged_launch(q, k_pages, v_pages, slots, valid, n * p, p, c,
                         c * p * q.shape[2], mode=_PARTIALS, n=s)


def combine_partials(m, l, o):
    """m/l: (N, B, Hq) f32; o: (N, B, Hq, D) f32, stacked partials ->
    (B, Hq, D) f32: the global max, rescale, sum, divide by max(l, 1e-30);
    a row empty on every partial gives 0."""
    if _on_cpu(m, l, o):
        return _ref.combine_partials_ref(m, l, o)
    _require(m.dim() == 3 and l.shape == m.shape and o.dim() == 4
             and o.shape[:3] == m.shape,
             "combine_partials: m/l must be (N, B, Hq) and o (N, B, Hq, D)")
    _check_operands("combine_partials", (m, l, o), torch.float32)
    n, b, hq = m.shape
    d = o.shape[3]
    out = torch.empty((b, hq, d), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        err = _build.library().h2eal_combine_partials(
            m.data_ptr(), l.data_ptr(), o.data_ptr(), out.data_ptr(), n, b * hq, d,
            _stream(m))
    _build.check(err, "combine_partials")
    LAUNCHES["combine_partials"] += 1
    return out
