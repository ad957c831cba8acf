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
            "chunk_attention": 0, "chunk_attention_paged": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_MAX_GROUP = 8


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sink: int = 0, q_offset: int = 0):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D)."""
    if _on_cpu(q, k, v):
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        sink=sink, q_offset=q_offset)
    b, sq, hq, d = q.shape
    _require(k.dim() == 4 and k.shape == v.shape and k.shape[0] == b
             and k.shape[3] == d, "flash_attention: k/v must be (B, Sk, Hkv, D)")
    sk, hkv = k.shape[1], k.shape[2]
    _require(q.dtype in _DTYPES, f"flash_attention: dtype {q.dtype} not supported")
    _check_operands("flash_attention", (q, k, v), q.dtype)
    _require(d in _HEAD_DIMS, f"flash_attention: head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hkv == 0, "flash_attention: Hq must be a multiple of Hkv")
    _require(q_offset >= 0 and window >= 0 and sink >= 0,
             "flash_attention: q_offset, window and sink must be >= 0")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().h2eal_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, hq, hkv, d, int(causal), window, sink,
            q_offset, _scale(d), _stream(q))
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def paged_attention(q, k, v, valid):
    """q: (B, Hq, D); k/v: (B, Hkv, T, D); valid: (B, Hkv, T) bool ->
    (B, Hq, D)."""
    if _on_cpu(q, k, v, valid):
        return _ref.paged_attention_ref(q, k, v, valid)
    b, hq, d = q.shape
    _require(k.dim() == 4 and k.shape == v.shape and k.shape[0] == b
             and k.shape[3] == d, "paged_attention: k/v must be (B, Hkv, T, D)")
    hkv, t = k.shape[1], k.shape[2]
    _require(valid.shape == (b, hkv, t) and valid.dtype == torch.bool,
             "paged_attention: valid must be (B, Hkv, T) bool")
    _require(q.dtype in _DTYPES, f"paged_attention: dtype {q.dtype} not supported")
    _check_operands("paged_attention", (q, k, v), q.dtype)
    _check_operands("paged_attention", (valid,))
    _require(d in _HEAD_DIMS, f"paged_attention: head_dim {d} not in {_HEAD_DIMS}")
    _require(hq % hkv == 0 and 1 <= hq // hkv <= _MAX_GROUP,
             f"paged_attention: GQA group must divide Hq and be <= {_MAX_GROUP}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().h2eal_paged_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], b, hkv, t, hq // hkv, d,
            _scale(d), _stream(q))
    _build.check(err, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out


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


def chunk_attention(q, k, v, valid):
    """q: (B, Cq, Hq, D); k/v: (B, Hkv, T, D); valid: (B, Hkv, Cq, T) bool
    -> (B, Cq, Hq, D); a row with no valid key gives 0."""
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().h2eal_chunk_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], b, cq, hkv, t, hq // hkv, d,
            _scale(d), _stream(q))
    _build.check(err, "chunk_attention")
    LAUNCHES["chunk_attention"] += 1
    return out


def chunk_attention_paged(q, k_pages, v_pages, page_start, start, k_new, v_new):
    """Chunked-prefill retrieval attention over the pre-append paged cache
    with the page gather fused. q: (B, Cq, Hq, D); k/v_pages: (B, Hr, C, P,
    D); page_start: (B, Hr, C) int32; start: (B,) int32; k/v_new: (B, Cq,
    Hr, D) -> (B, Cq, Hq, D). The chunk KV is cast to the cache dtype first,
    on both routes, so the chunk attends exactly what a post-append read
    would return."""
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().h2eal_chunk_attention_paged(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_start.data_ptr(), start.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, cq, hr, c, p,
            hq // hr, d, _scale(d), _stream(q))
    _build.check(err, "chunk_attention_paged")
    LAUNCHES["chunk_attention_paged"] += 1
    return out
