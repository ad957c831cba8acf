"""Serve-cache layouts (counterpart of ``repro/core/layouts.py``).

Only the ``default`` layout is ported: the single-program §IV-A algorithm,
the token-exactness oracle every other layout is held to. The other names
of the JAX registry raise until their ROADMAP item lands.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core import hybrid_attention as hattn

LAYOUT_DEFAULT = "default"
_NOT_PORTED = ("head", "coplace", "interleave", "coplace_shmap")


class DefaultLayout:
    """Single-program path: no mesh, no sharding."""

    name = LAYOUT_DEFAULT

    def prefill(self, spec, k, v, length: int, capacity: int, perm=None) -> Dict:
        """Build the decode state {"paged", "stream"} from prefill K/V."""
        paged, stream = hattn.init_decode_state(spec, k, v, length, capacity,
                                                perm)
        return {"paged": paged, "stream": stream}

    def prefill_chunk(self, spec, state: Dict, q, k_new, v_new, start,
                      chunk_len, active, perm=None):
        """Chunked prefill: attend one prompt chunk per slot and append it
        into the slots' caches -> (out (B, C, Hq, D), state)."""
        out, paged, stream = hattn.chunk_prefill_attention(
            spec, q, k_new, v_new, state["paged"], state["stream"], start,
            chunk_len, active, perm=perm)
        return out, {"paged": paged, "stream": stream}

    def decode(self, spec, state: Dict, q, k_new, v_new, length, *,
               do_select: bool, perm=None, active=None, need_select=None):
        """Decode step, lockstep (int ``length``) or ragged ((B,) lengths,
        ``active``, ``need_select``) -> (out (B, Hq, D), state)."""
        out, paged, stream = hattn.decode_attention(
            spec, q, k_new, v_new, state["paged"], state["stream"], length,
            do_select=do_select, perm=perm, active=active,
            need_select=need_select)
        return out, {"paged": paged, "stream": stream}


_DEFAULT = DefaultLayout()


def get_layout(name: str) -> DefaultLayout:
    if name == LAYOUT_DEFAULT:
        return _DEFAULT
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"layout {name!r} is not ported yet (ROADMAP Queue 1 item 9)")
    raise ValueError(f"unknown attention layout {name!r}; ported layouts: "
                     f"{LAYOUT_DEFAULT}")
