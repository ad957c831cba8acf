"""The collectives of the GSPMD layouts, over a ``launch/mesh.Mesh``.

Where GSPMD inserts its own collectives around the reference's sharded
decode, the port gathers explicitly, and only along an axis of more than
one rank: an axis of size 1 issues nothing, so a one-rank mesh runs no
collective at all.

One code path serves every backend: a gather is one
``all_gather_into_tensor`` of the flattened block. NCCL captures it inside
a CUDA graph; gloo takes it on CPU tensors and on card tensors (PyTorch
documents only ``all_reduce`` and ``broadcast`` for CUDA tensors under
gloo; ``chip_smoke.py`` phase 15b checks on the card which others it
takes), so the same call serves the CPU tests, ranks that share one card
over gloo, and NCCL ranks on their own cards. Everything travels as f32:
exact for f32 and bf16 values and for integers below 2**24 (page slots,
token ids); the result comes back in the input's dtype.

Beside the gather, two collectives serve what a rank holds only a part of:

  * ``sum_tiles``: an all_reduce of blocks that are zero outside the
    elements the rank owns, each element owned by exactly one rank, so the
    sum is every owner's value, exactly (x + 0 = x); the speculative
    verify builds its [sink | selected | local] buffer so;
  * ``owner_select``: every rank's block stacked and the one of the rank
    ``owner`` (a card tensor, so that a captured step reads no host value)
    taken: a slot's row moved between ranks by a migration.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

WIRE = torch.float32


def stack(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The blocks ``x`` of every rank along ``axis``, stacked in their order
    on a new leading dim: (n, *x.shape); (1, *x.shape) for an axis of one
    rank, with no collective."""
    n = mesh.shape[axis]
    if n == 1:
        return x[None]
    wire = x.to(WIRE).reshape(-1).contiguous()
    buf = torch.empty(n * wire.numel(), dtype=WIRE, device=x.device)
    dist.all_gather_into_tensor(buf, wire, group=mesh.group(axis))
    return buf.view((n,) + tuple(x.shape)).to(x.dtype)


def gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks ``x`` of every rank along ``axis`` concatenated on ``dim``
    in their order; ``x`` itself for an axis of one rank."""
    if mesh.shape[axis] == 1:
        return x
    return torch.cat(stack(x, mesh, axis).unbind(0), dim=dim)


def sum_tiles(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of blocks ``x`` that are zero
    outside the elements each rank owns: every owner's elements, exact;
    ``x`` itself where every axis has one rank."""
    groups = [mesh.group(a) for a in axes if mesh.shape[a] > 1]
    if not groups:
        return x
    wire = x.to(WIRE).contiguous()
    for g in groups:
        dist.all_reduce(wire, group=g)
    return wire.to(x.dtype)


def owner_select(x: torch.Tensor, mesh, axis: str, owner: torch.Tensor) -> torch.Tensor:
    """The block ``x`` of the rank at index ``owner`` ((1,) int64 on the
    device) along ``axis``, on every rank of it; ``x`` for an axis of one
    rank."""
    if mesh.shape[axis] == 1:
        return x
    return stack(x, mesh, axis).index_select(0, owner.reshape(1))[0]


def warm_up(mesh, device) -> None:
    """One small all_reduce on each axis group of more than one rank, then a
    wait: NCCL makes its communicators at a group's first collective, which
    must not fall inside a CUDA graph capture."""
    for axis in mesh.axis_names:
        if mesh.shape[axis] > 1:
            dist.all_reduce(torch.zeros(1, dtype=WIRE, device=device),
                            group=mesh.group(axis))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
