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
