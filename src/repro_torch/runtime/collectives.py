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

Tensor parallelism and FSDP (``runtime/tensor_parallel.py``) need
collectives that autograd differentiates, each a ``torch.autograd.Function``
(Megatron-LM's pairs):

  * ``copy_to``: identity forward, the gradient summed over the axis
    backward (the input of a product whose weight is cut over 'model');
  * ``reduce_from``: the sum over the axis forward, identity backward (the
    partial outputs of a product whose input dim is cut);
  * ``gather_cols``: the blocks gathered on a dim forward, the rank's block
    of the gradient backward (the gradient arrives whole and the same on
    every rank);
  * ``split``: the rank's block of a dim forward, the gradient's blocks
    gathered backward (the inverse pair);
  * ``fsdp_gather``: a weight stored cut over 'data' gathered forward; the
    gradient summed over 'data' backward, then the rank's block (each
    'data' rank's gradient is its own rows' part).

Gloo has no reduce-scatter, so every sum is an ``all_reduce`` (then a
slice where a block is due), one path on both backends. Nothing is sent on
an axis of one rank: each returns its input there, so a one-rank mesh
computes what no mesh does, bit for bit.
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


def _block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The rank's contiguous block of ``x`` along ``dim`` over ``axis``."""
    n = mesh.shape[axis]
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(axis) * size, size)


def _sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, f32 on the wire."""
    wire = x.to(WIRE).contiguous()
    dist.all_reduce(wire, group=mesh.group(axis))
    return wire.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return gather(w, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = _sum(g, ctx.mesh, ctx.axis)
        return _block(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``x``, its gradient summed over ``axis``."""
    return x if mesh.shape[axis] == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum of ``x`` over ``axis``, its gradient passed through."""
    return x if mesh.shape[axis] == 1 else _ReduceFrom.apply(x, mesh, axis)


def gather_cols(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks ``x`` gathered on ``dim``; backward, the rank's block."""
    return x if mesh.shape[axis] == 1 else _GatherCols.apply(x, mesh, axis, dim)


def split(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The rank's block of ``x`` on ``dim``; backward, the blocks gathered."""
    return x if mesh.shape[axis] == 1 else _Split.apply(x, mesh, axis, dim)


def fsdp_gather(w: torch.Tensor, mesh, dim: int, axis: str = "data") -> torch.Tensor:
    """A weight's blocks gathered on ``dim``; backward, the gradient summed
    over ``axis`` and the rank's block of it."""
    return w if mesh.shape[axis] == 1 else _FsdpGather.apply(w, mesh, axis, dim)
