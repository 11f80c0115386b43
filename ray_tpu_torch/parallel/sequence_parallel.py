"""Sequence (context) parallelism over a mesh's "sp" axis.

The JAX package shards the sequence over "sp" ("length" -> "sp" in its
rules) and runs ring and Ulysses attention inside `shard_map`, with
`ppermute` and `all_to_all` over the axis name. The port runs one
process per rank, so this module holds the explicit collectives:

- `SPGroup`: the sp axis's process group, this rank's coordinate on it
  and its size; `sp_group(mesh, axis)` builds it (a group of one when
  the mesh has no such axis or it has size 1, and then nothing here
  launches a collective);
- `rotate_start` / `rotate`: each rank sends tensors to ``(rank + 1) %
  n`` and receives the same shapes from ``(rank - 1) % n``, JAX's
  ``perm``. Over NCCL the pairs go out as one `batch_isend_irecv` on
  the process group's own stream, and the handle's ``wait`` makes the
  caller's stream wait on it (an event, no host sync), so a transfer
  started before a kernel overlaps it; `Rotate` is the differentiable
  form (its backward sends the gradient the other way);
- `all_to_all`: JAX's tiled ``all_to_all(x, split_axis, concat_axis)``
  (`AllToAll` the differentiable form: its backward is the inverse
  all-to-all);
- `gather_seq`: the sequence all-gathered along a dimension, whose
  backward sums each rank's gradient of the whole and keeps the
  rank's own block (a reduce-scatter): what GSPMD inserts where a
  replicated consumer reads a sequence-sharded value.
- `splitting` / `check_split`: a train step that splits the sequence
  marks its loss_fn's run, and the model refuses to run it without a
  matching sp group.

Over gloo (the CPU tests, and rank processes that share one card) the
point-to-point and all-to-all calls take CUDA tensors through host
memory: they are copied to the CPU, exchanged there and copied back.
That path is for correctness runs only.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SPGroup:
    """The sp axis as one rank sees it. ``group`` is None for a group of
    one rank; ``nccl`` whether its collectives take CUDA tensors as
    they are (else they are staged through host memory)."""

    group: object
    rank: int
    size: int
    nccl: bool = False


def sp_group(mesh, axis: str = "sp") -> SPGroup:
    """The `SPGroup` of ``mesh``'s ``axis`` (``LlamaConfig.ring_axis``)
    for this rank. A mesh without the axis, or with it of size 1, gives
    a group of one rank, which runs no collective."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return SPGroup(None, 0, 1)
    size = int(mesh.mesh.shape[list(mesh.mesh_dim_names).index(axis)])
    if size == 1:
        return SPGroup(None, 0, 1)
    import torch.distributed as dist

    group = mesh.get_group(axis)
    return SPGroup(group, int(mesh.get_local_rank(axis)), size,
                   "nccl" in str(dist.get_backend(group)))


def is_split(sp) -> bool:
    """Whether ``sp`` splits the sequence over several ranks (a ring of
    blocks held by one process, `ops.ring_attention.LocalRing`, does
    not: that process holds the whole sequence)."""
    return isinstance(sp, SPGroup) and sp.size > 1


class Pending:
    """An exchange in flight: ``wait()`` returns the received tensors on
    the senders' device."""

    def __init__(self, works, received: List[torch.Tensor], sent,
                 device: Optional[torch.device] = None):
        self._works, self._received = works, received
        self._sent, self._device = sent, device   # kept alive until wait

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._sent = None
        if self._device is not None:
            return [x.to(self._device) for x in self._received]
        return self._received


def _staged(sp: SPGroup, x: torch.Tensor) -> bool:
    return x.is_cuda and not sp.nccl


def rotate_start(xs: Sequence[torch.Tensor], sp: Optional[SPGroup],
                 offset: int = 1) -> Pending:
    """Send each of ``xs`` to rank ``(rank + offset) % n`` and receive
    the same shapes from ``(rank - offset) % n``; returns the exchange
    in flight. A group of one receives its own tensors."""
    if not is_split(sp):
        return Pending([], list(xs), None)
    import torch.distributed as dist

    n = sp.size
    dst = dist.get_global_rank(sp.group, (sp.rank + offset) % n)
    src = dist.get_global_rank(sp.group, (sp.rank - offset) % n)
    xs = [x.detach().contiguous() for x in xs]
    if sp.nccl:
        recv = [torch.empty_like(x) for x in xs]
        works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x, dst, sp.group) for x in xs]
            + [dist.P2POp(dist.irecv, r, src, sp.group) for r in recv])
        return Pending(works, recv, xs)
    device = xs[0].device if _staged(sp, xs[0]) else None
    host = [x.cpu() for x in xs] if device is not None else xs
    recv = [torch.empty_like(h) for h in host]
    works = [dist.isend(h, dst, group=sp.group, tag=i)
             for i, h in enumerate(host)]
    works += [dist.irecv(r, src, group=sp.group, tag=i)
              for i, r in enumerate(recv)]
    return Pending(works, recv, host, device)


def rotate(xs: Sequence[torch.Tensor], sp: Optional[SPGroup],
           offset: int = 1) -> List[torch.Tensor]:
    """`rotate_start` and wait."""
    return rotate_start(xs, sp, offset).wait()


class Rotate(torch.autograd.Function):
    """Differentiable rotation of tensors that travel together:
    ``Rotate.apply(sp, *xs)`` sends them to rank + 1, and the backward
    sends their gradients back to rank - 1 in one exchange. One node
    for all of them keeps the exchanges of a backward in one order on
    every rank."""

    @staticmethod
    def forward(ctx, sp, *xs):
        ctx.sp = sp
        return tuple(rotate(xs, sp))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(rotate(gs, ctx.sp, offset=-1))


def all_to_all(x: torch.Tensor, sp: Optional[SPGroup], split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` cut into n blocks along
    ``split_dim``, block j sent to rank j, and the blocks received
    concatenated along ``concat_dim`` in the senders' order."""
    if not is_split(sp):
        return x
    import torch.distributed as dist

    n = sp.size
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over sp={n}")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    device = x.device if _staged(sp, x) else None
    if device is not None:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=sp.group)
    if device is not None:
        recv = recv.to(device)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class AllToAll(torch.autograd.Function):
    """Differentiable `all_to_all`: the backward is the inverse
    all-to-all (split and concatenation dimensions swapped)."""

    @staticmethod
    def forward(ctx, x, sp, split_dim, concat_dim):
        ctx.sp, ctx.dims = sp, (split_dim, concat_dim)
        return all_to_all(x, sp, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g, ctx.sp, concat_dim, split_dim), None, None, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim``; backward: the rank's block of the
    gradients summed over the group (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, sp, dim):
        import torch.distributed as dist

        ctx.sp, ctx.dim = sp, dim
        part = x.movedim(dim, 0).contiguous()
        out = part.new_empty((sp.size * part.shape[0],) + part.shape[1:])
        device = x.device if _staged(sp, x) else None
        if device is not None:
            host = out.cpu()
            dist.all_gather_into_tensor(host, part.cpu(), group=sp.group)
            out = host.to(device)
        else:
            dist.all_gather_into_tensor(out, part, group=sp.group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        sp = ctx.sp
        whole = g.movedim(ctx.dim, 0).contiguous()
        out = whole.new_empty((whole.shape[0] // sp.size,)
                              + whole.shape[1:])
        device = g.device if _staged(sp, g) else None
        if device is not None:
            host = out.cpu()
            dist.reduce_scatter_tensor(host, whole.cpu(), group=sp.group)
            out = host.to(device)
        else:
            dist.reduce_scatter_tensor(out, whole, group=sp.group)
        return out.movedim(0, ctx.dim), None, None


def gather_seq(x: torch.Tensor, sp: Optional[SPGroup],
               dim: int) -> torch.Tensor:
    """The whole sequence from each rank's block along ``dim`` (in rank
    order); its gradient is summed over the group. A group of one
    returns ``x``."""
    return _GatherSeq.apply(x, sp, dim) if is_split(sp) else x


# the sp size a train step splits the sequence over while its loss_fn
# runs (`splitting`); 1 outside a step
_step_split = 1


@contextlib.contextmanager
def splitting(size: int):
    """The block runs a train step's loss_fn on a block of the sequence,
    split over ``size`` sp ranks: a model handed no matching sp group
    raises (`check_split`) instead of attending within its block."""
    global _step_split
    outer, _step_split = _step_split, size
    try:
        yield
    finally:
        _step_split = outer


def check_split(sp) -> None:
    """Raise ValueError when a train step splits the sequence over sp
    ranks (`splitting`) and ``sp`` is not an sp group of that size: the
    model would attend within each rank's block, with positions from 0
    on every rank (JAX's step needs no such argument: GSPMD inserts the
    gathers)."""
    if _step_split > 1 and not (is_split(sp) and sp.size == _step_split):
        raise ValueError(
            f"the train step splits the sequence over sp={_step_split}, "
            f"but the model was given sp={sp!r}: pass sp=sp_group(mesh) "
            "to llama_loss")


def seq_positions(batch: int, length: int, sp: Optional[SPGroup],
                  device) -> torch.Tensor:
    """[batch, length] positions of this rank's block of the sequence:
    global, ``rank * length + arange(length)`` (a group of one: from
    0)."""
    start = sp.rank * length if is_split(sp) else 0
    return torch.arange(start, start + length,
                        device=device).expand(batch, length)
