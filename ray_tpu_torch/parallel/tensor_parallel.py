"""Tensor (Megatron) parallelism over a mesh's "tp" axis.

The JAX package shards heads, MLP width and vocab over "tp" by its
logical-axis rules and lets GSPMD insert the collectives. The port runs
one process per rank, so this module is the explicit form of what GSPMD
inserts there:

- `TPGroup`: the tp axis's process group, this rank's coordinate on it,
  its size, and whether its collectives can be captured in a CUDA graph
  (NCCL, or a group of one rank, which runs none);
- `copy_to_tp` (Megatron's f: identity forward, all-reduce backward)
  before a column-parallel product or wherever a replicated tensor
  enters a rank-local computation, and `reduce_from_tp` (g: all-reduce
  forward, identity backward) after a row-parallel product:

  ========================================  ===============  ==========
  products                                  weight split     around
  ========================================  ===============  ==========
  wq, wk, wv, w_gate, w_up, lm_head         output axis      f before
  wo, w_down                                input axis       g after
  ========================================  ===============  ==========

  so each decoder layer makes two all-reduces of ``[B, S, dim]``;
- the vocab-parallel ends: `vocab_embed` (a masked local gather summed
  over tp), `gather_logits` (the logits made whole for sampling) and
  `vocab_cross_entropy` (max, sum of exponentials and target logit each
  reduced over tp; the full ``[N, vocab]`` row never exists);
- `local_heads`: the q heads a rank computes and the kv heads they read.

Every collective runs through `collective`, which does nothing for a
group of one, so tp = 1 launches no collective. With ``tp=None`` no function
here is called at all: the model runs the ops it runs without a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The tp axis as one rank sees it. ``group`` is None for a group of
    one rank. ``host_group`` (gloo, CPU tensors) carries the host loop's
    shared decisions and the handoff payloads; None for one rank."""

    group: object
    rank: int
    size: int
    capturable: bool
    host_group: object = None


def _backend(group) -> str:
    import torch.distributed as dist

    return str(dist.get_backend(group))


def _host_group(mesh, axis: str):
    """A gloo group over each of ``mesh``'s ``axis`` groups, created on
    every rank in one order (every rank calls this collectively)."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    i = names.index(axis)
    ranks = mesh.mesh.movedim(i, -1).reshape(-1, mesh.mesh.shape[i])
    group, _ = dist.new_subgroups_by_enumeration(ranks.tolist(),
                                                 backend="gloo")
    return group


def tp_group(mesh, axis: str = "tp", host: bool = False) -> TPGroup:
    """The `TPGroup` of ``mesh``'s ``axis`` for this rank (collective:
    every rank calls it in the same order when ``host`` builds the gloo
    group). A mesh without the axis, or with it of size 1, gives a group
    of one rank, which runs no collective."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return TPGroup(None, 0, 1, True)
    size = int(mesh.mesh.shape[list(mesh.mesh_dim_names).index(axis)])
    if size == 1:
        return TPGroup(None, 0, 1, True)
    group = mesh.get_group(axis)
    rank = int(mesh.get_local_rank(axis))
    return TPGroup(group, rank, size, "nccl" in _backend(group),
                   _host_group(mesh, axis) if host else None)


def is_split(tp: Optional[TPGroup]) -> bool:
    return tp is not None and tp.size > 1


def collective(op: str, x: torch.Tensor, tp: Optional[TPGroup],
               host: bool = False) -> torch.Tensor:
    """Every collective of the tp layer: "sum" / "max" all-reduce ``x``
    in place, "broadcast" rank 0's ``x`` in place, "gather" returns the
    ranks' ``x`` stacked on a new leading axis; over the tp group, or its
    gloo twin for host tensors (``host``). A group of one does
    nothing (and "gather" adds the axis)."""
    if not is_split(tp):
        return x[None] if op == "gather" else x
    import torch.distributed as dist

    group = tp.host_group if host else tp.group
    if op == "gather":
        out = x.new_empty((tp.size,) + x.shape)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    if op == "broadcast":
        dist.broadcast(x, group_src=0, group=group)
    else:
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
    return x


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective("sum", g.clone(), ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return collective("sum", x.clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """f before a column-parallel product (or a replicated tensor's
    entry into rank-local use): its gradient is summed over tp."""
    return _CopyToTP.apply(x, tp) if is_split(tp) else x


def reduce_from_tp(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """g after a row-parallel product: the partial sums made whole."""
    return _ReduceFromTP.apply(x, tp) if is_split(tp) else x


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                tp: Optional[TPGroup], vocab_size: int) -> torch.Tensor:
    """``table[tokens]`` with ``table`` this rank's vocab rows (a
    contiguous block of ``vocab_size / tp`` rows, or all of them when the
    vocab axis is not split): a masked local gather, summed over tp. Only
    one rank holds each row, so the sum adds zeros and is exact."""
    if not is_split(tp) or table.shape[0] == vocab_size:
        return table[tokens]
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce_from_tp(rows.masked_fill(~mine[..., None], 0), tp)


def gather_logits(local: torch.Tensor, tp: Optional[TPGroup],
                  vocab_size: int) -> torch.Tensor:
    """Make a rank's vocab-split logits ``[..., vocab / tp]`` whole (f32,
    the same on every rank), for sampling: an all-gather over NCCL, else
    an all-reduce into a zeroed full-width buffer (exact: every other
    entry a rank adds is a zero). Logits that are already whole pass."""
    if not is_split(tp) or local.shape[-1] == vocab_size:
        return local
    n = local.shape[-1]
    if tp.capturable:
        parts = collective("gather", local, tp)
        return parts.movedim(0, -2).reshape(*local.shape[:-1], vocab_size)
    full = local.new_zeros(local.shape[:-1] + (vocab_size,))
    full[..., tp.rank * n:(tp.rank + 1) * n] = local
    return collective("sum", full, tp)


class _VocabCrossEntropy(torch.autograd.Function):
    """Token nll from vocab-split f32 logits [N, V/tp]; the backward is
    ``softmax - onehot`` on the rank's columns, with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, tp):
        n = logits.shape[-1]
        m = collective("max", logits.max(dim=-1).values, tp)
        shifted = logits - m[:, None]
        e = shifted.exp()
        s = collective("sum", e.sum(dim=-1), tp)
        local = targets.long() - tp.rank * n
        mine = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        t = shifted.gather(-1, idx[:, None])[:, 0].masked_fill(~mine, 0.0)
        t = collective("sum", t, tp)
        ctx.save_for_backward(e / s[:, None], idx, mine)
        return s.log() - t

    @staticmethod
    def backward(ctx, g):
        p, idx, mine = ctx.saved_tensors
        grad = p.clone()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, idx] -= mine.to(grad.dtype)
        return grad * g[:, None], None, None


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        tp: Optional[TPGroup]) -> torch.Tensor:
    """Per-token nll [N] of f32 logits [N, V/tp] split over tp by vocab
    (`torch.nn.functional.cross_entropy` when they are whole)."""
    if not is_split(tp):
        return torch.nn.functional.cross_entropy(
            logits, targets.long(), reduction="none")
    return _VocabCrossEntropy.apply(logits, targets, tp)


def local_heads(cfg, rules, rank: int, size: int
                ) -> Tuple[slice, List[int]]:
    """(q-head slice, kv-head list) of rank ``rank`` of ``size``: its q
    heads ``[rank·H/size, (rank+1)·H/size)`` and the kv heads ``h //
    (H/KV)`` they read, in order, each once when the local q heads group
    evenly over them (always the case when KV divides ``size``, where
    the list is the rank's block of KV/size heads), else one per q head.
    The grouped-query kernels take ``g = H_local / KV_local``, so a rank
    hands them exactly these kv heads. ``rules`` (the pruned table, or
    None) must split "heads" over tp when ``size`` > 1."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if size == 1:
        return slice(0, H), list(range(KV))
    if rules is not None and "tp" not in _axes(rules.get("heads")):
        raise ValueError(
            f"tensor parallelism over tp={size} needs the heads axis on "
            f"tp (n_heads={H}); the rules give {rules.get('heads')!r}")
    if H % size:
        raise ValueError(f"n_heads={H} does not split over tp={size}")
    hl = H // size
    q0 = rank * hl
    kv = [h // (H // KV) for h in range(q0, q0 + hl)]
    uniq = sorted(set(kv))
    g = hl // len(uniq)
    if g * len(uniq) == hl and kv == [u for u in uniq for _ in range(g)]:
        return slice(q0, q0 + hl), uniq
    return slice(q0, q0 + hl), kv


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def select_kv(w: torch.Tensor, tp: Optional[TPGroup], cfg,
              dim: int) -> torch.Tensor:
    """The kv heads this rank reads, along ``dim`` of a kv-head tensor
    ``w`` that holds all ``n_kv_heads`` (a leaf replicated over tp while
    the q heads split): f, then the selection, so the leaf's partial
    gradients are summed over tp, also when every rank reads every kv
    head (n_kv_heads = 1) and nothing is cut. A tensor already cut to
    the rank's kv heads passes."""
    if not is_split(tp) or w.shape[dim] != cfg.n_kv_heads:
        return w
    w = copy_to_tp(w, tp)
    _, kv = local_heads(cfg, None, tp.rank, tp.size)
    if kv == list(range(cfg.n_kv_heads)):
        return w
    return w.index_select(dim, torch.tensor(kv, device=w.device))
