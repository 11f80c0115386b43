"""Ring attention: sequence parallelism over the sp group.

Port of `ray_tpu/ops/ring_attention.py`. The sequence is split over
the ranks of an `SPGroup` (`parallel.sequence_parallel`); each rank
holds its q, k and v block, the k/v blocks travel around the ring
(rank r sends to r + 1), and after t steps rank r holds the block of
rank ``(r - t) % n``. Two implementations, by JAX's names:

- ``impl="pallas"``, the kernel schedule (`_RingFlash`): each step runs
  kernel B1 (`ops.flash_attention._flash_fwd`, with the row logsumexp)
  on (q, the k/v block held), and the partial ``(o, lse)`` pairs merge
  exactly in f32 (`_combine`). The blocks are equal, so the choice is
  static per step (`shard_kind`): causal on the diagonal block (``src
  == rank``), non-causal on past blocks, and future blocks skipped. The
  backward is a second ring pass over kernels B3a/B3b
  (`_flash_bwd(..., delta=, grad_dtype=float32)`, delta taken once
  outside the loop): the f32 dk/dv accumulators travel with the k/v
  blocks, each rank adding its part, and one more rotation at the end
  brings each accumulator home (`_home`). Over NCCL the next block's
  transfer is started before the current block's kernels and waited on
  after them, so the two overlap;
- ``impl="xla"``, the plain ring (`_ring_plain`): JAX's einsum
  online-softmax steps (`_block_attn`), differentiable by autograd, the
  rotation a `Rotate` whose backward sends the gradient back.

``"auto"`` is the kernel schedule on CUDA tensors and the plain ring on
CPU tensors (by the tensors' device). On CPU tensors the kernel
schedule runs the kernels' plain versions, as `_flash_fwd` and
`_flash_bwd` do.

Both see the ring through one interface (``lanes``/``join`` the held
blocks, ``start`` a rotation and ``shift`` its differentiable form):
`_RankRing` over an `SPGroup` (one block per rank, one process per
rank; None or a group of one is a ring of one), or `LocalRing`, the
whole ring in one process, its n blocks concatenated along the
sequence and each rotation a reordering of them, which runs the ranks'
code on one device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.ops.attention import _repeat_kv
from ray_tpu_torch.ops.flash_attention import (_check_blocks, _delta,
                                               _flash_bwd, _flash_fwd)
from ray_tpu_torch.parallel.sequence_parallel import (Rotate, SPGroup,
                                                      is_split, rotate_start)

_NEG_INF = -1e30
_IMPLS = ("auto", "pallas", "xla")


class _Rotating:
    """A rotation in flight: ``wait()`` returns what each held block
    receives, as a list of tuples."""

    def __init__(self, wait):
        self.wait = wait


class _RankRing:
    """The ring as one rank of an `SPGroup` sees it (None or a group of
    one: a ring of one): it holds its own block, and a rotation is an
    exchange with its neighbours."""

    def __init__(self, sp: Optional[SPGroup]):
        split = is_split(sp)
        self.sp = sp
        self.size = sp.size if split else 1
        self.ranks = (sp.rank if split else 0,)

    def lanes(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x]

    def join(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return xs[0]

    def start(self, lanes: Sequence[Tuple[torch.Tensor, ...]]) -> _Rotating:
        (tensors,) = lanes
        pending = rotate_start(tensors, self.sp)
        return _Rotating(lambda: [tuple(pending.wait())])

    def shift(self, lanes):
        (tensors,) = lanes
        return [Rotate.apply(self.sp, *tensors)]


class LocalRing:
    """A ring of ``size`` blocks held by this one process, concatenated
    along the sequence: a rotation hands block i the tensors of block
    i - 1. It runs the ranks' code (kernel calls, masks, merge) on one
    device."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = tuple(range(size))

    def lanes(self, x: torch.Tensor) -> List[torch.Tensor]:
        return list(x.chunk(self.size, dim=2))

    def join(self, xs: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, dim=2)

    def start(self, lanes) -> _Rotating:
        rotated = self.shift(lanes)
        return _Rotating(lambda: rotated)

    def shift(self, lanes):
        lanes = list(lanes)
        return lanes[-1:] + lanes[:-1]


def _ring_of(sp):
    return sp if isinstance(sp, LocalRing) else _RankRing(sp)


def _held(x: torch.Tensor, ring) -> List[torch.Tensor]:
    """The held blocks of ``x``, each contiguous (as the kernels read
    them)."""
    return [b.contiguous() for b in ring.lanes(x)]


def shard_kind(src: int, rank: int, causal: bool) -> Optional[str]:
    """The kernel a rank runs on block ``src``: "past" (non-causal),
    "diag" (causal) or None (a future block, skipped)."""
    if not causal or src < rank:
        return "past"
    return "diag" if src == rank else None


def _combine(o, lse, o_i, lse_i):
    """Exact merge of two normalized flash partials in f32: o = acc / l
    with lse = m + log(l); the result is (acc0 + acc1) / (l0 + l1) in
    the max-lse frame."""
    m = torch.maximum(lse, lse_i)
    w0 = torch.exp(lse - m)
    w1 = torch.exp(lse_i - m)
    denom = w0 + w1
    o_c = (o * w0 + o_i.float() * w1) / denom
    return o_c, m + torch.log(denom)


def _home(acc: List[Tuple[torch.Tensor, ...]], ring):
    """The last rotation of the backward: after n - 1 steps rank r holds
    block (r + 1) % n's dk/dv accumulator, one more step on brings each
    to its block's rank."""
    return ring.start(acc).wait()


class _RingFlash(torch.autograd.Function):
    """The kernel schedule (`jax.custom_vjp` `_ring_pallas` of the JAX
    package): the forward saves (q, k, v, o, lse); the backward is the
    second ring pass."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, sm_scale):
        n = ring.size
        qs = _held(q, ring)
        kv = list(zip(_held(k, ring), _held(v, ring)))
        o = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
             for x in qs]
        lse = [torch.full(x.shape[:3] + (1,), _NEG_INF, dtype=torch.float32,
                          device=x.device) for x in qs]
        for t in range(n):
            pend = ring.start(kv) if t < n - 1 else None
            for i, r in enumerate(ring.ranks):
                kind = shard_kind((r - t) % n, r, causal)
                if kind is None:
                    continue
                o_i, lse_i = _flash_fwd(qs[i], kv[i][0], kv[i][1], sm_scale,
                                        kind == "diag", with_lse=True)
                o[i], lse[i] = _combine(o[i], lse[i], o_i, lse_i)
            if pend is not None:
                kv = pend.wait()
        out = ring.join([x.to(q.dtype) for x in o])
        ctx.ring, ctx.causal, ctx.sm_scale = ring, causal, sm_scale
        ctx.save_for_backward(q, k, v, out, ring.join(lse))
        return out

    @staticmethod
    def backward(ctx, g):
        ring, causal, sm_scale = ctx.ring, ctx.causal, ctx.sm_scale
        q, k, v, out, lse = ctx.saved_tensors
        n = ring.size
        qs, os_, lses, gs = (_held(t, ring) for t in (q, out, lse, g))
        kv = list(zip(_held(k, ring), _held(v, ring)))
        # loop-invariant: once, outside the ring
        deltas = [_delta(o_, g_) for o_, g_ in zip(os_, gs)]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in qs]
        acc = [tuple(torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) for x in pair)
               for pair in kv]
        acc_pend = None
        for t in range(n):
            pend = ring.start(kv) if t < n - 1 else None
            parts = []
            for i, r in enumerate(ring.ranks):
                kind = shard_kind((r - t) % n, r, causal)
                if kind is None:
                    parts.append(None)
                    continue
                dq_i, dk_i, dv_i = _flash_bwd(
                    qs[i], kv[i][0], kv[i][1], os_[i], lses[i], gs[i],
                    sm_scale, kind == "diag", delta=deltas[i],
                    grad_dtype=torch.float32)
                dq[i] = dq[i] + dq_i
                parts.append((dk_i, dv_i))
            if acc_pend is not None:
                acc = acc_pend.wait()
            acc = [a if p is None else (a[0] + p[0], a[1] + p[1])
                   for a, p in zip(acc, parts)]
            # the accumulators travel with their blocks; the rotation
            # after the last step is the one that brings them home
            acc_pend = ring.start(acc) if t < n - 1 else None
            if pend is not None:
                kv = pend.wait()
        acc = _home(acc, ring)
        dk = ring.join([a[0] for a in acc]).to(k.dtype)
        dv = ring.join([a[1] for a in acc]).to(v.dtype)
        return ring.join(dq).to(q.dtype), dk, dv, None, None, None


def _block_attn(q, k, v, m, l, acc, q_off, k_off, causal, sm_scale):
    """One online-softmax accumulation step (JAX's, op for op). q
    [B,H,Sq,D], k/v [B,Hkv,Sk,D]."""
    h, hkv = q.shape[1], k.shape[1]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qi = q_off + torch.arange(sq, device=q.device)[:, None]
        ki = k_off + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, _NEG_INF)
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return m_new, l_new, acc_new


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with zero gradients for ``xs``: the blocks a
    rank skips (future ones) stay in its autograd graph, so the backward
    of every rotation runs on every rank, as the transpose of each
    `ppermute` does in JAX. Without it a rank whose last blocks are all
    future ones would not send their gradients back."""

    @staticmethod
    def forward(ctx, out, *xs):
        ctx.xs = [(x.shape, x.dtype, x.device) for x in xs]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=dev)
                            for s, d, dev in ctx.xs)


def _ring_plain(q, k, v, ring, causal: bool, sm_scale: float):
    """The plain ring (JAX's `_ring_xla`)."""
    n = ring.size
    qs, ks, vs = (ring.lanes(x) for x in (q, k, v))
    sq, sk = qs[0].shape[2], ks[0].shape[2]
    b, h, _, d = qs[0].shape
    state = [(torch.full((b, h, sq, 1), _NEG_INF, device=q.device),
              torch.zeros((b, h, sq, 1), device=q.device),
              torch.zeros((b, h, sq, d), device=q.device)) for _ in qs]
    kv = list(zip(ks, vs))
    skipped = [[] for _ in qs]
    for t in range(n):
        for i, r in enumerate(ring.ranks):
            q_off, k_off = r * sq, ((r - t) % n) * sk
            if causal and k_off > q_off + sq - 1:   # a future block
                skipped[i] += kv[i]
                continue
            state[i] = _block_attn(qs[i], kv[i][0], kv[i][1], *state[i],
                                   q_off, k_off, causal, sm_scale)
        if t < n - 1:      # the last step's rotation would be unused
            kv = ring.shift(kv)
    outs = []
    for x, (_, l, acc), skip in zip(qs, state, skipped):
        l = torch.where(l == 0.0, 1.0, l)
        out = (acc / l).to(x.dtype)
        outs.append(_Tie.apply(out, *skip) if skip else out)
    return ring.join(outs)


def ring_attention(q: torch.Tensor,
                   k: torch.Tensor,
                   v: torch.Tensor,
                   *,
                   sp=None,
                   causal: bool = True,
                   sm_scale: Optional[float] = None,
                   impl: str = "auto",
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None) -> torch.Tensor:
    """Ring attention over the blocks this process holds: q [B,H,S,D],
    k/v [B,Hkv,Sk,D] (GQA when Hkv < H), differentiable in all three.

    ``sp``: an `SPGroup` (each rank passes its own block, as JAX's
    `ring_attention` inside `shard_map` takes local shapes), None for a
    ring of one, or a `LocalRing` (this process holds all n blocks,
    concatenated). block_q/block_k: as in `flash_attention`, validated
    and ignored."""
    _check_blocks(block_q, block_k)
    if impl not in _IMPLS:
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    ring = _ring_of(sp)
    if impl == "auto":
        impl = "pallas" if q.is_cuda else "xla"
    if impl == "xla":
        return _ring_plain(q, k, v, ring, bool(causal), float(sm_scale))
    if causal and k.shape[2] != q.shape[2]:
        raise ValueError(
            "causal ring attention requires equal q/kv shards "
            f"(got Sq={q.shape[2] // len(ring.ranks)}, "
            f"Sk={k.shape[2] // len(ring.ranks)})")
    return _RingFlash.apply(q, k, v, ring, bool(causal), float(sm_scale))


class _GatherReplicated(torch.autograd.Function):
    """The rank's output block made whole on every rank; every rank
    then computes the same function of it, so the gradient of its block
    is its block of the gradient."""

    @staticmethod
    def forward(ctx, x, sp):
        from ray_tpu_torch.parallel.sequence_parallel import gather_seq

        ctx.sp = sp
        with torch.no_grad():
            return gather_seq(x, sp, 2)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[2] // ctx.sp.size
        return g[:, :, ctx.sp.rank * n:(ctx.sp.rank + 1) * n], None


def ring_attention_sharded(q: torch.Tensor,
                           k: torch.Tensor,
                           v: torch.Tensor,
                           sp: Optional[SPGroup],
                           **kw) -> torch.Tensor:
    """JAX's `shard_map` wrapper in one rank's terms: q, k, v are the
    GLOBAL [B,H,S,D] tensors (the same on every rank); the rank runs
    `ring_attention` on its block of the sequence and returns the whole
    output, gathered over ``sp``."""
    if not is_split(sp):
        return ring_attention(q, k, v, sp=sp, **kw)
    n, r = sp.size, sp.rank

    def block(x):
        s = x.shape[2] // n
        return x[:, :, r * s:(r + 1) * s]

    out = ring_attention(block(q), block(k), block(v), sp=sp, **kw)
    return _GatherReplicated.apply(out, sp)
