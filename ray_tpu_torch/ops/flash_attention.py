"""Flash attention: forward and backward drivers, their plain PyTorch
versions and the autograd wrapper.

Port of `ray_tpu/ops/flash_attention.py`. `_flash_fwd` and `_flash_bwd`
keep the JAX drivers' signatures (less ``interpret``): on CUDA tensors
they launch the hand-written Hopper kernels of
`ops.flash_attention_kernel` (B1 forward, B3a dq, B3b dk/dv; bf16
forward and dk/dv on wgmma with TMA loads), on CPU
tensors they run the plain versions `_flash_fwd_reference` and
`_flash_bwd_reference`. There is no fallback: a CUDA tensor the kernels
do not take raises.

The plain versions are whole-matrix PyTorch code with the Pallas
kernels' semantics: scores masked with -1e30 (not -inf) by the causal
rule ``q_offset + qi >= ki`` (``q_offset = Sk - Sq``, a kv prefix as in
decode), m/l/acc in f32, ``l == 0 -> 1``, a fully masked row (``m <=
-5e29``) written as exactly 0, ``lse = m + log l``; in the backward ``p
= 0`` where ``lse <= -5e29``, p rounded to v's (dO's) dtype before its
product and ds to k's (q's) dtype before its products, and the dk/dv of
a GQA group summed over its q heads. The kernels share the semantics;
their online softmax rounds p per tile, so bf16 results differ from
the plain versions within bf16 rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import flash_attention_kernel as fak
from ray_tpu_torch.ops.attention import _repeat_kv

_NEG_INF = -1e30


def _check_heads(q: torch.Tensor, k: torch.Tensor) -> int:
    h, hkv = q.shape[1], k.shape[1]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    return h // hkv


def _masked_scores(q, k, sm_scale: float, causal: bool) -> torch.Tensor:
    """f32 scores [B,H,Sq,Sk] (k already repeated to H heads) with the
    kernels' mask and -1e30 fill."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, _NEG_INF)
    return s


def _flash_fwd_reference(q, k, v, sm_scale: float, causal: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B1: (o [B,H,Sq,D] in q.dtype, lse
    [B,H,Sq,1] f32)."""
    grp = _check_heads(q, k)
    s = _masked_scores(q, _repeat_kv(k, grp), sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                       _repeat_kv(v, grp).float())
    o = torch.where(m > _NEG_INF / 2, acc / l, 0.0).to(q.dtype)
    return o, m + torch.log(l)


def _flash_bwd_reference(q, k, v, o, lse, dO, sm_scale: float,
                         causal: bool, delta=None, grad_dtype=None
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain version of kernels B3a and B3b: (dq, dk, dv), dk/dv summed
    over each GQA group, in ``grad_dtype`` or the inputs' dtypes."""
    grp = _check_heads(q, k)
    b, hkv, sk, d = k.shape
    if delta is None:
        delta = _delta(o, dO)
    kr, vr = _repeat_kv(k, grp), _repeat_kv(v, grp)
    s = _masked_scores(q, kr, sm_scale, causal)
    p = torch.where(lse <= _NEG_INF / 2, 0.0, torch.exp(s - lse))
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dO.dtype).float(), dO.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", dO.float(), vr.float())
    ds = p * (dp - delta) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(), kr.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dk = dk.reshape(b, hkv, grp, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, grp, sk, d).sum(dim=2)
    return (dq.to(grad_dtype or q.dtype), dk.to(grad_dtype or k.dtype),
            dv.to(grad_dtype or v.dtype))


def _delta(o: torch.Tensor, dO: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) [B,H,Sq,1] f32 (outside the kernels, as
    it is outside the `pallas_call` in JAX)."""
    return (dO.float() * o.float()).sum(dim=-1, keepdim=True)


def _check_blocks(block_q: Optional[int], block_k: Optional[int]) -> None:
    for nm, b in (("block_q", block_q), ("block_k", block_k)):
        if b is not None and b <= 0:
            raise ValueError(f"{nm} must be positive, got {b}")


def _flash_fwd(q, k, v, sm_scale: float, causal: bool,
               block_q: Optional[int] = None, block_k: Optional[int] = None,
               with_lse: bool = False):
    """o, or (o, lse) with ``with_lse``. Kernel B1 on CUDA tensors, the
    plain version on CPU tensors. block_q/block_k are the JAX driver's
    tile sizes, accepted and ignored (see `flash_attention`)."""
    if q.is_cuda:
        o, lse = fak.flash_fwd_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), sm_scale, causal,
                                      with_lse)
    else:
        o, lse = _flash_fwd_reference(q, k, v, sm_scale, causal)
    return (o, lse) if with_lse else o


def _flash_bwd(q, k, v, out, lse, g, sm_scale: float, causal: bool,
               block_q: Optional[int] = None, block_k: Optional[int] = None,
               delta=None, grad_dtype=None):
    """(dq, dk, dv). grad_dtype overrides their dtype (ring attention
    accumulates per-shard partials in f32); delta may be precomputed by
    callers that invoke this once per kv shard. Kernels B3a and B3b on
    CUDA tensors, the plain version on CPU tensors. block_q/block_k: as
    in `_flash_fwd`."""
    if delta is None:
        delta = _delta(out, g)
    if not q.is_cuda:
        return _flash_bwd_reference(q, k, v, out, lse, g, sm_scale, causal,
                                    delta=delta, grad_dtype=grad_dtype)
    q, k, v, g, lse, delta = (t.contiguous() for t in (q, k, v, g, lse,
                                                       delta))
    dq = fak.flash_bwd_dq_kernel(q, k, v, g, lse, delta, sm_scale, causal,
                                 grad_dtype)
    dk, dv = fak.flash_bwd_dkv_kernel(q, k, v, g, lse, delta, sm_scale,
                                      causal, grad_dtype)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """`jax.custom_vjp` `_flash` of the JAX package: the forward saves
    (q, k, v, o, lse) and the backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        o, lse = _flash_fwd(q, k, v, sm_scale, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, g, ctx.sm_scale,
                                ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor,
                    k: torch.Tensor,
                    v: torch.Tensor,
                    *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k,v: [B,Hkv,Sk,D] (GQA when Hkv < H). -> [B,H,Sq,D],
    differentiable in q, k and v.

    block_q/block_k are validated as positive and otherwise ignored: on
    the TPU they sized the Pallas kernel's VMEM tiles, while the CUDA
    kernels use their own compile-time tiles (bf16 forward and dq: 128 q
    rows by 64 kv rows; bf16 dk/dv: 64 kv rows by 64 q rows; f32: 64
    rows, 32 q rows per step of the dk/dv loop). Results do not depend
    on them."""
    _check_blocks(block_q, block_k)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        # the kernels read contiguous [B, H, S, D]; saving the contiguous
        # copies spares the backward a second copy
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _Flash.apply(q, k, v, float(sm_scale), bool(causal))
