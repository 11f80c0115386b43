"""Attention dispatch seams and their plain PyTorch versions.

Port of `ray_tpu/ops/attention.py`: `_repeat_kv`, `mha_reference`, the
`attention` dispatch (training and prefill attention over contiguous
K/V) and `paged_attention` (decode over the paged pool). In both seams
``impl="auto"`` launches the hand-written Hopper kernels for CUDA
tensors (`ops.flash_attention`, `ops.paged_attention_kernel`) and runs
the plain version for CPU tensors; "kernel" (or "flash", the JAX
package's name for it) and "reference" force one.
There is no fallback: on a CUDA tensor "auto" launches the kernel or
raises. The JAX dispatch's `shard_map` branch under a mesh has no
counterpart: under tensor parallelism each rank calls these seams with
its own q heads and the kv heads they read
(`parallel.tensor_parallel.local_heads`), so the kernels run at the
local head counts with their usual grouped-query mapping.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.paged_attention_kernel import paged_attention_kernel

_NEG_INF = -1e30
_IMPLS = ("auto", "kernel", "flash", "reference")


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, Hkv, S, D] -> [B, Hkv*n_rep, S, D] for grouped-query attention."""
    if n_rep == 1:
        return k
    b, hkv, s, d = k.shape
    return k[:, :, None].expand(b, hkv, n_rep, s, d).reshape(
        b, hkv * n_rep, s, d)


def mha_reference(q: torch.Tensor,
                  k: torch.Tensor,
                  v: torch.Tensor,
                  *,
                  causal: bool = True,
                  sm_scale: Optional[float] = None,
                  segment_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Stable-softmax attention. q: [B,H,Sq,D]; k,v: [B,Hkv,Sk,D].

    Computes in float32 whatever the input dtype (f32 operands: a bf16
    product is exact in f32, so this is JAX's bf16 einsum with
    preferred_element_type=float32) and returns q.dtype. A causal mask
    lets q row i see kv columns <= i + (Sk - Sq) (a kv prefix, as in
    decode). A row with no unmasked column attends to nothing: its
    output and gradient are zero, as in the kernels."""
    h, sq, d = q.shape[-3:]
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = qi >= ki
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else (mask[None, None] & seg)
    if mask is not None:
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor,
              k: torch.Tensor,
              v: torch.Tensor,
              *,
              causal: bool = True,
              sm_scale: Optional[float] = None,
              impl: str = "auto",
              block_q: Optional[int] = None,
              block_k: Optional[int] = None) -> torch.Tensor:
    """Dispatch: impl in {'auto', 'kernel', 'flash', 'reference'}.
    "kernel" (alias "flash") is
    `ops.flash_attention.flash_attention` (the CUDA kernels on CUDA
    tensors, their plain versions on CPU tensors); "reference" is
    `mha_reference`. block_q/block_k are the JAX kernel's tile sizes:
    validated, passed on, and ignored by the CUDA kernels (see
    `flash_attention`)."""
    for nm, b in (("block_q", block_q), ("block_k", block_k)):
        if b is not None and b <= 0:
            raise ValueError(f"{nm} must be positive, got {b}")
    if impl not in _IMPLS:
        raise ValueError(f"impl must be auto|kernel|flash|reference, "
                         f"got {impl!r}")
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "reference"
    if impl in ("kernel", "flash"):
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               block_q=block_q, block_k=block_k)
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)


def paged_attention(q: torch.Tensor,
                    k_pages: torch.Tensor,
                    v_pages: torch.Tensor,
                    block_tables: torch.Tensor,
                    q_slots: torch.Tensor,
                    *,
                    kv_valid_len: int,
                    sm_scale: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Attention over PAGED K/V: each query row reads its keys/values
    through a per-row block table instead of a contiguous cache row.

      q            [B, S, H, D]   queries (S=1 decode)
      k/v_pages    [NB, T, KV, D] ONE layer's slice of the block pool
                                  (block 0 is the reserved null block)
      block_tables [B, MB]        row b's logical block p covers cache
                                  slots [p*T, (p+1)*T); unallocated
                                  entries point at block 0
      q_slots      [B, S]         the cache slot each query occupies
      kv_valid_len int            slots >= this are masked
      k/v_scale    [NB, KV]       f32 dequant scales of an int8/fp8 pool

    The plain version ("reference") is op for op the JAX reference: the
    dense `_cached_attention` evaluated on the block-table gather —
    causal mask ``slot <= q_slot`` plus the valid-length cap, -1e30
    fill, f32 softmax. Gathered garbage is always masked and adds
    exactly 0.0. One difference from the kernel is inherited from the
    JAX pair: for a row with NO live slot, the reference's softmax over
    an all -1e30 row averages v uniformly, while the kernel (like the
    Pallas kernel) writes 0. The engine never forms such a row (a
    query's own slot is always live)."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be auto|kernel|flash|reference, "
                         f"got {impl!r}")
    B, S, H, D = q.shape
    NB, T, KV, _ = k_pages.shape
    if H % KV:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KV}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "reference"
    if impl in ("kernel", "flash"):
        return paged_attention_kernel(
            q, k_pages, v_pages, block_tables, q_slots,
            kv_valid_len=kv_valid_len, sm_scale=sm_scale,
            k_scale=k_scale, v_scale=v_scale)
    # Gather the per-row dense view [B, MB, T, KV, D] -> [B, MB*T, ..]
    bt = block_tables.long()
    k = k_pages[bt]
    v = v_pages[bt]
    if k_scale is not None:
        # dequant-in-gather; the view stays f32
        k = k.float() * k_scale[bt][:, :, None, :, None]
        v = v.float() * v_scale[bt][:, :, None, :, None]
    span = k.shape[1] * T
    k = k.reshape(B, span, KV, D)
    v = v.reshape(B, span, KV, D)
    # -- lockstep with generate._cached_attention from here on --
    rep = H // KV
    k = k.repeat_interleave(rep, dim=2)            # [B, span, H, D]
    v = v.repeat_interleave(rep, dim=2)
    # f32 operands: a bf16 x bf16 product is exact in f32, so this is
    # the bf16 einsum with f32 accumulation (preferred_element_type).
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    logits = logits * (sm_scale if sm_scale is not None else D ** -0.5)
    slots = torch.arange(span, device=q.device)
    mask = (slots[None, None, None, :] <= q_slots[:, None, :, None]) \
        & (slots[None, None, None, :] < kv_valid_len)
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)
