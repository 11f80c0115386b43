"""Ulysses (DeepSpeed-Ulysses style) sequence parallelism.

Port of `ray_tpu/ops/ulysses.py`. Where ring attention rotates k/v
blocks around the sp group, Ulysses swaps the split dimension with two
all-to-alls (`parallel.sequence_parallel.AllToAll`): the sequence-split
q, k and v become head-split, each rank runs attention over the WHOLE
sequence for its ``H / sp`` heads (`ops.attention.attention`: the flash
kernels on CUDA tensors, the plain version on CPU tensors), and the
second all-to-all splits the output by sequence again. Exact, with no
online-softmax merge.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel.sequence_parallel import (AllToAll, SPGroup,
                                                      is_split)


def swap_in(x: torch.Tensor, sp: Optional[SPGroup]) -> torch.Tensor:
    """[B, H, S/sp, D] -> [B, H/sp, S, D]: split heads, gather the
    sequence."""
    return AllToAll.apply(x, sp, 1, 2) if is_split(sp) else x


def swap_out(x: torch.Tensor, sp: Optional[SPGroup]) -> torch.Tensor:
    """[B, H/sp, S, D] -> [B, H, S/sp, D]: the inverse of `swap_in`."""
    return AllToAll.apply(x, sp, 2, 1) if is_split(sp) else x


def ulysses_attention(q: torch.Tensor,
                      k: torch.Tensor,
                      v: torch.Tensor,
                      sp: Optional[SPGroup] = None,
                      causal: bool = True,
                      impl: str = "auto",
                      block_q: Optional[int] = None,
                      block_k: Optional[int] = None) -> torch.Tensor:
    """q [B, H, S/sp, D], k/v [B, Hkv, S/sp, D]: this rank's block of
    the sequence (``sp`` None: the whole of it). Returns [B, H, S/sp,
    D]. H and Hkv must both split over sp: rank r takes q heads
    ``[r·H/sp, (r+1)·H/sp)`` and kv heads ``[r·Hkv/sp, (r+1)·Hkv/sp)``,
    which are the ones those q heads read."""
    n = sp.size if is_split(sp) else 1
    if q.shape[1] % n:
        raise ValueError(f"n_heads={q.shape[1]} must be divisible by sp={n}")
    if k.shape[1] % n:
        raise ValueError(
            f"n_kv_heads={k.shape[1]} must be divisible by sp={n}")
    out = attention(swap_in(q, sp), swap_in(k, sp), swap_in(v, sp),
                    causal=causal, impl=impl, block_q=block_q,
                    block_k=block_k)
    return swap_out(out, sp)
