"""Wrapper of the hand-written Hopper paged decode-attention kernel.

Port of `ray_tpu/ops/paged_attention_kernel.py:paged_attention_kernel`
(Pallas). The kernel is ``csrc/paged_attention.cu`` (design notes at its
top), built by `ray_tpu_torch._build` at the first launch and called
through ctypes on PyTorch's current stream. Its plain PyTorch version is
`ops.attention.paged_attention(..., impl="reference")`.

`launches` counts kernel launches (one per call that reached the
kernel); a run sets it to 0 before the path it wants to account for.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch import _build

launches = 0

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_QUANT_PAGES = (torch.int8, torch.float8_e4m3fn)
HEAD_DIMS = (64, 128)
# Shared memory one H100 block may use (dynamic, after opt-in).
MAX_SMEM_BYTES = 227 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    if not getattr(lib, "_ray_tpu_torch_bound", False):
        fn = lib.ray_tpu_torch_paged_attention
        fn.argtypes = [_P] * 8 + [_I] * 10 + [ctypes.c_float, _P]
        fn.restype = _I
        lib.ray_tpu_torch_paged_attention_smem.argtypes = [_I, _I, _I]
        lib.ray_tpu_torch_paged_attention_smem.restype = ctypes.c_size_t
        lib.ray_tpu_torch_cuda_error_string.argtypes = [_I]
        lib.ray_tpu_torch_cuda_error_string.restype = ctypes.c_char_p
        lib._ray_tpu_torch_bound = True
    return lib


def shared_memory_bytes(q_rows: int, head_dim: int,
                        block_tokens: int) -> int:
    """Dynamic shared memory of one thread block that serves ``q_rows``
    (= H/KV * S) query rows over pages of ``block_tokens`` slots."""
    return _lib().ray_tpu_torch_paged_attention_smem(q_rows, head_dim,
                                                     block_tokens)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_kernel: {msg}")


def paged_attention_kernel(q: torch.Tensor,
                           k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           q_slots: torch.Tensor,
                           *,
                           kv_valid_len: int,
                           sm_scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Same contract as `ops.attention.paged_attention`, on the card.

      q            [B, S, H, D]   float32 or bfloat16, D in HEAD_DIMS
      k/v_pages    [NB, T, KV, D] float32, bfloat16, int8 or
                                  float8_e4m3fn (the last two need
                                  k/v_scale [NB, KV] float32)
      block_tables [B, MB] int32; q_slots [B, S] int32

    Every tensor must be a contiguous CUDA tensor on one device;
    anything else raises (CPU tensors take the plain version). Entries
    of block_tables are trusted to lie in [0, NB): the engine writes
    them. Returns a new [B, S, H, D] tensor in q's dtype."""
    global launches
    scales = [t for t in (k_scale, v_scale) if t is not None]
    tensors = [q, k_pages, v_pages, block_tables, q_slots] + scales
    _check(all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    _check(q.dim() == 4 and k_pages.dim() == 4,
           "q must be [B, S, H, D] and pages [NB, T, KV, D]")
    B, S, H, D = q.shape
    NB, T, KV, Dk = k_pages.shape
    _check(q.dtype in _Q_CODES, f"q dtype {q.dtype} not supported")
    _check(k_pages.dtype in _PAGE_CODES,
           f"page dtype {k_pages.dtype} not supported")
    _check(v_pages.dtype == k_pages.dtype
           and v_pages.shape == k_pages.shape, "k/v pages differ")
    _check(Dk == D and D in HEAD_DIMS,
           f"head dim {D} (pages {Dk}) not in {HEAD_DIMS}")
    _check(KV > 0 and H % KV == 0,
           f"q heads {H} not a multiple of kv heads {KV}")
    _check(block_tables.dtype == torch.int32 and block_tables.dim() == 2
           and block_tables.shape[0] == B, "block_tables must be [B, MB] "
           "int32")
    _check(q_slots.dtype == torch.int32
           and tuple(q_slots.shape) == (B, S), "q_slots must be [B, S] "
           "int32")
    quant = k_pages.dtype in _QUANT_PAGES
    _check(len(scales) == (2 if quant else 0),
           "int8/fp8 pages need k_scale and v_scale; float pages take "
           "none")
    for s in scales:
        _check(s.dtype == torch.float32 and tuple(s.shape) == (NB, KV),
               "scales must be [NB, KV] float32")
    _check(all(t.is_cuda for t in tensors),
           "needs CUDA tensors (CPU tensors take impl='reference')")
    _check(len({t.device for t in tensors}) == 1,
           "tensors are on different devices")
    MB = block_tables.shape[1]
    smem = shared_memory_bytes((H // KV) * S, D, T)
    _check(smem <= MAX_SMEM_BYTES,
           f"{smem} bytes of shared memory for g*S={(H // KV) * S} query "
           f"rows and T={T} exceed {MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ray_tpu_torch_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), q_slots.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, out.data_ptr(),
            _Q_CODES[q.dtype], _PAGE_CODES[k_pages.dtype], B, S, H, KV, D,
            T, MB, int(kv_valid_len), float(scale), stream)
    if err != 0:
        raise RuntimeError(
            "paged_attention kernel launch failed: "
            + lib.ray_tpu_torch_cuda_error_string(err).decode())
    launches += 1
    return out
