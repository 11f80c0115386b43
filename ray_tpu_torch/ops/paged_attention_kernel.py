"""Wrapper of the hand-written Hopper paged decode-attention kernel.

Port of `ray_tpu/ops/paged_attention_kernel.py:paged_attention_kernel`
(Pallas). The kernel is ``csrc/paged_attention.cu`` (design notes at its
top): a split-KV pass over contiguous ranges of each row's block table
(on the tensor cores for bf16 q over bf16, int8 or fp8 pages; exact f32
FMAs for f32 q or pages), then a pass that merges the partials. It is
built by `ray_tpu_torch._build` at the first launch and called through
ctypes on PyTorch's current stream. Its plain PyTorch version is
`ops.attention.paged_attention(..., impl="reference")`;
`split_kv_reference` is the kernel's algorithm in plain PyTorch, for the
tests.

The launch is planned on the host from static shapes only (`split_plan`;
the kernel source sizes its page rings): nothing is read from the device,
so the decode loop keeps its tokens on the card and the call can be
captured in a CUDA graph.

`launches` counts calls that reached the kernel (one per call, whose
two launches, split and combine, go out together); a run sets it to 0
before the path it wants to account for.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch import _build

launches = 0

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_QUANT_PAGES = (torch.int8, torch.float8_e4m3fn)
HEAD_DIMS = (64, 128)
BLOCKS_PER_SM = 4       # split blocks the plan aims at per SM
MIN_SPLIT_SLOTS = 128   # cache slots a split covers, at least

_NEG_INF = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_attention")
    if not getattr(lib, "_ray_tpu_torch_bound", False):
        fn = lib.ray_tpu_torch_paged_attention
        fn.argtypes = [_P] * 10 + [_I] * 12 + [ctypes.c_float, _P]
        fn.restype = _I
        fn = lib.ray_tpu_torch_paged_attention_smem
        fn.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
        fn.restype = ctypes.c_size_t
        lib.ray_tpu_torch_cuda_error_string.argtypes = [_I]
        lib.ray_tpu_torch_cuda_error_string.restype = ctypes.c_char_p
        lib._ray_tpu_torch_bound = True
    return lib


def split_plan(max_blocks: int, block_tokens: int, batch: int,
               kv_heads: int, sms: int) -> Tuple[int, int]:
    """(block-table entries per split, number of splits) for rows of
    ``max_blocks`` entries of ``block_tokens`` slots, ``batch`` rows,
    ``kv_heads`` kv heads, on a card with ``sms`` SMs. Split i covers
    entries [i * per, min((i + 1) * per, max_blocks)); together the
    splits cover every entry once. The grid of (split, kv head, row)
    blocks aims at BLOCKS_PER_SM per SM, each split covering at least
    MIN_SPLIT_SLOTS slots (a split's partials cost a write and a read)."""
    want = -(-BLOCKS_PER_SM * sms // max(1, batch * kv_heads))
    per = max(-(-MIN_SPLIT_SLOTS // block_tokens), -(-max_blocks // want))
    per = max(1, min(per, max_blocks))
    return per, max(1, -(-max_blocks // per))


@functools.lru_cache(maxsize=None)
def kernel_config(q_dtype: torch.dtype, page_dtype: torch.dtype,
                  q_rows: int, head_dim: int, block_tokens: int
                  ) -> Tuple[int, bool]:
    """(dynamic shared memory of one split block, whether it is the
    tensor-core kernel) for ``q_rows`` (= H/KV * S) query rows over pages
    of ``block_tokens`` slots; 0 bytes when no page ring fits. Builds the
    library on first use."""
    mma = _I(0)
    smem = _lib().ray_tpu_torch_paged_attention_smem(
        _Q_CODES[q_dtype], _PAGE_CODES[page_dtype], q_rows, head_dim,
        block_tokens, ctypes.byref(mma))
    return smem, bool(mma.value)


def split_kv_reference(q: torch.Tensor,
                       k_pages: torch.Tensor,
                       v_pages: torch.Tensor,
                       block_tables: torch.Tensor,
                       q_slots: torch.Tensor,
                       *,
                       kv_valid_len: int,
                       pages_per_split: int,
                       sm_scale: Optional[float] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The kernel's split-KV algorithm in plain PyTorch, in f32: for each
    split of ``pages_per_split`` block-table entries, the partial (acc,
    m, l) of each (row, query, head) over the split's slots under the
    mask ``slot <= q_slot && slot < kv_valid_len``, with masked
    probabilities zeroed; a split that starts at or past its row's live
    frontier is empty (m = -1e30, l = 0); then the exact f32 merge of
    the combine pass. A row with no live slot gives 0. The tests hold it
    to the JAX reference; the main path never calls it."""
    B, S, H, D = q.shape
    NB, T, KV, _ = k_pages.shape
    MB = block_tables.shape[1]
    g = H // KV
    scale = sm_scale if sm_scale is not None else D ** -0.5
    live = (q_slots.long().amax(dim=1) + 1).clamp(max=kv_valid_len)
    n_pages = ((live + T - 1) // T).clamp(min=0, max=MB)      # [B]
    accs, ms, ls = [], [], []
    for j0 in range(0, MB, pages_per_split):
        bt = block_tables[:, j0:j0 + pages_per_split].long()
        n = bt.shape[1] * T
        k = k_pages[bt].float()                              # [B,P,T,KV,D]
        v = v_pages[bt].float()
        if k_scale is not None:
            k = k * k_scale[bt][:, :, None, :, None]
            v = v * v_scale[bt][:, :, None, :, None]
        k = k.reshape(B, n, KV, D).repeat_interleave(g, dim=2)
        v = v.reshape(B, n, KV, D).repeat_interleave(g, dim=2)
        s = torch.einsum("bshd,bthd->bhst", q.float(), k) * scale
        slots = j0 * T + torch.arange(n, device=q.device)
        mask = (slots[None, None, None, :] <= q_slots[:, None, :, None]) \
            & (slots[None, None, None, :] < kv_valid_len) \
            & (j0 < n_pages)[:, None, None, None]
        s = torch.where(mask, s, _NEG_INF)
        m = s.amax(dim=-1)                                   # [B,H,S]
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        accs.append(torch.einsum("bhst,bthd->bhsd", p, v))
        ms.append(m)
        ls.append(p.sum(dim=-1))
    m_all = torch.stack(ms)                                  # [n,B,H,S]
    top = m_all.amax(dim=0)
    w = torch.where(m_all > _NEG_INF / 2, torch.exp(m_all - top), 0.0)
    den = (torch.stack(ls) * w).sum(dim=0)
    num = (torch.stack(accs) * w[..., None]).sum(dim=0)
    row_live = (top > _NEG_INF / 2)[..., None]
    out = torch.where(row_live,
                      num / torch.where(row_live, den[..., None], 1.0), 0.0)
    return out.permute(0, 2, 1, 3).to(q.dtype)               # [B,S,H,D]


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

    Every tensor must be a contiguous, 16-byte aligned CUDA tensor on
    one device; anything else raises (CPU tensors take the plain
    version). Entries of block_tables are trusted to lie in [0, NB):
    the engine writes them. Returns a new [B, S, H, D] tensor in q's
    dtype."""
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
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
           "q and pages must be 16-byte aligned")
    MB = block_tables.shape[1]
    _check(kernel_config(q.dtype, k_pages.dtype, (H // KV) * S, D, T)[0] > 0,
           f"no page ring of T={T} slots for g*S={(H // KV) * S} query rows "
           f"fits in shared memory")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    per, splits = split_plan(MB, T, B, KV, sms)
    out = torch.empty_like(q)
    # the partials: o [splits, B, S, H, D], then (m, l) [splits, B, S, H]
    n = splits * B * S * H
    part = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ray_tpu_torch_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), q_slots.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, out.data_ptr(),
            part.data_ptr(), part.data_ptr() + 4 * n * D,
            _Q_CODES[q.dtype], _PAGE_CODES[k_pages.dtype], B, S, H, KV, D,
            T, MB, int(kv_valid_len), per, splits, float(scale), stream)
    if err != 0:
        raise RuntimeError(
            "paged_attention kernel launch failed: "
            + lib.ray_tpu_torch_cuda_error_string(err).decode())
    launches += 1
    return out
