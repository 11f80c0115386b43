"""Wrappers of the hand-written Hopper flash-attention kernels.

Port of the three `pl.pallas_call` sites of
`ray_tpu/ops/flash_attention.py`: the forward with the row logsumexp
(`_flash_fwd`), the dq backward and the dk/dv backward (`_flash_bwd`).
The kernel is chosen by the inputs' dtype:

- bf16: ``csrc/flash_attention_sm90.cu`` (wgmma fed by a TMA ring) for
  all three, whatever the gradients' dtype;
- f32: ``csrc/flash_attention.cu`` (exact f32 FMAs: wgmma has no exact
  f32 form).

That is a dispatch by type, not a fallback: a kernel that does not build
or launch raises. Each source carries its design notes at its top, is
built by `ray_tpu_torch._build` at its first launch and is called
through ctypes on PyTorch's current stream. The plain PyTorch versions
are `ops.flash_attention._flash_fwd_reference` and
`_flash_bwd_reference`.

`fwd_launches`, `dq_launches` and `dkv_launches` count kernel launches
(one per call that reached its kernel); a run sets them to 0 before the
path it wants to account for.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch import _build

fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    if not getattr(lib, "_ray_tpu_torch_bound", False):
        lib.ray_tpu_torch_flash_fwd.argtypes = \
            [_P] * 5 + [_I] * 7 + [_F, _I, _P]
        lib.ray_tpu_torch_flash_bwd_dq.argtypes = \
            [_P] * 7 + [_I] * 8 + [_F, _I, _P]
        lib.ray_tpu_torch_flash_bwd_dkv.argtypes = \
            [_P] * 8 + [_I] * 8 + [_F, _I, _P]
        for fn in (lib.ray_tpu_torch_flash_fwd,
                   lib.ray_tpu_torch_flash_bwd_dq,
                   lib.ray_tpu_torch_flash_bwd_dkv):
            fn.restype = _I
        lib.ray_tpu_torch_flash_error_string.argtypes = [_I]
        lib.ray_tpu_torch_flash_error_string.restype = ctypes.c_char_p
        lib._ray_tpu_torch_bound = True
    return lib


def _lib_sm90() -> ctypes.CDLL:
    lib = _build.library("flash_attention_sm90")
    if not getattr(lib, "_ray_tpu_torch_bound", False):
        lib.ray_tpu_torch_flash_sm90_fwd.argtypes = \
            [_P] * 5 + [_I] * 6 + [_F, _I, _P]
        lib.ray_tpu_torch_flash_sm90_bwd_dq.argtypes = \
            [_P] * 7 + [_I] * 7 + [_F, _I, _P]
        lib.ray_tpu_torch_flash_sm90_bwd_dkv.argtypes = \
            [_P] * 8 + [_I] * 7 + [_F, _I, _P]
        for fn in (lib.ray_tpu_torch_flash_sm90_fwd,
                   lib.ray_tpu_torch_flash_sm90_bwd_dq,
                   lib.ray_tpu_torch_flash_sm90_bwd_dkv):
            fn.restype = _I
        lib.ray_tpu_torch_flash_sm90_error_string.argtypes = [_I]
        lib.ray_tpu_torch_flash_sm90_error_string.restype = ctypes.c_char_p
        lib._ray_tpu_torch_bound = True
    return lib


def _sm90(dtype: torch.dtype) -> bool:
    """Whether inputs of ``dtype`` take the wgmma kernels."""
    return dtype == torch.bfloat16


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def _check_inputs(q, k, v, dout=None, lse=None, delta=None
                  ) -> Tuple[int, ...]:
    """Validate q [B,H,Sq,D], k/v [B,Hkv,Sk,D] and, for the backward,
    dO (q's shape and dtype) and lse/delta ([B,H,Sq,1] float32); return
    (B, H, Hkv, Sq, Sk, D)."""
    rows = [t for t in (lse, delta) if t is not None]
    tensors = [q, k, v] + ([dout] if dout is not None else []) + rows
    _check(all(t.is_cuda for t in tensors),
           "needs CUDA tensors (CPU tensors take the plain version)")
    _check(len({t.device for t in tensors}) == 1,
           "tensors are on different devices")
    _check(all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in tensors),
           "tensors must be 16-byte aligned")
    _check(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
           "q must be [B, H, Sq, D] and k, v [B, Hkv, Sk, D]")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _check(k.shape[0] == B and k.shape[3] == D, "q and k/v shapes differ")
    _check(q.dtype in _CODES, f"dtype {q.dtype} not supported")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _check(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _check(Hkv > 0 and H % Hkv == 0,
           f"q heads {H} not a multiple of kv heads {Hkv}")
    if dout is not None:
        _check(dout.shape == q.shape and dout.dtype == q.dtype,
               "dO must have q's shape and dtype")
    _check(all(t.dtype == torch.float32 and t.shape == (B, H, Sq, 1)
               for t in rows), "lse and delta must be [B, H, Sq, 1] float32")
    return B, H, Hkv, Sq, Sk, D


def _out_dtype(q: torch.Tensor, grad_dtype: Optional[torch.dtype]):
    out = grad_dtype or q.dtype
    _check(out == q.dtype or out == torch.float32,
           f"grad_dtype {grad_dtype} not supported for {q.dtype} inputs")
    return out


def _launch(what: str, fn, strerror, device: torch.device, *args) -> None:
    """Call a C launcher on ``device``'s current stream; raise with
    ``strerror``'s text if the launch was refused."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {what} kernel launch failed: "
                           + strerror(err).decode())


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float, causal: bool, with_lse: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel B1: o [B,H,Sq,D] in q's dtype and, with ``with_lse``, the
    row logsumexp [B,H,Sq,1] float32 (else None)."""
    global fwd_launches
    B, H, Hkv, Sq, Sk, D = _check_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq, 1), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if Sq == 0:
        return o, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None)
    shape = (B, H, Hkv, Sq, Sk, D, float(sm_scale), int(bool(causal)))
    if _sm90(q.dtype):
        lib = _lib_sm90()
        _launch("forward", lib.ray_tpu_torch_flash_sm90_fwd,
                lib.ray_tpu_torch_flash_sm90_error_string, q.device, *ptrs,
                *shape)
    else:
        lib = _lib()
        _launch("forward", lib.ray_tpu_torch_flash_fwd,
                lib.ray_tpu_torch_flash_error_string, q.device, *ptrs,
                _CODES[q.dtype], *shape)
    fwd_launches += 1
    return o, lse


def flash_bwd_dq_kernel(q, k, v, dout, lse, delta, sm_scale: float,
                        causal: bool,
                        grad_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Kernel B3a: dq [B,H,Sq,D] in ``grad_dtype or q.dtype``."""
    global dq_launches
    B, H, Hkv, Sq, Sk, D = _check_inputs(q, k, v, dout, lse, delta)
    out_dtype = _out_dtype(q, grad_dtype)
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if Sq == 0:
        return dq
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    shape = (B, H, Hkv, Sq, Sk, D, float(sm_scale), int(bool(causal)))
    if _sm90(q.dtype):
        lib = _lib_sm90()
        _launch("dq", lib.ray_tpu_torch_flash_sm90_bwd_dq,
                lib.ray_tpu_torch_flash_sm90_error_string, q.device, *ptrs,
                _CODES[out_dtype], *shape)
    else:
        lib = _lib()
        _launch("dq", lib.ray_tpu_torch_flash_bwd_dq,
                lib.ray_tpu_torch_flash_error_string, q.device, *ptrs,
                _CODES[q.dtype], _CODES[out_dtype], *shape)
    dq_launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, sm_scale: float,
                         causal: bool,
                         grad_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3b: dk, dv [B,Hkv,Sk,D] in ``grad_dtype or k.dtype``,
    already summed over each GQA group."""
    global dkv_launches
    B, H, Hkv, Sq, Sk, D = _check_inputs(q, k, v, dout, lse, delta)
    out_dtype = _out_dtype(q, grad_dtype)
    dk = torch.empty(k.shape, dtype=out_dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=out_dtype, device=v.device)
    if Sk == 0:
        return dk, dv
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (B, H, Hkv, Sq, Sk, D, float(sm_scale), int(bool(causal)))
    if _sm90(q.dtype):
        lib = _lib_sm90()
        _launch("dk/dv", lib.ray_tpu_torch_flash_sm90_bwd_dkv,
                lib.ray_tpu_torch_flash_sm90_error_string, q.device, *ptrs,
                _CODES[out_dtype], *shape)
    else:
        lib = _lib()
        _launch("dk/dv", lib.ray_tpu_torch_flash_bwd_dkv,
                lib.ray_tpu_torch_flash_error_string, q.device, *ptrs,
                _CODES[q.dtype], _CODES[out_dtype], *shape)
    dkv_launches += 1
    return dk, dv
