"""Low-bit paged-KV quantization: per-block, per-kv-head scales.

Port of `ray_tpu/ops/kv_quant.py`'s spec and arithmetic: a quantized
pool holds int8 (qmax 127) or fp8-e4m3 (qmax 448) values plus an f32
scale slab ``[NB, KV]`` per layer, one scale per block per kv head.
Symmetric absmax: ``s = amax / qmax`` (``s = 1.0`` for an all-zero
block so dequant stays exact and finite), ``q = round_or_cast(clip(x /
s, -qmax, qmax))``, dequant ``x' = q.float() * s``. The bytes equal the
JAX package's for the same f32 inputs (tested). The decode kernel
fuses `dequantize` into its page loads.

Two properties the engine (``kv_quant=``) leans on, as in the JAX
package:

* Requantization is byte-stable: requantizing a dequantized block with
  a freshly recomputed scale reproduces its bytes, PROVIDED the
  dequantized view stays float32 end to end (a bf16 round trip breaks
  it). That keeps shared prefix blocks byte-identical under the paged
  prefill's whole-view write-back.
* Stale slots are zeroed at every write: a block's scale is an absmax
  over all its slots, so every write site zeroes the slots at or past
  the row's written frontier before recomputing it.

`paged_quant_write` is the decode write site. Like the JAX function it
is plain tensor arithmetic outside any kernel; it writes the pool in
place, so a CUDA graph that captures it replays it on the same
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

KV_QUANT_MODES = ("int8", "fp8_e4m3")


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """One quantized-KV mode."""

    name: str         # "int8" | "fp8_e4m3"
    dtype: torch.dtype  # stored pool dtype
    qmax: float       # largest representable magnitude pre-scale
    itemsize: int = 1  # bytes per stored value

    @property
    def is_int(self) -> bool:
        return self.name == "int8"


_SPECS = {
    "int8": KVQuantSpec("int8", torch.int8, 127.0, 1),
    "fp8_e4m3": KVQuantSpec("fp8_e4m3", torch.float8_e4m3fn, 448.0, 1),
}


def resolve_kv_quant(name: Optional[str]) -> Optional[KVQuantSpec]:
    """Map a ``kv_quant`` knob to a spec (None -> None)."""
    if name is None:
        return None
    spec = _SPECS.get(name)
    if spec is None:
        raise ValueError(
            f"kv_quant must be one of {KV_QUANT_MODES} or None, got "
            f"{name!r}")
    return spec


def block_scale(amax: torch.Tensor, qspec: KVQuantSpec) -> torch.Tensor:
    """amax -> scale with the all-zero guard (scale 1.0, so dequant of
    a zero block is exactly zero and never divides by zero)."""
    amax = amax.float()
    return torch.where(amax > 0, amax / qspec.qmax,
                       torch.ones_like(amax))


def quantize(x: torch.Tensor, scale: torch.Tensor,
             qspec: KVQuantSpec) -> torch.Tensor:
    """``x`` -> stored dtype; ``scale`` must broadcast against x."""
    y = torch.clamp(x.float() / scale, -qspec.qmax, qspec.qmax)
    if qspec.is_int:
        y = torch.round(y)          # half to even, as jnp.round
    return y.to(qspec.dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Stored dtype -> f32. Keep the result f32: a bf16 round trip
    breaks requantization byte-stability."""
    return q.float() * scale


def raw(pages: torch.Tensor) -> torch.Tensor:
    """A byte view of an fp8 pool (other dtypes pass through): the
    pool's gathers, scatters and copies run on it, so they never need an
    fp8 indexing kernel, and an fp8 copy moves the bytes verbatim."""
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)
    return pages


def paged_quant_write(pages: torch.Tensor, scales: torch.Tensor,
                      bt: torch.Tensor, start: torch.Tensor,
                      vals: torch.Tensor, qspec: KVQuantSpec
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-modify-write ``vals`` [B, S, KV, D] into the quantized
    ``pages`` [NB, T, KV, D] at cache slots ``start[b] + s`` routed
    through the block table ``bt`` [B, MB], recomputing the per-block,
    per-kv-head ``scales`` [NB, KV] of every block it touches. Writes
    both in place and returns them.

    A static loop over the (at most ``(S + T - 2) // T + 1``) blocks a
    window can touch; each pass does ONE read-modify-write of one block
    per row: gather and dequantize it to f32, write in the window's
    tokens that land in it (offset ``(start + s) % T``), zero every slot
    at or past ``start + S``, recompute the scale (all-zero guard),
    requantize and scatter it back. A row whose logical block runs off
    the table writes the null block 0, which is never attended; rows
    that share block 0 there write it in an unspecified order."""
    B, S, KV, D = vals.shape
    T = pages.shape[1]
    MB = bt.shape[1]
    dev = vals.device
    vals = vals.float()
    store = raw(pages)
    start = start.long()
    bidx = torch.arange(B, device=dev)
    slot_in_block = torch.arange(T, device=dev)
    pos = (start % T)[:, None] + torch.arange(S, device=dev)[None, :]
    for w in range((S + T - 2) // T + 1):
        lb = start // T + w                                   # [B]
        blk = torch.where(lb < MB, bt[bidx, lb.clamp(max=MB - 1)].long(),
                          0)
        cur = dequantize(store[blk].view(pages.dtype),
                         scales[blk][:, None, :, None])     # [B, T, KV, D]
        for s in range(S):
            # token s lands in this block iff (off0 + s) // T == w
            hit = (pos[:, s] // T == w)[:, None] \
                & (slot_in_block[None, :] == (pos[:, s] % T)[:, None])
            cur = torch.where(hit[:, :, None, None], vals[:, s, None], cur)
        live = (lb * T)[:, None] + slot_in_block[None, :] \
            < (start + S)[:, None]                            # [B, T]
        cur = torch.where(live[:, :, None, None], cur, 0.0)
        s_new = block_scale(cur.abs().amax(dim=(1, 3)), qspec)  # [B, KV]
        store[blk] = raw(quantize(cur, s_new[:, None, :, None], qspec))
        scales[blk] = s_new
    return pages, scales
