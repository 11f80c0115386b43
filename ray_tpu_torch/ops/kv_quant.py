"""Low-bit paged-KV quantization: per-block, per-kv-head scales.

Port of `ray_tpu/ops/kv_quant.py`'s spec and arithmetic: a quantized
pool holds int8 (qmax 127) or fp8-e4m3 (qmax 448) values plus an f32
scale slab ``[NB, KV]`` per layer, one scale per block per kv head.
Symmetric absmax: ``s = amax / qmax`` (``s = 1.0`` for an all-zero
block so dequant stays exact and finite), ``q = round_or_cast(clip(x /
s, -qmax, qmax))``, dequant ``x' = q.float() * s``. The bytes equal the
JAX package's for the same f32 inputs (tested). The decode kernel
fuses `dequantize` into its page loads.

The engine's quantized write path (`paged_quant_write`, ``kv_quant=``)
waits for a later slice (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
