"""Llama-family decoder: config, seeded init and the shared layer math.

Port of the serving half of `ray_tpu/models/llama.py`: `LlamaConfig`
with its presets, `_rmsnorm`, `_rope` and `llama_init`. Params are a
plain dict of tensors in the JAX package's layout — every per-layer
weight stacked with a leading ``[n_layers]`` axis, `wq` ``[L, d, H,
hd]``, `wo` ``[L, H, hd, d]`` — so the einsum strings carry over
verbatim. `llama_forward` (the uncached training forward) waits for
the flash-attention kernel (ROADMAP.md Queue B, B1).

Storage dtype: the JAX package keeps f32 master weights and casts each
one with ``.astype(cfg.dtype)`` right before its einsum. Serving never
updates weights, so the port stores them in ``cfg.dtype`` once: the
einsums see the same bf16 operands at half the memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # weights and activations
    # Decode attention: "auto" launches the hand-written kernel on CUDA
    # tensors and runs the plain version on CPU tensors; "kernel" and
    # "reference" force one (see ops.attention.paged_attention).
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.attn_impl not in ("auto", "kernel", "reference"):
            raise ValueError(f"attn_impl must be auto|kernel|reference, "
                             f"got {self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # ---- presets ----
    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                           ffn_dim=13824, **kw)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        """Meta-Llama-3-8B's published widths."""
        return LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, ffn_dim=14336,
                           rope_theta=500000.0, max_seq_len=8192, **kw)

    @staticmethod
    def nano(**kw) -> "LlamaConfig":
        """Tiny f32 config for CPU tests."""
        defaults = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                        dtype=torch.float32)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    def num_params(self) -> int:
        d, v, f, L = self.dim, self.vocab_size, self.ffn_dim, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlp = 3 * d * f
        return v * d + L * (attn + mlp + 2 * d) + d + d * v


def resolve_device(device) -> torch.device:
    """The port's device rule: CUDA unless the caller asks for the CPU,
    and no silent fallback when CUDA is asked for and missing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return device


def _layer_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """name -> (per-layer shape, fan_in of the contraction or None for
    a norm scale)."""
    d, hd = cfg.dim, cfg.head_dim
    return {
        "wq": ((d, cfg.n_heads, hd), d),
        "wk": ((d, cfg.n_kv_heads, hd), d),
        "wv": ((d, cfg.n_kv_heads, hd), d),
        "wo": ((cfg.n_heads, hd, d), cfg.n_heads * hd),
        "w_gate": ((d, cfg.ffn_dim), d),
        "w_up": ((d, cfg.ffn_dim), d),
        "w_down": ((cfg.ffn_dim, d), cfg.ffn_dim),
        "attn_norm": ((d,), None),
        "mlp_norm": ((d,), None),
    }


@torch.no_grad()
def llama_init(cfg: LlamaConfig, *, seed: int = 0,
               device="cuda") -> Params:
    """Seeded random weights built on ``device`` in ``cfg.dtype``, with
    `ray_tpu.models.llama.llama_init`'s scales (normal * fan_in**-0.5,
    embedding * 0.02, unit norms). The draws come from a
    `torch.Generator`, so the values differ from the JAX init's; tests
    share weights through `ray_tpu_torch.convert` instead. Stacked
    weights are drawn one layer at a time, so the f32 scratch stays at
    one layer's size."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return x.mul_(std).to(cfg.dtype)

    layers = {}
    for name, (shape, fan_in) in _layer_shapes(cfg).items():
        if fan_in is None:
            layers[name] = torch.ones((cfg.n_layers,) + shape,
                                      dtype=cfg.dtype, device=device)
            continue
        w = torch.empty((cfg.n_layers,) + shape, dtype=cfg.dtype,
                        device=device)
        for i in range(cfg.n_layers):
            w[i] = normal(shape, fan_in ** -0.5)
        layers[name] = w
    return {
        "tok_embed": normal((cfg.vocab_size, cfg.dim), 0.02),
        "layers": layers,
        "final_norm": torch.ones((cfg.dim,), dtype=cfg.dtype,
                                 device=device),
        "lm_head": normal((cfg.dim, cfg.vocab_size), cfg.dim ** -0.5),
    }


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; rotate pairs (d, d + D/2)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs           # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
