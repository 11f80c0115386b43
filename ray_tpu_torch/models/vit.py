"""Vision Transformer (ViT) classifier.

Port of `ray_tpu/models/vit.py`: `ViTConfig`, `vit_init`, the specs,
`_layernorm`, `_encoder_layer`, `vit_forward` and `vit_loss`, in the JAX
package's layout (per-layer weights stacked with a leading
``[n_layers]`` axis). Patchify is a reshape: [B,H,W,C] -> [B, N, p*p*C]
-> a linear embedding. The attention is non-causal over the N + 1
tokens (`ops.attention.attention`: B1/B3 on the card; the default
config's head dim is 32). bf16 activations over f32 master weights, a
per-layer checkpoint under ``remat``.

Under a tp group (`vit_loss(..., tp=tp_group(mesh))`, the explicit form
of the JAX step's GSPMD split) a rank computes its heads and its
columns of the MLP: f before the qkv and w_in products, g after wo and
w_out (``b_out`` added once, after the g). ``wqkv`` stays the
contiguous tp shard its spec gives, which is not head-aligned; the rank
forms its heads' q/k/v columns with an all-gather each way
(`tensor_parallel.fused_heads`). The classifier ``head`` is
vocab-parallel where the classes split over tp (`vocab_nll`)
and replicated where the pruned rules replicate it. ``patch_embed``,
``cls_token``, ``pos_embed`` and the norms stay replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel import data_parallel as dp
from ray_tpu_torch.parallel.sharding import logical_tree_to_mesh
from ray_tpu_torch.parallel.tensor_parallel import (TPGroup, check_tp_width,
                                                    copy_to_tp, fused_heads,
                                                    gather_logits,
                                                    reduce_from_tp, vocab_nll)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    dim: int = 192
    n_layers: int = 6
    n_heads: int = 6
    ffn_dim: int = 768
    num_classes: int = 10
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # "auto" (kernels on CUDA tensors), "kernel" or "reference"
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError("patch_size must divide image_size")
        if self.dim % self.n_heads:
            raise ValueError("n_heads must divide dim")

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    def num_params(self) -> int:
        # Mirrors vit_init: per layer 4 LN vectors (4d), qkv (3d^2) + out
        # (d^2) projections, MLP w_in/b_in/w_out/b_out (2df + f + d); top
        # level patch_embed (no bias), cls, pos, final LN pair, bias-free
        # head.
        d, f = self.dim, self.ffn_dim
        per_layer = 4 * d * d + 2 * d * f + 5 * d + f
        return (self.patch_dim * d + d + (self.n_patches + 1) * d +
                self.n_layers * per_layer + 2 * d +
                d * self.num_classes)


def _layer_shapes(cfg: ViTConfig) -> Dict[str, tuple]:
    d, f = cfg.dim, cfg.ffn_dim
    return {
        # name: (shape, logical axes, fan_in, or None for a scale / 0 for
        # a bias)
        "ln1_scale": ((d,), ("embed",), None),
        "ln1_bias": ((d,), ("embed",), 0),
        "wqkv": ((d, 3 * d), ("embed", "qkv"), d),
        "wo": ((d, d), ("heads", "embed"), d),
        "ln2_scale": ((d,), ("embed",), None),
        "ln2_bias": ((d,), ("embed",), 0),
        "w_in": ((d, f), ("embed", "mlp"), d),
        "b_in": ((f,), ("mlp",), 0),
        "w_out": ((f, d), ("mlp", "embed"), f),
        "b_out": ((d,), ("embed",), 0),
    }


@torch.no_grad()
def vit_init(cfg: ViTConfig, *, seed: int = 0, device="cuda",
             dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random weights with the JAX init's scales (a
    `torch.Generator`'s draws; tests carry JAX's weights across through
    `ray_tpu_torch.convert`)."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32).mul_(std).to(dtype)

    layers = {}
    for name, (shape, _, fan_in) in _layer_shapes(cfg).items():
        full = (cfg.n_layers,) + shape
        if fan_in is None:
            layers[name] = torch.ones(full, dtype=dtype, device=device)
        elif fan_in == 0:
            layers[name] = torch.zeros(full, dtype=dtype, device=device)
        else:
            layers[name] = normal(full, fan_in ** -0.5)
    d = cfg.dim
    return {
        "patch_embed": normal((cfg.patch_dim, d), cfg.patch_dim ** -0.5),
        "cls_token": torch.zeros((d,), dtype=dtype, device=device),
        "pos_embed": normal((cfg.n_patches + 1, d), 0.02),
        "layers": layers,
        "final_ln_scale": torch.ones((d,), dtype=dtype, device=device),
        "final_ln_bias": torch.zeros((d,), dtype=dtype, device=device),
        "head": normal((d, cfg.num_classes), d ** -0.5),
    }


def vit_logical_specs(cfg: ViTConfig) -> Params:
    layer_specs = {name: ("layers",) + logical
                   for name, (_, logical, _f) in _layer_shapes(cfg).items()}
    return {
        "patch_embed": (None, "embed"),
        "cls_token": ("embed",),
        "pos_embed": (None, "embed"),
        "layers": layer_specs,
        "final_ln_scale": ("embed",),
        "final_ln_bias": ("embed",),
        "head": ("embed", "vocab"),   # classes shard like the LM head
    }


def vit_param_specs(cfg: ViTConfig, rules=None) -> Params:
    return logical_tree_to_mesh(vit_logical_specs(cfg), rules)


def _layernorm(x, scale, bias, eps):
    """In f32, rounded to the activation dtype before scale and bias."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def _encoder_layer(x: torch.Tensor, layer: Dict[str, torch.Tensor],
                   cfg: ViTConfig, tp: Optional[TPGroup] = None
                   ) -> torch.Tensor:
    B, N, d = x.shape
    hd = cfg.dim // cfg.n_heads
    y = _layernorm(x, layer["ln1_scale"], layer["ln1_bias"], cfg.norm_eps)
    wqkv = fused_heads(layer["wqkv"], tp, cfg.dim, cfg.n_heads)
    h = wqkv.shape[-1] // (3 * hd)           # this rank's heads
    qkv = (copy_to_tp(y, tp) @ wqkv.to(y.dtype)).reshape(B, N, 3, h, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    att = attention(q, k, v, causal=False, impl=cfg.attn_impl)  # [B,h,N,hd]
    att = att.transpose(1, 2).reshape(B, N, h * hd)
    x = x + reduce_from_tp(att @ layer["wo"].to(att.dtype), tp)
    y = _layernorm(x, layer["ln2_scale"], layer["ln2_bias"], cfg.norm_eps)
    # jax.nn.gelu's default is the tanh approximation
    y = F.gelu(copy_to_tp(y, tp) @ layer["w_in"].to(y.dtype)
               + layer["b_in"].to(y.dtype), approximate="tanh")
    return x + (reduce_from_tp(y @ layer["w_out"].to(y.dtype), tp)
                + layer["b_out"].to(y.dtype))


def _check_shards(params: Params, cfg: ViTConfig,
                  tp: Optional[TPGroup]) -> None:
    layers, d = params["layers"], cfg.dim
    check_tp_width("wqkv", layers["wqkv"].shape[-1], 3 * d, tp)
    check_tp_width("wo", layers["wo"].shape[-2], d, tp)
    check_tp_width("w_in", layers["w_in"].shape[-1], cfg.ffn_dim, tp)


def _features(params: Params, images: torch.Tensor, cfg: ViTConfig,
              tp: Optional[TPGroup]) -> torch.Tensor:
    """images [B, H, W, C] -> the final-norm class token [B, dim]."""
    _check_shards(params, cfg, tp)
    B = images.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    x = images.to(cfg.dtype).reshape(B, g, p, g, p, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, cfg.patch_dim)
    x = x @ params["patch_embed"].to(cfg.dtype)
    cls = params["cls_token"].to(cfg.dtype).expand(B, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(cfg.dtype)
    per_layer = {name: torch.unbind(w) for name, w in
                 params["layers"].items()}
    for i in range(cfg.n_layers):
        layer = {name: ws[i] for name, ws in per_layer.items()}
        if cfg.remat:
            x = checkpoint(_encoder_layer, x, layer, cfg, tp,
                           use_reentrant=False)
        else:
            x = _encoder_layer(x, layer, cfg, tp)
    return _layernorm(x[:, 0], params["final_ln_scale"],
                      params["final_ln_bias"], cfg.norm_eps)


def vit_forward(params: Params, images: torch.Tensor, cfg: ViTConfig,
                tp: Optional[TPGroup] = None) -> torch.Tensor:
    """images [B, H, W, C] -> class logits [B, num_classes] (f32); under
    ``tp`` (the params this rank's tp shards) gathered whole on every
    rank (inference: not differentiable over a class split)."""
    x = _features(params, images, cfg, tp)
    logits = (x @ params["head"].to(x.dtype)).float()
    return gather_logits(logits, tp, cfg.num_classes)


def vit_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: ViTConfig, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Softmax cross-entropy on {'images': [B,H,W,C], 'labels': [B]};
    ``tp``: the params are this rank's tp shards (the module
    docstring), the loss the same on every rank of the group."""
    dp.refuse_model_split("vit_loss")
    x = _features(params, batch["images"], cfg, tp)
    return vocab_nll(x, params["head"], batch["labels"].long(), tp,
                     cfg.num_classes,
                     lambda h, w: (h @ w.to(h.dtype)).float()).mean()
