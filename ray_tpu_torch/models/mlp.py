"""Minimal MLP classifier (the MNIST end-to-end slice model).

Port of `ray_tpu/models/mlp.py`: `MLPConfig`, `mlp_init`, `mlp_forward`
and `mlp_loss`, in f32, params ``{"layer{i}": {"w", "b"}}``. The JAX
model names no logical axes, so GSPMD runs it replicated over tp; so
does the port's step: every tp rank runs the whole step on the same
rows, and no gradient is summed over tp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.parallel import data_parallel as dp


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Sequence[int] = (512, 512)
    n_classes: int = 10
    dtype: torch.dtype = torch.float32


@torch.no_grad()
def mlp_init(cfg: MLPConfig, *, seed: int = 0,
             device="cuda") -> Dict[str, Any]:
    """Seeded weights with the JAX init's scales (normal * fan_in**-0.5,
    zero biases), drawn from a `torch.Generator`."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    dims = [cfg.in_dim, *cfg.hidden, cfg.n_classes]
    return {
        f"layer{i}": {
            "w": torch.randn((dims[i], dims[i + 1]), generator=g,
                             device=device).mul_(dims[i] ** -0.5)
            .to(cfg.dtype),
            "b": torch.zeros((dims[i + 1],), dtype=cfg.dtype, device=device),
        }
        for i in range(len(dims) - 1)
    }


def mlp_forward(params: Dict[str, Any], x: torch.Tensor,
                cfg: MLPConfig) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        layer = params[f"layer{i}"]
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = F.relu(x)
    return x


def mlp_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             cfg: MLPConfig) -> torch.Tensor:
    dp.refuse_model_split("mlp_loss")
    logits = mlp_forward(params, batch["x"], cfg)
    return F.cross_entropy(logits, batch["y"].long())
