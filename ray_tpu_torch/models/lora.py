"""LoRA (low-rank adaptation) for the stacked-layer models.

Port of `ray_tpu/models/lora.py` for one card: `LoraConfig`, the seeded
`lora_init`, `lora_num_params`, `lora_merge` and the adapter-only
`make_lora_train_step`. The mesh forms (`lora_param_specs`,
`lora_stack_specs`) wait for tensor parallelism (ROADMAP A9).

- Adapters are a SEPARATE small tree ``{"layers": {name: {"a": [L, in,
  r], "b": [L, r, out]}}}`` with the leading [n_layers] axis of every
  stacked weight. The base tree is never mutated.
- The train step takes the base as a plain input that never gets
  ``requires_grad`` and differentiates only the adapters; the merge
  ``W + alpha/r * A@B`` happens inside the step, so autograd reaches the
  adapters through `lora_merge` (JAX: ``stop_gradient`` on the base and
  ``value_and_grad`` over the adapters).
- `lora_merge` exports a plain param tree: the merged model runs through
  `llama_forward`, `generate` and the engine unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.llama import (LlamaConfig, _layer_shapes,
                                        resolve_device)
from ray_tpu_torch.models.training import AdamW, _leaves, _tree_map

Params = Dict[str, Any]

# Layer weights eligible for adaptation (norm scales are excluded:
# rank-decomposing a vector is meaningless).
_ADAPTABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    def __post_init__(self):
        if self.rank <= 0:
            raise ValueError(f"rank must be positive, got {self.rank}")
        bad = [t for t in self.targets if t not in _ADAPTABLE]
        if not self.targets or bad:
            raise ValueError(
                f"targets {self.targets!r}: "
                + (f"unknown {bad}" if bad else "empty")
                + f" (adaptable: {_ADAPTABLE})")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _in_out_split(shape: Tuple[int, ...], fan_in: int) -> Tuple[int, int]:
    """Split a weight shape into (fan_in, fan_out) sizes by locating the
    contraction prefix (wq: (d,h,hd) -> d | h*hd; wo: (h,hd,d) -> h*hd | d)."""
    acc = 1
    for i, s in enumerate(shape):
        acc *= s
        if acc == fan_in:
            return fan_in, math.prod(shape[i + 1:])
    raise ValueError(f"fan_in {fan_in} is not a prefix product of {shape}")


def lora_dims(cfg: LlamaConfig, lora_cfg: LoraConfig
              ) -> Dict[str, Tuple[int, int]]:
    """target name -> (n_in, n_out) of its flattened weight."""
    shapes = _layer_shapes(cfg)
    return {name: _in_out_split(shapes[name][0], shapes[name][2])
            for name in lora_cfg.targets}


@torch.no_grad()
def lora_init(cfg: LlamaConfig, lora_cfg: LoraConfig, *,
              generator: Optional[torch.Generator] = None, device="cuda",
              dtype: torch.dtype = torch.float32) -> Params:
    """Adapter tree {"layers": {name: {"a": [L, in, r], "b": [L, r, out]}}}
    on ``device`` in ``dtype`` (default f32, the JAX ``param_dtype``).
    A ~ N(0, 1/in), drawn in f32 from ``generator`` (default: seed 0 on
    the device), one target after another; B = 0, so the merged model
    equals the base exactly at init. The draws differ from the JAX
    init's; tests share adapters through `convert.lora_from_numpy`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    layers = {}
    for name, (n_in, n_out) in lora_dims(cfg, lora_cfg).items():
        a = torch.randn((cfg.n_layers, n_in, lora_cfg.rank),
                        generator=generator, device=device,
                        dtype=torch.float32)
        layers[name] = {
            "a": a.mul_(n_in ** -0.5).to(dtype),
            "b": torch.zeros((cfg.n_layers, lora_cfg.rank, n_out),
                             dtype=dtype, device=device),
        }
    return {"layers": layers}


def lora_num_params(cfg: LlamaConfig, lora_cfg: LoraConfig) -> int:
    return sum(cfg.n_layers * lora_cfg.rank * (n_in + n_out)
               for n_in, n_out in lora_dims(cfg, lora_cfg).values())


def lora_merge(base: Params, lora: Params, cfg: LlamaConfig,
               lora_cfg: LoraConfig) -> Params:
    """base + scale * A@B, reshaped per weight: the f32 einsum
    ``lir,lro->lio`` times the scale, added to the f32 weight, then cast
    back to the weight's dtype. Returns a full param tree usable by
    `llama_forward` / `generate` / the engine; base is not mutated.
    Differentiable in the adapters (the train step's path)."""
    merged_layers = dict(base["layers"])
    for name, ab in lora["layers"].items():
        w = base["layers"][name]
        delta = torch.einsum("lir,lro->lio", ab["a"].float(),
                             ab["b"].float()) * lora_cfg.scale
        merged_layers[name] = (w.float()
                               + delta.reshape(w.shape)).to(w.dtype)
    out = dict(base)
    out["layers"] = merged_layers
    return out


def make_lora_train_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: AdamW,
    cfg: LlamaConfig,
    lora_cfg: LoraConfig,
    *,
    device="cuda",
):
    """Returns (init_fn, step_fn) for adapter-only training on one card.

    loss_fn(merged_params, batch) -> scalar: the SAME loss as full
    fine-tuning (e.g. llama_loss); the merge happens inside the step.

    init_fn(base, lora) -> (base, lora, opt_state): the base's leaves on
    ``device``, detached (never ``requires_grad``), the adapters' as
    autograd leaves, and the optimizer state over the adapters only.

    step_fn(lora, opt_state, base, batch) -> (lora, opt_state, {"loss",
    "grad_norm"}): the adapters and their optimizer state are updated IN
    PLACE (the JAX step's donation); the step never writes to the base.
    Autograd still forms the targeted weights' gradients (they carry the
    adapters' through the merge) but no other base gradient, and the
    optimizer touches the adapters only."""
    device = resolve_device(device)

    def init_fn(base: Params, lora: Params):
        base = _tree_map(lambda p: p.detach().to(device), base)
        lora = _tree_map(
            lambda p: p.detach().to(device).requires_grad_(True), lora)
        return base, lora, optimizer.init(lora)

    def step_fn(lora: Params, opt_state, base: Params,
                batch: Dict[str, Any]):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        leaves = _leaves(lora)
        loss = loss_fn(lora_merge(base, lora, cfg, lora_cfg), batch)
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        optimizer.update(opt_state, leaves, grads)
        return lora, opt_state, {"loss": loss.detach(),
                                 "grad_norm": grad_norm}

    return init_fn, step_fn
