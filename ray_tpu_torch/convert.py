"""Move a JAX-package param tree — Llama, a LoRA adapter, MoE, ViT, T5,
the MLP or a pipeline's stacked stages — into the port's tensors, and
the port's Llama param tree back to numpy.

`ray_tpu.models.llama.llama_init` builds ``{"tok_embed", "layers":
{name: [L, ...]}, "final_norm", "lm_head"}`` and
`ray_tpu.models.lora.lora_init` ``{"layers": {name: {"a", "b"}}}``; the
port keeps the same keys and layouts, for every model. Pass the tree as
numpy arrays (``jax.device_get`` or ``np.asarray`` per leaf): this
module imports no JAX, so tests hand the same numbers to both packages
through it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig, resolve_device


def params_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig, *,
                      device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Numpy param tree -> the port's params on ``device`` in ``dtype``
    (default ``cfg.dtype``, as serving stores them; training passes
    torch.float32 for f32 master weights — see `llama.py`)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype

    def conv(x):
        # np.array copies: the tensors never alias the caller's arrays,
        # which a training step then updates in place
        return torch.from_numpy(np.array(x, np.float32)).to(
            device=device, dtype=dtype)

    return {
        "tok_embed": conv(tree["tok_embed"]),
        "layers": {k: conv(v) for k, v in tree["layers"].items()},
        "final_norm": conv(tree["final_norm"]),
        "lm_head": conv(tree["lm_head"]),
    }


def lora_from_numpy(tree: Dict[str, Any], cfg: LlamaConfig, lora_cfg, *,
                    device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Numpy adapter tree ``{"layers": {name: {"a": [L, in, r], "b": [L,
    r, out]}}}`` (`ray_tpu.models.lora.lora_init`'s layout) -> the
    port's on ``device`` in ``dtype`` (default f32, the adapters' JAX
    ``param_dtype``). Checks the targets and shapes against
    ``lora_cfg``; copies, never aliases, the caller's arrays."""
    from ray_tpu_torch.models.lora import lora_dims

    device = resolve_device(device)
    dtype = dtype or torch.float32
    layers = tree.get("layers", tree)
    out = {}
    for name, (n_in, n_out) in lora_dims(cfg, lora_cfg).items():
        want = {"a": (cfg.n_layers, n_in, lora_cfg.rank),
                "b": (cfg.n_layers, lora_cfg.rank, n_out)}
        if name not in layers:
            raise ValueError(f"adapter tree has no target {name!r}")
        out[name] = {}
        for k, shape in want.items():
            x = np.array(layers[name][k], np.float32)
            if x.shape != shape:
                raise ValueError(f"{name}.{k}: shape {x.shape}, want {shape}")
            out[name][k] = torch.from_numpy(x).to(device=device, dtype=dtype)
    return {"layers": out}


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's param tree -> the numpy tree `params_from_numpy` and
    `ray_tpu.models.llama` take (host copies). Leaves keep their dtype
    where numpy has it; bf16 ones widen to f32 exactly (a bf16 value's
    bits are the high half of its f32's), since numpy has no bf16."""
    def conv(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            bits = x.view(torch.int16).numpy().view(np.uint16)
            return (bits.astype(np.uint32) << 16).view(np.float32)
        return x.numpy().copy()

    return {
        "tok_embed": conv(params["tok_embed"]),
        "layers": {k: conv(v) for k, v in params["layers"].items()},
        "final_norm": conv(params["final_norm"]),
        "lm_head": conv(params["lm_head"]),
    }


def _tree_from_numpy(tree, like, device, dtype, where="params"):
    """Copy every leaf of the numpy ``tree`` (nested dicts) to ``device``
    in ``dtype``; ``like`` (a tree of the same keys, or None) checks the
    structure."""
    if isinstance(tree, dict):
        if like is not None and set(tree) != set(like):
            raise ValueError(f"{where}: keys {sorted(tree)}, want "
                             f"{sorted(like)}")
        return {k: _tree_from_numpy(v, None if like is None else like[k],
                                    device, dtype, f"{where}.{k}")
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device=device,
                                                           dtype=dtype)


def moe_params_from_numpy(tree, cfg, *, device="cuda", dtype=None):
    """`ray_tpu.models.moe.moe_init`'s tree -> the port's, in ``dtype``
    (default ``cfg.dtype``; training passes torch.float32)."""
    from ray_tpu_torch.models.moe import moe_logical_specs

    return _tree_from_numpy(tree, moe_logical_specs(cfg),
                            resolve_device(device), dtype or cfg.dtype)


def vit_params_from_numpy(tree, cfg, *, device="cuda", dtype=None):
    """`ray_tpu.models.vit.vit_init`'s tree -> the port's."""
    from ray_tpu_torch.models.vit import vit_logical_specs

    return _tree_from_numpy(tree, vit_logical_specs(cfg),
                            resolve_device(device), dtype or cfg.dtype)


def t5_params_from_numpy(tree, cfg, *, device="cuda", dtype=None):
    """`ray_tpu.models.t5.t5_init`'s tree -> the port's."""
    from ray_tpu_torch.models.t5 import t5_logical_specs

    return _tree_from_numpy(tree, t5_logical_specs(cfg),
                            resolve_device(device), dtype or cfg.dtype)


def mlp_params_from_numpy(tree, cfg, *, device="cuda", dtype=None):
    """`ray_tpu.models.mlp.mlp_init`'s ``{"layer{i}": {"w", "b"}}`` ->
    the port's."""
    n = len(cfg.hidden) + 1
    like = {f"layer{i}": {"w": None, "b": None} for i in range(n)}
    return _tree_from_numpy(tree, like, resolve_device(device),
                            dtype or cfg.dtype)


def stage_params_from_numpy(tree, *, device="cuda",
                            dtype=torch.float32):
    """A pipeline's stacked stage tree (`stack_stage_params`: every leaf
    with a leading stage dim) -> the port's, in ``dtype``."""
    return _tree_from_numpy(tree, None, resolve_device(device), dtype)
