"""Move a JAX-package Llama param tree into the port's tensors.

`ray_tpu.models.llama.llama_init` builds ``{"tok_embed", "layers":
{name: [L, ...]}, "final_norm", "lm_head"}``; the port keeps the same
keys and layouts. Pass the tree as numpy arrays (``jax.device_get`` or
``np.asarray`` per leaf): this module imports no JAX, so tests hand the
same numbers to both packages through it.
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
