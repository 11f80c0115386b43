"""Shared inputs for the PyTorch-port tests (tests/test_torch_port_*.py).

Inputs are made from a seed with numpy and handed to both packages, so
the JAX reference and the port compute on the same numbers.
"""

import numpy as np
import torch

from ray_tpu.models.llama import _layer_shapes


def numpy_params(cfg, seed=0):
    """Seeded numpy Llama params in `llama_init`'s layout and scales;
    norm scales are perturbed from 1 so the tests see them applied."""
    rng = np.random.RandomState(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    layers = {}
    for name, (shape, _, fan_in) in _layer_shapes(cfg).items():
        full = (cfg.n_layers,) + shape
        layers[name] = (1.0 + normal(full, 0.1) if fan_in is None
                        else normal(full, fan_in ** -0.5))
    return {
        "tok_embed": normal((cfg.vocab_size, cfg.dim), 0.02),
        "layers": layers,
        "final_norm": 1.0 + normal((cfg.dim,), 0.1),
        "lm_head": normal((cfg.dim, cfg.vocab_size), cfg.dim ** -0.5),
    }


def to_torch(x):
    """numpy (incl. ml_dtypes float8_e4m3fn) -> CPU torch tensor."""
    x = np.asarray(x)
    if x.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(x.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(x.copy())


def byte_view(x):
    """Raw bytes of a numpy array or torch tensor, as numpy uint8."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)
