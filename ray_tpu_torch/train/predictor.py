"""Checkpoint -> batch inference seam.

Port of `ray_tpu/train/predictor.py` (``Predictor``, ``JaxPredictor``;
reference: python/ray/train/predictor.py:40, ``from_checkpoint`` +
``predict`` over a batch). ``TorchPredictor`` keeps the params on its
device (the card unless the caller asks for the CPU) and applies a
function of ``(params, batch)`` there without autograd; a batch goes in
and comes out as numpy. A checkpoint is any object with
``to_directory()`` and ``to_dict()`` (the JAX package's ``Checkpoint``
is one). ``BatchPredictor``'s actor pool needs the runtime and is not
ported (ROADMAP.md, Queue A item A14e).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.models.training import _tree_map


class Predictor:
    """Load-once / predict-many (reference: train/predictor.py:40)."""

    @classmethod
    def from_checkpoint(cls, checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
        """One numpy batch in, one numpy batch out."""
        raise NotImplementedError


def _on(x, device: torch.device) -> torch.Tensor:
    x = x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x)))
    return x.to(device)


class TorchPredictor(Predictor):
    """Params (a tree of dicts) on ``device`` + an apply function.

    ``from_checkpoint`` accepts either a dict checkpoint holding
    ``{"params": tree}`` (read through ``to_dict()``) or, when a
    ``template`` tree is given, an array checkpoint directory
    (`train.array_checkpoint.save_pytree`, either package's)."""

    def __init__(self, apply_fn: Callable, params: Any, *, device="cuda"):
        self.device = resolve_device(device)
        self._params = _tree_map(lambda x: _on(x, self.device), params)
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint, *, apply_fn: Callable,
                        template: Any = None,
                        device="cuda") -> "TorchPredictor":
        d = checkpoint.to_directory()
        if template is not None:
            from ray_tpu_torch.train.array_checkpoint import restore_pytree

            params = restore_pytree(template, d)
        else:
            try:
                state = checkpoint.to_dict()
            except FileNotFoundError:
                raise ValueError(
                    f"checkpoint at {d} is neither a dict checkpoint nor "
                    "was a `template` given for a sharded array "
                    "checkpoint") from None
            params = state.get("params", state)
        return cls(apply_fn, params, device=device)

    def predict(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, np.ndarray]:
        inputs = {k: _on(v, self.device) for k, v in batch.items()}
        with torch.no_grad():
            out = self._apply(self._params, inputs)
        if isinstance(out, dict):
            return {k: v.cpu().numpy() for k, v in out.items()}
        return {"predictions": out.cpu().numpy()}
