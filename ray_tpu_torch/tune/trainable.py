"""Trainable — the class API of a tunable training loop.

A copy of `ray_tpu/tune/trainable.py`'s ``Trainable`` (reference:
python/ray/tune/trainable/trainable.py:58): subclasses implement
``setup`` and ``step`` (and the checkpoint pair); the controller calls
``train()`` once per iteration. Host code only: the port imports
nothing of `ray_tpu`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Trainable:
    """Subclass and implement setup/step (+ save/load_checkpoint)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}
        self.iteration = 0
        self.setup(self.config)

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        return None

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable reconfigured in place (PBT fast
        path; otherwise the controller restarts the actor)."""
        return False

    def cleanup(self) -> None:
        pass

    def train(self) -> Dict[str, Any]:
        result = self.step()
        self.iteration += 1
        return result
