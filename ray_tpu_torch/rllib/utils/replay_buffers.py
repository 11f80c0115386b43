"""Replay buffers for off-policy algorithms.

Reference: rllib/utils/replay_buffers/ (ReplayBuffer,
PrioritizedEpisodeReplayBuffer). Transition-level ring buffer in numpy;
uniform and proportional-priority sampling.

A copy of `ray_tpu/rllib/utils/replay_buffers.py`: the port imports
nothing of `ray_tpu`. The draws are numpy's (``default_rng(seed)``,
``integers``, ``choice(p=)``), so for a seed and the same adds both
packages sample the same indices, PER weights and priorities.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform ring buffer over transitions."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, batch_size)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference: PER variants)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros(capacity, np.float32)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch) -> None:
        n = len(batch)
        idx = (self._next + np.arange(n)) % self.capacity
        super().add(batch)
        self._priorities[idx] = self._max_priority

    def sample(self, batch_size: int) -> SampleBatch:
        probs = self._priorities[:self._size] ** self.alpha
        probs = probs / probs.sum()
        idx = self._rng.choice(self._size, batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-self.beta)
        weights = weights / weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["batch_indexes"] = idx
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, idx: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prios = np.abs(td_errors) + 1e-6
        self._priorities[idx] = prios
        self._max_priority = max(self._max_priority, float(prios.max()))
