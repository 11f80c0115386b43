"""SampleBatch — columnar container for trajectory data.

Reference: python/ray/rllib/policy/sample_batch.py (SampleBatch). Columns
are numpy arrays with a shared leading (time/batch) dimension; the learner
converts to torch tensors at update time.

A copy of `ray_tpu/rllib/utils/sample_batch.py`: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

# Canonical column names (reference: SampleBatch.OBS etc.)
OBS = "obs"
NEXT_OBS = "next_obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
ACTION_LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
EPS_ID = "eps_id"


class SampleBatch(dict):
    """dict of column -> np.ndarray with equal leading dimension."""

    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in keys})

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(len(self))
        return SampleBatch({k: np.asarray(v)[perm] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: np.asarray(v)[start:end]
                            for k, v in self.items()})

    def minibatches(self, size: int,
                    rng: np.random.Generator) -> Iterator["SampleBatch"]:
        """Shuffled minibatches; drops the ragged tail if smaller than
        size//2 (keeps jit shapes near-constant)."""
        shuffled = self.shuffle(rng)
        n = len(shuffled)
        for start in range(0, n, size):
            end = min(start + size, n)
            if end - start >= max(1, size // 2):
                yield shuffled.slice(start, end)

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dict(self)
