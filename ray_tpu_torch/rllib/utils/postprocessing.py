"""Advantage estimation (GAE) over concatenated rollout batches.

Reference: rllib/evaluation/postprocessing.py (compute_advantages) /
connectors GeneralAdvantageEstimation. Computed host-side in numpy —
rollouts arrive as numpy and the scan is O(T) with trivial FLOPs, so
there is nothing for the card here.

A copy of `ray_tpu/rllib/utils/postprocessing.py`: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


def compute_gae(batch: SampleBatch, gamma: float, lambda_: float,
                bootstrap_value=0.0) -> SampleBatch:
    """Adds ADVANTAGES and VALUE_TARGETS columns.

    Episode boundaries come from EPS_ID + TERMINATEDS/TRUNCATEDS.
    ``bootstrap_value`` is either a scalar (exact bootstrap for the
    chronologically-last step only — single-env runners) or a dict
    {eps_id: value} of exact bootstraps for each env's final (possibly
    cut) episode — vector-env runners, whose batches are env-major.
    Boundaries without an exact bootstrap fall back to the standard
    one-step-stale bootstrap from the row's own value estimate.
    """
    rewards = np.asarray(batch[sb.REWARDS], np.float32)
    values = np.asarray(batch[sb.VF_PREDS], np.float32)
    terminateds = np.asarray(batch[sb.TERMINATEDS], bool)
    eps_ids = np.asarray(batch[sb.EPS_ID])
    boots = bootstrap_value if isinstance(bootstrap_value, dict) else None
    scalar_boot = 0.0 if boots is not None else float(bootstrap_value)
    n = len(rewards)
    advantages = np.zeros(n, np.float32)
    last_gae = 0.0
    next_value = scalar_boot
    for t in range(n - 1, -1, -1):
        boundary = (t == n - 1) or (eps_ids[t + 1] != eps_ids[t])
        if boundary:
            last_gae = 0.0
            if terminateds[t]:
                next_value = 0.0
            elif boots is not None and int(eps_ids[t]) in boots:
                # Exact per-env bootstrap (vector runners).
                next_value = boots[int(eps_ids[t])]
            elif boots is None and t == n - 1:
                # Chronologically-last step: caller's bootstrap is exact.
                next_value = scalar_boot
            else:
                # Episode truncated or cut mid-batch: one-step-stale
                # bootstrap from its own last value estimate.
                next_value = values[t]
        delta = rewards[t] + gamma * next_value - values[t]
        last_gae = delta + gamma * lambda_ * last_gae
        advantages[t] = last_gae
        next_value = values[t]
    out = SampleBatch(batch)
    out[sb.ADVANTAGES] = advantages
    out[sb.VALUE_TARGETS] = advantages + values
    return out


def standardize(x: np.ndarray) -> np.ndarray:
    return (x - x.mean()) / max(1e-6, x.std())
