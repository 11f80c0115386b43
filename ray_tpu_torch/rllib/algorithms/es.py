"""ES / ARS — gradient-free evolution algorithms.

Port of `ray_tpu/rllib/algorithms/es.py`: each training_step fans
perturbation SEEDS out to the env runners
(`EnvRunnerGroup.evaluate_perturbations`), which regenerate the noise
with numpy over the flat weight vector in ``ravel_pytree``'s order and
return antithetic-pair returns; the driver rebuilds the same noise to
apply the update (ES: centered-rank fitness shaping; ARS: top-k
directions scaled by their returns' std). The learner only stores the
parameters, so checkpoints and evaluation ride the standard paths.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule, ravel_tree


class _ParamStoreLearner(TorchLearner):
    """Parameter store only — ES/ARS never compute a gradient."""

    def loss_fn(self, batch, generator):
        raise RuntimeError("ES/ARS are gradient-free: loss_fn unused")


def centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping: map returns to ranks in [-0.5, 0.5]."""
    flat = x.ravel()
    ranks = np.empty(flat.size, dtype=np.float64)
    ranks[flat.argsort()] = np.arange(flat.size)
    if flat.size > 1:
        ranks = ranks / (flat.size - 1) - 0.5
    else:
        ranks[:] = 0.0
    return ranks.reshape(x.shape)


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.num_perturbations: int = 16   # antithetic PAIRS per iter
        self.es_stdev: float = 0.05        # perturbation scale sigma
        self.es_step_size: float = 0.1     # SGD step on the estimate
        self.es_weight_decay: float = 0.0
        self.episodes_per_perturbation: int = 1

    @property
    def algo_class(self):
        return ES


class ES(Algorithm):
    config_class = ESConfig
    learner_class = _ParamStoreLearner
    module_class = DiscreteMLPModule

    def setup(self, config) -> None:
        super().setup(config)
        self._next_seed = int(self.config.seed) * 1_000_000 + 1

    def _draw_seeds(self) -> list:
        n = int(self.config.num_perturbations)
        seeds = list(range(self._next_seed, self._next_seed + n))
        self._next_seed += n
        return seeds

    def _flat_params(self):
        flat, unravel = ravel_tree(self.learner_group.get_weights())
        return flat.astype(np.float64), unravel

    def _noise(self, seed: int, dim: int) -> np.ndarray:
        return np.random.default_rng(int(seed)).standard_normal(
            dim).astype(np.float64)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        seeds = self._draw_seeds()
        params = self.learner_group.get_weights()
        results = self.env_runner_group.evaluate_perturbations(
            params, seeds, cfg.es_stdev, cfg.episodes_per_perturbation)
        flat, unravel = self._flat_params()
        returns = np.array([[rp, rn] for _, rp, rn in results], np.float64)
        weights = centered_ranks(returns)
        w = weights[:, 0] - weights[:, 1]            # antithetic pairs
        grad = np.zeros_like(flat)
        for (seed, _, _), wi in zip(results, w):
            grad += wi * self._noise(seed, flat.size)
        grad /= max(1, len(results)) * cfg.es_stdev
        new_flat = flat + cfg.es_step_size * grad \
            - cfg.es_step_size * cfg.es_weight_decay * flat
        self._set_flat(new_flat, unravel)
        return {
            "es_return_mean": float(returns.mean()),
            "es_return_max": float(returns.max()),
            "num_perturbation_pairs": len(results),
        }

    def _set_flat(self, new_flat: np.ndarray, unravel) -> None:
        self.learner_group.set_weights(
            unravel(np.asarray(new_flat, np.float32)))
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights())

    def get_extra_state(self) -> Dict[str, Any]:
        return {"next_seed": self._next_seed}

    def set_extra_state(self, state: Dict[str, Any]) -> None:
        self._next_seed = state.get("next_seed", self._next_seed)


class ARSConfig(ESConfig):
    def __init__(self):
        super().__init__()
        self.top_directions: int = 8  # k best of num_perturbations

    @property
    def algo_class(self):
        return ARS


class ARS(ES):
    """Augmented Random Search (V1-t): keep only the top-k directions
    by max(r+, r-) and scale the step by the std of their returns."""

    config_class = ARSConfig

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        seeds = self._draw_seeds()
        params = self.learner_group.get_weights()
        results = self.env_runner_group.evaluate_perturbations(
            params, seeds, cfg.es_stdev, cfg.episodes_per_perturbation)
        k = min(int(cfg.top_directions), len(results))
        ranked = sorted(results, key=lambda t: max(t[1], t[2]),
                        reverse=True)[:k]
        sel = np.array([[rp, rn] for _, rp, rn in ranked], np.float64)
        sigma_r = float(sel.std()) or 1.0
        flat, unravel = self._flat_params()
        grad = np.zeros_like(flat)
        for seed, rp, rn in ranked:
            grad += (rp - rn) * self._noise(seed, flat.size)
        grad /= k * sigma_r
        new_flat = flat + cfg.es_step_size * grad \
            - cfg.es_step_size * cfg.es_weight_decay * flat
        self._set_flat(new_flat, unravel)
        all_returns = np.array([[rp, rn] for _, rp, rn in results])
        return {
            "es_return_mean": float(all_returns.mean()),
            "es_return_max": float(all_returns.max()),
            "ars_sigma_r": sigma_r,
            "num_perturbation_pairs": len(results),
            "num_top_directions": k,
        }
