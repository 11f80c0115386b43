"""CQL — conservative Q-learning for offline continuous control.

Port of `ray_tpu/rllib/algorithms/cql.py` (reference: rllib/algorithms/
cql/, Kumar et al. 2020 on top of SAC: the critic loss adds
alpha_prime * (logsumexp_a Q(s, a) - Q(s, a_data)), which pushes down
the Q-values of out-of-distribution actions). The logsumexp runs over
``2n`` sampled actions: ``n`` uniform over the action box ("cql_uniform")
and ``n`` from the current policy ("cql_pi"), the latter detached.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.sac import (SACConfig, SACLearner,
                                                _actions)
from ray_tpu_torch.rllib.core.rl_module import SACModule
from ray_tpu_torch.rllib.utils import sample_batch as sb


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.offline_dataset: Any = None
        self.cql_alpha: float = 1.0       # conservative penalty weight
        self.cql_n_actions: int = 4       # samples for the logsumexp
        self.num_env_runners = 0
        self.updates_per_step = 8

    def offline_data(self, *, dataset=None, **kwargs) -> "CQLConfig":
        if dataset is not None:
            self.offline_dataset = dataset
        self._apply(kwargs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d.pop("offline_dataset", None)
        return d

    @property
    def algo_class(self):
        return CQL


class CQLLearner(SACLearner):
    def loss_fn(self, batch, generator):
        cfg = self.config
        m: SACModule = self.module
        sac_loss, metrics = super().loss_fn(batch, generator)

        # --- conservative penalty on both critics ---
        obs = batch[sb.OBS]
        n = cfg.get("cql_n_actions", 4)
        b, act_dim = obs.shape[0], m.act_dim
        lo = m.action_center - m.action_scale
        hi = m.action_center + m.action_scale
        # jax.random.uniform(minval=lo, maxval=hi)'s map of [0, 1)
        u = self.noise("cql_uniform", (n, b, act_dim), "uniform")
        rand_a = torch.maximum(lo, u * (hi - lo) + lo)
        # Detach: the penalty regularizes the CRITICS; minimizing the
        # logsumexp through the policy samples would train the actor to
        # pick low-Q actions, fighting the SAC actor loss.
        with torch.no_grad():
            pi_a = m.sample_action(
                obs.expand(n, b, obs.shape[-1]),
                eps=self.noise("cql_pi", (n, b, act_dim)))[0]
        all_a = torch.cat([rand_a, pi_a])                 # [2n, B, A]
        obs_rep = obs.expand(2 * n, b, obs.shape[-1])
        q1_all, q2_all = m.q_values(obs_rep.reshape(2 * n * b, -1),
                                    all_a.reshape(2 * n * b, act_dim))
        q1_data, q2_data = m.q_values(obs, _actions(batch))
        gap1 = torch.logsumexp(q1_all.reshape(2 * n, b), 0) - q1_data
        gap2 = torch.logsumexp(q2_all.reshape(2 * n, b), 0) - q2_data
        cql_penalty = gap1.mean() + gap2.mean()
        total = sac_loss + cfg.get("cql_alpha", 1.0) * cql_penalty
        metrics = dict(metrics)
        metrics["cql_penalty"] = cql_penalty
        metrics["conservative_gap"] = gap1.mean()
        return total, metrics


class CQL(Algorithm):
    config_class = CQLConfig
    learner_class = CQLLearner
    module_class = SACModule

    def setup(self, config) -> None:
        cfg = config if isinstance(config, CQLConfig) else \
            self.config_class().update_from_dict(dict(config or {}))
        if cfg.num_learners != 0:
            raise ValueError("CQL uses a local learner")
        super().setup(cfg)
        ds = self.config.offline_dataset
        if ds is None:
            raise ValueError("CQLConfig.offline_data(dataset=...) required")
        self._data = {
            sb.OBS: np.asarray(ds["obs"], np.float32),
            sb.ACTIONS: np.asarray(ds["actions"], np.float32),
            sb.REWARDS: np.asarray(ds["rewards"], np.float32),
            sb.NEXT_OBS: np.asarray(ds["next_obs"], np.float32),
            sb.TERMINATEDS: np.asarray(ds["terminateds"], bool),
        }
        self._rng = np.random.default_rng(self.config.seed)

    @property
    def _learner(self) -> CQLLearner:
        return self.learner_group.learner

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self._data[sb.OBS])
        metrics: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_step):
            idx = self._rng.integers(0, n, cfg.train_batch_size)
            batch = {k: v[idx] for k, v in self._data.items()}
            m = self._learner.update_sac(batch)
            self._learner.sync_target(cfg.tau)
            metrics.update(m)
        return metrics
