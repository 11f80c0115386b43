"""DDPG / TD3 — deterministic-policy continuous control.

Port of `ray_tpu/rllib/algorithms/ddpg.py` (reference: rllib_contrib
ddpg: deterministic actor, Q critic, polyak targets, Gaussian
exploration noise; td3: DDPG + clipped double-Q, target policy
smoothing, delayed policy updates — Fujimoto et al. 2018).

TD3's policy delay multiplies the actor loss by an ``update_actor``
flag, as JAX does: on critic-only steps the actor's gradient is exactly
zero and the shared Adam state still ticks (skipping the actor would
change every later update). The smoothing noise draws through the
learner's noise seam ("target").
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import (OffPolicyAlgorithm,
                                                       TargetNetworkLearner)
from ray_tpu_torch.rllib.algorithms.sac import _actions
from ray_tpu_torch.rllib.core.rl_module import DDPGModule
from ray_tpu_torch.rllib.utils import sample_batch as sb


class DDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.replay_buffer_capacity: int = 100_000
        self.num_steps_sampled_before_learning_starts: int = 1_000
        self.tau: float = 0.005
        self.exploration_noise: float = 0.1   # of the action half-range
        self.twin_q: bool = False
        self.target_noise: float = 0.0        # TD3 smoothing (off)
        self.target_noise_clip: float = 0.5
        self.policy_delay: int = 1
        self.rollout_fragment_length = 64
        self.train_batch_size = 256
        self.updates_per_step: int = 16
        self.lr = 3e-3

    @property
    def algo_class(self):
        return DDPG


class TD3Config(DDPGConfig):
    def __init__(self):
        super().__init__()
        self.twin_q = True
        self.target_noise = 0.2
        self.policy_delay = 2

    @property
    def algo_class(self):
        return TD3


class DDPGLearner(TargetNetworkLearner):
    def __init__(self, module_spec, config, device=None):
        super().__init__(module_spec, config, device)
        self._update_count = 0

    def loss_fn(self, batch, generator):
        cfg = self.config
        m: DDPGModule = self.module
        gamma = cfg.get("gamma", 0.99)
        twin_q = cfg.get("twin_q", False)
        target_noise = cfg.get("target_noise", 0.0)
        noise_clip = cfg.get("target_noise_clip", 0.5)
        obs, next_obs = batch[sb.OBS], batch[sb.NEXT_OBS]
        scale, center = m.action_scale, m.action_center

        # --- critic target: y = r + gamma (1-d) Q_t(s', mu_t(s') + eps) ---
        with torch.no_grad():
            target = self.target_module
            next_a = target.action(next_obs)
            if target_noise > 0.0:
                eps = torch.clamp(
                    self.noise("target", next_a.shape) * target_noise
                    * scale, -noise_clip * scale, noise_clip * scale)
                next_a = torch.clamp(next_a + eps, center - scale,
                                     center + scale)
            tq1, tq2 = target.q_values(next_obs, next_a)
            tq = torch.minimum(tq1, tq2) if twin_q else tq1
            not_done = 1.0 - batch[sb.TERMINATEDS].to(torch.float32)
            y = batch[sb.REWARDS] + gamma * not_done * tq

        q1, q2 = m.q_values(obs, _actions(batch))
        critic_loss = ((q1 - y) ** 2).mean()
        if twin_q:
            critic_loss = critic_loss + ((q2 - y) ** 2).mean()

        # --- actor: maximize Q1(s, mu(s)) with critics frozen ---
        pq1, _ = m.q_values(obs, m.action(obs), frozen=True)
        actor_loss = -pq1.mean() * batch["update_actor"]

        total = critic_loss + actor_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "q1_mean": q1.mean(),
            "td_target_mean": y.mean(),
        }

    def update_ddpg(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        self._update_count += 1
        delay = int(self.config.get("policy_delay", 1))
        batch = dict(batch)
        batch["update_actor"] = np.float32(
            1.0 if self._update_count % delay == 0 else 0.0)
        return self.update(batch)

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["update_count"] = self._update_count
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        self._update_count = state.get("update_count", 0)


class DDPG(OffPolicyAlgorithm):
    config_class = DDPGConfig
    learner_class = DDPGLearner
    module_class = DDPGModule

    def setup(self, config) -> None:
        cfg = config if isinstance(config, self.config_class) else \
            self.config_class().update_from_dict(dict(config or {}))
        # The runner's exploration noise comes from the module config.
        model = dict(cfg.model)
        model.setdefault("exploration_noise", cfg.exploration_noise)
        cfg.model = model
        super().setup(cfg)

    def _update_once(self, batch) -> Dict[str, float]:
        return self._learner.update_ddpg(batch)


class TD3(DDPG):
    config_class = TD3Config
