"""SAC — Soft Actor-Critic for continuous control.

Port of `ray_tpu/rllib/algorithms/sac.py` (reference: rllib/algorithms/
sac/: squashed-Gaussian actor, twin Q critics with min-target,
polyak-averaged target networks, and automatic entropy-temperature
tuning against target_entropy = -act_dim). One update is the three
losses summed, with JAX's stop-gradients: the TD target is constant,
the actor's loss sees the critics frozen and alpha constant, and the
temperature's loss sees the log-probs constant. The two action samples
draw through the learner's noise seam ("next" and "pi").
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import (OffPolicyAlgorithm,
                                                       TargetNetworkLearner)
from ray_tpu_torch.rllib.core.rl_module import SACModule
from ray_tpu_torch.rllib.utils import sample_batch as sb


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.replay_buffer_capacity: int = 100_000
        self.num_steps_sampled_before_learning_starts: int = 1_000
        self.tau: float = 0.005  # polyak factor, every update
        self.target_entropy: float = None  # default: -act_dim
        self.initial_alpha: float = 1.0
        self.rollout_fragment_length = 64
        self.train_batch_size = 256
        self.updates_per_step: int = 16
        self.lr = 3e-3

    @property
    def algo_class(self):
        return SAC


def _actions(batch) -> torch.Tensor:
    actions = batch[sb.ACTIONS]
    return actions[:, None] if actions.dim() == 1 else actions


class SACLearner(TargetNetworkLearner):
    # targets of the critic subtrees only (the actor has none)
    target_keys = ("q1", "q2")

    def loss_fn(self, batch, generator):
        cfg = self.config
        m: SACModule = self.module
        gamma = cfg.get("gamma", 0.99)
        target_entropy = cfg.get("target_entropy")
        if target_entropy is None:
            target_entropy = -float(m.act_dim)
        obs, next_obs = batch[sb.OBS], batch[sb.NEXT_OBS]
        shape = (obs.shape[0], m.act_dim)
        alpha = torch.exp(m.log_alpha)

        # --- critic loss: y = r + gamma (1-d) [min Q_t(s',a') - a logp'] ---
        with torch.no_grad():
            next_a, next_logp = m.sample_action(
                next_obs, eps=self.noise("next", shape))
            tq1, tq2 = self.target_module.q_values(next_obs, next_a)
            not_done = 1.0 - batch[sb.TERMINATEDS].to(torch.float32)
            y = batch[sb.REWARDS] + gamma * not_done * (
                torch.minimum(tq1, tq2) - alpha * next_logp)
        q1, q2 = m.q_values(obs, _actions(batch))
        critic_loss = ((q1 - y) ** 2).mean() + ((q2 - y) ** 2).mean()

        # --- actor loss: E[alpha logp - min Q(s, pi(s))], critics frozen ---
        pi_a, pi_logp = m.sample_action(obs, eps=self.noise("pi", shape))
        pq1, pq2 = m.q_values(obs, pi_a, frozen=True)
        actor_loss = (alpha.detach() * pi_logp
                      - torch.minimum(pq1, pq2)).mean()

        # --- temperature loss: drive E[-logp] toward target entropy ---
        alpha_loss = (-torch.exp(m.log_alpha)
                      * (pi_logp + target_entropy).detach()).mean()

        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha_loss": alpha_loss,
            "alpha": alpha,
            "q1_mean": q1.mean(),
            "entropy": -pi_logp.mean(),
        }

    def update_sac(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """`update` (the targets live in the learner; JAX threads them
        through the batch)."""
        return self.update(batch)


class SAC(OffPolicyAlgorithm):
    config_class = SACConfig
    learner_class = SACLearner
    module_class = SACModule

    def _update_once(self, batch) -> Dict[str, float]:
        return self._learner.update_sac(batch)
