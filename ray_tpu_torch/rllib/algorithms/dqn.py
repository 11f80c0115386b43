"""DQN — deep Q-learning with target network and (optional) PER.

Port of `ray_tpu/rllib/algorithms/dqn.py` (reference: rllib/algorithms/
dqn/, the new stack: epsilon-greedy sampling into a replay buffer,
double-Q TD targets, periodic target-net sync). The loss is a Huber TD
error, weighted by the PER importance weights when the batch has them;
its per-sample ``td_abs`` feeds the priorities.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.off_policy import TargetNetworkLearner
from ray_tpu_torch.rllib.core.rl_module import QNetModule
from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                      ReplayBuffer)


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.replay_buffer_capacity: int = 50_000
        self.prioritized_replay: bool = False
        self.num_steps_sampled_before_learning_starts: int = 500
        self.target_network_update_freq: int = 500  # in env steps
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_decay_steps: int = 5_000
        self.double_q: bool = True
        self.tau: float = 1.0  # 1.0 = hard target sync
        self.rollout_fragment_length = 50
        self.train_batch_size = 32
        self.updates_per_step: int = 4

    @property
    def algo_class(self):
        return DQN


def _taken(q_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return torch.gather(q_all, -1, actions.long()[:, None])[:, 0]


class DQNLearner(TargetNetworkLearner):
    def loss_fn(self, batch, generator):
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        q = _taken(self.module.forward_train(batch[sb.OBS])["q_values"],
                   batch[sb.ACTIONS])
        with torch.no_grad():
            q_next_target = self.target_module.forward_train(
                batch[sb.NEXT_OBS])["q_values"]
            online = (self.module.forward_train(batch[sb.NEXT_OBS])
                      ["q_values"] if cfg.get("double_q", True)
                      else q_next_target)
            q_next = _taken(q_next_target, torch.argmax(online, dim=-1))
        not_done = 1.0 - batch[sb.TERMINATEDS].to(torch.float32)
        targets = batch[sb.REWARDS] + gamma * not_done * q_next
        td = q - targets
        huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
        weights = batch.get("weights")
        loss = (huber * weights).mean() if weights is not None \
            else huber.mean()
        return loss, {"td_error_mean": td.abs().mean(),
                      "td_abs": td.abs(), "q_mean": q.mean()}

    def update_dqn(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """`update` (the target lives in the learner; JAX threads it
        through the batch)."""
        return self.update(batch)


class DQN(Algorithm):
    config_class = DQNConfig
    learner_class = DQNLearner
    module_class = QNetModule

    def setup(self, config) -> None:
        cfg = config if isinstance(config, DQNConfig) else \
            self.config_class().update_from_dict(dict(config or {}))
        if cfg.num_learners != 0:
            raise ValueError(
                "DQN uses a local learner (target-net state is per-learner)")
        super().setup(cfg)
        cfg = self.config
        buffer_cls = PrioritizedReplayBuffer if cfg.prioritized_replay \
            else ReplayBuffer
        self.replay = buffer_cls(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._env_steps = 0
        self._last_target_sync = 0

    @property
    def _learner(self) -> DQNLearner:
        return self.learner_group.learner

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final -
                                             cfg.epsilon_initial)

    def get_extra_state(self) -> Dict[str, Any]:
        state = {
            "env_steps": self._env_steps,
            "last_target_sync": self._last_target_sync,
            "replay_cols": dict(self.replay._cols),
            "replay_size": self.replay._size,
            "replay_next": self.replay._next,
        }
        if isinstance(self.replay, PrioritizedReplayBuffer):
            state["replay_priorities"] = self.replay._priorities.copy()
            state["replay_max_priority"] = self.replay._max_priority
        return state

    def set_extra_state(self, state: Dict[str, Any]) -> None:
        if not state:
            return
        self._env_steps = state["env_steps"]
        self._last_target_sync = state["last_target_sync"]
        self.replay._cols = dict(state["replay_cols"])
        self.replay._size = state["replay_size"]
        self.replay._next = state["replay_next"]
        if isinstance(self.replay, PrioritizedReplayBuffer) and \
                "replay_priorities" in state:
            self.replay._priorities = np.asarray(
                state["replay_priorities"])
            self.replay._max_priority = state["replay_max_priority"]

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        rollout = self.env_runner_group.sample(
            cfg.rollout_fragment_length, epsilon=self._epsilon())
        self._env_steps += len(rollout)
        self.replay.add(rollout)

        metrics: Dict[str, Any] = {"epsilon": self._epsilon(),
                                   "replay_size": len(self.replay)}
        if len(self.replay) >= \
                cfg.num_steps_sampled_before_learning_starts:
            for _ in range(cfg.updates_per_step):
                batch = self.replay.sample(cfg.train_batch_size)
                m = self._learner.update_dqn(batch)
                td_abs = m.pop("td_abs", None)
                if cfg.prioritized_replay and "batch_indexes" in batch \
                        and td_abs is not None:
                    self.replay.update_priorities(
                        batch["batch_indexes"], td_abs)
                metrics.update(m)
            if self._env_steps - self._last_target_sync >= \
                    cfg.target_network_update_freq:
                self._learner.sync_target(cfg.tau)
                self._last_target_sync = self._env_steps
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
        return metrics
