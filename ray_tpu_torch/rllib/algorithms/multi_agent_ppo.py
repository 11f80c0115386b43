"""Multi-agent PPO — independent PPO learners over a shared env.

Port of `ray_tpu/rllib/algorithms/multi_agent_ppo.py`: N agents map to M
policy modules via ``policy_mapping_fn``; each module trains on its own
experience with its own `PPOLearner` on ``config.device``. The JAX
trainer is a ``ray_tpu.tune`` Trainable; this one keeps the surface it
uses (``train``, ``step``, checkpoints, ``cleanup``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
from ray_tpu_torch.rllib.core.rl_module import (DiscreteMLPModule,
                                                RLModuleSpec)
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.env.multi_agent_env_runner import \
    MultiAgentEnvRunner
from ray_tpu_torch.rllib.env.registry import make_env
from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.postprocessing import compute_gae, standardize
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_: float = 0.95
        self.clip_param: float = 0.2
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        # agent_id -> module_id; default: one module per agent.
        self.policy_mapping_fn: Optional[Callable[[str], str]] = None

    def multi_agent(self, *, policy_mapping_fn=None
                    ) -> "MultiAgentPPOConfig":
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    @property
    def algo_class(self):
        return MultiAgentPPO


class MultiAgentPPO:
    """Independent-PPO trainer over a MultiAgentEnv."""

    config_class = MultiAgentPPOConfig

    def __init__(self, config=None):
        self.iteration = 0
        self.setup(config)

    def setup(self, config) -> None:
        if isinstance(config, MultiAgentPPOConfig):
            self.config = config
        else:
            self.config = self.config_class().update_from_dict(
                dict(config or {}))
        cfg = self.config
        probe = make_env(cfg.env, cfg.env_config)
        mapping = cfg.policy_mapping_fn or (lambda aid: aid)
        self._mapping = mapping
        # One module spec per distinct module id, sized by (any of) its
        # agents' spaces.
        self.module_specs: Dict[str, RLModuleSpec] = {}
        for aid in probe.agent_ids:
            mid = mapping(aid)
            if mid in self.module_specs:
                continue
            obs_dim = int(probe.observation_space_of(aid).shape[0])
            num_actions = int(probe.action_space_of(aid).n)
            self.module_specs[mid] = RLModuleSpec(
                DiscreteMLPModule, obs_dim, num_actions, dict(cfg.model))
        run_cfg = cfg.to_dict()
        run_cfg["module_specs"] = self.module_specs
        run_cfg["policy_mapping_fn"] = mapping
        self.learners: Dict[str, PPOLearner] = {
            mid: PPOLearner(spec, run_cfg)
            for mid, spec in self.module_specs.items()}
        self.env_runner_group = EnvRunnerGroup(
            run_cfg, runner_cls=MultiAgentEnvRunner)
        self._sync_weights()
        self._iteration = 0

    def _get_weights(self) -> Dict[str, Any]:
        return {mid: learner.get_weights()
                for mid, learner in self.learners.items()}

    def _sync_weights(self) -> None:
        self.env_runner_group.sync_weights(self._get_weights())

    def train(self) -> Dict[str, Any]:
        result = self.step()
        self.iteration += 1
        return result

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        per_module: Dict[str, List] = {}
        for batches, boots in self.env_runner_group.sample_multi(
                cfg.train_batch_size):
            for mid, per_agent in batches.items():
                for aid, batch in per_agent.items():
                    gae = compute_gae(batch, cfg.gamma, cfg.lambda_,
                                      boots.get(aid, 0.0))
                    per_module.setdefault(mid, []).append(gae)
        metrics: Dict[str, Any] = {}
        rng = np.random.default_rng(cfg.seed + self._iteration)
        for mid, parts in per_module.items():
            train_batch = SampleBatch.concat_samples(parts)
            train_batch[sb.ADVANTAGES] = standardize(
                train_batch[sb.ADVANTAGES])
            m: Dict[str, Any] = {}
            for _ in range(cfg.num_epochs):
                for minibatch in train_batch.minibatches(
                        min(cfg.minibatch_size, len(train_batch)), rng):
                    m = self.learners[mid].update(minibatch)
            metrics[mid] = m
            metrics[f"{mid}/steps_trained"] = len(train_batch)
        self._sync_weights()
        self._iteration += 1
        metrics.update(self.env_runner_group.aggregate_metrics())
        metrics["training_iteration"] = self._iteration
        return metrics

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        state = {"learners": {mid: lr.get_state()
                              for mid, lr in self.learners.items()},
                 "iteration": self._iteration}
        with open(os.path.join(checkpoint_dir, "ma_state.pkl"), "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "ma_state.pkl"), "rb") as f:
            state = pickle.load(f)
        for mid, s in state["learners"].items():
            self.learners[mid].set_state(s)
        self._iteration = state.get("iteration", 0)
        self._sync_weights()

    def cleanup(self) -> None:
        self.env_runner_group.stop()

    stop = cleanup
