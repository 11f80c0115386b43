"""Algorithm — the trainable driver of an RL experiment.

Port of `ray_tpu/rllib/algorithms/algorithm.py`. The JAX Algorithm is a
``ray_tpu.tune`` Trainable, which the port cannot subclass without
importing ``ray_tpu``; this one keeps the Trainable surface it uses
(``train()`` = ``step()`` + the iteration count, ``setup``,
``save_checkpoint`` / ``load_checkpoint``, ``cleanup`` / ``stop``) and
``evaluate``. Subclasses implement ``training_step()``. The learner
and the local env runner run on ``config.device`` (``"cuda"`` unless
set to ``"cpu"``).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.connectors.connector import build_pipeline
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rllib.env.registry import make_env
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class Algorithm:
    config_class = AlgorithmConfig
    learner_class: type = None  # set by subclass
    module_class: type = None   # set by subclass

    def __init__(self, config=None):
        self.iteration = 0
        self.setup(config)

    def setup(self, config) -> None:
        if isinstance(config, AlgorithmConfig):
            self.config = config
        else:
            self.config = self.config_class().update_from_dict(
                dict(config or {}))
        if self.config.env is None:
            raise ValueError("config.environment(env=...) is required")
        probe = make_env(self.config.env, self.config.env_config)
        obs_dim = int(probe.observation_space.shape[0])
        # an env_to_module connector may reshape observations (frame
        # stacking): size the module from the TRANSFORMED dim
        obs_dim = build_pipeline(
            self.config.env_to_module_connector).observation_dim(obs_dim)
        self.learner_connector_pipeline = build_pipeline(
            self.config.learner_connector)
        space = probe.action_space
        if hasattr(space, "n"):  # Discrete
            num_actions = int(space.n)
        else:  # Box: num_actions is the action DIM; bounds go to the module
            num_actions = int(np.prod(space.shape))
            model = dict(self.config.model)
            model.setdefault("action_low", np.asarray(space.low))
            model.setdefault("action_high", np.asarray(space.high))
            self.config.model = model
        self.module_spec = self._make_module_spec(obs_dim, num_actions)
        cfg = self.config.to_dict()
        cfg["module_spec"] = self.module_spec
        self.env_runner_group = EnvRunnerGroup(cfg)
        self.learner_group = LearnerGroup(
            self.learner_class, self.module_spec, cfg)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        # Dedicated evaluation runner group (reference:
        # AlgorithmConfig.evaluation() -> eval EnvRunnerGroup).
        self.eval_env_runner_group = None
        if self.config.evaluation_interval > 0:
            eval_cfg = dict(cfg)
            eval_cfg["num_env_runners"] = \
                self.config.evaluation_num_env_runners
            self.eval_env_runner_group = EnvRunnerGroup(eval_cfg)
        self._iteration = 0

    def _make_module_spec(self, obs_dim: int, num_actions: int):
        return RLModuleSpec(self.module_class, obs_dim, num_actions,
                            dict(self.config.model))

    def apply_learner_connector(self, batch):
        """Run the learner ConnectorV2 pipeline over a sampled batch
        (before advantage estimation, as the reference orders it)."""
        if not len(self.learner_connector_pipeline):
            return batch
        return SampleBatch(self.learner_connector_pipeline(batch))

    def train(self) -> Dict[str, Any]:
        """One iteration (the Trainable's ``train``)."""
        result = self.step()
        self.iteration += 1
        return result

    def step(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        results = self.training_step()
        self._iteration += 1
        if self.config.restart_failed_env_runners:
            restored = self.env_runner_group.restore_failed(
                self.learner_group.get_weights)
            if restored:
                results["num_env_runners_restored"] = restored
        results.update(self.env_runner_group.aggregate_metrics())
        if self.eval_env_runner_group is not None and \
                self._iteration % self.config.evaluation_interval == 0:
            results.update(self.evaluate(self.config.evaluation_duration))
        results["training_iteration"] = self._iteration
        results["time_this_iter_s"] = time.perf_counter() - t0
        return results

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        state = {
            "learner": self.learner_group.get_state(),
            "iteration": self._iteration,
            "algo_state": self.get_extra_state(),
        }
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._iteration = state["iteration"]
        self.set_extra_state(state.get("algo_state", {}))
        self.env_runner_group.sync_weights(self.learner_group.get_weights())

    def get_extra_state(self) -> Dict[str, Any]:
        return {}

    def set_extra_state(self, state: Dict[str, Any]) -> None:
        pass

    def cleanup(self) -> None:
        try:
            self.env_runner_group.stop()
            if self.eval_env_runner_group is not None:
                self.eval_env_runner_group.stop()
        finally:
            self.learner_group.stop()

    stop = cleanup

    def evaluate(self, num_episodes: int = 5) -> Dict[str, Any]:
        """Greedy evaluation on the dedicated eval runner group (built
        when config.evaluation_interval > 0), else an ad-hoc local one."""
        group = self.eval_env_runner_group
        if group is None:
            cfg = self.config.to_dict()
            cfg["module_spec"] = self.module_spec
            cfg["num_env_runners"] = 0
            group = EnvRunnerGroup(cfg)
            try:
                group.sync_weights(self.learner_group.get_weights())
                returns = group.sample_episodes(num_episodes)
            finally:
                group.stop()
        else:
            group.sync_weights(self.learner_group.get_weights())
            returns = group.sample_episodes(num_episodes)
        return {"evaluation": {
            "episode_return_mean":
                float(np.mean(returns)) if returns else float("nan"),
            "num_episodes": len(returns)}}
