"""OffPolicyAlgorithm — shared scaffolding for replay-buffer algorithms.

Port of `ray_tpu/rllib/algorithms/off_policy.py`: a LOCAL learner
holding polyak-averaged target nets, a driver-side replay buffer
checkpointed with the algorithm, and a training step of rollout →
replay → K updates → target sync → weight broadcast. Subclasses supply
`_update_once` (one learner update from a sampled batch).

`TargetNetworkLearner` is the learner side. JAX keeps the target as a
second params tree threaded through the batch; here it is a frozen copy
of the module (``target_module``) whose tensors are not parameters of
the learner: they are outside `tree_paths(learner.module)`, Adam's
state and `update_ddp`'s flat vector, and the losses evaluate the Q
networks on them directly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.core.learner import TorchLearner, _tensor
from ray_tpu_torch.rllib.core.rl_module import (RLModule, _leaf, _nest,
                                                frozen_copy, tree_paths)
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer


class TargetNetworkLearner(TorchLearner):
    """A learner with a target copy of its module (or of the subtrees
    ``target_keys`` names: SAC and CQL keep targets of the critics
    only)."""

    target_keys: Optional[Tuple[str, ...]] = None   # None: the whole tree

    def __init__(self, module_spec, config, device=None):
        super().__init__(module_spec, config, device)
        self.target_module = self._make_target()

    def _make_target(self) -> RLModule:
        """A copy of the module that shares no storage with it."""
        return frozen_copy(self.module)

    def _target_pairs(self) -> List[Tuple[Tuple[Any, ...], torch.Tensor,
                                          torch.Tensor]]:
        """(path, target tensor, online parameter) in JAX's leaf order."""
        online = dict(tree_paths(self.module))
        return [(path, t, online[path])
                for path, t in tree_paths(self.target_module)
                if self.target_keys is None or path[0] in self.target_keys]

    def sync_target(self, tau: float = 1.0) -> None:
        """``t * (1 - tau) + p * tau`` on every target leaf, the
        operations of JAX's ``tree_map`` (``tau`` 1.0: a hard copy)."""
        with torch.no_grad():
            for _, t, p in self._target_pairs():
                t.copy_(t * (1 - tau) + p * tau)

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["target_params"] = _nest([
            (path, t.detach().cpu().numpy().copy())
            for path, t, _ in self._target_pairs()])
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        tree = state.get("target_params")
        with torch.no_grad():
            for path, t, p in self._target_pairs():
                t.copy_(p if tree is None
                        else _tensor(_leaf(tree, path), t.device))


class OffPolicyAlgorithm(Algorithm):
    def setup(self, config) -> None:
        cfg = config if isinstance(config, self.config_class) else \
            self.config_class().update_from_dict(dict(config or {}))
        if cfg.num_learners != 0:
            raise ValueError(
                f"{type(self).__name__} uses a local learner "
                "(target-net state is per-learner)")
        super().setup(cfg)
        self.replay = ReplayBuffer(self.config.replay_buffer_capacity,
                                   seed=self.config.seed)
        self._env_steps = 0

    @property
    def _learner(self):
        return self.learner_group.learner

    def get_extra_state(self) -> Dict[str, Any]:
        return {
            "env_steps": self._env_steps,
            "replay_cols": dict(self.replay._cols),
            "replay_size": self.replay._size,
            "replay_next": self.replay._next,
        }

    def set_extra_state(self, state: Dict[str, Any]) -> None:
        if not state:
            return
        self._env_steps = state["env_steps"]
        self.replay._cols = dict(state["replay_cols"])
        self.replay._size = state["replay_size"]
        self.replay._next = state["replay_next"]

    def _update_once(self, batch) -> Dict[str, float]:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        rollout = self.env_runner_group.sample(cfg.rollout_fragment_length)
        self._env_steps += len(rollout)
        self.replay.add(rollout)

        metrics: Dict[str, Any] = {"replay_size": len(self.replay),
                                   "num_env_steps_total": self._env_steps}
        if len(self.replay) >= \
                cfg.num_steps_sampled_before_learning_starts:
            for _ in range(cfg.updates_per_step):
                batch = self.replay.sample(cfg.train_batch_size)
                metrics.update(self._update_once(batch))
                self._learner.sync_target(cfg.tau)
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights())
        return metrics
