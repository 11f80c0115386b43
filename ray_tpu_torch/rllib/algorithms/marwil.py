"""MARWIL — monotonic advantage re-weighted imitation learning.

Port of `ray_tpu/rllib/algorithms/marwil.py`: behavior cloning weighted
by exp(beta * advantage), with a jointly-trained value head providing
the advantages (beta = 0 is BC). Discounted returns-to-go of the offline
log are computed at setup; the loss re-weights the log-likelihood by the
batch-RMS-normalized advantage exponent.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms._losses import action_logp
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule
from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.offline_dataset: Any = None
        self.beta: float = 1.0  # 0 => plain BC
        self.vf_coeff: float = 1.0
        self.max_advantage_weight: float = 20.0
        self.train_batch_size = 256
        self.num_env_runners = 0

    def offline_data(self, *, dataset=None, **kwargs) -> "MARWILConfig":
        if dataset is not None:
            self.offline_dataset = dataset
        self._apply(kwargs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d.pop("offline_dataset", None)  # stays with the driver
        return d

    @property
    def algo_class(self):
        return MARWIL


class MARWILLearner(TorchLearner):
    def loss_fn(self, batch, generator):
        cfg = self.config
        beta = cfg.get("beta", 1.0)
        out = self.module.forward_train(batch[sb.OBS])
        logits = out["action_dist_inputs"]
        values = out["vf_preds"]
        returns = batch["returns"]
        actions = batch[sb.ACTIONS].long()
        _, logp = action_logp(logits, actions)

        adv = (returns - values).detach()
        # batch RMS normalization (the reference keeps a running average)
        adv_rms = torch.sqrt(torch.mean(adv ** 2) + 1e-8)
        weights = torch.exp(torch.clamp(beta * adv / adv_rms, -10.0, 10.0))
        weights = torch.clamp(weights,
                              max=cfg.get("max_advantage_weight", 20.0))
        policy_loss = -(weights * logp).mean()
        vf_loss = ((values - returns) ** 2).mean()
        total = policy_loss + cfg.get("vf_coeff", 1.0) * vf_loss
        accuracy = (logits.argmax(-1) == actions).float().mean()
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "mean_weight": weights.mean(),
                       "accuracy": accuracy}


def _returns_to_go(rewards: np.ndarray, dones: np.ndarray,
                   gamma: float) -> np.ndarray:
    out = np.zeros_like(rewards, np.float32)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        if dones[t]:
            acc = 0.0
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out


class MARWIL(Algorithm):
    config_class = MARWILConfig
    learner_class = MARWILLearner
    module_class = DiscreteMLPModule

    def setup(self, config) -> None:
        super().setup(config)
        ds = self.config.offline_dataset
        if ds is None:
            raise ValueError(
                "MARWILConfig.offline_data(dataset=...) required")
        if hasattr(ds, "take_all"):  # a Dataset of rows
            rows = ds.take_all()
            ds = {k: np.asarray([r[k] for r in rows])
                  for k in rows[0]}
        self._obs = np.asarray(ds["obs"], np.float32)
        self._actions = np.asarray(ds["actions"])
        rewards = np.asarray(ds.get("rewards",
                                    np.zeros(len(self._obs))), np.float32)
        dones = np.array(
            ds.get("terminateds", ds.get("dones",
                                         np.zeros(len(self._obs)))),
            dtype=bool)  # copy: we write dones[-1] below
        dones[-1] = True  # the log ends here regardless
        returns = _returns_to_go(rewards, dones, self.config.gamma)
        # standardized: raw returns through the shared torso would make
        # the value loss drown the policy gradient
        self._returns = ((returns - returns.mean()) /
                         (returns.std() + 1e-8)).astype(np.float32)
        self._rng = np.random.default_rng(self.config.seed)

    def training_step(self) -> Dict[str, Any]:
        idx = self._rng.integers(0, len(self._obs),
                                 self.config.train_batch_size)
        batch = SampleBatch({
            sb.OBS: self._obs[idx],
            sb.ACTIONS: self._actions[idx],
            "returns": self._returns[idx],
        })
        return self.learner_group.update(batch)
