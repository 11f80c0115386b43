"""PPO — Proximal Policy Optimization.

Port of `ray_tpu/rllib/algorithms/ppo.py`: training_step samples the
env runners, runs GAE on the host, standardizes the advantages and takes
``num_epochs`` passes of shuffled minibatch SGD on the learner's device
with the clipped surrogate loss, then broadcasts the weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms._losses import action_logp, entropy
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule
from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.postprocessing import compute_gae, standardize
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_: float = 0.95
        self.clip_param: float = 0.2
        self.vf_clip_param: float = 10.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        self.kl_target: float = 0.01
        self.use_kl_loss: bool = False
        self.kl_coeff: float = 0.2

    @property
    def algo_class(self):
        return PPO


class PPOLearner(TorchLearner):
    def loss_fn(self, batch, generator):
        cfg = self.config
        out = self.module.forward_train(batch[sb.OBS])
        logits = out["action_dist_inputs"]
        values = out["vf_preds"]
        logp_all, logp = action_logp(logits, batch[sb.ACTIONS])
        old_logp = batch[sb.ACTION_LOGP]
        adv = batch[sb.ADVANTAGES]

        ratio = torch.exp(logp - old_logp)
        clip = cfg.get("clip_param", 0.2)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        policy_loss = -surrogate.mean()

        # Clipped value loss (reference: ppo_torch_learner vf_loss_clipped).
        vf_err = (values - batch[sb.VALUE_TARGETS]) ** 2
        vf_loss = torch.clamp(vf_err, 0.0,
                              cfg.get("vf_clip_param", 10.0)).mean()
        ent = entropy(logits, logp_all)
        kl = (old_logp - logp).mean()
        total = (policy_loss +
                 cfg.get("vf_loss_coeff", 0.5) * vf_loss -
                 cfg.get("entropy_coeff", 0.0) * ent)
        if cfg.get("use_kl_loss", False):
            total = total + cfg.get("kl_coeff", 0.2) * kl
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": ent, "kl": kl}


class PPO(Algorithm):
    config_class = PPOConfig
    learner_class = PPOLearner
    module_class = DiscreteMLPModule

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        pairs = self.env_runner_group.sample_with_bootstraps(
            cfg.train_batch_size)
        train_batch = SampleBatch.concat_samples([
            compute_gae(self.apply_learner_connector(batch),
                        cfg.gamma, cfg.lambda_, bootstrap)
            for batch, bootstrap in pairs])
        train_batch[sb.ADVANTAGES] = standardize(
            train_batch[sb.ADVANTAGES])

        rng = np.random.default_rng(cfg.seed + self._iteration)
        metrics: Dict[str, float] = {}
        count = 0
        for _ in range(cfg.num_epochs):
            for minibatch in train_batch.minibatches(cfg.minibatch_size,
                                                     rng):
                m = self.learner_group.update(minibatch)
                count += 1
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v
        metrics = {k: v / max(1, count) for k, v in metrics.items()}
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return metrics
