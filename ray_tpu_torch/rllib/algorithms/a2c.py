"""A2C — synchronous advantage actor-critic.

Port of `ray_tpu/rllib/algorithms/a2c.py`: GAE from the same rollout
machinery as PPO, then ONE whole-batch vanilla policy-gradient step per
iteration (policy loss + value loss - entropy bonus; no clipping, no
minibatch epochs).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rllib.algorithms._losses import action_logp
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule
from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.postprocessing import compute_gae, standardize
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lambda_: float = 1.0          # pure n-step returns
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.train_batch_size = 512
        self.lr = 1e-3

    @property
    def algo_class(self):
        return A2C


class A2CLearner(TorchLearner):
    def loss_fn(self, batch, generator):
        cfg = self.config
        out = self.module.forward_train(batch[sb.OBS])
        logits = out["action_dist_inputs"]
        values = out["vf_preds"]
        logp_all, logp = action_logp(logits, batch[sb.ACTIONS])
        pg_loss = -(logp * batch[sb.ADVANTAGES]).mean()
        vf_loss = ((values - batch[sb.VALUE_TARGETS]) ** 2).mean()
        ent = -(logp_all.exp() * logp_all).sum(-1).mean()
        total = pg_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss \
            - cfg.get("entropy_coeff", 0.01) * ent
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": ent}


class A2C(Algorithm):
    config_class = A2CConfig
    learner_class = A2CLearner
    module_class = DiscreteMLPModule

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        pieces = self.env_runner_group.sample_with_bootstraps(
            cfg.train_batch_size)
        batches = []
        for batch, boot in pieces:
            batch = self.apply_learner_connector(batch)
            batch = compute_gae(batch, gamma=cfg.gamma,
                                lambda_=cfg.lambda_, bootstrap_value=boot)
            batches.append(batch)
        train_batch = SampleBatch.concat_samples(batches)
        train_batch[sb.ADVANTAGES] = standardize(
            train_batch[sb.ADVANTAGES])
        # ONE whole-batch step per iteration (the A2C/PPO difference).
        metrics = self.learner_group.update(train_batch)
        self.env_runner_group.sync_weights(
            self.learner_group.get_weights())
        return dict(metrics)
