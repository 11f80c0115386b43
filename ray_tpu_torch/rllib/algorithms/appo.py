"""APPO — asynchronous-proximal PPO (IMPALA architecture + PPO clipping).

Port of `ray_tpu/rllib/algorithms/appo.py`: PPO's clipped surrogate
against V-trace-corrected advantages (`impala.vtrace`) from the behavior
log-probs recorded at sample time; the value and entropy terms are
IMPALA's.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.rllib.algorithms._losses import action_logp
from ray_tpu_torch.rllib.algorithms.impala import (IMPALA, IMPALAConfig,
                                                   IMPALALearner, vtrace)
from ray_tpu_torch.rllib.utils import sample_batch as sb


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.clip_param: float = 0.3
        self.num_epochs = 1

    @property
    def algo_class(self):
        return APPO


class APPOLearner(IMPALALearner):
    def loss_fn(self, batch, generator):
        cfg = self.config
        # IMPALA's loss, with its policy term swapped for the surrogate
        total_impala, metrics = super().loss_fn(batch, generator)
        out = self.module.forward_train(batch[sb.OBS])
        _, logp = action_logp(out["action_dist_inputs"], batch[sb.ACTIONS])
        ratio = torch.exp(logp - batch[sb.ACTION_LOGP])
        _, _, adv = vtrace(cfg, out["vf_preds"], logp, batch)
        clip = cfg.get("clip_param", 0.3)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        ppo_policy_loss = -surrogate.mean()
        total = total_impala - metrics["policy_loss"] + ppo_policy_loss
        metrics = dict(metrics)
        metrics["policy_loss"] = ppo_policy_loss
        metrics["clip_fraction"] = (
            torch.abs(ratio - 1.0) > clip).float().mean()
        return total, metrics


class APPO(IMPALA):
    config_class = APPOConfig
    learner_class = APPOLearner

    def training_step(self) -> Dict:
        return super().training_step()
