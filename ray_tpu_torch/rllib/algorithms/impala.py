"""IMPALA — importance-weighted actor-learner with V-trace.

Port of `ray_tpu/rllib/algorithms/impala.py`. Behavior-policy log-probs
recorded at sample time feed V-trace's clipped importance ratios
(rho/c), which correct the value targets; the targets are computed
inside the loss from the learner's own value predictions. JAX runs the
backward recursion as a ``lax.scan`` inside its jitted step; the port
runs it as a plain loop over T on the learner's device (`vtrace_scan`,
two small kernels a step; a fused kernel is a later perf item), on
detached inputs, since its result is a stop-gradient target.
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
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.vtrace_clip_rho_threshold: float = 1.0
        self.vtrace_clip_c_threshold: float = 1.0
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.train_batch_size = 512
        self.num_epochs = 1  # IMPALA is single-pass over each rollout
        self.minibatch_size = 512

    @property
    def algo_class(self):
        return IMPALA


def vtrace_scan(deltas: torch.Tensor, c_bar: torch.Tensor,
                not_done: torch.Tensor, gamma: float) -> torch.Tensor:
    """``vs - V(s)``: the backward recursion ``acc_t = delta_t + gamma *
    c_t * nd_t * acc_{t+1}`` (JAX's ``lax.scan(..., reverse=True)``,
    the same float ops in the same order), one step at a time."""
    coef = gamma * c_bar * not_done
    acc = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
    out = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + coef[t] * acc
        out.append(acc)
    return torch.stack(out[::-1])


def vtrace(cfg: dict, values: torch.Tensor, logp: torch.Tensor,
           batch: Dict[str, torch.Tensor]):
    """V-trace targets and advantages over a batch with host-computed
    seams (``boundary``, ``next_value_override``): (rho, vs, pg_adv),
    vs and pg_adv without gradient."""
    gamma = cfg.get("gamma", 0.99)
    rho = torch.exp(logp - batch[sb.ACTION_LOGP])
    with torch.no_grad():
        values, rho_d = values.detach(), rho.detach()
        rho_bar = torch.clamp(rho_d,
                              max=cfg.get("vtrace_clip_rho_threshold", 1.0))
        c_bar = torch.clamp(rho_d,
                            max=cfg.get("vtrace_clip_c_threshold", 1.0))
        rewards = batch[sb.REWARDS]
        seam = batch["boundary"].float() > 0
        override = batch["next_value_override"]
        zero = torch.zeros((1,), dtype=values.dtype, device=values.device)
        # At seams the learner's values[t+1] belongs to another episode
        # or shard: the host-provided bootstrap is used instead.
        values_next = torch.where(seam, override,
                                  torch.cat([values[1:], zero]))
        not_done = 1.0 - batch["boundary"].float()
        deltas = rho_bar * (rewards + gamma * values_next - values)
        vs = vtrace_scan(deltas, c_bar, not_done, gamma) + values
        vs_next = torch.where(seam, override, torch.cat([vs[1:], zero]))
        pg_adv = rho_bar * (rewards + gamma * vs_next - values)
    return rho, vs, pg_adv


class IMPALALearner(TorchLearner):
    def loss_fn(self, batch, generator):
        cfg = self.config
        out = self.module.forward_train(batch[sb.OBS])
        logits = out["action_dist_inputs"]
        values = out["vf_preds"]                       # [T]
        logp_all, logp = action_logp(logits, batch[sb.ACTIONS])
        rho, vs, pg_adv = vtrace(cfg, values, logp, batch)
        policy_loss = -(logp * pg_adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        ent = entropy(logits, logp_all)
        total = (policy_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss -
                 cfg.get("entropy_coeff", 0.01) * ent)
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": ent, "mean_rho": rho.mean()}


class IMPALA(Algorithm):
    config_class = IMPALAConfig
    learner_class = IMPALALearner
    module_class = DiscreteMLPModule

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        pairs = self.env_runner_group.sample_with_bootstraps(
            cfg.train_batch_size)
        batches = []
        for batch, boot in pairs:
            b = SampleBatch(batch)
            eps = np.asarray(b[sb.EPS_ID])
            terms = np.asarray(b[sb.TERMINATEDS], bool)
            vf = np.asarray(b.get(sb.VF_PREDS,
                                  np.zeros(len(b))), np.float32)
            # Seams where V-trace must not use the learner's values[t+1]:
            # episode change mid-rollout or the rollout tail. Bootstrap:
            # terminal -> 0; tail -> the runner's exact bootstrap value;
            # truncation/cut -> the row's own (stale) behavior value.
            boundary = np.zeros(len(b), np.float32)
            boundary[:-1] = (eps[1:] != eps[:-1]).astype(np.float32)
            boundary[-1] = 1.0
            override = np.where(terms, 0.0, vf).astype(np.float32)
            if isinstance(boot, dict):
                # Vector runners: exact per-env bootstraps keyed by the
                # final eps_id of each env's segment.
                for t in np.nonzero(boundary)[0]:
                    e = int(eps[t])
                    if not terms[t] and e in boot:
                        override[t] = boot[e]
            else:
                override[-1] = 0.0 if terms[-1] else float(boot)
            b["boundary"] = boundary
            b["next_value_override"] = override
            batches.append(b)
        train_batch = SampleBatch.concat_samples(batches)
        # (learner actors, which would also cut the scan at shard edges,
        # are not ported: LearnerGroup runs one local learner)
        metrics = self.learner_group.update(train_batch)
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        return metrics
