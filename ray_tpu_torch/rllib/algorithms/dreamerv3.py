"""DreamerV3 — model-based RL: learn a world model, act in imagination.

Port of `ray_tpu/rllib/algorithms/dreamerv3.py` (reference:
rllib/algorithms/dreamerv3/) for vector observations and discrete
actions:

- RSSM world model (`WorldModel`): GRU deterministic core (clipped
  ``tanh`` gates) + grouped categorical stochastic latents
  (straight-through one-hot, 1% unimix), obs encoder/decoder, reward and
  continue heads. Symlog targets for obs/reward; KL with free bits,
  split into dynamics (posterior stop-grad) and representation (prior
  stop-grad) terms.
- Imagination: H-step rollouts from posterior states under the actor;
  lambda-returns with a slow (EMA) critic bootstrap; the critic
  regresses symlog lambda-returns; the actor is REINFORCE with
  percentile-normalized returns and an entropy bonus.
- Sequence replay (per-env lanes, is_first flags), a host copy.

Simplifications vs the paper, as in the JAX package: MSE-on-symlog
critic/reward heads instead of twohot regression, and MLP encoders only.

The modules are named as JAX's trees (``wm``, ``actor``, ``critic``,
``slow_critic``) and live on ``config.device`` ("cuda" unless set to
"cpu"). Each categorical sample is ``argmax(logits + g)`` with a
standard Gumbel draw ``g`` (what ``jax.random.categorical`` computes)
taken through the learner's noise seam (`NoiseSeam.noise`, kind
"gumbel"), by name: ``observe.{t}`` (the posterior latent of step t; JAX
draws the prior's from the same key, and the prior's sample is unused),
``imagine.action.{t}`` / ``imagine.latent.{t}`` and ``policy.action`` /
``policy.latent``. A step's recurrent state stays on the device between
env steps; only the actions are copied to the host, and `train` copies
its metrics once.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (Adam, NoiseSeam, _tensor,
                                              scalars, to_tensors)
from ray_tpu_torch.rllib.core.rl_module import (_mlp, _mlp_apply,
                                                frozen_copy,
                                                params_from_numpy,
                                                params_to_numpy)


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        # world model
        self.deter_size: int = 128
        self.stoch_groups: int = 4
        self.stoch_classes: int = 8
        self.units: int = 128
        self.kl_free_bits: float = 1.0
        self.kl_dyn_scale: float = 0.5
        self.kl_rep_scale: float = 0.1
        # actor-critic (imagination)
        self.imagine_horizon: int = 10
        self.lambda_: float = 0.95
        self.gamma = 0.99
        self.entropy_coeff: float = 3e-3
        self.critic_ema_decay: float = 0.98
        # replay / schedule
        self.sequence_length: int = 16
        self.batch_size_sequences: int = 16
        self.replay_capacity_steps: int = 100_000
        self.env_steps_per_iteration: int = 64
        self.train_updates_per_iteration: int = 2
        self.num_steps_before_learning: int = 300
        self.model_lr: float = 1e-3
        self.actor_lr: float = 3e-4
        self.critic_lr: float = 3e-4
        self.num_envs_per_runner = 8

    @property
    def algo_class(self):
        return DreamerV3


# ----------------------------------------------------------- replay buffer
class SequenceReplay:
    """Per-env contiguous step storage; samples fixed-length
    subsequences with is_first flags (reference: dreamerv3's episode
    replay). A host copy of the JAX package's buffer: the same seed
    gives the same samples."""

    def __init__(self, capacity_steps: int, num_envs: int, seed: int = 0):
        self.cap = max(1, capacity_steps // max(1, num_envs))
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0

    def add_batch(self, step: Dict[str, np.ndarray]) -> None:
        """step: column -> [num_envs, ...] for ONE env step."""
        if not self._cols:
            for k, v in step.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.cap, *v.shape), v.dtype)
        i = self._next
        for k, v in step.items():
            self._cols[k][i] = v
        self._next = (self._next + 1) % self.cap
        self._size = min(self._size + 1, self.cap)

    def __len__(self) -> int:
        return self._size * self.num_envs

    def sample(self, batch: int, length: int) -> Dict[str, np.ndarray]:
        """[batch, length, ...] subsequences (random env lane + offset).
        Sequences never span the ring's write head."""
        assert self._size > length
        out: Dict[str, List[np.ndarray]] = {k: [] for k in self._cols}
        for _ in range(batch):
            env = int(self._rng.integers(self.num_envs))
            # Valid starts avoid wrapping through the write pointer.
            if self._size < self.cap:
                start = int(self._rng.integers(0, self._size - length))
            else:
                off = int(self._rng.integers(0, self.cap - length))
                start = (self._next + off) % self.cap
            idx = [(start + t) % self.cap for t in range(length)]
            for k, col in self._cols.items():
                out[k].append(col[idx, env])
        return {k: np.stack(v) for k, v in out.items()}


# ----------------------------------------------------------- modules
def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class GRUCell(nn.Module):
    """JAX's ``_gru`` with its tree's names (``wz``, ``bz``, ``wr``,
    ``br``, ``wh``, ``bh``; w [U + D, D], init normal x 0.02)."""

    def __init__(self, units: int, deter: int, generator=None):
        super().__init__()
        for g in ("z", "r", "h"):
            setattr(self, f"w{g}", nn.Parameter(
                torch.randn((units + deter, deter), generator=generator)
                * 0.02))
            setattr(self, f"b{g}", nn.Parameter(torch.zeros((deter,))))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        xh = torch.cat([x, h], -1)
        z = torch.clamp(torch.tanh(xh @ self.wz + self.bz) * 0.5 + 0.5,
                        0, 1)
        r = torch.clamp(torch.tanh(xh @ self.wr + self.br) * 0.5 + 0.5,
                        0, 1)
        cand = torch.tanh(torch.cat([x, r * h], -1) @ self.wh + self.bh)
        return (1 - z) * h + z * cand


class WorldModel(nn.Module):
    """The RSSM's parameters, named as JAX's ``wm`` tree."""

    def __init__(self, obs_dim: int, num_actions: int, D: int, Z: int,
                 U: int, generator=None):
        super().__init__()
        self.enc = _mlp([obs_dim, U, U], generator)
        self.gru_x = _mlp([Z + num_actions, U], generator)
        self.gru = GRUCell(U, D, generator)
        self.prior = _mlp([D, U, Z], generator)
        self.post = _mlp([D + U, U, Z], generator)
        self.dec = _mlp([D + Z, U, obs_dim], generator)
        self.rew = _mlp([D + Z, U, 1], generator)
        self.cont = _mlp([D + Z, U, 1], generator)

    def img_step(self, h, z, a_oh):
        """The deterministic core's next state from (h, z, action)."""
        x = _mlp_apply(self.gru_x, torch.cat([z, a_oh], -1),
                       final_activation=True)
        return self.gru(x, h)


class DreamerV3Learner(NoiseSeam):
    """World model + actor + critic, one update per `train` call."""

    def __init__(self, obs_dim: int, num_actions: int, cfg: dict,
                 device=None):
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.device = resolve_device(device if device is not None
                                     else cfg.get("device", "cuda"))
        D, G, C, U = (cfg["deter_size"], cfg["stoch_groups"],
                      cfg["stoch_classes"], cfg["units"])
        self.D, self.G, self.C, self.Z = D, G, C, G * C
        seed = int(cfg.get("seed", 0))
        gen = torch.Generator().manual_seed(seed)
        self.wm = WorldModel(obs_dim, num_actions, D, self.Z, U,
                             gen).to(self.device)
        self.actor = _mlp([D + self.Z, U, num_actions], gen).to(self.device)
        self.critic = _mlp([D + self.Z, U, 1], gen).to(self.device)
        self.slow_critic = frozen_copy(self.critic)
        self.wm_opt = Adam(self.wm, cfg["model_lr"])
        self.ac_opt = Adam(self.actor, cfg["actor_lr"])
        self.cr_opt = Adam(self.critic, cfg["critic_lr"])
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._noise = None
        # Percentile return-normalization EMA (paper sec. "returns").
        self.ret_lo = torch.zeros((), device=self.device)
        self.ret_hi = torch.ones((), device=self.device)

    # ---- building blocks ----

    def _latent(self, logits: torch.Tensor, gumbel=None):
        """Straight-through one-hot sample from grouped categoricals
        with 1% unimix: (sample [..., G*C], log-probs [..., G, C]). The
        sample is ``argmax(log(probs) + gumbel)``; without ``gumbel``
        only the log-probs are returned."""
        C = self.C
        logits = logits.reshape(*logits.shape[:-1], self.G, C)
        probs = 0.99 * torch.softmax(logits, -1) + 0.01 / C
        logp = torch.log(probs)
        if gumbel is None:
            return None, logp
        onehot = F.one_hot(torch.argmax(logp + gumbel, -1), C).to(
            probs.dtype)
        st = onehot + probs - probs.detach()
        return st.reshape(*st.shape[:-2], self.G * C), logp

    @staticmethod
    def _kl(logp_a, logp_b):
        """KL(a||b) over grouped categoricals, summed across groups."""
        return (torch.exp(logp_a) * (logp_a - logp_b)).sum(-1).sum(-1)

    # ---- world model over a sequence ----

    def _observe(self, obs_seq, act_seq, first_seq):
        """Roll the RSSM over [B, T, ...]: (hs, zs, posterior log-probs,
        prior log-probs), each [B, T, ...]."""
        wm = self.wm
        B, T = obs_seq.shape[:2]
        emb = _mlp_apply(wm.enc, symlog(obs_seq), final_activation=True)
        h = obs_seq.new_zeros((B, self.D))
        z = obs_seq.new_zeros((B, self.Z))
        hs, zs, lp_post, lp_prior = [], [], [], []
        for t in range(T):
            # Episode starts reset the recurrent state.
            mask = (1.0 - first_seq[:, t])[:, None]
            h, z = h * mask, z * mask
            h = wm.img_step(h, z, act_seq[:, t] * mask)
            prior_logits = _mlp_apply(wm.prior, h)
            post_logits = _mlp_apply(wm.post, torch.cat([h, emb[:, t]], -1))
            z, lpo = self._latent(post_logits, self.noise(
                f"observe.{t}", (B, self.G, self.C), "gumbel"))
            _, lpr = self._latent(prior_logits)
            hs.append(h)
            zs.append(z)
            lp_post.append(lpo)
            lp_prior.append(lpr)
        st = lambda xs: torch.stack(xs, 1)  # noqa: E731
        return st(hs), st(zs), st(lp_post), st(lp_prior)

    def _wm_loss(self, batch):
        obs = batch["obs"]
        acts = F.one_hot(batch["actions"].long(), self.num_actions).to(
            obs.dtype)
        # Action that LED TO step t is a[t-1]; first steps get zeros.
        prev_act = torch.cat([torch.zeros_like(acts[:, :1]), acts[:, :-1]],
                             1)
        hs, zs, lp_post, lp_prior = self._observe(obs, prev_act,
                                                  batch["is_first"])
        feat = torch.cat([hs, zs], -1)
        wm = self.wm
        recon = _mlp_apply(wm.dec, feat)
        rew_hat = _mlp_apply(wm.rew, feat)[..., 0]
        cont_logit = _mlp_apply(wm.cont, feat)[..., 0]
        recon_loss = ((recon - symlog(obs)) ** 2).sum(-1).mean()
        rew_loss = ((rew_hat - symlog(batch["rewards"])) ** 2).mean()
        cont_target = 1.0 - batch["terminateds"].to(obs.dtype)
        cont_loss = -(cont_target * F.logsigmoid(cont_logit) +
                      (1 - cont_target) * F.logsigmoid(-cont_logit)).mean()
        free = self.cfg["kl_free_bits"]
        kl_dyn = torch.clamp_min(
            self._kl(lp_post.detach(), lp_prior), free).mean()
        kl_rep = torch.clamp_min(
            self._kl(lp_post, lp_prior.detach()), free).mean()
        loss = (recon_loss + rew_loss + cont_loss +
                self.cfg["kl_dyn_scale"] * kl_dyn +
                self.cfg["kl_rep_scale"] * kl_rep)
        metrics = {"wm_loss": loss, "recon_loss": recon_loss,
                   "reward_loss": rew_loss, "kl_dyn": kl_dyn}
        return loss, feat, metrics

    # ---- imagination + actor/critic ----

    def _imagine(self, start_feat):
        """H steps under the actor from ``start_feat`` [N, D + Z] on the
        (frozen) world model: (feats [H, N, F], actions [H, N]). The
        rollout carries no gradient (JAX's: a stop-gradient start, the
        world model under stop-gradient, discrete actions)."""
        wm, H = self.wm, self.cfg["imagine_horizon"]
        N = start_feat.shape[0]
        h, z = start_feat[..., :self.D], start_feat[..., self.D:]
        feats, acts = [], []
        with torch.no_grad():
            for t in range(H):
                feat = torch.cat([h, z], -1)
                logits = _mlp_apply(self.actor, feat)
                a = torch.argmax(logits + self.noise(
                    f"imagine.action.{t}", (N, self.num_actions), "gumbel"),
                    -1)
                h = wm.img_step(h, z, F.one_hot(a, self.num_actions).to(
                    feat.dtype))
                z, _ = self._latent(_mlp_apply(wm.prior, h), self.noise(
                    f"imagine.latent.{t}", (N, self.G, self.C), "gumbel"))
                feats.append(feat)
                acts.append(a)
        return torch.stack(feats), torch.stack(acts)

    def _lambda_returns(self, rew, disc, v_slow):
        """lambda-returns [H-1, N], backwards, bootstrapped with the slow
        critic's last value."""
        lam = self.cfg["lambda_"]
        nxt, rets = v_slow[-1], []
        for t in range(rew.shape[0] - 2, -1, -1):
            nxt = rew[t] + disc[t] * ((1 - lam) * v_slow[t + 1] + lam * nxt)
            rets.append(nxt)
        return torch.stack(rets[::-1])

    def _ac_losses(self, start):
        """(actor loss, critic loss, metrics, 5th and 95th percentiles of
        the returns) from imagined rollouts of the current world model."""
        wm = self.wm
        feats, acts = self._imagine(start)
        with torch.no_grad():
            rew = symexp(_mlp_apply(wm.rew, feats)[..., 0])
            cont = torch.sigmoid(_mlp_apply(wm.cont, feats)[..., 0])
            disc = self.cfg["gamma"] * cont
            v_slow = symexp(_mlp_apply(self.slow_critic, feats)[..., 0])
            rets = self._lambda_returns(rew, disc, v_slow)    # [H-1, N]
            flat = rets.flatten()
            lo = torch.quantile(flat, 0.05)
            hi = torch.quantile(flat, 0.95)
        feats_t, acts_t = feats[:-1], acts[:-1]
        logps_t = F.log_softmax(_mlp_apply(self.actor, feats_t), -1)
        v_pred = _mlp_apply(self.critic, feats_t)[..., 0]
        # Percentile return normalization (paper): scale by the EMA of
        # the 5-95% range, not this batch's (noisier) percentiles.
        scale = torch.clamp_min(self.ret_hi - self.ret_lo, 1.0)
        adv = (rets - symexp(v_pred.detach())) / scale
        taken_logp = torch.gather(logps_t, -1, acts_t[..., None])[..., 0]
        entropy = -(torch.exp(logps_t) * logps_t).sum(-1)
        actor_loss = -(adv * taken_logp +
                       self.cfg["entropy_coeff"] * entropy).mean()
        critic_loss = ((v_pred - symlog(rets)) ** 2).mean()
        metrics = {"actor_loss": actor_loss.detach(),
                   "critic_loss": critic_loss.detach(),
                   "imagined_return": rets.mean(),
                   "actor_entropy": entropy.mean().detach()}
        return actor_loss, critic_loss, metrics, lo, hi

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One update on a [B, T] batch of tensors; the metrics stay
        tensors."""
        # 1. world model
        wm_loss, feat, metrics = self._wm_loss(batch)
        self.wm_opt.step(torch.autograd.grad(
            wm_loss, self.wm_opt.params, allow_unused=True,
            materialize_grads=True))
        # 2. imagination from (stop-grad) posterior states, on the world
        # model after its step
        start = feat.detach().reshape(-1, feat.shape[-1])
        actor_loss, critic_loss, ac_metrics, lo, hi = self._ac_losses(start)
        a_grads = torch.autograd.grad(actor_loss, self.ac_opt.params,
                                      allow_unused=True,
                                      materialize_grads=True)
        c_grads = torch.autograd.grad(critic_loss, self.cr_opt.params,
                                      allow_unused=True,
                                      materialize_grads=True)
        self.ac_opt.step(a_grads)
        self.cr_opt.step(c_grads)
        decay = self.cfg["critic_ema_decay"]
        with torch.no_grad():
            for s, p in zip(self.slow_critic.parameters(),
                            self.critic.parameters()):
                s.copy_(decay * s + (1 - decay) * p)
            self.ret_lo = 0.99 * self.ret_lo + 0.01 * lo
            self.ret_hi = 0.99 * self.ret_hi + 0.01 * hi
        out = {k: v.detach() for k, v in metrics.items()}
        out.update(ac_metrics)
        return out

    def policy(self, h, z, prev_a, first, obs):
        """One recurrent policy step for the env loop (posterior): the
        next (h, z) on the device and the actions [N]."""
        wm = self.wm
        N = obs.shape[0]
        with torch.no_grad():
            mask = (1.0 - first)[:, None]
            h, z = h * mask, z * mask
            a_oh = F.one_hot(prev_a.long(), self.num_actions).to(
                h.dtype) * mask
            h = wm.img_step(h, z, a_oh)
            emb = _mlp_apply(wm.enc, symlog(obs), final_activation=True)
            post_logits = _mlp_apply(wm.post, torch.cat([h, emb], -1))
            z, _ = self._latent(post_logits, self.noise(
                "policy.latent", (N, self.G, self.C), "gumbel"))
            logits = _mlp_apply(self.actor, torch.cat([h, z], -1))
            a = torch.argmax(logits + self.noise(
                "policy.action", (N, self.num_actions), "gumbel"), -1)
        return h, z, a

    # ---- public ----

    def train(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return scalars(self.train_step(to_tensors(batch, self.device)))

    def get_state(self) -> Dict[str, Any]:
        """The four weight trees in JAX's layout (as JAX's checkpoint:
        no optimizer moments, no return-normalization EMA)."""
        return {"wm": params_to_numpy(self.wm),
                "actor": params_to_numpy(self.actor),
                "critic": params_to_numpy(self.critic),
                "slow_critic": params_to_numpy(self.slow_critic)}

    def set_state(self, state: Dict[str, Any]) -> None:
        params_from_numpy(self.wm, state["wm"])
        params_from_numpy(self.actor, state["actor"])
        params_from_numpy(self.critic, state["critic"])
        params_from_numpy(self.slow_critic, state["slow_critic"])


def dreamerv3_from_jax(learner: DreamerV3Learner, state: Dict[str, Any],
                       opt_states=None, ret_stats=None) -> DreamerV3Learner:
    """Carry a JAX DreamerV3Learner's numpy trees (``get_state()``: wm,
    actor, critic, slow_critic) into the port's ``learner``, in place;
    ``opt_states`` (the three Adams' ``{"count", "mu", "nu"}``, read out
    of optax's states, in the order wm, actor, critic) and ``ret_stats``
    (``(ret_lo, ret_hi)``) carry the rest of a JAX learner's state.
    Returns ``learner``."""
    learner.set_state(state)
    if opt_states is not None:
        for opt, s in zip((learner.wm_opt, learner.ac_opt, learner.cr_opt),
                          opt_states):
            opt.load(s)
    if ret_stats is not None:
        learner.ret_lo = _tensor(ret_stats[0], learner.device)
        learner.ret_hi = _tensor(ret_stats[1], learner.device)
    return learner


# ----------------------------------------------------------- algorithm
class DreamerV3(Algorithm):
    """Self-contained setup: the recurrent policy owns its env loop (the
    reference's DreamerV3 likewise subclasses the runner stack rather
    than using the stateless one)."""

    config_class = DreamerV3Config

    def setup(self, config) -> None:
        from ray_tpu_torch.rllib.env.vector import make_vector_env

        if isinstance(config, AlgorithmConfig):
            self.config = config
        else:
            self.config = self.config_class().update_from_dict(
                dict(config or {}))
        cfg = self.config
        self.num_envs = max(1, cfg.num_envs_per_runner)
        self.env = make_vector_env(cfg.env, cfg.env_config, self.num_envs,
                                   seed=cfg.seed)
        self.env.reset(seed=cfg.seed)
        obs_dim = int(self.env.observation_space.shape[0])
        self.num_actions = int(self.env.action_space.n)
        self.learner = DreamerV3Learner(obs_dim, self.num_actions,
                                        cfg.to_dict())
        self.device = self.learner.device
        self.replay = SequenceReplay(cfg.replay_capacity_steps,
                                     self.num_envs, seed=cfg.seed)
        D = cfg.deter_size
        Z = cfg.stoch_groups * cfg.stoch_classes
        self._h = torch.zeros((self.num_envs, D), device=self.device)
        self._z = torch.zeros((self.num_envs, Z), device=self.device)
        self._prev_a = np.zeros(self.num_envs, np.int32)
        self._first = np.ones(self.num_envs, np.float32)
        self._ep_ret = np.zeros(self.num_envs)
        self._recent_returns: List[float] = []
        self._env_steps = 0
        self._iteration = 0

    def step(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        results = self.training_step()
        self._iteration += 1
        results["training_iteration"] = self._iteration
        results["time_this_iter_s"] = time.perf_counter() - t0
        return results

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        dev = self.device
        for _ in range(cfg.env_steps_per_iteration // self.num_envs):
            obs = self.env.current_obs
            h, z, a = self.learner.policy(
                self._h, self._z, torch.as_tensor(self._prev_a, device=dev),
                torch.as_tensor(self._first, device=dev),
                _tensor(obs, dev))
            actions = a.cpu().numpy().astype(np.int32)
            _, rewards, terms, truncs = self.env.step(actions)
            self.replay.add_batch({
                "obs": obs.astype(np.float32),
                "actions": actions,
                "rewards": rewards.astype(np.float32),
                "terminateds": terms.astype(np.float32),
                "is_first": self._first.astype(np.float32)})
            self._h, self._z = h, z
            self._prev_a = actions
            done = terms | truncs
            self._first = done.astype(np.float32)
            self._ep_ret += rewards
            for i in np.nonzero(done)[0]:
                self._recent_returns.append(float(self._ep_ret[i]))
                self._ep_ret[i] = 0.0
            self._env_steps += self.num_envs
        metrics: Dict[str, Any] = {"num_env_steps": self._env_steps}
        if len(self.replay) >= cfg.num_steps_before_learning and \
                self.replay._size > cfg.sequence_length:
            last: Dict[str, torch.Tensor] = {}
            for _ in range(cfg.train_updates_per_iteration):
                batch = self.replay.sample(cfg.batch_size_sequences,
                                           cfg.sequence_length)
                last = self.learner.train_step(to_tensors(batch, dev))
            metrics.update(scalars(last))
        recent = self._recent_returns[-100:]
        if recent:
            metrics["episode_return_mean"] = float(np.mean(recent))
        return metrics

    def get_extra_state(self) -> Dict[str, Any]:
        return {"env_steps": self._env_steps}

    def set_extra_state(self, state: Dict[str, Any]) -> None:
        self._env_steps = state.get("env_steps", 0)

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump({"learner": self.learner.get_state(),
                         "iteration": self._iteration,
                         "algo_state": self.get_extra_state()}, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir,
                               "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_state(state["learner"])
        self._iteration = state["iteration"]
        self.set_extra_state(state.get("algo_state", {}))

    def cleanup(self) -> None:
        pass
