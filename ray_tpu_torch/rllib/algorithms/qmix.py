"""QMIX — cooperative multi-agent Q-learning with monotonic mixing.

Port of `ray_tpu/rllib/algorithms/qmix.py` (reference: rllib_contrib
qmix, Rashid et al. 2018): per-agent utility networks Q_i(o_i, a_i)
combined by a MIXING network whose weights come from hypernetworks
conditioned on the GLOBAL state, made non-negative by ``abs`` so that
argmax_a Q_tot decomposes into per-agent argmaxes.

The agents share one utility net over ``obs ++ one-hot(agent id)``
(`QMIXModule`, parameters named as JAX's tree); JAX's ``vmap`` over the
batch is one batched product here. The target is a frozen copy of the
module (no parameters of the optimizer), soft-synced after every update
as ``t * (1 - tau) + p * tau``. An update is the TD loss against the
target mixer over the max of the target agent Qs, then exactly optax's
``chain(clip_by_global_norm(grad_clip), adam(lr))`` (`Adam`, the
learners' own step). The module and its target live on
``config.device`` ("cuda" unless set to "cpu"); an env step copies the
greedy actions to the host once, and a training step copies its
metrics once. Rollouts are a local env loop, so transitions stay JOINT;
remote collectors (``num_env_runners > 0``) are not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib._unported import unported
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (Adam, _tensor, scalars,
                                              to_tensors)
from ray_tpu_torch.rllib.core.rl_module import (_mlp, _mlp_apply,
                                                frozen_copy,
                                                params_from_numpy,
                                                params_to_numpy)
from ray_tpu_torch.rllib.env.registry import make_env
from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch
from ray_tpu_torch.tune.trainable import Trainable


class QMIXConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.mixing_embed_dim: int = 32
        self.hypernet_hidden: int = 64
        self.agent_hidden: tuple = (64,)
        self.replay_buffer_capacity: int = 50_000
        self.num_steps_sampled_before_learning_starts: int = 200
        self.epsilon_start: float = 1.0
        self.epsilon_end: float = 0.05
        self.epsilon_decay_steps: int = 2_000
        self.tau: float = 0.01
        self.rollout_fragment_length = 64
        self.train_batch_size = 128
        self.updates_per_step: int = 8
        self.lr = 5e-3

    @property
    def algo_class(self):
        return QMIX


class QMIXModule(nn.Module):
    """The shared agent-utility net and the mixer's hypernetworks, named
    as JAX's params tree (``agent``, ``hyper_w1``, ``hyper_b1``,
    ``hyper_w2``, ``hyper_b2``; w [fan_in, fan_out])."""

    def __init__(self, obs_dim: int, n_agents: int, n_actions: int,
                 agent_hidden=(64,), embed: int = 32, hyper: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_agents, self.embed = n_agents, embed
        state_dim = obs_dim * n_agents
        self.agent = _mlp((obs_dim + n_agents, *agent_hidden, n_actions),
                          generator)
        self.hyper_w1 = _mlp((state_dim, hyper, n_agents * embed), generator)
        self.hyper_b1 = _mlp((state_dim, embed), generator)
        self.hyper_w2 = _mlp((state_dim, hyper, embed), generator)
        self.hyper_b2 = _mlp((state_dim, embed, 1), generator)

    def agent_qs(self, obs: torch.Tensor) -> torch.Tensor:
        """obs [..., A, obs_dim] -> per-agent Q values [..., A, actions]."""
        eye = torch.eye(self.n_agents, dtype=obs.dtype, device=obs.device)
        x = torch.cat([obs, eye.expand(*obs.shape[:-1], self.n_agents)], -1)
        return _mlp_apply(self.agent, x)

    def mix(self, agent_q: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        """Monotonic mixer: agent_q [B, A], state [B, S] -> Q_tot [B]."""
        w1 = torch.abs(_mlp_apply(self.hyper_w1, state)).reshape(
            -1, self.n_agents, self.embed)
        b1 = _mlp_apply(self.hyper_b1, state)
        hidden = F.elu(torch.einsum("ba,bae->be", agent_q, w1) + b1)
        w2 = torch.abs(_mlp_apply(self.hyper_w2, state))
        b2 = _mlp_apply(self.hyper_b2, state)[..., 0]
        return torch.einsum("be,be->b", hidden, w2) + b2


class QMIXRolloutWorker:
    """Remote joint-episode collector of the JAX package: needs the
    actor runtime."""

    def __init__(self, config: dict, worker_index: int):
        raise unported("QMIX with num_env_runners > 0")


class QMIX(Trainable):
    config_class = QMIXConfig

    def setup(self, config) -> None:
        self.config = config if isinstance(config, QMIXConfig) else \
            QMIXConfig().update_from_dict(dict(config or {}))
        cfg = self.config
        if cfg.num_env_runners > 0:
            raise unported("QMIX with num_env_runners > 0")
        self.device = resolve_device(cfg.device)
        self.env = make_env(cfg.env, cfg.env_config)
        self.agents = list(self.env.agent_ids)
        self.n_agents = len(self.agents)
        self.obs_dim = int(
            self.env.observation_space_of(self.agents[0]).shape[0])
        self.n_actions = int(self.env.action_space_of(self.agents[0]).n)
        self.state_dim = self.obs_dim * self.n_agents  # global state

        gen = torch.Generator().manual_seed(int(cfg.seed))
        self.module = QMIXModule(
            self.obs_dim, self.n_agents, self.n_actions,
            tuple(cfg.agent_hidden), cfg.mixing_embed_dim,
            cfg.hypernet_hidden, generator=gen).to(self.device)
        self.target_module = frozen_copy(self.module)
        self.opt = Adam(self.module, cfg.lr, cfg.grad_clip)
        self._replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                    seed=cfg.seed)
        self._explore_rng = np.random.default_rng(cfg.seed)
        self._env_steps = 0
        self._iteration = 0
        self._recent_team_returns: list = []
        self._obs, _ = self.env.reset(seed=cfg.seed)
        self._episode_return = 0.0

    # ---- policy ----

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end -
                                           cfg.epsilon_start)

    def _act(self, obs: Dict[str, np.ndarray], epsilon: float
             ) -> Dict[str, int]:
        stack = np.stack([obs[a] for a in self.agents])
        with torch.no_grad():
            greedy = self.module.agent_qs(_tensor(stack, self.device)
                                          ).argmax(-1).cpu().numpy()
        out = {}
        rng = self._explore_rng
        for i, a in enumerate(self.agents):
            if rng.random() < epsilon:
                out[a] = int(rng.integers(self.n_actions))
            else:
                out[a] = int(greedy[i])
        return out

    # ---- learning ----

    def _loss(self, batch: Dict[str, torch.Tensor]):
        """(TD loss, metrics) of the online module against the target."""
        m, t = self.module, self.target_module
        obs, next_obs = batch["obs"], batch["next_obs"]
        B = obs.shape[0]
        q = torch.gather(m.agent_qs(obs), -1,
                         batch["actions"].long()[..., None])[..., 0]
        q_tot = m.mix(q, obs.reshape(B, -1))
        with torch.no_grad():
            next_max = t.agent_qs(next_obs).max(-1).values
            next_tot = t.mix(next_max, next_obs.reshape(B, -1))
            y = batch["rewards"] + self.config.gamma * (
                1.0 - batch["dones"]) * next_tot
        loss = ((q_tot - y) ** 2).mean()
        return loss, {"td_loss": loss.detach(),
                      "q_tot_mean": q_tot.mean().detach()}

    def _grads(self, batch: Dict[str, np.ndarray]):
        loss, metrics = self._loss(to_tensors(batch, self.device))
        grads = torch.autograd.grad(loss, self.opt.params, allow_unused=True,
                                    materialize_grads=True)
        return list(grads), metrics

    def _update(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on the batch; the metrics stay tensors
        (the step copies them to the host once)."""
        grads, metrics = self._grads(batch)
        self.opt.step(grads)
        return metrics

    def _sync_target(self, tau: float) -> None:
        with torch.no_grad():
            for t, p in zip(self.target_module.parameters(),
                            self.module.parameters()):
                t.copy_(t * (1 - tau) + p * tau)

    # ---- Trainable ----

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        eps = self._epsilon()
        frag: Dict[str, list] = {k: [] for k in
                                 ("obs", "actions", "rewards",
                                  "next_obs", "dones")}
        for _ in range(cfg.rollout_fragment_length):
            actions = self._act(self._obs, eps)
            nxt, rewards, terms, truncs, _ = self.env.step(actions)
            team = float(rewards[self.agents[0]])
            done = bool(terms.get("__all__") or truncs.get("__all__"))
            frag["obs"].append(
                np.stack([self._obs[a] for a in self.agents]))
            frag["actions"].append(
                np.array([actions[a] for a in self.agents], np.int32))
            frag["rewards"].append(np.float32(team))
            frag["next_obs"].append(
                np.stack([nxt[a] for a in self.agents]))
            frag["dones"].append(
                np.float32(terms.get("__all__", False)))
            self._episode_return += team
            self._env_steps += 1
            if done:
                self._recent_team_returns.append(self._episode_return)
                self._recent_team_returns = \
                    self._recent_team_returns[-100:]
                self._episode_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        self._replay.add(SampleBatch(
            {k: np.stack(v) for k, v in frag.items()}))
        return self._learn_and_finish(eps)

    def _learn_and_finish(self, eps: float) -> Dict[str, Any]:
        """Metrics + the learn loop (the last update's loss metrics)."""
        cfg = self.config
        metrics: Dict[str, Any] = {
            "epsilon": eps,
            "num_env_steps_total": self._env_steps,
            "replay_size": len(self._replay),
            "episode_return_mean":
                float(np.mean(self._recent_team_returns))
                if self._recent_team_returns else float("nan"),
        }
        if len(self._replay) >= \
                cfg.num_steps_sampled_before_learning_starts:
            last: Dict[str, torch.Tensor] = {}
            for _ in range(cfg.updates_per_step):
                batch = dict(self._replay.sample(cfg.train_batch_size))
                last = self._update(batch)
                self._sync_target(cfg.tau)
            metrics.update(scalars(last))
        self._iteration += 1
        metrics["training_iteration"] = self._iteration
        return metrics

    def _compact_replay(self) -> Dict[str, np.ndarray]:
        """Filled replay rows, oldest-first (unwraps the ring)."""
        buf = self._replay
        if buf._size == 0:
            return {}
        if buf._size < buf.capacity:
            idx = np.arange(buf._size)
        else:
            idx = (buf._next + np.arange(buf.capacity)) % buf.capacity
        return {k: v[idx] for k, v in buf._cols.items()}

    # ---- state ----

    def get_state(self) -> Dict[str, Any]:
        """Weights, target and Adam's count and moments as numpy trees
        in JAX's layout."""
        return {"params": params_to_numpy(self.module),
                "target_params": params_to_numpy(self.target_module),
                "opt_state": self.opt.state()}

    def set_state(self, state: Dict[str, Any]) -> None:
        """`get_state`'s inverse; without ``opt_state`` Adam restarts."""
        params_from_numpy(self.module, state["params"])
        params_from_numpy(self.target_module, state["target_params"])
        if state.get("opt_state") is None:
            self.opt.reset()
        else:
            self.opt.load(state["opt_state"])

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        state = self.get_state()
        # Replay is stored COMPACT (filled rows in ring order).
        state.update({
            "replay_rows": self._compact_replay(),
            "recent_team_returns": list(self._recent_team_returns),
            "env_steps": self._env_steps,
            "iteration": self._iteration,
        })
        with open(os.path.join(checkpoint_dir, "qmix_state.pkl"),
                  "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "qmix_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.set_state(state)
        rows = state.get("replay_rows")
        if rows:
            self._replay = ReplayBuffer(
                self.config.replay_buffer_capacity,
                seed=self.config.seed)
            self._replay.add(SampleBatch(rows))
        self._recent_team_returns = list(
            state.get("recent_team_returns", []))
        self._env_steps = state["env_steps"]
        self._iteration = state["iteration"]

    stop = Trainable.cleanup

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        """Greedy (decentralized-execution) evaluation on a FRESH env
        instance, so the training env's episode state is untouched."""
        env = make_env(self.config.env, self.config.env_config)
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=10_000 + ep)
            total, done = 0.0, False
            while not done:
                actions = self._act(obs, epsilon=0.0)
                obs, rewards, terms, truncs, _ = env.step(actions)
                total += float(rewards[self.agents[0]])
                done = bool(terms.get("__all__") or
                            truncs.get("__all__"))
            returns.append(total)
        return {"evaluation": {
            "episode_return_mean": float(np.mean(returns)),
            "num_episodes": num_episodes}}


def qmix_from_jax(algo: QMIX, params, target_params,
                  opt_state: Optional[Dict[str, Any]] = None) -> QMIX:
    """Carry a JAX QMIX's numpy trees (``params``, ``target_params``;
    Adam's ``{"count", "mu", "nu"}`` read out of its optax state) into
    the port's ``algo``, in place. Returns ``algo``."""
    algo.set_state({"params": params, "target_params": target_params,
                    "opt_state": opt_state})
    return algo
