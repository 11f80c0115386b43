"""SingleAgentEnvRunner — samples episodes with the current policy.

Port of `ray_tpu/rllib/env/env_runner.py`. The runner steps a VECTOR of
envs (N sub-envs advance per policy forward; the built-in CartPole runs
fully numpy-vectorized, `env/vector.py`) and evaluates its RLModule on
its device (``"cuda"`` unless the config or the caller says ``"cpu"``)
from host weights: one forward over the whole env batch per step, one
host copy of its outputs. Exploration samples from the runner's own
``torch.Generator``; the action post-processing (EpsilonGreedy) keeps
its numpy generator, as in JAX.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib.core.rl_module import (params_from_numpy,
                                                ravel_tree)
from ray_tpu_torch.rllib.env.vector import make_vector_env
from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


def module_outputs(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A forward's outputs on the host (the runner's one pull a step)."""
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


class SingleAgentEnvRunner:
    """One rollout worker stepping a vector of envs."""

    def __init__(self, config: dict, worker_index: int = 0, device=None):
        self.config = config
        self.worker_index = worker_index
        self.device = resolve_device(device if device is not None
                                     else config.get("device", "cuda"))
        self.num_envs = max(1, int(config.get("num_envs_per_runner", 1)))
        seed = config.get("seed", 0) * 1000 + worker_index
        self.env = make_vector_env(config["env"],
                                   config.get("env_config"),
                                   self.num_envs, seed=seed)
        spec = config["module_spec"]
        self.module = spec.build(seed=seed, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        self.params = None
        self.env.reset(seed=seed)
        self._episode_return = np.zeros(self.num_envs, np.float64)
        # Distinct eps-id ranges per (worker, sub-env).
        self._eps_id = np.array(
            [(worker_index * self.num_envs + i) * 1_000_000
             for i in range(self.num_envs)], np.int64)
        self._recent_returns: collections.deque = collections.deque(
            maxlen=100)
        self._total_steps = 0
        # ConnectorV2 pipelines: user env_to_module/module_to_env
        # factories from the config, plus the default EpsilonGreedy
        # module_to_env connector.
        from ray_tpu_torch.rllib.connectors.connector import (
            EpsilonGreedy, build_pipeline)

        self._env_to_module = build_pipeline(
            config.get("env_to_module_connector"))
        self._module_to_env = build_pipeline(
            config.get("module_to_env_connector"))
        self._module_to_env.append(EpsilonGreedy())
        self._prev_dones = np.ones(self.num_envs, bool)  # fresh episodes

    def _obs_in(self, obs: np.ndarray) -> np.ndarray:
        """env_to_module transform for the obs the policy will act on
        (advances connector state; resets per-env state after dones)."""
        if not len(self._env_to_module):
            return obs
        return self._env_to_module({"obs": obs},
                                   dones=self._prev_dones)["obs"]

    def _obs_peek(self, obs: np.ndarray, dones: np.ndarray) -> np.ndarray:
        """env_to_module transform WITHOUT advancing state (recording
        next_obs / value bootstraps)."""
        if not len(self._env_to_module):
            return obs
        return self._env_to_module({"obs": obs}, dones=dones,
                                   commit=False)["obs"]

    def set_weights(self, params) -> None:
        """Host weights (a numpy tree in JAX's layout) for the module."""
        params_from_numpy(self.module, params)
        self.params = params

    def get_weights(self):
        return self.params

    def _obs_tensor(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(obs, np.float32),
                               device=self.device)

    def _explore_batch(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        """One policy forward over the whole env batch [N, ...]."""
        with torch.no_grad():
            return module_outputs(self.module.forward_exploration(
                self._obs_tensor(obs), self._gen))

    def _infer_batch(self, obs: np.ndarray) -> Dict[str, np.ndarray]:
        """Greedy (deterministic) forward for evaluation."""
        with torch.no_grad():
            return module_outputs(self.module.forward_inference(
                self._obs_tensor(obs)))

    def sample_episodes(self, num_episodes: int,
                        explore: bool = False) -> List[float]:
        """Run whole episodes and return their returns — the evaluation
        path. Greedy by default."""
        assert self.params is not None, "set_weights before sample"
        self.env.reset(seed=self.config.get("seed", 0) * 777 +
                       self.worker_index + 10_000)
        ep_ret = np.zeros(self.num_envs, np.float64)
        discrete = hasattr(self.env.action_space, "n")
        # Per-env quota — taking the first N episodes to FINISH across
        # parallel envs would bias the sample toward short episodes.
        quota = -(-num_episodes // self.num_envs)
        counts = np.zeros(self.num_envs, np.int64)
        done_returns: List[float] = []
        self._prev_dones = np.ones(self.num_envs, bool)  # fresh episodes
        for _ in range(100_000):  # hard cap; envs bound episode length
            obs = self._obs_in(self.env.current_obs)
            out = (self._explore_batch(obs) if explore
                   else self._infer_batch(obs))
            out = self._module_to_env(
                out, explore=explore,
                action_space_n=(self.env.action_space.n if discrete
                                else None),
                rng=self._np_rng)
            actions = np.asarray(out["actions"])
            if not discrete:
                actions = actions.astype(np.float32)
            _, rewards, terms, truncs = self.env.step(actions)
            self._prev_dones = terms | truncs
            ep_ret += rewards
            for i in np.nonzero(terms | truncs)[0]:
                if counts[i] < quota:
                    done_returns.append(float(ep_ret[i]))
                    counts[i] += 1
                ep_ret[i] = 0.0
            if len(done_returns) >= num_episodes:
                return done_returns[:num_episodes]
        return done_returns

    def sample(self, num_steps: int, explore: bool = True,
               epsilon: float = 0.0) -> SampleBatch:
        """Collect >= num_steps transitions (rounded up to a multiple of
        num_envs; episodes may span calls).

        epsilon > 0 overrides sampled actions with uniform-random ones
        (value-based algorithms; the EpsilonGreedy connector). The batch
        is laid out env-major (env0's steps, then env1's ...) so each
        eps_id segment is chronologically ordered for GAE.
        """
        assert self.params is not None, "set_weights before sample"
        n_iters = -(-num_steps // self.num_envs)
        discrete = hasattr(self.env.action_space, "n")
        per_env: List[Dict[str, List[Any]]] = [
            collections.defaultdict(list) for _ in range(self.num_envs)]
        last_terms = np.zeros(self.num_envs, bool)
        last_truncs = np.zeros(self.num_envs, bool)
        last_next_obs = self.env.current_obs
        for _ in range(n_iters):
            obs = self._obs_in(self.env.current_obs)
            out = self._explore_batch(obs)
            out = self._module_to_env(
                out, explore=explore, epsilon=epsilon,
                action_space_n=(self.env.action_space.n if discrete
                                else None),
                rng=self._np_rng)
            actions = np.asarray(out["actions"])
            next_obs_raw, rewards, terms, truncs = self.env.step(actions)
            done = terms | truncs
            # NEXT_OBS records the CONTINUING-episode view even on done
            # steps (the truncation bootstrap uses the same peek).
            next_obs = self._obs_peek(next_obs_raw,
                                      np.zeros(self.num_envs, bool))
            for i in range(self.num_envs):
                cols = per_env[i]
                cols[sb.OBS].append(obs[i])
                cols[sb.NEXT_OBS].append(next_obs[i])
                cols[sb.ACTIONS].append(
                    int(actions[i]) if discrete
                    else np.asarray(actions[i], np.float32))
                cols[sb.REWARDS].append(float(rewards[i]))
                cols[sb.TERMINATEDS].append(bool(terms[i]))
                cols[sb.TRUNCATEDS].append(bool(truncs[i]))
                cols[sb.EPS_ID].append(int(self._eps_id[i]))
                if "action_logp" in out:
                    cols[sb.ACTION_LOGP].append(out["action_logp"][i])
                if "vf_preds" in out:
                    cols[sb.VF_PREDS].append(out["vf_preds"][i])
            self._episode_return += rewards
            self._total_steps += self.num_envs
            for i in np.nonzero(done)[0]:
                self._recent_returns.append(float(
                    self._episode_return[i]))
                self._episode_return[i] = 0.0
                self._eps_id[i] += 1
            last_terms, last_truncs = terms, truncs
            last_next_obs = next_obs_raw
            self._prev_dones = done
        # Exact per-env bootstraps for each env's final step: terminated
        # -> 0; truncated -> V(final next_obs); cut mid-episode ->
        # V(current obs). Each batched forward runs only when some env
        # needs that bootstrap kind.
        zeros = np.zeros(self.num_envs, np.float32)
        no_dones = np.zeros(self.num_envs, bool)
        vf_next = (self._explore_batch(
            self._obs_peek(last_next_obs, no_dones)).get(
            "vf_preds", zeros) if last_truncs.any() else zeros)
        cut = ~(last_terms | last_truncs)
        vf_cur = (self._explore_batch(
            self._obs_peek(self.env.current_obs, self._prev_dones)).get(
            "vf_preds", zeros) if cut.any() else zeros)
        boots: Dict[int, float] = {}
        for i in range(self.num_envs):
            final_eps = int(per_env[i][sb.EPS_ID][-1])
            if last_terms[i]:
                boots[final_eps] = 0.0
            elif last_truncs[i]:
                boots[final_eps] = float(np.asarray(vf_next)[i])
            else:
                boots[final_eps] = float(np.asarray(vf_cur)[i])
        self._end_bootstraps = boots
        merged: Dict[str, np.ndarray] = {}
        for key in per_env[0]:
            merged[key] = np.concatenate(
                [np.asarray(per_env[i][key])
                 for i in range(self.num_envs)])
        return SampleBatch(merged)

    def evaluate_perturbations(self, base_params, seeds: List[int],
                               stdev: float, episodes_per: int = 1
                               ) -> List[tuple]:
        """ES/ARS worker op: for each noise seed, evaluate the antithetic
        pair theta +- stdev * eps(seed) and return (seed, ret_plus,
        ret_minus). Noise ships as SEEDS; eps is regenerated from the
        seed with numpy over the flat vector in ``ravel_pytree``'s leaf
        order, so a seed perturbs the same weights in both packages.
        Episode returns are recorded into the recent-returns window."""
        flat, unravel = ravel_tree(base_params)
        saved = self.params
        out = []
        try:
            for seed in seeds:
                eps = np.random.default_rng(int(seed)).standard_normal(
                    flat.shape[0]).astype(np.float32)
                pair = []
                for sign in (1.0, -1.0):
                    self.set_weights(unravel(flat + sign * stdev * eps))
                    rets = self.sample_episodes(episodes_per)
                    for r in rets:
                        self._recent_returns.append(float(r))
                    pair.append(float(np.mean(rets)) if rets else 0.0)
                out.append((int(seed), pair[0], pair[1]))
        finally:
            if saved is not None:
                self.set_weights(saved)
        return out

    def bootstrap_value(self):
        """Per-final-episode value bootstraps of the last sample()
        rollout ({eps_id: value}, consumed by compute_gae)."""
        if hasattr(self, "_end_bootstraps"):
            return self._end_bootstraps
        out = self._explore_batch(
            self._obs_peek(self.env.current_obs, self._prev_dones))
        vals = np.asarray(out.get("vf_preds",
                                  np.zeros(self.num_envs, np.float32)))
        return {int(self._eps_id[i]): float(vals[i])
                for i in range(self.num_envs)}

    def get_metrics(self) -> Dict[str, Any]:
        returns = list(self._recent_returns)
        return {
            "episode_return_mean":
                float(np.mean(returns)) if returns else float("nan"),
            "num_episodes": len(returns),
            "num_env_steps": self._total_steps,
        }

    def ping(self) -> bool:
        return True
