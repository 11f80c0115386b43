"""MultiAgentEnvRunner — samples a multi-agent env with per-policy modules.

Port of `ray_tpu/rllib/env/multi_agent_env_runner.py`: one env, N
agents, ``policy_mapping_fn`` agent_id -> module_id, per-module batch
assembly. Each module runs on the runner's device (``"cuda"`` unless
the config or the caller says ``"cpu"``) and explores from the runner's
own ``torch.Generator``. ``sample()`` returns ``{module_id: {agent_id:
SampleBatch}}``.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib.core.rl_module import params_from_numpy
from ray_tpu_torch.rllib.env.env_runner import module_outputs
from ray_tpu_torch.rllib.env.registry import make_env
from ray_tpu_torch.rllib.utils import sample_batch as sb
from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch


class MultiAgentEnvRunner:
    """One multi-agent rollout worker."""

    def __init__(self, config: dict, worker_index: int = 0, device=None):
        self.config = config
        self.worker_index = worker_index
        self.device = resolve_device(device if device is not None
                                     else config.get("device", "cuda"))
        self.env = make_env(config["env"], config.get("env_config"))
        self.policy_mapping_fn = config.get(
            "policy_mapping_fn") or (lambda aid: aid)
        seed = config.get("seed", 0) * 1000 + worker_index
        # module_specs: {module_id: RLModuleSpec}
        self.modules = {mid: spec.build(seed=seed, device=self.device)
                        for mid, spec in config["module_specs"].items()}
        self.params: Dict[str, Any] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_returns: Dict[str, float] = collections.defaultdict(
            float)
        self._recent_returns: collections.deque = collections.deque(
            maxlen=100)
        # Per-AGENT episode ids: a shared-policy module concatenates
        # several agents' trajectories, and GAE relies on eps_id changes
        # to find trajectory boundaries.
        self._eps_ids = {
            aid: worker_index * 1_000_000 + j * 100_000
            for j, aid in enumerate(self.env.agent_ids)}
        self._total_steps = 0

    def set_weights(self, params: Dict[str, Any]) -> None:
        for mid, tree in params.items():
            params_from_numpy(self.modules[mid], tree)
        self.params = params

    def _explore(self, module_id: str, obs) -> Dict[str, np.ndarray]:
        x = torch.as_tensor(np.asarray(obs, np.float32)[None, ...],
                            device=self.device)
        with torch.no_grad():
            out = module_outputs(self.modules[module_id].forward_exploration(
                x, self._gen))
        return {k: v[0] for k, v in out.items()}

    def sample(self, num_env_steps: int
               ) -> Dict[str, Dict[str, SampleBatch]]:
        """Collect num_env_steps env steps.

        Returns {module_id: {agent_id: SampleBatch}} — per-AGENT batches
        so the trainer can GAE each agent's trajectory with its own
        bootstrap before concatenating a shared module's data."""
        assert self.params, "set_weights before sample"
        cols: Dict[str, Dict[str, List[Any]]] = collections.defaultdict(
            lambda: collections.defaultdict(list))
        for _ in range(num_env_steps):
            actions: Dict[str, Any] = {}
            step_outs: Dict[str, Dict[str, np.ndarray]] = {}
            for aid, obs in self._obs.items():
                mid = self.policy_mapping_fn(aid)
                out = self._explore(mid, obs)
                step_outs[aid] = out
                discrete = hasattr(self.env.action_space_of(aid), "n")
                actions[aid] = (int(out["actions"]) if discrete
                                else np.asarray(out["actions"]))
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            for aid in actions:
                if aid not in rewards:
                    continue
                c = cols[aid]
                c[sb.OBS].append(self._obs[aid])
                c[sb.NEXT_OBS].append(next_obs.get(aid, self._obs[aid]))
                c[sb.ACTIONS].append(actions[aid])
                c[sb.REWARDS].append(rewards[aid])
                c[sb.TERMINATEDS].append(terms.get(aid, False))
                c[sb.TRUNCATEDS].append(truncs.get(aid, False))
                c[sb.EPS_ID].append(self._eps_ids[aid])
                out = step_outs[aid]
                if "action_logp" in out:
                    c[sb.ACTION_LOGP].append(out["action_logp"])
                if "vf_preds" in out:
                    c[sb.VF_PREDS].append(out["vf_preds"])
                self._episode_returns[aid] += rewards[aid]
            self._total_steps += 1
            if terms.get("__all__") or truncs.get("__all__"):
                self._recent_returns.append(
                    sum(self._episode_returns.values()))
                self._episode_returns.clear()
                for aid in self._eps_ids:
                    self._eps_ids[aid] += 1
                self._obs, _ = self.env.reset()
            else:
                self._obs = {aid: o for aid, o in next_obs.items()}
        result: Dict[str, Dict[str, SampleBatch]] = \
            collections.defaultdict(dict)
        for aid, c in cols.items():
            mid = self.policy_mapping_fn(aid)
            result[mid][aid] = SampleBatch(
                {k: np.asarray(v) for k, v in c.items()})
        return dict(result)

    def bootstrap_values(self) -> Dict[str, float]:
        """Per-AGENT value bootstrap for the current (mid-episode) obs."""
        out: Dict[str, float] = {}
        for aid, obs in self._obs.items():
            mid = self.policy_mapping_fn(aid)
            o = self._explore(mid, obs)
            out[aid] = float(o.get("vf_preds", 0.0))
        return out

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
