"""Multi-agent environment protocol + a tiny built-in test env.

Reference: rllib/env/multi_agent_env.py (MultiAgentEnv: dict-keyed
reset/step — {agent_id: obs}, {agent_id: reward}, ... with "__all__" in
the done dicts). Agents may come and go between steps; each agent maps
to a policy module via the algorithm's policy_mapping_fn.

A copy of `ray_tpu/rllib/env/multi_agent_env.py`: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.env.tiny_envs import Box, Discrete, GridWorld


class MultiAgentEnv:
    """Protocol: subclasses define agents, observation/action spaces per
    agent, and dict-keyed reset/step."""

    agent_ids: Tuple[str, ...] = ()

    def observation_space_of(self, agent_id: str):
        raise NotImplementedError

    def action_space_of(self, agent_id: str):
        raise NotImplementedError

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, actions: Dict[str, Any]):
        """Returns (obs, rewards, terminateds, truncateds, infos), each a
        dict keyed by agent id; terminateds/truncateds also carry
        "__all__"."""
        raise NotImplementedError


class CoopPress(MultiAgentEnv):
    """Cooperative coordination task (QMIX testbed): each step both
    agents observe a context bit and must JOINTLY act — both matching
    the context pays +1, both pressing the other button +0.3, any
    mismatch 0. The reward is a single TEAM reward (shared), so
    credit assignment needs centralized value decomposition.
    """

    agent_ids = ("a0", "a1")

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.episode_len = int(config.get("episode_len", 8))
        self._rng = np.random.default_rng(config.get("seed", 0))
        self._ctx = 0
        self._t = 0

    def observation_space_of(self, agent_id: str):
        return Box(0.0, 1.0, (2,))

    def action_space_of(self, agent_id: str):
        return Discrete(2)

    def _obs(self) -> Dict[str, np.ndarray]:
        o = np.zeros(2, np.float32)
        o[self._ctx] = 1.0
        return {a: o.copy() for a in self.agent_ids}

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = int(self._rng.integers(2))
        self._t = 0
        return self._obs(), {}

    def step(self, actions: Dict[str, Any]):
        a0, a1 = int(actions["a0"]), int(actions["a1"])
        if a0 == a1 == self._ctx:
            team = 1.0
        elif a0 == a1:
            team = 0.3
        else:
            team = 0.0
        self._t += 1
        self._ctx = int(self._rng.integers(2))
        done = self._t >= self.episode_len
        obs = self._obs()
        rewards = {a: team for a in self.agent_ids}
        terms = {a: False for a in self.agent_ids}
        terms["__all__"] = False
        truncs = {a: done for a in self.agent_ids}
        truncs["__all__"] = done
        return obs, rewards, terms, truncs, {}


class TwoAgentGrid(MultiAgentEnv):
    """Two independent GridWorld agents on separate boards, one episode
    clock. Agent "a1"'s board is larger than "a0"'s, so the two policies
    genuinely need different weights — a 2-policy smoke env.
    """

    agent_ids = ("a0", "a1")

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self._envs = {
            "a0": GridWorld({"size": config.get("size_a0", 3)}),
            "a1": GridWorld({"size": config.get("size_a1", 4)}),
        }
        self._terminated: Dict[str, bool] = {}
        self._truncated: Dict[str, bool] = {}

    def observation_space_of(self, agent_id: str):
        return self._envs[agent_id].observation_space

    def action_space_of(self, agent_id: str):
        return self._envs[agent_id].action_space

    def reset(self, *, seed: Optional[int] = None):
        obs, infos = {}, {}
        for aid, env in self._envs.items():
            o, i = env.reset(seed=seed)
            obs[aid] = o
            infos[aid] = i
        self._terminated = {aid: False for aid in self.agent_ids}
        self._truncated = {aid: False for aid in self.agent_ids}
        return obs, infos

    def step(self, actions: Dict[str, Any]):
        obs: Dict[str, np.ndarray] = {}
        rewards: Dict[str, float] = {}
        terminateds: Dict[str, bool] = {}
        truncateds: Dict[str, bool] = {}
        for aid, action in actions.items():
            if self._terminated.get(aid) or self._truncated.get(aid):
                continue
            o, r, term, trunc, _ = self._envs[aid].step(action)
            obs[aid] = o
            rewards[aid] = r
            terminateds[aid] = term
            truncateds[aid] = trunc
            self._terminated[aid] = term
            self._truncated[aid] = trunc and not term
        all_done = all(t or u for t, u in zip(self._terminated.values(),
                                              self._truncated.values()))
        # A natural all-agents termination is NOT a truncation: consumers
        # use the distinction to decide final-step bootstrapping.
        terminateds["__all__"] = all_done and \
            all(self._terminated.values())
        truncateds["__all__"] = all_done and \
            not all(self._terminated.values())
        return obs, rewards, terminateds, truncateds, {}
