"""ConnectorV2: pluggable transform pipelines between env, module, and
learner.

Reference: rllib/connectors/connector.py (ConnectorV2 +
ConnectorPipelineV2) — the new-stack seam where observation
preprocessing, action post-processing, and train-batch transforms live,
instead of being hard-wired into env runners and learners. Three
pipelines, mirroring the reference:

- env_to_module: raw env observations -> module inputs (each rollout
  step, batched over the runner's vector envs).
- module_to_env: module outputs -> env actions (each rollout step).
- learner: sampled train batch -> loss inputs (before GAE/update —
  where the reference runs its GeneralAdvantageEstimation connector).

Connectors are stateful objects built per runner/learner from picklable
FACTORIES carried in the config (the runner is an actor in another
process). ``get_state``/``set_state`` expose synchronizable state
(e.g. running normalization statistics).

A copy of `ray_tpu/rllib/connectors/connector.py`: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class ConnectorV2:
    """One transform. Subclasses override __call__ and may carry state.

    __call__ receives the batch dict (column -> np.ndarray) plus keyword
    context and returns the (possibly new) batch dict. Context keys used
    by the built-in seams:

    - dones: bool[N] — which vector envs finished on the PREVIOUS step
      (env_to_module; reset per-env state there).
    - commit: bool — False for peek-style calls that must not advance
      internal state (the runner transforms next_obs for recording
      without double-advancing frame stacks).
    - explore / epsilon / action_space_n / rng — module_to_env context.
    """

    def __call__(self, batch: Dict[str, Any], **ctx) -> Dict[str, Any]:
        return batch

    def observation_dim(self, input_dim: int) -> int:
        """Transformed flat observation dim (module sizing)."""
        return input_dim

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass

    @property
    def name(self) -> str:
        return type(self).__name__


class ConnectorPipelineV2(ConnectorV2):
    """An ordered chain of connectors applied left to right."""

    def __init__(self, connectors: Optional[Sequence[ConnectorV2]] = None):
        self.connectors: List[ConnectorV2] = list(connectors or [])

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def __call__(self, batch: Dict[str, Any], **ctx) -> Dict[str, Any]:
        for c in self.connectors:
            batch = c(batch, **ctx)
        return batch

    def observation_dim(self, input_dim: int) -> int:
        for c in self.connectors:
            input_dim = c.observation_dim(input_dim)
        return input_dim

    def get_state(self) -> Dict[str, Any]:
        return {c.name + f"_{i}": c.get_state()
                for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            key = c.name + f"_{i}"
            if key in state:
                c.set_state(state[key])

    def __len__(self) -> int:
        return len(self.connectors)


def build_pipeline(factory: Optional[Callable[[], Any]]
                   ) -> ConnectorPipelineV2:
    """Materialize a user factory into a pipeline (factories keep the
    config picklable; a factory may return one connector or a list)."""
    if factory is None:
        return ConnectorPipelineV2()
    made = factory()
    if isinstance(made, ConnectorPipelineV2):
        return made
    if isinstance(made, ConnectorV2):
        return ConnectorPipelineV2([made])
    return ConnectorPipelineV2(list(made))


# --------------------------------------------------------------- built-ins
class FrameStackObs(ConnectorV2):
    """env_to_module: stack the last k observations per vector env along
    the feature axis (reference: connectors/env_to_module/
    frame_stacking.py). State resets for an env when its episode ends.
    """

    def __init__(self, k: int = 4):
        assert k >= 1
        self.k = k
        self._stacks: Optional[List[collections.deque]] = None

    def observation_dim(self, input_dim: int) -> int:
        return input_dim * self.k

    def _ensure(self, n: int, obs: np.ndarray) -> None:
        if self._stacks is None or len(self._stacks) != n:
            self._stacks = [
                collections.deque([obs[i]] * self.k, maxlen=self.k)
                for i in range(n)]

    def __call__(self, batch: Dict[str, Any], **ctx) -> Dict[str, Any]:
        obs = np.asarray(batch["obs"])
        n = obs.shape[0]
        self._ensure(n, obs)
        dones = ctx.get("dones")
        commit = ctx.get("commit", True)
        out = np.empty((n, obs.shape[1] * self.k), obs.dtype)
        for i in range(n):
            fresh = dones is not None and dones[i]
            if commit:
                if fresh:
                    # Fresh episode: history is just the new obs.
                    self._stacks[i] = collections.deque(
                        [obs[i]] * self.k, maxlen=self.k)
                else:
                    self._stacks[i].append(obs[i])
                frames = list(self._stacks[i])
            elif fresh:
                frames = [obs[i]] * self.k
            else:
                # Peek: view with obs appended, state untouched.
                frames = list(self._stacks[i])[1:] + [obs[i]]
            out[i] = np.concatenate(frames, axis=-1)
        return {**batch, "obs": out}

    def get_state(self) -> Dict[str, Any]:
        return {}  # per-episode state is runner-local by design


class EpsilonGreedy(ConnectorV2):
    """module_to_env: override sampled actions with uniform-random ones
    with probability epsilon (reference: the EpsilonGreedy exploration
    connector). Reads epsilon / action_space_n / rng from context so the
    schedule stays owned by the algorithm."""

    def __call__(self, batch: Dict[str, Any], **ctx) -> Dict[str, Any]:
        epsilon = float(ctx.get("epsilon", 0.0) or 0.0)
        n_actions = ctx.get("action_space_n")
        rng: Optional[np.random.Generator] = ctx.get("rng")
        if epsilon <= 0.0 or n_actions is None or "actions" not in batch:
            return batch
        if rng is None:
            rng = np.random.default_rng()
        actions = np.asarray(batch["actions"])
        override = rng.random(actions.shape[0]) < epsilon
        randoms = rng.integers(n_actions, size=actions.shape[0])
        return {**batch, "actions": np.where(override, randoms, actions)}


class RunningRewardNorm(ConnectorV2):
    """learner pipeline: scale rewards by a running standard deviation
    (reference: reward-scaling connectors / MeanStdFilter). Applied to
    the sampled batch BEFORE advantage estimation, like the reference's
    learner connector ordering."""

    def __init__(self, epsilon: float = 1e-8, clip: float = 10.0):
        self.epsilon = epsilon
        self.clip = clip
        self._count = 0.0
        self._mean = 0.0
        self._m2 = 0.0

    def _update(self, rewards: np.ndarray) -> None:
        for x in np.asarray(rewards, np.float64).ravel():
            self._count += 1.0
            delta = x - self._mean
            self._mean += delta / self._count
            self._m2 += delta * (x - self._mean)

    @property
    def std(self) -> float:
        if self._count < 2:
            return 1.0
        return float(np.sqrt(self._m2 / (self._count - 1)) + self.epsilon)

    def __call__(self, batch: Dict[str, Any], **ctx) -> Dict[str, Any]:
        if "rewards" not in batch:
            return batch
        rewards = np.asarray(batch["rewards"], np.float64)
        self._update(rewards)
        scaled = np.clip(rewards / self.std, -self.clip, self.clip)
        out = dict(batch)
        out["rewards"] = scaled.astype(np.float32)
        return out

    def get_state(self) -> Dict[str, Any]:
        return {"count": self._count, "mean": self._mean, "m2": self._m2}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._count = state.get("count", 0.0)
        self._mean = state.get("mean", 0.0)
        self._m2 = state.get("m2", 0.0)
