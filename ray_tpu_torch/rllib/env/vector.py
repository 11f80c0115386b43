"""Vectorized environments — batch N sub-envs per runner.

Reference: rllib/env/single_agent_env_runner.py:60 (env runners step
gymnasium *vector* envs, not single envs). Two layers here:

- ``VectorEnv``: generic wrapper stepping N independent sub-envs with
  gymnasium-style autoreset (a sub-env that ends is reset immediately;
  ``step`` returns the PRE-reset next_obs so bootstrapping sees the true
  terminal observation, while ``current_obs`` advances to the reset one).
- ``VectorCartPole``: natively numpy-vectorized CartPole — one
  [N, 4] state array, all dynamics as array ops. This is the
  throughput-tier path (no per-env Python loop at all).

A copy of `ray_tpu/rllib/env/vector.py`: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.env.tiny_envs import Box, Discrete


class VectorEnv:
    """N sub-envs with batched step/reset + autoreset."""

    VECTORIZED = True

    def __init__(self, make_fn: Callable[[], Any], num_envs: int,
                 seed: int = 0, first_env: Optional[Any] = None):
        self.envs = ([first_env] if first_env is not None else []) + \
            [make_fn() for _ in range(num_envs -
                                      (1 if first_env is not None else 0))]
        self.num_envs = num_envs
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._seed = seed
        self._obs: Optional[np.ndarray] = None

    def reset(self, *, seed: Optional[int] = None) -> Tuple[np.ndarray,
                                                            dict]:
        base = self._seed if seed is None else seed
        obs = [e.reset(seed=base + i)[0]
               for i, e in enumerate(self.envs)]
        self._obs = np.stack(obs)
        return self._obs, {}

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
        """Returns (next_obs_pre_reset, rewards, terminateds, truncateds);
        ended sub-envs are autoreset and current_obs reflects that."""
        next_obs: List[np.ndarray] = []
        cur_obs: List[np.ndarray] = []
        rewards = np.zeros(self.num_envs, np.float32)
        terms = np.zeros(self.num_envs, bool)
        truncs = np.zeros(self.num_envs, bool)
        for i, env in enumerate(self.envs):
            o, r, te, tr, _ = env.step(actions[i])
            next_obs.append(o)
            rewards[i] = r
            terms[i] = te
            truncs[i] = tr
            cur_obs.append(env.reset()[0] if (te or tr) else o)
        self._obs = np.stack(cur_obs)
        return np.stack(next_obs), rewards, terms, truncs

    @property
    def current_obs(self) -> np.ndarray:
        return self._obs


class VectorCartPole:
    """Numpy-vectorized CartPole: all N poles advance in one array op
    (dynamics identical to tiny_envs.CartPole / gymnasium CartPole-v1)."""

    VECTORIZED = True
    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    observation_space = Box(-np.inf, np.inf, (4,))
    action_space = Discrete(2)

    def __init__(self, num_envs: int, seed: int = 0,
                 config: Optional[dict] = None):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), np.float32)
        self._steps = np.zeros(num_envs, np.int64)

    def reset(self, *, seed: Optional[int] = None) -> Tuple[np.ndarray,
                                                            dict]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(
            -0.05, 0.05, (self.num_envs, 4)).astype(np.float32)
        self._steps[:] = 0
        return self._state.copy(), {}

    def _reset_rows(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if n:
            self._state[mask] = self._rng.uniform(
                -0.05, 0.05, (n, 4)).astype(np.float32)
            self._steps[mask] = 0

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
        a = np.asarray(actions)
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(a == 1, self.FORCE_MAG, -self.FORCE_MAG)
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        temp = (force + pole_ml * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN *
            (4.0 / 3.0 - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * x_acc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * theta_acc
        self._state = np.stack([x, x_dot, theta, theta_dot],
                               axis=1).astype(np.float32)
        self._steps += 1
        terms = (np.abs(x) > self.X_LIMIT) | \
            (np.abs(theta) > self.THETA_LIMIT)
        truncs = (~terms) & (self._steps >= self.MAX_STEPS)
        rewards = np.ones(self.num_envs, np.float32)
        next_obs = self._state.copy()
        self._reset_rows(terms | truncs)
        return next_obs, rewards, terms, truncs

    @property
    def current_obs(self) -> np.ndarray:
        return self._state.copy()


def make_vector_env(env: object, env_config: Optional[dict],
                    num_envs: int, seed: int = 0):
    """Vectorized env factory: natively-vectorized fast path when the
    name resolves to the BUILT-IN CartPole (a user registration of the
    same name takes precedence and gets the generic wrapper), generic
    VectorEnv wrapper otherwise."""
    from ray_tpu_torch.rllib.env.registry import _REGISTRY, make_env

    if num_envs > 1 and isinstance(env, str) and \
            env.lower() in ("cartpole", "cartpole-v1") and \
            env not in _REGISTRY:
        return VectorCartPole(num_envs, seed=seed, config=env_config)
    probe = make_env(env, env_config)
    if getattr(probe, "VECTORIZED", False):
        return probe
    # The probe becomes sub-env 0 — expensive envs build exactly N times.
    return VectorEnv(lambda: make_env(env, env_config), num_envs,
                     seed=seed, first_env=probe)
