"""Built-in numpy environments (no external gym dependency).

The reference leans on gymnasium for its test envs; this framework ships
tiny in-repo versions with the gymnasium step/reset API so RL tests run
anywhere. External gymnasium envs plug in through the same registry
(see registry.py).

A copy of `ray_tpu/rllib/env/tiny_envs.py`: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class Box:
    """Minimal space descriptor (continuous)."""

    def __init__(self, low, high, shape, dtype=np.float32):
        self.low = low
        self.high = high
        self.shape = tuple(shape)
        self.dtype = dtype


class Discrete:
    """Minimal space descriptor (categorical actions)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64


class CartPole:
    """Classic cart-pole balance task (dynamics per Barto-Sutton-Anderson,
    matching gymnasium's CartPole-v1: 500-step limit, +1 reward/step)."""

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

    def __init__(self, config: Optional[dict] = None):
        self._rng = np.random.default_rng(0)
        self._state = np.zeros(4, np.float32)
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[np.ndarray, Dict[str, Any]]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self._steps = 0
        return self._state.copy(), {}

    def step(self, action: int
             ) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
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
        self._state = np.array([x, x_dot, theta, theta_dot], np.float32)
        self._steps += 1
        terminated = bool(abs(x) > self.X_LIMIT or
                          abs(theta) > self.THETA_LIMIT)
        truncated = self._steps >= self.MAX_STEPS
        return self._state.copy(), 1.0, terminated, truncated, {}


class Pendulum:
    """Classic underactuated pendulum swing-up (dynamics and reward match
    gymnasium's Pendulum-v1: obs [cos th, sin th, thdot], torque in
    [-2, 2], reward -(th^2 + 0.1 thdot^2 + 0.001 u^2), 200-step episodes).
    The canonical continuous-control test task (for SAC)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    observation_space = Box(-np.inf, np.inf, (3,))
    action_space = Box(-MAX_TORQUE, MAX_TORQUE, (1,))

    def __init__(self, config: Optional[dict] = None):
        self._rng = np.random.default_rng(0)
        self._th = 0.0
        self._thdot = 0.0
        self._steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([np.cos(self._th), np.sin(self._th),
                         self._thdot], np.float32)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = self._rng.uniform(-np.pi, np.pi)
        self._thdot = self._rng.uniform(-1.0, 1.0)
        self._steps = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th_norm = ((self._th + np.pi) % (2 * np.pi)) - np.pi
        cost = th_norm ** 2 + 0.1 * self._thdot ** 2 + 0.001 * u ** 2
        thdot = self._thdot + (
            3 * self.G / (2 * self.L) * np.sin(self._th) +
            3.0 / (self.M * self.L ** 2) * u) * self.DT
        self._thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        self._th = self._th + self._thdot * self.DT
        self._steps += 1
        truncated = self._steps >= self.MAX_STEPS
        return self._obs(), -float(cost), False, truncated, {}


class GridWorld:
    """N×N grid; start top-left, goal bottom-right; -0.01/step, -0.05 for
    bumping a wall, +1 at the goal.

    Observation is the one-hot cell index; actions: 0=up 1=right 2=down
    3=left. The wall penalty breaks the Q-value tie between a no-op bump
    and progress, so the greedy policy is unambiguous under function
    approximation. Useful for DQN tests (tabular-ish, fast convergence).
    """

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.n = int(config.get("size", 4))
        self.max_steps = int(config.get("max_steps", 4 * self.n * self.n))
        self.observation_space = Box(0.0, 1.0, (self.n * self.n,))
        self.action_space = Discrete(4)
        self._pos = 0
        self._steps = 0
        self._rng = np.random.default_rng(0)

    def _obs(self) -> np.ndarray:
        obs = np.zeros(self.n * self.n, np.float32)
        obs[self._pos] = 1.0
        return obs

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = 0
        self._steps = 0
        return self._obs(), {}

    def step(self, action: int):
        prev = self._pos
        row, col = divmod(self._pos, self.n)
        if action == 0:
            row = max(0, row - 1)
        elif action == 1:
            col = min(self.n - 1, col + 1)
        elif action == 2:
            row = min(self.n - 1, row + 1)
        elif action == 3:
            col = max(0, col - 1)
        self._pos = row * self.n + col
        self._steps += 1
        at_goal = self._pos == self.n * self.n - 1
        if at_goal:
            reward = 1.0
        elif self._pos == prev:
            reward = -0.05
        else:
            reward = -0.01
        truncated = self._steps >= self.max_steps
        return self._obs(), reward, at_goal, truncated, {}
