"""Environment registry.

Reference: ray.tune.registry.register_env (used by RLlib configs to map a
string env id to a creator). Built-ins resolve first; unknown ids fall
back to gymnasium when it is importable.

A copy of `ray_tpu/rllib/env/registry.py`: the port imports nothing of
`ray_tpu`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}


def register_env(name: str, creator: Callable) -> None:
    _REGISTRY[name] = creator


def _builtin(name: str) -> Optional[Callable]:
    from ray_tpu_torch.rllib.env.multi_agent_env import TwoAgentGrid
    from ray_tpu_torch.rllib.env.tiny_envs import CartPole, GridWorld, Pendulum

    table = {
        "CartPole-v1": CartPole,
        "CartPole": CartPole,
        "GridWorld-v0": GridWorld,
        "GridWorld": GridWorld,
        "Pendulum-v1": Pendulum,
        "Pendulum": Pendulum,
        "TwoAgentGrid": TwoAgentGrid,
    }
    return table.get(name)


def make_env(env: object, env_config: Optional[dict] = None):
    """Instantiate an env from an id string, creator callable, or class."""
    env_config = env_config or {}
    if callable(env):
        return env(env_config)
    if isinstance(env, str):
        creator = _REGISTRY.get(env) or _builtin(env)
        if creator is not None:
            return creator(env_config)
        try:
            import gymnasium

            return gymnasium.make(env, **env_config)
        except Exception:
            raise ValueError(
                f"unknown env id {env!r}: not registered, not a built-in, "
                "and gymnasium could not create it")
    raise TypeError(f"env must be a str id or callable, got {type(env)}")
