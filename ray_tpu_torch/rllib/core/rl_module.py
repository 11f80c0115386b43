"""RLModule — the neural-network component of an algorithm, in PyTorch.

Port of `ray_tpu/rllib/core/rl_module.py`. Each module is an
``nn.Module`` whose parameters mirror the JAX package's params pytree
name for name: ``{"torso": [{"w", "b"}, ...], "pi": [...], "vf": [...]}``
with ``w`` stored ``[fan_in, fan_out]`` and applied as ``x @ w + b``, so
weights cross between the packages as numpy trees in JAX's layout
(`params_to_numpy` / `params_from_numpy`), and the flat vector of
`ravel_tree` follows JAX's ``ravel_pytree`` leaf order (dict keys
sorted, list order kept). Initialization draws from an explicit
``torch.Generator`` (He-normal weights, zero biases, as in JAX); the
bits are not JAX's threefry bits.

Exploration samples from the caller's ``torch.Generator``: sampled
actions are held to their distributions, deterministic outputs
(`forward_train`, `forward_inference`) to the JAX modules.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import resolve_device


@dataclasses.dataclass
class RLModuleSpec:
    """Builds an RLModule from config (reference: SingleAgentRLModuleSpec)."""

    module_class: type
    obs_dim: int = 0
    num_actions: int = 0
    model_config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self, seed: int = 0, device="cuda") -> "RLModule":
        """The module with weights drawn from a CPU generator seeded
        ``seed``, on ``device`` (the card unless the caller asks for
        the CPU), in float32."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        return self.module_class(self.obs_dim, self.num_actions,
                                 self.model_config, generator=gen
                                 ).to(device)


class RLModule(nn.Module):
    """Module over its own parameters + the three forward methods."""

    def forward_train(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Differentiable path used by the learner loss."""
        raise NotImplementedError

    def forward_exploration(self, obs: torch.Tensor,
                            generator: torch.Generator
                            ) -> Dict[str, torch.Tensor]:
        """Stochastic action selection for rollouts."""
        raise NotImplementedError

    def forward_inference(self, obs: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
        """Greedy action selection for evaluation."""
        raise NotImplementedError


class _Dense(nn.Module):
    """One JAX-layout dense layer: ``x @ w + b``, w [fan_in, fan_out]."""

    def __init__(self, fan_in: int, fan_out: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.w = nn.Parameter(torch.randn((fan_in, fan_out),
                                          generator=generator)
                              * math.sqrt(2.0 / fan_in))
        self.b = nn.Parameter(torch.zeros((fan_out,)))


def _mlp(sizes: Sequence[int],
         generator: Optional[torch.Generator]) -> nn.ModuleList:
    return nn.ModuleList([_Dense(i, o, generator)
                          for i, o in zip(sizes[:-1], sizes[1:])])


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor,
               final_activation: bool = False,
               frozen: bool = False) -> torch.Tensor:
    """The MLP on ``x``; ``frozen`` takes its weights detached (JAX's
    ``stop_gradient`` on the params: gradients reach ``x`` only)."""
    for i, layer in enumerate(layers):
        w, b = (layer.w.detach(), layer.b.detach()) if frozen \
            else (layer.w, layer.b)
        x = x @ w + b
        if i < len(layers) - 1 or final_activation:
            x = torch.tanh(x)
    return x


def frozen_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` that shares no storage with it, with
    requires_grad off: a target network outside the optimizer."""
    target = copy.deepcopy(module)
    target.requires_grad_(False)
    return target


def _bounds(cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    low = np.asarray(cfg.get("action_low", -1.0), np.float32)
    high = np.asarray(cfg.get("action_high", 1.0), np.float32)
    return (torch.from_numpy(np.asarray((high - low) / 2.0)),
            torch.from_numpy(np.asarray((high + low) / 2.0)))


class DiscreteMLPModule(RLModule):
    """MLP torso + policy-logits head + value head for discrete actions.

    The default module for PPO (analog of the reference's default
    PPOTorchRLModule built by the catalog)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 model_config: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config or {}
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(cfg.get("fcnet_hiddens", (64, 64)))
        self.torso = _mlp((obs_dim,) + self.hiddens, generator)
        self.pi = _mlp((self.hiddens[-1], num_actions), generator)
        self.vf = _mlp((self.hiddens[-1], 1), generator)

    def forward_train(self, obs):
        feat = _mlp_apply(self.torso, obs, final_activation=True)
        return {"action_dist_inputs": _mlp_apply(self.pi, feat),
                "vf_preds": _mlp_apply(self.vf, feat)[..., 0]}

    def forward_exploration(self, obs, generator):
        out = self.forward_train(obs)
        logp = F.log_softmax(out["action_dist_inputs"], dim=-1)
        flat = logp.reshape(-1, logp.shape[-1]).exp()
        action = torch.multinomial(flat, 1, generator=generator
                                   ).reshape(logp.shape[:-1])
        action_logp = torch.gather(logp, -1, action[..., None])[..., 0]
        return {"actions": action, "action_logp": action_logp,
                "vf_preds": out["vf_preds"]}

    def forward_inference(self, obs):
        out = self.forward_train(obs)
        return {"actions": torch.argmax(out["action_dist_inputs"], dim=-1)}


class QNetModule(RLModule):
    """MLP Q-network for DQN (analog of the reference's DQN RLModule)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 model_config: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config or {}
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(cfg.get("fcnet_hiddens", (64, 64)))
        self.q = _mlp((obs_dim,) + self.hiddens + (num_actions,), generator)

    def forward_train(self, obs):
        return {"q_values": _mlp_apply(self.q, obs)}

    def forward_exploration(self, obs, generator):
        # Epsilon handling lives in the env runner (needs the schedule).
        q = self.forward_train(obs)["q_values"]
        return {"actions": torch.argmax(q, dim=-1), "q_values": q}

    def forward_inference(self, obs):
        q = self.forward_train(obs)["q_values"]
        return {"actions": torch.argmax(q, dim=-1)}


class SACModule(RLModule):
    """Squashed-Gaussian actor + twin Q critics for continuous control.

    Reference: rllib/algorithms/sac/ (policy net emitting (mu, log_std),
    tanh squashing onto the action bounds, two independent Q networks
    over (obs, action)). num_actions is the ACTION DIM here;
    model_config carries action_low/action_high bounds."""

    LOG_STD_MIN = -20.0
    LOG_STD_MAX = 2.0

    def __init__(self, obs_dim: int, num_actions: int,
                 model_config: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config or {}
        self.obs_dim = obs_dim
        self.act_dim = num_actions
        self.hiddens = tuple(cfg.get("fcnet_hiddens", (64, 64)))
        scale, center = _bounds(cfg)
        self.register_buffer("action_scale", scale, persistent=False)
        self.register_buffer("action_center", center, persistent=False)
        q_sizes = (obs_dim + num_actions,) + self.hiddens + (1,)
        self.pi = _mlp((obs_dim,) + self.hiddens + (2 * num_actions,),
                       generator)
        self.q1 = _mlp(q_sizes, generator)
        self.q2 = _mlp(q_sizes, generator)
        # log entropy temperature, auto-tuned by the learner.
        self.log_alpha = nn.Parameter(torch.zeros(()))

    def pi_dist(self, obs):
        mu, log_std = torch.chunk(_mlp_apply(self.pi, obs), 2, dim=-1)
        return mu, torch.clamp(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)

    def sample_action(self, obs, generator=None, eps=None):
        """Reparameterized tanh-squashed sample + its log-prob. ``eps``
        is the standard normal draw (a learner passes its `noise`);
        without it one is drawn from ``generator``."""
        mu, log_std = self.pi_dist(obs)
        std = torch.exp(log_std)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device)
        tanh_a = torch.tanh(mu + std * eps)
        # Gaussian logp with tanh change-of-variables correction.
        gauss_logp = (-0.5 * (eps ** 2 + 2 * log_std
                              + math.log(2 * math.pi))).sum(-1)
        correction = torch.log(1.0 - tanh_a ** 2 + 1e-6).sum(-1)
        action = tanh_a * self.action_scale + self.action_center
        return action, gauss_logp - correction

    def q_values(self, obs, action, frozen=False):
        """Both critics; ``frozen`` detaches their weights (a loss that
        trains the actor through them)."""
        x = torch.cat([obs, action], dim=-1)
        return (_mlp_apply(self.q1, x, frozen=frozen)[..., 0],
                _mlp_apply(self.q2, x, frozen=frozen)[..., 0])

    def forward_train(self, obs):
        mu, log_std = self.pi_dist(obs)
        return {"mu": mu, "log_std": log_std}

    def forward_exploration(self, obs, generator):
        action, logp = self.sample_action(obs, generator)
        return {"actions": action, "action_logp": logp}

    def forward_inference(self, obs):
        mu, _ = self.pi_dist(obs)
        return {"actions": torch.tanh(mu) * self.action_scale
                + self.action_center}


class DDPGModule(RLModule):
    """Deterministic tanh actor + twin Q critics (DDPG/TD3).

    Twin critics are always present in the params; DDPG uses q1 only,
    TD3 takes the min. Exploration = Gaussian action noise scaled by
    `exploration_noise` (fraction of the action half-range)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 model_config: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = model_config or {}
        self.obs_dim = obs_dim
        self.act_dim = num_actions
        self.hiddens = tuple(cfg.get("fcnet_hiddens", (64, 64)))
        scale, center = _bounds(cfg)
        self.register_buffer("action_scale", scale, persistent=False)
        self.register_buffer("action_center", center, persistent=False)
        self.exploration_noise = float(cfg.get("exploration_noise", 0.1))
        q_sizes = (obs_dim + num_actions,) + self.hiddens + (1,)
        self.pi = _mlp((obs_dim,) + self.hiddens + (num_actions,),
                       generator)
        self.q1 = _mlp(q_sizes, generator)
        self.q2 = _mlp(q_sizes, generator)

    def action(self, obs):
        """Deterministic policy action, squashed onto the bounds."""
        return (torch.tanh(_mlp_apply(self.pi, obs)) * self.action_scale
                + self.action_center)

    def q_values(self, obs, action, frozen=False):
        """Both critics; ``frozen`` detaches their weights (a loss that
        trains the actor through them)."""
        x = torch.cat([obs, action], dim=-1)
        return (_mlp_apply(self.q1, x, frozen=frozen)[..., 0],
                _mlp_apply(self.q2, x, frozen=frozen)[..., 0])

    def forward_train(self, obs):
        return {"actions": self.action(obs)}

    def forward_exploration(self, obs, generator):
        a = self.action(obs)
        noise = torch.randn(a.shape, generator=generator, device=a.device) \
            * self.exploration_noise * self.action_scale
        low = self.action_center - self.action_scale
        high = self.action_center + self.action_scale
        return {"actions": torch.clamp(a + noise, low, high)}

    def forward_inference(self, obs):
        return {"actions": self.action(obs)}


# ---------------------------------------------------------------------------
# Weights as numpy trees in JAX's layout, and JAX's ravel order
# ---------------------------------------------------------------------------

def _path(name: str) -> Tuple[Any, ...]:
    """``"torso.0.w"`` -> ``("torso", 0, "w")``: a parameter's path in
    the JAX tree (ModuleList indices are list positions)."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def tree_paths(module: nn.Module) -> List[Tuple[Tuple[Any, ...],
                                               nn.Parameter]]:
    """(path, parameter) pairs in ``ravel_pytree``'s leaf order: dict
    keys sorted, list positions in order (siblings are all keys or all
    positions, so sorting the paths is that order)."""
    return sorted(((_path(n), p) for n, p in module.named_parameters()),
                  key=lambda item: item[0])


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nest(pairs: List[Tuple[Tuple[Any, ...], Any]]):
    """Rebuild a JAX-layout tree (dicts, and lists where the keys are
    positions) from (path, leaf) pairs."""
    root: Dict[Any, Any] = {}
    for path, leaf in pairs:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[i]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def params_to_numpy(module: nn.Module):
    """The module's weights as a numpy tree in JAX's layout (for
    shipping weights to env runners, or to the JAX package)."""
    return _nest([(path, p.detach().cpu().numpy().copy())
                  for path, p in tree_paths(module)])


def params_from_numpy(module: nn.Module, tree) -> nn.Module:
    """Copy a numpy (or torch) tree in JAX's layout into the module's
    parameters, in place; shapes must match. Returns the module."""
    with torch.no_grad():
        for path, p in tree_paths(module):
            x = torch.from_numpy(np.array(_leaf(tree, path), np.float32))
            if tuple(x.shape) != tuple(p.shape):
                raise ValueError(f"{'.'.join(map(str, path))}: shape "
                                 f"{tuple(x.shape)} != {tuple(p.shape)}")
            p.copy_(x)
    return module


def tree_leaves(tree) -> List[Any]:
    """A JAX-layout tree's leaves in ``ravel_pytree``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def ravel_tree(tree) -> Tuple[np.ndarray, Callable[[np.ndarray], Any]]:
    """numpy ``ravel_pytree``: the f32 flat vector of a JAX-layout tree
    and the function that rebuilds a tree of its structure from one."""
    leaves = [np.asarray(x, np.float32) for x in tree_leaves(tree)]
    flat = (np.concatenate([x.ravel() for x in leaves]) if leaves
            else np.zeros((0,), np.float32))

    def unravel(vec: np.ndarray):
        vec = np.asarray(vec, np.float32)
        out, o = [], 0
        for x in leaves:
            out.append(vec[o:o + x.size].reshape(x.shape))
            o += x.size
        return _rebuild(tree, iter(out))

    return flat, unravel


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)
