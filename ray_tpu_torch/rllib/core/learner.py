"""TorchLearner — computes losses and applies updates.

Port of `ray_tpu/rllib/core/learner.py` (``JaxLearner``). The module's
parameters live on the learner's device (``"cuda"`` unless the caller
passes ``device="cpu"``); a step is the loss, its gradients by
autograd, and exactly optax's ``chain(clip_by_global_norm(c),
adam(lr))`` written out on the parameter list (`Adam`, which the
algorithms with their own modules use too):

- clipping scales every gradient by ``(g / norm) * c`` only when the
  global norm is ``>= c`` (``torch.nn.utils.clip_grad_norm_`` divides
  by ``norm + 1e-6`` and is not used);
- Adam (b1 0.9, b2 0.999) with bias correction in float32 and ``eps =
  1e-8`` outside the square root; the update ``-lr * m_hat / (sqrt(
  v_hat) + eps)`` is added to the parameter.

Subclasses implement ``loss_fn(batch, generator) -> (loss, metrics)``
over the module's own parameters (JAX's ``loss_fn(params, batch, rng)``
with the params bound). A parameter the loss does not reach gets a zero
gradient, as ``jax.grad`` gives it. Every random draw a loss makes goes
through `TorchLearner.noise`: the learner's device generator by
default, or a source installed with `set_noise` that returns given
arrays (JAX's threefry bits cannot be reproduced, so tests feed the JAX
loss's own draws through it).

``update_ddp`` is the data-parallel step: local gradients flattened in
``ravel_pytree``'s order, averaged with one all-reduce over a
``torch.distributed`` group (gloo on the CPU, NCCL on the card; it takes
the place of ``ray_tpu.collective``), then the same apply on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.rllib._unported import unported
from ray_tpu_torch.rllib.core.rl_module import (RLModule, RLModuleSpec,
                                                _leaf, _nest,
                                                params_from_numpy,
                                                params_to_numpy, tree_paths)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def to_tensors(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """A numpy column batch on ``device``: float64 columns (a runner's
    rewards) become float32, as ``jnp.asarray`` makes them without x64;
    other dtypes are kept."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = torch.as_tensor(v.astype(np.float32) if v.dtype == np.float64
                                 else v, device=device)
    return out


def _tensor(x, device) -> torch.Tensor:
    x = x if torch.is_tensor(x) else torch.as_tensor(np.array(x))
    return x.to(device=device, dtype=torch.float32)


def scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Metrics to host values in one transfer: scalars become floats,
    vector metrics (per-sample TD errors) numpy arrays."""
    keys = [k for k, v in metrics.items() if v.dim() == 0]
    out: Dict[str, Any] = {}
    if keys:
        vals = torch.stack([metrics[k].detach().float() for k in keys])
        out.update(zip(keys, vals.cpu().tolist()))
    for k, v in metrics.items():
        if v.dim():
            out[k] = v.detach().cpu().numpy()
    return {k: out[k] for k in metrics}


class Adam:
    """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))``
    (``adam(lr)`` alone when ``grad_clip`` is None) and ``params +
    updates``, in place, over a module's parameters in JAX's leaf order;
    its state crosses as numpy trees in JAX's layout (``{"count", "mu",
    "nu"}``)."""

    def __init__(self, module: torch.nn.Module, lr: float, grad_clip=None):
        pairs = tree_paths(module)
        self.paths = [path for path, _ in pairs]
        self.params: List[torch.nn.Parameter] = [p for _, p in pairs]
        self.lr, self.grad_clip = float(lr), grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def reset(self) -> None:
        self.count = 0
        with torch.no_grad():
            for m, v in zip(self.mu, self.nu):
                m.zero_()
                v.zero_()

    def step(self, grads: List[torch.Tensor]) -> None:
        with torch.no_grad():
            if self.grad_clip is not None:
                c = self.grad_clip
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                keep = norm < c
                grads = [torch.where(keep, g, (g / norm) * c) for g in grads]
            self.count += 1
            # optax computes decay ** count in float32
            bc1 = float(np.float32(1) - np.float32(ADAM_B1)
                        ** np.float32(self.count))
            bc2 = float(np.float32(1) - np.float32(ADAM_B2)
                        ** np.float32(self.count))
            for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
                m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
                v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v)
                step = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
                p.copy_(p + (-self.lr) * step)

    def state(self) -> Dict[str, Any]:
        def tree(xs):
            return _nest([(path, x.detach().cpu().numpy().copy())
                          for path, x in zip(self.paths, xs)])

        return {"count": self.count, "mu": tree(self.mu), "nu": tree(self.nu)}

    def load(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for path, m, v in zip(self.paths, self.mu, self.nu):
                m.copy_(_tensor(_leaf(state["mu"], path), m.device))
                v.copy_(_tensor(_leaf(state["nu"], path), v.device))


class NoiseSeam:
    """The random draws of a loss. A class using it sets ``device``,
    ``_gen`` (a generator on that device) and ``_noise = None``."""

    def noise(self, name: str, shape, kind: str = "normal"
              ) -> torch.Tensor:
        """One random draw of a loss: ``kind`` "normal" (standard),
        "uniform" (in [0, 1)) or "gumbel" (standard Gumbel, ``-log(-log
        u)`` with u uniform in [tiny, 1), as ``jax.random.gumbel``), f32
        on the learner's device. ``name`` says which draw of the loss it
        is, for an installed source."""
        shape = tuple(int(n) for n in shape)
        if self._noise is not None:
            x = _tensor(self._noise(name, shape, kind), self.device)
            if tuple(x.shape) != shape:
                raise ValueError(f"noise {name!r}: shape {tuple(x.shape)} "
                                 f"!= {shape}")
            return x
        if kind == "normal":
            return torch.randn(shape, generator=self._gen,
                               device=self.device)
        u = torch.rand(shape, generator=self._gen, device=self.device)
        if kind == "uniform":
            return u
        if kind == "gumbel":
            return -torch.log(-torch.log(
                u.clamp_min(torch.finfo(torch.float32).tiny)))
        raise ValueError(f"unknown noise kind {kind!r}")

    def set_noise(self, source) -> None:
        """Install ``source(name, shape, kind) -> array`` in place of the
        generator (None restores it)."""
        self._noise = source


class TorchLearner(NoiseSeam):
    """Base learner; subclasses implement loss_fn."""

    def __init__(self, module_spec: RLModuleSpec, config: dict,
                 device=None):
        if int(config.get("num_devices_per_learner", 1)) > 1:
            raise unported("num_devices_per_learner > 1 (a dp mesh inside "
                           "one learner; update_ddp runs over a process "
                           "group)")
        self.config = config
        self.device = resolve_device(device if device is not None
                                     else config.get("device", "cuda"))
        seed = int(config.get("seed", 0))
        self.module: RLModule = module_spec.build(seed=seed,
                                                  device=self.device)
        self.lr = float(config.get("lr", 3e-4))
        self.grad_clip = float(config.get("grad_clip", 10.0))
        self.opt = Adam(self.module, self.lr, self.grad_clip)
        self._paths, self.params = self.opt.paths, self.opt.params
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._noise = None

    # ---- subclass hook ----

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (scalar loss, metrics dict of tensors)."""
        raise NotImplementedError

    # ---- update paths ----

    def _grads(self, batch: Dict[str, Any]
               ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        loss, metrics = self.loss_fn(to_tensors(batch, self.device),
                                     self._gen)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True,
                                    materialize_grads=True)
        metrics = dict(metrics)
        metrics["total_loss"] = loss
        return list(grads), metrics

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One SGD step on the full batch."""
        grads, metrics = self._grads(batch)
        self.opt.step(grads)
        return scalars(metrics)

    # ---- distributed-data-parallel over a process group ----

    def compute_gradients(self, batch: Dict[str, np.ndarray]
                          ) -> Tuple[Any, Dict[str, float]]:
        """The gradients as a tree of tensors in JAX's layout, and the
        metrics (``total_loss`` included) as floats."""
        grads, metrics = self._grads(batch)
        return _nest(list(zip(self._paths, grads))), scalars(metrics)

    def apply_gradients(self, grads) -> None:
        """Apply a JAX-layout tree of gradients (tensors or numpy)."""
        self.opt.step([_tensor(_leaf(grads, path), self.device)
                     for path in self._paths])

    def update_ddp(self, batch_shard: Dict[str, np.ndarray],
                   group=None) -> Dict[str, float]:
        """Data-parallel update across the ranks of ``group`` (the
        default group when None): local gradients, one all-reduce of the
        flat vector in ``ravel_pytree``'s order, divided by the world
        size, then the same apply on every rank (reference semantics:
        torch_learner DDP)."""
        import torch.distributed as dist

        grads, metrics = self._grads(batch_shard)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / dist.get_world_size(group)
        out, o = [], 0
        for p in self.params:
            out.append(flat[o:o + p.numel()].view(p.shape))
            o += p.numel()
        self.opt.step(out)
        return scalars(metrics)

    # ---- state ----

    def get_weights(self):
        return params_to_numpy(self.module)

    def set_weights(self, params) -> None:
        params_from_numpy(self.module, params)
        self.opt.reset()

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.get_weights(), "opt_state": self.opt.state()}

    def set_state(self, state: Dict[str, Any]) -> None:
        params_from_numpy(self.module, state["params"])
        self.opt.load(state["opt_state"])

    def ping(self) -> bool:
        return True
