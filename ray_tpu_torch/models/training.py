"""Train-step builder on one card.

Port of `ray_tpu/models/training.py:make_sharded_train_step` for a
single device: the step is the loss, its gradients by autograd, the
global gradient norm and one optimizer update. The JAX builder's
``mesh``, ``param_specs``, batch sharding and the data/fully-sharded
parallel forms (DDP, FSDP over NCCL) wait for tensor parallelism and
sharded training (ROADMAP A9, A11b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from ray_tpu_torch.models.llama import resolve_device

Pytree = Any


def _leaves(tree: Pytree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order (JAX's
    `tree_leaves` order for dicts)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [tree]


def _tree_map(fn, tree: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """`optax.adamw` with optax's defaults (weight decay 1e-4, not
    torch's 1e-2), applied by `torch.optim.AdamW` over all leaves in one
    group. The two compute the same update: bias-corrected moments,
    ``eps`` added outside the square root, decay ``lr * wd * p`` taken
    from the parameter before the step."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: Pytree) -> torch.optim.Optimizer:
        return torch.optim.AdamW(
            _leaves(params), lr=self.learning_rate, betas=(self.b1, self.b2),
            eps=self.eps, weight_decay=self.weight_decay)

    @staticmethod
    def update(opt_state: torch.optim.Optimizer,
               leaves: List[torch.Tensor],
               grads: Tuple[torch.Tensor, ...]) -> None:
        """Apply one step to ``leaves`` in place."""
        for p, g in zip(leaves, grads):
            p.grad = g
        opt_state.step()
        for p in leaves:
            p.grad = None


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """`optax.adamw(learning_rate, b1, b2, eps, weight_decay=...)`."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


def make_train_step(
    loss_fn: Callable[[Pytree, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: AdamW,
    *,
    device="cuda",
):
    """Returns (init_fn, step_fn).

    init_fn(params) -> (params, opt_state): the param tree's leaves on
    ``device`` as autograd leaves (sharing storage with the tensors given
    when those already lie there), and the optimizer's state.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics),
    with metrics ``{"loss", "grad_norm"}`` as 0-d device tensors (no host
    sync); ``grad_norm`` is `optax.global_norm` of the gradients, taken
    before the update. The step updates params and opt_state IN PLACE and
    returns the same objects: the counterpart of the JAX step's buffer
    donation, so the caller must not keep using a pre-step copy.
    """
    device = resolve_device(device)

    def init_fn(params: Pytree):
        params = _tree_map(
            lambda p: p.detach().to(device).requires_grad_(True), params)
        return params, optimizer.init(params)

    def step_fn(params: Pytree, opt_state, batch: Dict[str, Any]):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        leaves = _leaves(params)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        grad_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        optimizer.update(opt_state, leaves, grads)
        return params, opt_state, {"loss": loss.detach(),
                                   "grad_norm": grad_norm}

    return init_fn, step_fn
