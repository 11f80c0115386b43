"""Train-step builders.

Port of `ray_tpu/models/training.py`: `batch_sharding_fn` and
`make_sharded_train_step` over a `DeviceMesh` (`ray_tpu_torch.parallel`),
and `make_train_step`, the same step on one card without a mesh. A step
is the loss, its gradients by autograd, the global gradient norm and
one AdamW update, in place (the counterpart of JAX's buffer donation).

The JAX step is one GSPMD program whose collectives XLA inserts from
the shardings. Here each rank runs the step on its rows of the global
batch, and the step runs the collectives the data axes imply:

- ``fsdp`` is ZeRO-3: params and AdamW state live as shards between
  steps; the shards are all-gathered before the forward and the
  gradients reduce-scattered back to them;
- ``dcn`` and ``dp`` replicate: their gradients are summed by an
  all-reduce (together with fsdp's over a leaf that fsdp does not split);
- ``tp`` splits the compute, not the storage: a leaf split over tp stays
  split (no all-gather before the forward, no reduce-scatter after), and
  the loss_fn runs the tp layer (`llama_loss(..., tp=tp_group(mesh))`,
  likewise `moe_loss`, `vit_loss` and `t5_loss`;
  `parallel.tensor_parallel`), whose f and g make each rank's gradient
  the one of its own shard (the MLP names no logical axis and runs
  whole on every tp rank, as GSPMD runs it). A leaf replicated over tp whose use is split
  (`wk`/`wv` under the training rules, cut to the rank's kv heads) gets
  its partial gradients summed over tp by the f at that cut. The batch
  is replicated over tp;
- ``sp`` splits the sequence: with "length" -> "sp" in
  ``batch_logical`` each rank takes its block of the sequence (a
  ``tokens`` batch is shifted into inputs and targets first, then
  split), the loss_fn runs the sp layer (`llama_loss(..., sp=
  sp_group(mesh))`: ring or Ulysses attention, or attention over the
  gathered sequence for any other ``attn_impl``; a model given no sp
  group there raises), and the loss weight,
  the mask count and the gradient all-reduce run over sp as over any
  batch axis;
- ``ep`` and ``pp`` split the model, as tp does: a leaf split over the
  expert axis (MoE's expert weights) or the stage axis (a pipeline's
  stacked stages) stays split, and the loss_fn runs the matching layer
  (`moe_loss(..., ep=tp_group(mesh, "ep"))`, whose f and g make each
  rank's gradient its own experts'; `parallel.pipeline.
  make_pipelined_fn`, whose stages hand activations on point to point).
  The batch is replicated over both.

While the loss_fn runs, the step publishes its batch split
(`parallel.data_parallel`): a model that needs a quantity over the
global batch (MoE's capacity and load-balancing means, a pad-masked
mean's count) reduces it over the batch ranks there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.parallel.data_parallel import BatchSplit, batch_split
from ray_tpu_torch.parallel.sequence_parallel import splitting

Pytree = Any

# mesh axes that split the model's compute: a leaf split over one keeps
# its shard (never all-gathered), and its gradient is the shard's
_MODEL_AXES = ("tp", "ep", "pp")


def _leaves(tree: Pytree) -> List[Any]:
    """The leaves of a nested dict, in sorted-key order (JAX's
    `tree_leaves` order for dicts)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [tree]


def _tree_map(fn, tree: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def _unflatten(tree: Pytree, leaves: List[Any]) -> Pytree:
    """``tree``'s structure with ``leaves`` (in `_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(tree)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """`optax.adamw` with optax's defaults (weight decay 1e-4, not
    torch's 1e-2), applied by `torch.optim.AdamW` over all leaves in one
    group. The two compute the same update: bias-corrected moments,
    ``eps`` added outside the square root, decay ``lr * wd * p`` taken
    from the parameter before the step. The update is elementwise, so
    a shard updates exactly as its part of the whole leaf does."""

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

    @staticmethod
    def state_tree(opt_state: torch.optim.Optimizer,
                   params: Pytree) -> Pytree:
        """The optimizer state as a tree ``{"exp_avg", "exp_avg_sq",
        "step"}``, each shaped as ``params`` (``step`` 0-d f32), for
        `train.array_checkpoint`. The tensors are the live state, not
        copies; before the first step they are zeros."""
        def get(p, key):
            st = opt_state.state.get(p)
            if st:
                return st[key]
            return (torch.zeros((), dtype=torch.float32) if key == "step"
                    else torch.zeros_like(p.detach()))

        return {key: _tree_map(lambda p, k=key: get(p, k), params)
                for key in ("exp_avg", "exp_avg_sq", "step")}

    @staticmethod
    def load_state_tree(opt_state: torch.optim.Optimizer, params: Pytree,
                        tree: Pytree) -> None:
        """Set ``opt_state``'s state for ``params`` from a `state_tree`
        (copies; moments on each param's device, ``step`` a 0-d f32 CPU
        tensor as torch keeps it)."""
        for key in ("exp_avg", "exp_avg_sq", "step"):
            for p, x in zip(_leaves(params), _leaves(tree[key])):
                st = opt_state.state[p]
                if key == "step":
                    st[key] = torch.as_tensor(x).detach().to(
                        "cpu", torch.float32).clone()
                else:
                    st[key] = torch.as_tensor(x).detach().to(
                        p.device, p.dtype).clone()

    @staticmethod
    def state_specs(param_specs: Pytree) -> Pytree:
        """Partition specs of `state_tree`: the moments as their params,
        the step counts replicated."""
        return {"exp_avg": param_specs, "exp_avg_sq": param_specs,
                "step": _tree_map(lambda _: (), param_specs)}


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """`optax.adamw(learning_rate, b1, b2, eps, weight_decay=...)`."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


class _OneCard:
    """The step's parallel part on one card with no mesh: nothing."""

    sp = 1          # the sp ranks the sequence is split over

    def __init__(self, device: torch.device):
        self.device = device

    def local_batch(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's part of each leaf of the global batch."""
        return {k: self.local_batch(v) for k, v in batch.items()}

    def gather(self, leaves):
        return leaves

    def weight(self, batch, count=None):
        return None

    def batch_view(self) -> BatchSplit:
        """The batch split the loss_fn sees (`parallel.data_parallel`)."""
        return BatchSplit(None, 0, 1)

    def reduce(self, grads):
        return grads

    def reduce_replicated(self, grads):
        """Gradients of leaves replicated on every rank (LoRA adapters),
        summed over the batch axes."""
        return grads

    def grad_norm(self, grads) -> torch.Tensor:
        return torch.nn.utils.get_total_norm(grads, norm_type=2.0)

    def total(self, loss: torch.Tensor) -> torch.Tensor:
        return loss


def _step(loss_fn, optimizer: AdamW, params: Pytree, opt_state,
          batch: Dict[str, Any], plan: _OneCard):
    """One step of either builder: ``plan`` supplies the collectives."""
    batch = plan.batch(batch)
    leaves = _leaves(params)
    full = plan.gather(leaves)
    with splitting(plan.sp), batch_split(plan.batch_view()) as split:
        loss = loss_fn(_unflatten(params, full), batch)
    weight = plan.weight(batch, split.count)
    if weight is not None:
        loss = loss * weight
    grads = plan.reduce(torch.autograd.grad(loss, full))
    grad_norm = plan.grad_norm(grads)
    optimizer.update(opt_state, leaves, grads)
    return params, opt_state, {"loss": plan.total(loss.detach()),
                               "grad_norm": grad_norm}


def make_train_step(
    loss_fn: Callable[[Pytree, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: AdamW,
    *,
    device="cuda",
):
    """Returns (init_fn, step_fn) on one card.

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
    plan = _OneCard(resolve_device(device))

    def init_fn(params: Pytree):
        params = _tree_map(
            lambda p: p.detach().to(plan.device).requires_grad_(True),
            params)
        return params, optimizer.init(params)

    def step_fn(params: Pytree, opt_state, batch: Dict[str, Any]):
        return _step(loss_fn, optimizer, params, opt_state, batch, plan)

    return init_fn, step_fn


def batch_sharding_fn(mesh, batch_logical: Tuple[Optional[str], ...],
                      rules=None):
    """Rank-adaptive batch-leaf sharding: batch_logical is truncated /
    None-padded to each leaf's rank (labels are rank-1, tokens rank-2,
    images rank-4 — all shard their leading batch axis, trailing axes
    replicate unless batch_logical names them). Returns ``shard_for(x)``,
    this rank's region of a global batch leaf on the mesh's device."""
    from ray_tpu_torch.parallel.sharding import logical_to_mesh, shard_tensor

    def shard_for(x) -> torch.Tensor:
        x = torch.as_tensor(x)
        logical = tuple(batch_logical[:x.ndim]) + \
            (None,) * max(0, x.ndim - len(batch_logical))
        return shard_tensor(x, logical_to_mesh(logical, rules), mesh)

    return shard_for


def _moved(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


class _Mesh(_OneCard):
    """The step's collectives on one rank of ``mesh``.

    Each leaf is split along the mesh axes of size > 1 that its spec
    names (``self.split[i]``: (dim, axes) pairs; ``self.leaf_axes[i]``
    all of them). The batch is split over the axes its spec names
    (``self.batch_axes``, any size, so that the gradient all-reduce runs
    even in a world of one rank). The model axes (tp, ep, pp) are never
    gathered: such a shard is what the rank computes with, and its
    gradient is the shard's."""

    def __init__(self, mesh, param_specs, batch_logical, rules):
        from ray_tpu_torch.parallel.sharding import (logical_to_mesh,
                                                     mesh_axis_sizes,
                                                     mesh_device, spec_axes)

        self.mesh = mesh
        self.sizes = mesh_axis_sizes(mesh)
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        super().__init__(mesh_device(mesh))
        self.local_batch = batch_sharding_fn(mesh, batch_logical, rules)
        batch_spec = logical_to_mesh(tuple(batch_logical), rules)
        self.batch_axes = tuple(a for e in batch_spec for a in spec_axes(e))
        self.sp = sp = self.sizes.get("sp", 1)
        self.sp_dim = next((d for d, e in enumerate(batch_spec)
                            if "sp" in spec_axes(e)), None)
        if sp > 1 and self.sp_dim is None:
            raise ValueError(
                f"a mesh with sp={sp} needs the batch's sequence dimension "
                "split over it: batch_logical=(\"batch\", \"length\")")
        self.split = [
            [(dim, tuple(a for a in spec_axes(e) if self.sizes[a] > 1))
             for dim, e in enumerate(spec)
             if any(self.sizes[a] > 1 for a in spec_axes(e))]
            for spec in _leaves(param_specs)]
        for split in self.split:
            for _, axes in split:
                if set(axes) & set(_MODEL_AXES) and len(axes) > 1:
                    raise NotImplementedError(
                        f"a dimension split over {axes}: a model axis "
                        "shares a dimension with another axis")
        self.leaf_axes = [
            tuple(a for a in mesh.mesh_dim_names
                  if any(a in axes for _, axes in split))
            for split in self.split]
        # every group the step uses, made now in one order on every rank
        self._groups = {}
        for axes in [self.batch_axes] + [
                g for leaf in self.leaf_axes
                for g in (self._unsplit(leaf), leaf)]:
            self._group(axes)
        # this rank's rows are the batch_rank-th block of the global
        # batch: the batch axes' coordinates, the first the most major
        self.batch_rank = 0
        for a in self.batch_axes:
            self.batch_rank = self.batch_rank * self.sizes[a] + self.coord[a]
        self.batch_ranks = math.prod(self.sizes[a] for a in self.batch_axes)

    def batch(self, batch):
        """This rank's region of each leaf. When sp splits the
        sequence, a ``tokens`` leaf is shifted into inputs and targets
        before the split, so that no block loses its last target to the
        shift; the sequence must split evenly over sp."""
        sp = self.sp
        if sp > 1:
            batch = dict(batch)
            if "tokens" in batch:
                tokens = torch.as_tensor(batch.pop("tokens"))
                batch.update(inputs=tokens[:, :-1], targets=tokens[:, 1:])
            for k, v in batch.items():
                shape = torch.as_tensor(v).shape
                if len(shape) > self.sp_dim and shape[self.sp_dim] % sp:
                    raise ValueError(
                        f"sp={sp} does not divide the sequence length "
                        f"{shape[self.sp_dim]} of batch leaf {k!r} (a "
                        "'tokens' leaf is counted after the shift)")
        return super().batch(batch)

    def _unsplit(self, leaf_axes):
        """The batch axes a leaf is not split over: its gradient is
        all-reduced over them."""
        return tuple(a for a in self.batch_axes if a not in leaf_axes)

    def _group(self, axes):
        from ray_tpu_torch.parallel.mesh import axis_group

        if axes and axes not in self._groups:
            self._groups[axes] = axis_group(self.mesh, axes)
        return self._groups.get(axes)

    def _all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        import torch.distributed as dist

        if axes:
            dist.all_reduce(x, group=self._group(axes))
        return x

    def gather(self, leaves):
        import torch.distributed as dist

        full = []
        for leaf, split in zip(leaves, self.split):
            split = [(d, axes) for d, axes in split
                     if axes[0] not in _MODEL_AXES]
            if not split:
                full.append(leaf)
                continue
            x = leaf.detach()
            for dim, axes in split:
                for a in reversed(axes):
                    part = _moved(x, dim)
                    out = part.new_empty((self.sizes[a] * part.shape[0],)
                                         + part.shape[1:])
                    dist.all_gather_into_tensor(out, part,
                                                group=self._group((a,)))
                    x = out.movedim(0, dim)
            full.append(x.contiguous().requires_grad_(True))
        return full

    def batch_view(self) -> BatchSplit:
        group = self._group(self.batch_axes) if self.batch_ranks > 1 \
            else None
        if group is not None:
            import torch.distributed as dist

            # the group's rank order is the batch's block order
            assert dist.get_group_rank(group, dist.get_rank()) == \
                self.batch_rank
        return BatchSplit(group, self.batch_rank, self.batch_ranks,
                          dict(self.sizes))

    def weight(self, batch, count=None):
        """This rank's share of the global loss, for a loss_fn that is a
        token mean as `llama_loss` is: the mean over its rows, or with a
        "mask" leaf ``sum(nll * mask) / max(sum(mask), 1)``, or a mean
        over the ``count`` the loss_fn reported (`data_parallel.
        count_tokens`: T5's live labels) in the same form. Weighted so,
        the summed gradient is that of the loss over the global batch,
        whatever count each shard holds."""
        if count is None and "mask" in batch:
            count = batch["mask"].to(torch.float32).sum()
        if count is None:
            return 1.0 / self.batch_ranks
        total = self._all_reduce(count.clone(), self.batch_axes)
        return count.clamp(min=1) / total.clamp(min=1)

    def reduce_replicated(self, grads):
        return [self._all_reduce(g.contiguous(), self.batch_axes)
                for g in grads]

    def reduce(self, grads):
        import torch.distributed as dist

        out = []
        for g, split, leaf_axes in zip(grads, self.split, self.leaf_axes):
            for dim, axes in split:
                for a in axes:
                    n = self.sizes[a]
                    if a in self.batch_axes:      # ZeRO's reduce-scatter
                        part = _moved(g, dim)
                        shard = part.new_empty((part.shape[0] // n,)
                                               + part.shape[1:])
                        dist.reduce_scatter_tensor(shard, part,
                                                   group=self._group((a,)))
                        g = shard.movedim(0, dim)
                    elif a not in _MODEL_AXES:    # same data: own block
                        block = g.shape[dim] // n
                        g = g.narrow(dim, self.coord[a] * block, block)
            out.append(self._all_reduce(g.contiguous(),
                                        self._unsplit(leaf_axes)))
        return out

    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm: each shard's squares summed once over the
        axes that split its leaf (not once per replica)."""
        norm = super().grad_norm
        by_axes = {}
        for g, axes in zip(grads, self.leaf_axes):
            by_axes.setdefault(axes, []).append(g)
        if list(by_axes) == [()]:
            return norm(by_axes[()])
        return sum(self._all_reduce(norm(gs) ** 2, axes)
                   for axes, gs in by_axes.items()).sqrt()

    def total(self, loss: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(loss, self.batch_axes)


def make_sharded_train_step(
    loss_fn: Callable[[Pytree, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: AdamW,
    mesh,
    param_specs: Pytree,
    batch_logical: Tuple[Optional[str], ...] = ("batch", None),
    rules=None,
    donate: bool = True,
):
    """Returns (init_fn, step_fn) over ``mesh`` (run on every rank).

    init_fn(params) -> (params, opt_state): this rank's region of each
    leaf of the GLOBAL param tree, by its spec in ``param_specs``, as an
    autograd leaf on the mesh's device, and the optimizer's state over
    those shards.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    takes the GLOBAL batch, the same on every rank, as the JAX step does;
    each rank takes its rows by `batch_sharding_fn`. ``loss_fn`` must be
    a token mean, as `llama_loss` is (see `_Mesh.weight`). The metrics
    ``{"loss", "grad_norm"}`` are the global batch's, the same 0-d
    tensor on every rank. With ``donate`` the step updates params and
    opt_state in place and returns them (as `make_train_step`); without
    it, it leaves them as they were and returns new ones.
    """
    plan = _Mesh(mesh, param_specs, batch_logical, rules)

    def init_fn(params: Pytree):
        from ray_tpu_torch.parallel.sharding import shard_pytree

        params = _tree_map(lambda p: p.requires_grad_(True),
                           shard_pytree(params, param_specs, mesh,
                                        plan.device))
        return params, optimizer.init(params)

    def step_fn(params: Pytree, opt_state, batch: Dict[str, Any]):
        if not donate:
            state = optimizer.state_tree(opt_state, params)
            params = _tree_map(
                lambda p: p.detach().clone().requires_grad_(True), params)
            opt_state = optimizer.init(params)
            optimizer.load_state_tree(opt_state, params, state)
        return _step(loss_fn, optimizer, params, opt_state, batch, plan)

    return init_fn, step_fn
