"""LoRA (low-rank adaptation) for the stacked-layer models.

Port of `ray_tpu/models/lora.py`: `LoraConfig`, the seeded
`lora_init`, `lora_num_params`, `lora_merge`, the specs of training
adapters (`lora_param_specs`) and of the serving pool's stacks
(`lora_stack_specs`), and the adapter-only `make_lora_train_step` on
one card or over a mesh (the base sharded by its specs, the adapters
replicated, each rank merging its own slice of ``a @ b``).

- Adapters are a SEPARATE small tree ``{"layers": {name: {"a": [L, in,
  r], "b": [L, r, out]}}}`` with the leading [n_layers] axis of every
  stacked weight. The base tree is never mutated.
- The train step takes the base as a plain input that never gets
  ``requires_grad`` and differentiates only the adapters; the merge
  ``W + alpha/r * A@B`` happens inside the step, so autograd reaches the
  adapters through `lora_merge` (JAX: ``stop_gradient`` on the base and
  ``value_and_grad`` over the adapters).
- `lora_merge` exports a plain param tree: the merged model runs through
  `llama_forward`, `generate` and the engine unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.llama import (LlamaConfig, _layer_shapes,
                                        resolve_device)
from ray_tpu_torch.models.training import (AdamW, _leaves, _Mesh,
                                           _OneCard, _tree_map, _unflatten)
from ray_tpu_torch.parallel.sequence_parallel import splitting
from ray_tpu_torch.parallel.sharding import logical_to_mesh, shard_pytree
from ray_tpu_torch.parallel.tensor_parallel import copy_to_tp, tp_group

Params = Dict[str, Any]

# Layer weights eligible for adaptation (norm scales are excluded:
# rank-decomposing a vector is meaningless).
_ADAPTABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    def __post_init__(self):
        if self.rank <= 0:
            raise ValueError(f"rank must be positive, got {self.rank}")
        bad = [t for t in self.targets if t not in _ADAPTABLE]
        if not self.targets or bad:
            raise ValueError(
                f"targets {self.targets!r}: "
                + (f"unknown {bad}" if bad else "empty")
                + f" (adaptable: {_ADAPTABLE})")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _in_out_split(shape: Tuple[int, ...], fan_in: int) -> Tuple[int, int]:
    """Split a weight shape into (fan_in, fan_out) sizes by locating the
    contraction prefix (wq: (d,h,hd) -> d | h*hd; wo: (h,hd,d) -> h*hd | d)."""
    return fan_in, math.prod(shape[_fan_in_dims(shape, fan_in):])


def lora_dims(cfg: LlamaConfig, lora_cfg: LoraConfig
              ) -> Dict[str, Tuple[int, int]]:
    """target name -> (n_in, n_out) of its flattened weight."""
    shapes = _layer_shapes(cfg)
    return {name: _in_out_split(shapes[name][0], shapes[name][2])
            for name in lora_cfg.targets}


@torch.no_grad()
def lora_init(cfg: LlamaConfig, lora_cfg: LoraConfig, *,
              generator: Optional[torch.Generator] = None, device="cuda",
              dtype: torch.dtype = torch.float32) -> Params:
    """Adapter tree {"layers": {name: {"a": [L, in, r], "b": [L, r, out]}}}
    on ``device`` in ``dtype`` (default f32, the JAX ``param_dtype``).
    A ~ N(0, 1/in), drawn in f32 from ``generator`` (default: seed 0 on
    the device), one target after another; B = 0, so the merged model
    equals the base exactly at init. The draws differ from the JAX
    init's; tests share adapters through `convert.lora_from_numpy`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    layers = {}
    for name, (n_in, n_out) in lora_dims(cfg, lora_cfg).items():
        a = torch.randn((cfg.n_layers, n_in, lora_cfg.rank),
                        generator=generator, device=device,
                        dtype=torch.float32)
        layers[name] = {
            "a": a.mul_(n_in ** -0.5).to(dtype),
            "b": torch.zeros((cfg.n_layers, lora_cfg.rank, n_out),
                             dtype=dtype, device=device),
        }
    return {"layers": layers}


def lora_num_params(cfg: LlamaConfig, lora_cfg: LoraConfig) -> int:
    return sum(cfg.n_layers * lora_cfg.rank * (n_in + n_out)
               for n_in, n_out in lora_dims(cfg, lora_cfg).values())


def lora_param_specs(lora_cfg: LoraConfig, rules=None) -> Params:
    """Adapters shard only their stacked layer axis mapping (the base
    weights' "layers" logical axis); in/rank/out replicate: at ~0.1% of
    the model's size the replication is free and keeps the merge
    local."""
    spec = logical_to_mesh(("layers", None, None), rules)
    return {"layers": {name: {"a": spec, "b": spec}
                       for name in lora_cfg.targets}}


def lora_stack_specs(cfg: LlamaConfig, lora_cfg: LoraConfig,
                     rules=None) -> Params:
    """Partition specs of the serving `AdapterPool`'s stacks ``{name:
    {"a": [L, A, n_in, rank], "b": [L, A, rank, n_out]}}``: the a-stack's
    fan-in axis takes the base weight's leading input logical axis and
    the b-stack's fan-out axis its first output logical axis, through
    the engine's (pruned) rules, so an adapter axis replicates exactly
    when the base axis does (kv heads that do not divide tp). Slot and
    rank axes replicate."""
    shapes = _layer_shapes(cfg)
    out = {}
    for name in lora_cfg.targets:
        shape, logical, fan_in = shapes[name]
        split = _fan_in_dims(shape, fan_in)
        out[name] = {
            "a": logical_to_mesh(("layers", None, logical[0], None), rules),
            "b": logical_to_mesh(("layers", None, None, logical[split]),
                                 rules),
        }
    return out


def _fan_in_dims(shape: Tuple[int, ...], fan_in: int) -> int:
    """How many leading dims of ``shape`` the contraction spans."""
    acc = 1
    for i, s in enumerate(shape):
        acc *= s
        if acc == fan_in:
            return i + 1
    raise ValueError(f"fan_in {fan_in} is not a prefix product of {shape}")


def tp_cut(shape: Tuple[int, ...], fan_in: int, spec, size: int,
           rank: int) -> Optional[Tuple[slice, slice]]:
    """(in, out) slices of a weight's flattened [n_in, n_out] that rank
    ``rank`` of a tp axis of ``size`` holds under the weight's partition
    ``spec`` (its dims after the layer axis): the block of the one dim
    split over tp, which leads its side of the contraction. None when
    nothing is split over tp."""
    k = _fan_in_dims(shape, fan_in)
    n_in, n_out = math.prod(shape[:k]), math.prod(shape[k:])
    cut = [slice(0, n_in), slice(0, n_out)]
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "tp" not in axes or size == 1:
            continue
        side, lead = (0, 0) if dim < k else (1, k)
        if dim != lead:
            raise NotImplementedError(
                f"a tp split of dim {dim} of {shape}: only the leading "
                "dim of each side of the contraction may split")
        n = (n_in, n_out)[side] // size
        cut[side] = slice(rank * n, (rank + 1) * n)
    if cut == [slice(0, n_in), slice(0, n_out)]:
        return None
    return cut[0], cut[1]


def lora_merge(base: Params, lora: Params, cfg: LlamaConfig,
               lora_cfg: LoraConfig, cuts=None, tp=None) -> Params:
    """base + scale * A@B, reshaped per weight: the f32 einsum
    ``lir,lro->lio`` times the scale, added to the f32 weight, then cast
    back to the weight's dtype. Returns a full param tree usable by
    `llama_forward` / `generate` / the engine; base is not mutated.
    Differentiable in the adapters (the train step's path).

    ``cuts`` (the mesh step's): name -> this rank's (in, out) slices of
    the flattened weight, or None (`tp_cut`); the base holds that block,
    and the merge adds the same block of the delta, ``a[:, in] @ b[:, :,
    out]``, with f (`copy_to_tp`) on the replicated factors so their
    gradients are summed over ``tp``."""
    merged_layers = dict(base["layers"])
    for name, ab in lora["layers"].items():
        w = base["layers"][name]
        a, b = ab["a"], ab["b"]
        cut = None if cuts is None else cuts[name]
        if cut is not None:
            a = copy_to_tp(a, tp)[:, cut[0]]
            b = copy_to_tp(b, tp)[:, :, cut[1]]
        delta = torch.einsum("lir,lro->lio", a.float(),
                             b.float()) * lora_cfg.scale
        merged_layers[name] = (w.float()
                               + delta.reshape(w.shape)).to(w.dtype)
    out = dict(base)
    out["layers"] = merged_layers
    return out


def make_lora_train_step(
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor],
    optimizer: AdamW,
    *args,
    device="cuda",
    batch_logical: Tuple[Optional[str], ...] = ("batch", None),
    rules=None,
):
    """Returns (init_fn, step_fn) for adapter-only training:
    ``make_lora_train_step(loss_fn, optimizer, cfg, lora_cfg, device=)``
    on one card, or JAX's mesh form ``make_lora_train_step(loss_fn,
    optimizer, mesh, cfg, lora_cfg, base_specs, batch_logical=,
    rules=)`` (run on every rank).

    loss_fn(merged_params, batch) -> scalar: the SAME loss as full
    fine-tuning (e.g. llama_loss; over a tp mesh the tp-aware one,
    ``llama_loss(..., tp=tp_group(mesh))``); the merge happens inside the
    step.

    init_fn(base, lora) -> (base, lora, opt_state): the base's leaves on
    the device, detached (never ``requires_grad``; over a mesh this
    rank's region by ``base_specs``), the adapters' as autograd leaves
    (replicated), and the optimizer state over the adapters only.

    step_fn(lora, opt_state, base, batch) -> (lora, opt_state, {"loss",
    "grad_norm"}): the adapters and their optimizer state are updated IN
    PLACE (the JAX step's donation); the step never writes to the base.
    Autograd still forms the targeted weights' gradients (they carry the
    adapters' through the merge) but no other base gradient, and the
    optimizer touches the adapters only. Over a mesh the step takes the
    global batch (each rank its rows), gathers the base over its non-tp
    axes, merges its tp slice of each delta, and sums the adapters'
    gradients over the batch axes (tp's partial sums are made whole by
    the merge's f)."""
    if len(args) == 2:
        (cfg, lora_cfg), mesh, base_specs = args, None, None
        plan, tp, cuts = _OneCard(resolve_device(device)), None, None
    else:
        mesh, cfg, lora_cfg, base_specs = args
        plan, tp = _Mesh(mesh, base_specs, batch_logical, rules), \
            tp_group(mesh)
        shapes = _layer_shapes(cfg)
        cuts = {name: tp_cut(shapes[name][0], shapes[name][2],
                             base_specs["layers"][name][1:], tp.size,
                             tp.rank)
                for name in lora_cfg.targets}

    def init_fn(base: Params, lora: Params):
        if mesh is None:
            base = _tree_map(lambda p: p.detach().to(plan.device), base)
        else:
            base = shard_pytree(base, base_specs, mesh, plan.device)
        lora = _tree_map(
            lambda p: p.detach().to(plan.device).requires_grad_(True), lora)
        return base, lora, optimizer.init(lora)

    def step_fn(lora: Params, opt_state, base: Params,
                batch: Dict[str, Any]):
        batch = plan.batch(batch)
        weight = plan.weight(batch)
        with torch.no_grad():
            full = [x.detach() for x in plan.gather(_leaves(base))]
        leaves = _leaves(lora)
        merged = lora_merge(_unflatten(base, full), lora, cfg, lora_cfg,
                            cuts=cuts, tp=tp)
        with splitting(plan.sp):
            loss = loss_fn(merged, batch)
        if weight is not None:
            loss = loss * weight
        grads = plan.reduce_replicated(torch.autograd.grad(loss, leaves))
        grad_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        optimizer.update(opt_state, leaves, grads)
        return lora, opt_state, {"loss": plan.total(loss.detach()),
                                 "grad_norm": grad_norm}

    return init_fn, step_fn
