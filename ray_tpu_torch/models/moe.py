"""Mixture-of-Experts decoder LM (Mixtral-style).

Port of `ray_tpu/models/moe.py`: `MoeConfig` with `mixtral_8x7b` and
`nano_moe`, `moe_init`, the specs, `_route_topk`, `_moe_ffn`,
`_moe_decoder_layer`, `moe_forward`, `moe_loss` and
`moe_flops_per_token`. Top-k token-choice routing at a static capacity:
dispatch and combine are one-hot einsums, every shape is static, and
tokens past an expert's capacity are dropped. Attention, RoPE and
rmsnorm are the Llama layer's (`llama._attention_block`: B1/B3 on the
card).

Three parallel forms of what GSPMD does for the JAX step:

- the ``expert`` axis (-> ``ep``): a rank holds ``E / ep`` experts
  (`moe_loss(..., ep=tp_group(mesh, "ep"))`). The router and the combine
  weights are computed whole on every ep rank; each rank runs its own
  experts' slots. f (`copy_to_tp`) sits where the replicated ``xf`` and
  combine weights enter the rank-local part, g (`reduce_from_tp`) after
  the combine einsum;
- the ``heads``, ``mlp`` and ``vocab`` axes (-> ``tp``, `moe_loss(...,
  tp=tp_group(mesh))`): the attention is Llama's tp layer
  (`llama._attention_block`), the experts' ``we_gate`` / ``we_up`` are
  column-parallel over the expert width and ``we_down`` row-parallel,
  so their partial sums are summed over tp as well as ep: the f on
  ``xf`` and the combine weights and the g after the combine run over
  both cuts. The router stays replicated: every tp rank routes the
  same, and the aux loss is not summed over tp. ``tok_embed`` and
  ``lm_head`` are vocab-parallel (`vocab_embed`, `llama._nll`);
- the batch axes: the JAX step routes the GLOBAL batch, so inside a
  split train step (`parallel.data_parallel`) each rank's capacity
  positions are offset by the per-expert counts of the lower-ranked
  batch shards, the capacity comes from the global token count, and
  the load-balancing means are global (the gates' mean through
  `SumOverBatch`). Outside a step, or on one rank, none of this runs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.llama import (LlamaConfig, _attention_block,
                                        _check_shards, _layer_shapes,
                                        _logits, _nll, _rmsnorm,
                                        resolve_device)
from ray_tpu_torch.parallel import data_parallel as dp
from ray_tpu_torch.parallel.sharding import logical_tree_to_mesh
from ray_tpu_torch.parallel.tensor_parallel import (TPGroup, check_tp_width,
                                                    copy_to_tp,
                                                    gather_logits, is_split,
                                                    reduce_from_tp,
                                                    vocab_embed)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    def __post_init__(self):
        super().__post_init__()
        if self.remat_policy != "full":
            raise ValueError(
                "MoeConfig supports remat_policy='full' only: moe_forward "
                "ignores remat_policy and always applies a plain per-layer "
                "checkpoint (and _moe_decoder_layer carries no "
                "checkpoint_name tags for named policies either)")

    @staticmethod
    def mixtral_8x7b(**kw) -> "MoeConfig":
        return MoeConfig(vocab_size=32000, dim=4096, n_layers=32,
                         n_heads=32, n_kv_heads=8, ffn_dim=14336,
                         n_experts=8, top_k=2, **kw)

    @staticmethod
    def nano_moe(**kw) -> "MoeConfig":
        defaults = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=128, n_experts=4, top_k=2,
                        max_seq_len=128)
        defaults.update(kw)
        return MoeConfig(**defaults)

    def _attn_params(self) -> int:
        d = self.dim
        return d * self.n_heads * self.head_dim * 2 + \
            d * self.n_kv_heads * self.head_dim * 2

    def num_params(self) -> int:
        d, f, e = self.dim, self.ffn_dim, self.n_experts
        per_layer_moe = e * 3 * d * f + d * e  # experts + router
        return (self.vocab_size * d * 2 +
                self.n_layers * (self._attn_params() + per_layer_moe))

    def active_params(self) -> int:
        """Params touched per token (top-k experts only) — the MFU basis."""
        d, f = self.dim, self.ffn_dim
        per_layer_moe = self.top_k * 3 * d * f + d * self.n_experts
        return (self.vocab_size * d * 2 +
                self.n_layers * (self._attn_params() + per_layer_moe))


def _moe_layer_shapes(cfg: MoeConfig) -> Dict[str, Any]:
    """Llama attention shapes + expert-stacked FFN + router."""
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts
    shapes = {k: v for k, v in _layer_shapes(cfg).items()
              if not k.startswith("w_")}  # drop dense FFN
    shapes.update({
        "w_router": ((d, e), ("embed", None), d),
        "we_gate": ((e, d, f), ("expert", "embed", "mlp"), d),
        "we_up": ((e, d, f), ("expert", "embed", "mlp"), d),
        "we_down": ((e, f, d), ("expert", "mlp", "embed"), f),
    })
    return shapes


@torch.no_grad()
def moe_init(cfg: MoeConfig, *, seed: int = 0, device="cuda",
             dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random weights on ``device`` in ``dtype`` (default
    ``cfg.param_dtype``) with the JAX init's scales; the draws come from
    a `torch.Generator` (tests carry JAX's weights across through
    `ray_tpu_torch.convert`). Stacked weights are drawn one layer at a
    time."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return x.mul_(std).to(dtype)

    layers = {}
    for name, (shape, _, fan_in) in _moe_layer_shapes(cfg).items():
        full = (cfg.n_layers,) + shape
        if fan_in is None:
            layers[name] = torch.ones(full, dtype=dtype, device=device)
            continue
        w = torch.empty(full, dtype=dtype, device=device)
        for i in range(cfg.n_layers):
            w[i] = normal(shape, fan_in ** -0.5)
        layers[name] = w
    return {
        "tok_embed": normal((cfg.vocab_size, cfg.dim), 0.02),
        "layers": layers,
        "final_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "lm_head": normal((cfg.dim, cfg.vocab_size), cfg.dim ** -0.5),
    }


def moe_logical_specs(cfg: MoeConfig) -> Params:
    layer_specs = {name: ("layers",) + logical
                   for name, (_, logical, _f) in
                   _moe_layer_shapes(cfg).items()}
    return {
        "tok_embed": ("vocab", "embed"),
        "layers": layer_specs,
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def moe_param_specs(cfg: MoeConfig, rules=None) -> Params:
    return logical_tree_to_mesh(moe_logical_specs(cfg), rules)


def _route_topk(gates: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gates [G,E] -> (weights [G,k], expert_idx [G,k]); weights
    renormalized over the chosen k. A stable descending sort puts the
    lower index first among equal gates, as `jax.lax.top_k` does."""
    weights, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :k], idx[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, idx


def _route(xf: torch.Tensor, w_router: torch.Tensor, cfg: MoeConfig,
           split: Optional[dp.BatchSplit] = None):
    """xf [G,d] -> (gates [G,E] f32, weights [G,k], expert_idx [G,k],
    position [G,k]): the router in f32, the top-k choices and each
    (token, choice)'s position within its expert's capacity, token-major,
    choice-minor over the GLOBAL batch: earlier tokens (lower batch ranks
    first, ``split`` a train step's `parallel.data_parallel.BatchSplit`)
    win capacity."""
    g, e, k = xf.shape[0], cfg.n_experts, cfg.top_k
    gates = torch.softmax(xf.float() @ w_router.float(), dim=-1)
    weights, expert_idx = _route_topk(gates, k)
    flat = F.one_hot(expert_idx, e).reshape(g * k, e)
    position = torch.cumsum(flat, dim=0) - 1                     # [G*k,E]
    if split is not None and split.size > 1:
        counts = dp.gather_over_batch(flat.sum(0), split)        # [n,E]
        position = position + counts[:split.rank].sum(0)
    position = (position * flat).sum(-1).reshape(g, k)
    return gates, weights, expert_idx, position


def _local_experts(layer: Params, cfg: MoeConfig,
                   ep: Optional[TPGroup]) -> Tuple[int, int]:
    """(first, count) of the experts this rank's ``we_*`` hold."""
    held = layer["we_gate"].shape[0]
    if not is_split(ep):
        if held != cfg.n_experts:
            raise ValueError(
                f"params hold {held} of {cfg.n_experts} experts: expert-"
                "parallel shards need their group (ep=)")
        return 0, held
    if held * ep.size != cfg.n_experts:
        raise ValueError(f"{held} experts a rank over ep={ep.size}: "
                         f"n_experts is {cfg.n_experts}")
    return ep.rank * held, held


def _to_experts(x: torch.Tensor, ep: Optional[TPGroup],
                tp: Optional[TPGroup]) -> torch.Tensor:
    """f over both cuts of the experts: a replicated tensor entering the
    rank-local experts, its gradient summed over ep and tp."""
    return copy_to_tp(copy_to_tp(x, ep), tp)


def _from_experts(x: torch.Tensor, ep: Optional[TPGroup],
                  tp: Optional[TPGroup]) -> torch.Tensor:
    """g over both cuts: the rank's experts' partial sums (over its
    experts and its columns of their width) made whole."""
    return reduce_from_tp(reduce_from_tp(x, tp), ep)


def _moe_ffn(x: torch.Tensor, layer: Params, cfg: MoeConfig,
             ep: Optional[TPGroup] = None,
             split: Optional[dp.BatchSplit] = None,
             tp: Optional[TPGroup] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (out [B,S,d], aux_loss scalar f32). Static-capacity
    token-choice top-k dispatch, rounded where JAX's is: the router in
    f32, ``combine`` in cfg.dtype, ``dispatch = combine > 0``, the
    expert products and ``out`` in cfg.dtype. ``split``: the train
    step's batch split (global capacity, positions and means); ``ep``
    and ``tp``: the experts' cuts (the module docstring)."""
    dt = cfg.dtype
    b, s, d = x.shape
    g = b * s
    e, k = cfg.n_experts, cfg.top_k
    n = split.size if split is not None else 1
    capacity = max(1, int(cfg.capacity_factor * (g * n) * k / e))
    e0, el = _local_experts(layer, cfg, ep)

    xf = x.reshape(g, d)
    gates, weights, expert_idx, position = _route(xf, layer["w_router"],
                                                  cfg, split)
    in_capacity = position < capacity

    # Combine weights [G,k] -> combine tensor [G,E,C] (one-hot einsum);
    # a position past the capacity has an all-zero one-hot row, as
    # jax.nn.one_hot gives.
    keep = weights * in_capacity.to(weights.dtype)
    slots = torch.arange(capacity, device=x.device)
    pos_onehot = (position[..., None] == slots).to(dt)           # [G,k,C]
    exp_onehot = F.one_hot(expert_idx, e).to(dt)                 # [G,k,E]
    # this rank's experts: f where the replicated combine weights and
    # tokens enter (their gradients summed over ep and tp), g after the
    # combine
    combine = torch.einsum("gk,gke,gkc->gec",
                           _to_experts(keep, ep, tp).to(dt),
                           exp_onehot[:, :, e0:e0 + el], pos_onehot)
    dispatch = (combine > 0).to(dt)                              # [G,El,C]

    expert_in = torch.einsum("gec,gd->ecd", dispatch,
                             _to_experts(xf, ep, tp).to(dt))
    gate = torch.einsum("ecd,edf->ecf", expert_in, layer["we_gate"].to(dt))
    up = torch.einsum("ecd,edf->ecf", expert_in, layer["we_up"].to(dt))
    expert_out = torch.einsum("ecf,efd->ecd", F.silu(gate) * up,
                              layer["we_down"].to(dt))
    out = _from_experts(torch.einsum("gec,ecd->gd", combine, expert_out),
                        ep, tp)

    # Load-balancing aux loss (Switch/GShard): E * sum_e f_e * p_e, with
    # both means over the global batch.
    if n > 1:
        me = dp.summed_over_batch(gates.sum(0), split) / (g * n)  # [E]
        ce = (dp.sum_over_batch(exp_onehot.float().sum((0, 1)), split)
              / (g * n)).to(dt)                                  # [E]
    else:
        me = gates.mean(0)
        ce = exp_onehot.sum(1).mean(0)
    aux = e * torch.sum(me * ce) / k
    return out.reshape(b, s, d), aux.float()


def _moe_decoder_layer(h: torch.Tensor, aux_sum: torch.Tensor,
                       layer: Params, positions: torch.Tensor,
                       cfg: MoeConfig, ep: Optional[TPGroup] = None,
                       split: Optional[dp.BatchSplit] = None,
                       tp: Optional[TPGroup] = None):
    h = _attention_block(h, layer, positions, cfg, tp)
    x = _rmsnorm(h, layer["mlp_norm"], cfg.norm_eps)
    moe_out, aux = _moe_ffn(x, layer, cfg, ep, split, tp)
    return h + moe_out, aux_sum + aux


def _moe_hidden(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
                positions: Optional[torch.Tensor] = None,
                ep: Optional[TPGroup] = None, tp: Optional[TPGroup] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (final-norm hidden [B,S,d], mean aux loss)."""
    _check_shards(params, cfg, tp)
    check_tp_width("we_gate", params["layers"]["we_gate"].shape[-1],
                   cfg.ffn_dim, tp)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = vocab_embed(params["tok_embed"], tokens.long(), tp,
                    cfg.vocab_size).to(cfg.dtype)
    per_layer = {name: torch.unbind(w) for name, w in
                 params["layers"].items()}
    layer_fn = functools.partial(_moe_decoder_layer, positions=positions,
                                 cfg=cfg, ep=ep, split=dp.current(), tp=tp)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        layer = {name: ws[i] for name, ws in per_layer.items()}
        if cfg.remat:
            h, aux = checkpoint(layer_fn, h, aux, layer, use_reentrant=False)
        else:
            h, aux = layer_fn(h, aux, layer)
    return _rmsnorm(h, params["final_norm"], cfg.norm_eps), \
        aux / cfg.n_layers


def moe_forward(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
                positions: Optional[torch.Tensor] = None,
                ep: Optional[TPGroup] = None, tp: Optional[TPGroup] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,V] f32, mean aux loss). ``ep``: the
    params' expert weights are this rank's experts; ``tp``: the params
    are this rank's tp shards, and the logits are gathered whole
    (inference: not differentiable over a vocab split). The train
    step's batch split is read here and bound into each layer, so a
    layer's recompute sees it whatever thread runs the backward."""
    h, aux = _moe_hidden(params, tokens, cfg, positions, ep, tp)
    logits = _logits(h, params["lm_head"], cfg)
    return gather_logits(logits, tp, cfg.vocab_size), aux


def moe_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: MoeConfig, ep: Optional[TPGroup] = None,
             tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Next-token CE + router aux loss; under ``tp`` the vocab-parallel
    cross-entropy (no rank holds the [N, vocab] logits)."""
    dp.refuse_model_split("moe_loss")
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    h, aux = _moe_hidden(params, inputs, cfg, ep=ep, tp=tp)
    nll = _nll(h, targets, params["lm_head"], cfg, tp)
    return nll.mean() + cfg.router_aux_coef * aux


def moe_flops_per_token(cfg: MoeConfig, seq_len: int) -> float:
    """Training FLOPs/token on ACTIVE params (top-k experts)."""
    attn = 12 * cfg.n_layers * cfg.dim * seq_len
    return 6.0 * cfg.active_params() + attn * 0.5
