"""Llama-family decoder: config, seeded init, the layer math, the
training forward and the loss.

Port of `ray_tpu/models/llama.py`: `LlamaConfig` with its presets and
training fields, `_rmsnorm`, `_rope`, `llama_init`, `_attention_call`,
`_decoder_layer`, `llama_hidden`, `llama_forward`, `_nll`, `llama_loss`
and `llama_flops_per_token`. Params are a plain dict of tensors in the
JAX package's layout — every per-layer weight stacked with a leading
``[n_layers]`` axis, `wq` ``[L, d, H, hd]``, `wo` ``[L, H, hd, d]`` — so
the einsum strings carry over verbatim.

Storage dtype: `llama_init` builds weights in ``cfg.param_dtype`` (f32
master weights by default, as the JAX package does) unless the caller
asks for another one. Serving stores them in cfg.dtype (bf16) once
(``dtype=cfg.dtype``); training keeps the master weights, and
`_decoder_layer` casts each one to cfg.dtype right before its einsum, as
the JAX package does (a no-op on serving's bf16 weights).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel.tensor_parallel import (TPGroup, copy_to_tp,
                                                    gather_logits, is_split,
                                                    reduce_from_tp,
                                                    select_kv, vocab_embed,
                                                    vocab_cross_entropy)

Params = Dict[str, Any]

# checkpoint_name tags of remat_policy="save:...": each marks one output
# in _decoder_layer, as jax.ad_checkpoint.checkpoint_name does there.
REMAT_SAVE_NAMES = frozenset(
    {"qkv", "attn_out", "wo_out", "ffn_gate", "ffn_up", "ffn_down"})
# remat_policy="save_dots" (jax's dots_with_no_batch_dims_saveable): the
# projections' products. The attention is no dot (B1 and its plain
# version have batch dims), so it is recomputed.
_DOT_NAMES = ("qkv", "wo_out", "ffn_gate", "ffn_up", "ffn_down")
_ATTN_IMPLS = ("auto", "kernel", "flash", "reference", "ring", "ulysses")


def _parse_save_names(policy: str) -> list:
    """'save:a+b' -> ['a', 'b']; raises on empty or unknown names."""
    names = [n for n in policy[len("save:"):].split("+") if n]
    bad = [n for n in names if n not in REMAT_SAVE_NAMES]
    if not names or bad:
        raise ValueError(
            f"remat_policy {policy!r}: "
            + (f"unknown names {bad}" if bad else "no names given")
            + f" (valid: {sorted(REMAT_SAVE_NAMES)})")
    return names


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # activations (and serving weights)
    param_dtype: torch.dtype = torch.float32   # master weights (llama_init)
    remat: bool = True
    # Per-layer checkpoint policy of the JAX package: "full", "save_dots"
    # or "save:<name>+<name>+..." (names in REMAT_SAVE_NAMES); see
    # `_remat_context`.
    remat_policy: str = "full"
    # Attention: "auto" launches the hand-written kernels on CUDA tensors
    # and runs the plain versions on CPU tensors; "kernel" (or "flash",
    # the JAX package's name for it) and "reference" force one
    # (ops.attention.attention / paged_attention). "ring" and "ulysses"
    # wait for long context (ROADMAP A12).
    attn_impl: str = "auto"
    # The JAX flash kernel's tile sizes (None = kernel default). Validated
    # and passed on; the CUDA kernels use their own compile-time tiles.
    flash_block_q: Optional[int] = None
    flash_block_k: Optional[int] = None
    # Cross-entropy sequence chunking: the vocab projection + softmax run
    # loss_chunk tokens at a time under a checkpoint, so the [B, S, vocab]
    # f32 logits never exist at once. None = unchunked. Ignored when
    # S % loss_chunk != 0.
    loss_chunk: Optional[int] = None

    def __post_init__(self):
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {_ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")
        for nm in ("flash_block_q", "flash_block_k"):
            b = getattr(self, nm)
            if b is not None and b <= 0:
                raise ValueError(f"{nm} must be positive, got {b}")
        if self.remat_policy in ("full", "save_dots"):
            return
        if self.remat_policy.startswith("save:"):
            _parse_save_names(self.remat_policy)
            return
        raise ValueError(
            f"unknown remat_policy {self.remat_policy!r} "
            "(expected 'full', 'save_dots', or 'save:<names>')")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # ---- presets ----
    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                           ffn_dim=13824, **kw)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        """Meta-Llama-3-8B's published widths."""
        return LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, ffn_dim=14336,
                           rope_theta=500000.0, max_seq_len=8192, **kw)

    @staticmethod
    def nano(**kw) -> "LlamaConfig":
        """Tiny f32 config for CPU tests."""
        defaults = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                        dtype=torch.float32, remat=False)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    def num_params(self) -> int:
        d, v, f, L = self.dim, self.vocab_size, self.ffn_dim, self.n_layers
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlp = 3 * d * f
        return v * d + L * (attn + mlp + 2 * d) + d + d * v


def resolve_device(device) -> torch.device:
    """The port's device rule: CUDA unless the caller asks for the CPU,
    and no silent fallback when CUDA is asked for and missing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return device


def _layer_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """name -> (per-layer shape, logical axes, fan_in of the contraction
    or None for a norm scale)."""
    d, hd = cfg.dim, cfg.head_dim
    return {
        "wq": ((d, cfg.n_heads, hd), ("embed", "heads", "head_dim"), d),
        "wk": ((d, cfg.n_kv_heads, hd), ("embed", "kv", "head_dim"), d),
        "wv": ((d, cfg.n_kv_heads, hd), ("embed", "kv", "head_dim"), d),
        "wo": ((cfg.n_heads, hd, d), ("heads", "head_dim", "embed"),
               cfg.n_heads * hd),
        "w_gate": ((d, cfg.ffn_dim), ("embed", "mlp"), d),
        "w_up": ((d, cfg.ffn_dim), ("embed", "mlp"), d),
        "w_down": ((cfg.ffn_dim, d), ("mlp", "embed"), cfg.ffn_dim),
        "attn_norm": ((d,), ("embed",), None),
        "mlp_norm": ((d,), ("embed",), None),
    }


@torch.no_grad()
def llama_init(cfg: LlamaConfig, *, seed: int = 0, device="cuda",
               dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random weights built on ``device`` in ``dtype`` (default
    ``cfg.param_dtype``, the master weights training keeps; serving
    passes ``cfg.dtype``), with `ray_tpu.models.llama.llama_init`'s
    scales (normal * fan_in**-0.5, embedding * 0.02, unit norms). The
    draws come from a `torch.Generator`, so the values differ from the
    JAX init's; tests share weights through `ray_tpu_torch.convert`
    instead. Stacked weights are drawn one layer at a time, so the f32
    scratch stays at one layer's size."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return x.mul_(std).to(dtype)

    layers = {}
    for name, (shape, _, fan_in) in _layer_shapes(cfg).items():
        if fan_in is None:
            layers[name] = torch.ones((cfg.n_layers,) + shape, dtype=dtype,
                                      device=device)
            continue
        w = torch.empty((cfg.n_layers,) + shape, dtype=dtype, device=device)
        for i in range(cfg.n_layers):
            w[i] = normal(shape, fan_in ** -0.5)
        layers[name] = w
    return {
        "tok_embed": normal((cfg.vocab_size, cfg.dim), 0.02),
        "layers": layers,
        "final_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "lm_head": normal((cfg.dim, cfg.vocab_size), cfg.dim ** -0.5),
    }


def llama_logical_specs(cfg: LlamaConfig) -> Params:
    """Tree of logical-axis tuples matching llama_init's tree."""
    layer_specs = {name: ("layers",) + logical
                   for name, (_, logical, _f) in _layer_shapes(cfg).items()}
    return {
        "tok_embed": ("vocab", "embed"),
        "layers": layer_specs,
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def llama_param_specs(cfg: LlamaConfig, rules=None) -> Params:
    """Tree of partition specs (tuples of mesh-axis names, see
    `parallel.sharding.logical_to_mesh`) for the param tree under the
    given rules (default `DEFAULT_RULES`)."""
    from ray_tpu_torch.parallel.sharding import logical_to_mesh

    def specs(tree):
        if isinstance(tree, dict):
            return {k: specs(v) for k, v in tree.items()}
        return logical_to_mesh(tree, rules)

    return specs(llama_logical_specs(cfg))


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; rotate pairs (d, d + D/2)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs           # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _attention_call(q, k, v, cfg: LlamaConfig):
    """q,k,v: [B, S, H, D] -> [B, S, H, D]."""
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} (sequence-parallel attention) is "
            "not ported yet: ROADMAP A12")
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=True, impl=cfg.attn_impl,
                    block_q=cfg.flash_block_q, block_k=cfg.flash_block_k)
    with _named("attn_out"):
        return out.transpose(1, 2)


_CHECKPOINT_NAME = contextvars.ContextVar("checkpoint_name", default=None)
_KEPT = contextvars.ContextVar("remat_kept", default=None)
_PRODUCT_OPS = frozenset({torch.ops.aten.mm.default,
                          torch.ops.aten.bmm.default})


@dataclasses.dataclass
class _Kept:
    """One layer checkpoint's kept products: its forward appends them
    (``replay`` False), its recompute takes them back in order."""

    names: frozenset
    values: collections.deque
    replay: bool


class _KeepProducts(TorchDispatchMode):
    """Inside a named block that the policy saves: the forward keeps the
    output of each matrix product (torch.einsum lowers to mm or bmm),
    and the recompute returns it instead of running the product again.
    Every other op runs both times, so autograd saves the same tensors in
    the same order, as the checkpoint requires."""

    def __init__(self, kept: _Kept):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _PRODUCT_OPS:
            return func(*args, **(kwargs or {}))
        if self.kept.replay:
            return self.kept.values.popleft()
        out = func(*args, **(kwargs or {}))
        self.kept.values.append(out.detach())
        return out


@contextlib.contextmanager
def _named(name: str):
    """`jax.ad_checkpoint.checkpoint_name` for the ops of the block: they
    carry ``name`` while they dispatch, and inside a layer checkpoint
    whose policy saves it (`_remat_context`) its products are kept."""
    token = _CHECKPOINT_NAME.set(name)
    kept = _KEPT.get()
    try:
        with (_KeepProducts(kept) if kept is not None and name in kept.names
              else contextlib.nullcontext()):
            yield
    finally:
        _CHECKPOINT_NAME.reset(token)


@contextlib.contextmanager
def _keeping(kept: _Kept):
    token = _KEPT.set(kept)
    try:
        yield
    finally:
        _KEPT.reset(token)


def _remat_context(cfg: LlamaConfig):
    """The ``context_fn`` of each layer's checkpoint, or None under
    "full" (only the layer's input is kept).

    Under "save_dots" and "save:<names>" the layer's forward keeps the
    products of the saved names and its recompute reruns everything
    else, taking those back (`_KeepProducts`): JAX's policy over the
    same names. The values, and so the gradients, are those of "full";
    the weights' bf16 casts are recomputed, never kept. Two names keep
    nothing, as JAX keeps no residual for them: attn_out is remade for
    free, since B1 runs again in every policy for its lse (no named
    value), and ffn_down's product feeds only the residual sum, which no
    backward reads. The recompute stops at the last tensor the backward
    needs (torch's early stop), which comes before that product, so no
    policy reruns it either. Only the saved names' blocks dispatch
    through Python; the rest of the layer runs as under "full"."""
    if cfg.remat_policy == "full":
        return None
    names = frozenset(_DOT_NAMES if cfg.remat_policy == "save_dots"
                      else _parse_save_names(cfg.remat_policy)) \
        - {"attn_out", "ffn_down"}

    def context_fn():
        values = collections.deque()
        return (_keeping(_Kept(names, values, replay=False)),
                _keeping(_Kept(names, values, replay=True)))

    return context_fn


def _decoder_layer(h: torch.Tensor, layer: Params, positions: torch.Tensor,
                   cfg: LlamaConfig, tp: Optional[TPGroup] = None
                   ) -> torch.Tensor:
    """One decoder layer. Under a tp group ``tp`` the layer holds this
    rank's heads and MLP columns: f before the q/k/v and gate/up
    products, g after wo and w_down (`parallel.tensor_parallel`); kv
    weights replicated over tp are cut to the heads this rank's q heads
    read, so the attention runs at the local head counts."""
    dt = cfg.dtype
    x = copy_to_tp(_rmsnorm(h, layer["attn_norm"], cfg.norm_eps), tp)
    wk = select_kv(layer["wk"], tp, cfg, 1)
    wv = select_kv(layer["wv"], tp, cfg, 1)
    with _named("qkv"):
        q = torch.einsum("bsd,dhk->bshk", x, layer["wq"].to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, wv.to(dt))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = _attention_call(q, k, v, cfg)
    with _named("wo_out"):
        attn = torch.einsum("bshk,hkd->bsd", o, layer["wo"].to(dt))
    h = h + reduce_from_tp(attn, tp)

    x = _rmsnorm(h, layer["mlp_norm"], cfg.norm_eps)
    x = copy_to_tp(x, tp)
    with _named("ffn_gate"):
        gate = torch.einsum("bsd,df->bsf", x, layer["w_gate"].to(dt))
    with _named("ffn_up"):
        up = torch.einsum("bsd,df->bsf", x, layer["w_up"].to(dt))
    act = F.silu(gate) * up
    with _named("ffn_down"):
        down = torch.einsum("bsf,fd->bsd", act, layer["w_down"].to(dt))
    return h + reduce_from_tp(down, tp)


def _check_shards(params: Params, cfg: LlamaConfig,
                  tp: Optional[TPGroup]) -> None:
    """Refuse tp shards without their tp group: they would run as a
    smaller model."""
    heads = params["layers"]["wq"].shape[-2]
    if not is_split(tp) and heads != cfg.n_heads:
        raise ValueError(
            f"params hold {heads} of {cfg.n_heads} q heads: tensor-"
            "parallel shards need their group (tp=)")


def llama_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                 positions: Optional[torch.Tensor] = None,
                 tp: Optional[TPGroup] = None) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, dim] (activation
    dtype) — the backbone without the vocab projection.

    With ``cfg.remat`` each layer runs under a non-reentrant
    `torch.utils.checkpoint` (JAX's ``jax.checkpoint`` per layer), with
    ``cfg.remat_policy`` deciding what the forward keeps
    (`_remat_context`). ``tp``: the params are this rank's tp shards
    (`parallel.tensor_parallel`; vocab-parallel lookup, `_decoder_layer`
    at the local heads); the result is the whole hidden state on every
    rank."""
    _check_shards(params, cfg, tp)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    # gather, then cast: the same values as JAX's cast-then-gather
    h = vocab_embed(params["tok_embed"], tokens.long(), tp,
                    cfg.vocab_size).to(cfg.dtype)
    # one unbind per stacked leaf: its backward stacks the per-layer
    # grads once, where indexing [i] would add L full-size zero tensors
    per_layer = {name: torch.unbind(w) for name, w in
                 params["layers"].items()}
    layer_fn = functools.partial(_decoder_layer, positions=positions,
                                 cfg=cfg, tp=tp)
    context_fn = _remat_context(cfg) if cfg.remat else None
    kw = {} if context_fn is None else {"context_fn": context_fn}
    for i in range(cfg.n_layers):
        layer = {name: ws[i] for name, ws in per_layer.items()}
        if cfg.remat:
            h = checkpoint(layer_fn, h, layer, use_reentrant=False, **kw)
        else:
            h = layer_fn(h, layer)
    return _rmsnorm(h, params["final_norm"], cfg.norm_eps)


class _F32OutMatmul(torch.autograd.Function):
    """h [N, d] @ w [d, V] for bf16 operands on the card, with the f32
    result of the tensor-core GEMM (cuBLAS through torch.mm's
    ``out_dtype``) instead of its bf16 rounding. The backward rounds the
    f32 cotangent to bf16 once and runs two bf16 GEMMs, whose f32 sums
    are rounded to the operands' dtype as JAX's transposed products are."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = h.t() @ g if ctx.needs_input_grad[1] else None
        return dh, dw


def _logits(h: torch.Tensor, lm_head: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """[..., d] hidden -> [..., vocab] f32 logits: the cfg.dtype operands
    multiplied with an f32 result, as JAX's einsum with
    ``preferred_element_type=float32``. On the CPU both operands are
    upcast to f32 (a product of two bf16 values is exact in f32); a bf16
    config on the card keeps the bf16 tensor-core GEMM, with its f32
    accumulator as the result (an f32 GEMM of the flagship's vocab
    projection would cost tens of ms a step)."""
    w = lm_head.to(cfg.dtype)
    if h.is_cuda and cfg.dtype != torch.float32:
        flat = _F32OutMatmul.apply(h.reshape(-1, h.shape[-1]), w)
        return flat.reshape(*h.shape[:-1], w.shape[-1])
    return torch.matmul(h.float(), w.float())


def llama_forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                  positions: Optional[torch.Tensor] = None,
                  tp: Optional[TPGroup] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] (float32); under ``tp``
    gathered whole on every rank (inference: not differentiable)."""
    h = llama_hidden(params, tokens, cfg, positions, tp)
    if is_split(tp):
        return gather_logits(_logits(h, params["lm_head"], cfg), tp,
                             cfg.vocab_size)
    return _logits(h, params["lm_head"], cfg)


def _nll(h: torch.Tensor, targets: torch.Tensor, lm_head: torch.Tensor,
         cfg: LlamaConfig, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """[.., S, d] hidden + [.., S] targets -> [.., S] token nll (f32).
    With ``lm_head`` split over ``tp`` by vocab: f, the rank's logit
    columns and the vocab-parallel cross-entropy."""
    if is_split(tp) and lm_head.shape[-1] != cfg.vocab_size:
        logits = _logits(copy_to_tp(h, tp), lm_head, cfg)
        nll = vocab_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1), tp)
        return nll.reshape(targets.shape)
    logits = _logits(h, lm_head, cfg)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1).long(), reduction="none")
    return nll.reshape(targets.shape)


def llama_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: LlamaConfig, tp: Optional[TPGroup] = None
               ) -> torch.Tensor:
    """Next-token cross-entropy. batch: {'tokens': [B,S]} or
    {'inputs': [B,S], 'targets': [B,S]} (optional 'mask').

    With cfg.loss_chunk set (and dividing S), the vocab projection +
    softmax run loss_chunk tokens at a time, each chunk under a
    checkpoint: the [B, S, vocab] f32 logits are never materialized and
    the backward recomputes one chunk's projection at a time. Same loss
    and grads (tested). ``tp``: the params are this rank's tp shards;
    the loss is the same on every rank of the group, and no rank holds
    a [B, S, vocab] f32 tensor."""
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
        mask = batch.get("mask")
    else:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        mask = None
    h = llama_hidden(params, inputs, cfg, tp=tp)
    S = targets.shape[1]
    chunk = cfg.loss_chunk
    if chunk and S % chunk == 0 and S > chunk:
        nll = torch.cat([
            checkpoint(_nll, h[:, i:i + chunk], targets[:, i:i + chunk],
                       params["lm_head"], cfg, tp, use_reentrant=False)
            for i in range(0, S, chunk)], dim=1)
    else:
        nll = _nll(h, targets, params["lm_head"], cfg, tp)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def llama_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs/token (fwd+bwd): 6*N + attention term."""
    n = cfg.num_params()
    attn = 12 * cfg.n_layers * cfg.dim * seq_len  # causal: *0.5 of full
    return 6.0 * n + attn * 0.5
