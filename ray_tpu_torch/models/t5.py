"""Encoder-decoder (T5-class) seq2seq family.

Port of `ray_tpu/models/t5.py`: `T5Config`, `t5_init`, the specs, the
layer math (`_self_attention`, `_cross_attention`, `_mlp`,
`_encoder_layer`, `_decoder_layer`), `t5_encode`, `t5_decode`,
`t5_forward`, `t5_loss` and `t5_generate` with its cached decode
(`_cached_self_attention`, `_memory_attention`). Pre-RMSNorm, a gated
MLP, RoPE on the self-attention paths, position-free cross-attention
and a weight-tied head whose logits are computed in the activation
dtype, then cast to f32 (unlike Llama's f32-accumulated logits).

Training attention is `ops.attention.attention` (B1/B3 on the card):
non-causal in the encoder, causal in the decoder, non-causal with Sq !=
Sk in the cross-attention. The generation loop's attention is plain
einsums over a preallocated cache, as in JAX.

`t5_loss` is a pad-masked mean over the labels: it reports its live
count to a split train step (`parallel.data_parallel.count_tokens`), so
the step weights each rank's mean by its share of the global count.

Under a tp group (`t5_loss(..., tp=tp_group(mesh))`, the explicit form
of the JAX step's GSPMD split) a rank computes its heads of every
attention and its columns of every MLP: f before the q/k/v and gate/up
products, g after wo and w_down. The encoder's memory is whole on every
rank; one f on it before the decoder sums the cross k/v products'
gradients over tp. The tied ``embed`` is vocab-parallel: `vocab_embed`
for source and target and `vocab_nll` for the tied logits,
so the shard's gradient takes both uses. `t5_generate` takes no tp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.llama import _rmsnorm, _rope, resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel import data_parallel as dp
from ray_tpu_torch.parallel.sharding import logical_tree_to_mesh
from ray_tpu_torch.parallel.tensor_parallel import (TPGroup, check_tp_width,
                                                    copy_to_tp,
                                                    gather_logits,
                                                    reduce_from_tp,
                                                    vocab_embed, vocab_nll)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 6           # per stack (encoder AND decoder)
    n_heads: int = 8
    ffn_dim: int = 1024
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    pad_id: int = 0
    # "auto" (kernels on CUDA tensors), "kernel" or "reference"
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.dim % self.n_heads:
            raise ValueError("n_heads must divide dim")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def nano(**kw) -> "T5Config":
        base = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    ffn_dim=128)
        base.update(kw)
        return T5Config(**base)

    def num_params(self) -> int:
        d, f, h, k = self.dim, self.ffn_dim, self.n_heads, self.head_dim
        attn = d * h * k * 4          # wq wk wv (d,h,k) + wo (h,k,d)
        mlp = 3 * d * f               # gate/up/down
        enc_layer = attn + mlp + 2 * d              # 2 norms
        dec_layer = 2 * attn + mlp + 3 * d          # self+cross, 3 norms
        return (self.vocab_size * d +               # tied embed/head
                self.n_layers * (enc_layer + dec_layer) + 2 * d)


def _attn_shapes(cfg: T5Config, prefix: str) -> Dict[str, Any]:
    d, h, k = cfg.dim, cfg.n_heads, cfg.head_dim
    return {
        f"{prefix}_norm": ((d,), ("embed",), None),
        f"{prefix}_wq": ((d, h, k), ("embed", "heads", "kv"), d),
        f"{prefix}_wk": ((d, h, k), ("embed", "heads", "kv"), d),
        f"{prefix}_wv": ((d, h, k), ("embed", "heads", "kv"), d),
        f"{prefix}_wo": ((h, k, d), ("heads", "kv", "embed"), h * k),
    }


def _mlp_shapes(cfg: T5Config) -> Dict[str, Any]:
    d, f = cfg.dim, cfg.ffn_dim
    return {
        "mlp_norm": ((d,), ("embed",), None),
        "w_gate": ((d, f), ("embed", "mlp"), d),
        "w_up": ((d, f), ("embed", "mlp"), d),
        "w_down": ((f, d), ("mlp", "embed"), f),
    }


def _enc_shapes(cfg: T5Config) -> Dict[str, Any]:
    return {**_attn_shapes(cfg, "attn"), **_mlp_shapes(cfg)}


def _dec_shapes(cfg: T5Config) -> Dict[str, Any]:
    return {**_attn_shapes(cfg, "self"), **_attn_shapes(cfg, "cross"),
            **_mlp_shapes(cfg)}


@torch.no_grad()
def t5_init(cfg: T5Config, *, seed: int = 0, device="cuda",
            dtype: Optional[torch.dtype] = None) -> Params:
    """Seeded random weights with the JAX init's scales (a
    `torch.Generator`'s draws; tests carry JAX's weights across through
    `ray_tpu_torch.convert`)."""
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32).mul_(std).to(dtype)

    def stack(shapes):
        out = {}
        for name, (shape, _, fan_in) in shapes.items():
            full = (cfg.n_layers,) + shape
            out[name] = (torch.ones(full, dtype=dtype, device=device)
                         if fan_in is None else normal(full, fan_in ** -0.5))
        return out

    return {
        "embed": normal((cfg.vocab_size, cfg.dim), cfg.dim ** -0.5),
        "encoder": stack(_enc_shapes(cfg)),
        "decoder": stack(_dec_shapes(cfg)),
        "enc_final_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
        "dec_final_norm": torch.ones((cfg.dim,), dtype=dtype, device=device),
    }


def t5_logical_specs(cfg: T5Config) -> Params:
    def stack(shapes):
        return {name: ("layers",) + logical
                for name, (_, logical, _f) in shapes.items()}

    return {
        "embed": ("vocab", "embed"),
        "encoder": stack(_enc_shapes(cfg)),
        "decoder": stack(_dec_shapes(cfg)),
        "enc_final_norm": ("embed",),
        "dec_final_norm": ("embed",),
    }


def t5_param_specs(cfg: T5Config, rules=None) -> Params:
    return logical_tree_to_mesh(t5_logical_specs(cfg), rules)


def _proj(x, w, dt):
    return torch.einsum("bsd,dhk->bshk", x, w.to(dt))


def _attend(q, k, v, cfg: T5Config, causal: bool):
    """[B, S, H, D] in, [B, Sq, H, D] out."""
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal, impl=cfg.attn_impl)
    return o.transpose(1, 2)


def _self_attention(x, layer, prefix, positions, cfg: T5Config,
                    causal: bool, tp: Optional[TPGroup] = None):
    dt = cfg.dtype
    x = copy_to_tp(x, tp)
    q = _rope(_proj(x, layer[f"{prefix}_wq"], dt), positions,
              cfg.rope_theta)
    k = _rope(_proj(x, layer[f"{prefix}_wk"], dt), positions,
              cfg.rope_theta)
    v = _proj(x, layer[f"{prefix}_wv"], dt)
    return reduce_from_tp(torch.einsum(
        "bshk,hkd->bsd", _attend(q, k, v, cfg, causal),
        layer[f"{prefix}_wo"].to(dt)), tp)


def _cross_attention(x, memory, layer, cfg: T5Config,
                     tp: Optional[TPGroup] = None):
    """``memory`` has passed its f (`_decode_hidden`)."""
    dt = cfg.dtype
    q = _proj(copy_to_tp(x, tp), layer["cross_wq"], dt)
    k = _proj(memory, layer["cross_wk"], dt)
    v = _proj(memory, layer["cross_wv"], dt)
    return reduce_from_tp(torch.einsum(
        "bshk,hkd->bsd", _attend(q, k, v, cfg, False),
        layer["cross_wo"].to(dt)), tp)


def _mlp(x, layer, cfg: T5Config, tp: Optional[TPGroup] = None):
    dt = cfg.dtype
    x = copy_to_tp(x, tp)
    gate = torch.einsum("bsd,df->bsf", x, layer["w_gate"].to(dt))
    up = torch.einsum("bsd,df->bsf", x, layer["w_up"].to(dt))
    return reduce_from_tp(torch.einsum(
        "bsf,fd->bsd", F.silu(gate) * up, layer["w_down"].to(dt)), tp)


def _encoder_layer(h, layer, positions, cfg: T5Config,
                   tp: Optional[TPGroup] = None):
    x = _rmsnorm(h, layer["attn_norm"], cfg.norm_eps)
    h = h + _self_attention(x, layer, "attn", positions, cfg, False, tp)
    x = _rmsnorm(h, layer["mlp_norm"], cfg.norm_eps)
    return h + _mlp(x, layer, cfg, tp)


def _decoder_layer(h, layer, memory, positions, cfg: T5Config,
                   tp: Optional[TPGroup] = None):
    x = _rmsnorm(h, layer["self_norm"], cfg.norm_eps)
    h = h + _self_attention(x, layer, "self", positions, cfg, True, tp)
    x = _rmsnorm(h, layer["cross_norm"], cfg.norm_eps)
    h = h + _cross_attention(x, memory, layer, cfg, tp)
    x = _rmsnorm(h, layer["mlp_norm"], cfg.norm_eps)
    return h + _mlp(x, layer, cfg, tp)


def _run_stack(fn, h, stack: Params, cfg: T5Config, *args):
    per_layer = {name: torch.unbind(w) for name, w in stack.items()}
    for i in range(cfg.n_layers):
        layer = {name: ws[i] for name, ws in per_layer.items()}
        if cfg.remat:
            h = checkpoint(fn, h, layer, *args, use_reentrant=False)
        else:
            h = fn(h, layer, *args)
    return h


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _check_shards(params: Params, cfg: T5Config,
                  tp: Optional[TPGroup]) -> None:
    for stack, prefixes in (("encoder", ("attn",)),
                            ("decoder", ("self", "cross"))):
        layers = params[stack]
        for p in prefixes:
            check_tp_width(f"{stack}/{p}_wq", layers[f"{p}_wq"].shape[-2],
                           cfg.n_heads, tp)
        check_tp_width(f"{stack}/w_gate", layers["w_gate"].shape[-1],
                       cfg.ffn_dim, tp)


def t5_encode(params: Params, src_tokens: torch.Tensor, cfg: T5Config,
              tp: Optional[TPGroup] = None) -> torch.Tensor:
    """src_tokens [B, S] -> memory [B, S, dim] (activations dtype), whole
    on every rank of ``tp``."""
    _check_shards(params, cfg, tp)
    B, S = src_tokens.shape
    h = vocab_embed(params["embed"], src_tokens.long(), tp,
                    cfg.vocab_size).to(cfg.dtype)
    h = _run_stack(_encoder_layer, h, params["encoder"], cfg,
                   _positions(B, S, h.device), cfg, tp)
    return _rmsnorm(h, params["enc_final_norm"], cfg.norm_eps)


def _tied_logits(h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Weight-tied head (embed^T) in the activation dtype, then f32."""
    return torch.einsum("btd,vd->btv", h, embed.to(h.dtype)).float()


def _decode_hidden(params: Params, memory: torch.Tensor,
                   tgt_tokens: torch.Tensor, cfg: T5Config,
                   tp: Optional[TPGroup] = None) -> torch.Tensor:
    """memory [B, S, d] + tgt_tokens [B, T] -> final-norm hidden [B, T, d]."""
    _check_shards(params, cfg, tp)
    B, T = tgt_tokens.shape
    h = vocab_embed(params["embed"], tgt_tokens.long(), tp,
                    cfg.vocab_size).to(cfg.dtype)
    h = _run_stack(_decoder_layer, h, params["decoder"], cfg,
                   copy_to_tp(memory, tp), _positions(B, T, h.device), cfg,
                   tp)
    return _rmsnorm(h, params["dec_final_norm"], cfg.norm_eps)


def t5_decode(params: Params, memory: torch.Tensor,
              tgt_tokens: torch.Tensor, cfg: T5Config,
              tp: Optional[TPGroup] = None) -> torch.Tensor:
    """memory [B, S, d] + tgt_tokens [B, T] -> logits [B, T, vocab];
    under ``tp`` gathered whole on every rank (inference: not
    differentiable over a vocab split)."""
    h = _decode_hidden(params, memory, tgt_tokens, cfg, tp)
    return gather_logits(_tied_logits(h, params["embed"]), tp,
                         cfg.vocab_size)


def t5_forward(params: Params, src_tokens: torch.Tensor,
               tgt_tokens: torch.Tensor, cfg: T5Config,
               tp: Optional[TPGroup] = None) -> torch.Tensor:
    return t5_decode(params, t5_encode(params, src_tokens, cfg, tp),
                     tgt_tokens, cfg, tp)


# ------------------------------------------------------------- generation
def _cached_self_attention(q, k_cache, v_cache, slot, cfg: T5Config):
    """q [B, 1, H, D] over decoder cache slots <= slot."""
    D = q.shape[-1]
    max_len = k_cache.shape[1]
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k_cache.float())
    logits = logits * (D ** -0.5)
    mask = torch.arange(max_len, device=q.device) <= slot
    logits = torch.where(mask[None, None, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v_cache.float())
    return out.to(q.dtype)


def _memory_attention(q, mem_k, mem_v, src_live, cfg: T5Config):
    """Cross-attention of q [B, 1, H, D] over precomputed memory K/V
    [B, S, H, D]; src_live [B, S] masks pad source positions."""
    D = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q.float(), mem_k.float())
    logits = logits * (D ** -0.5)
    if src_live is not None:
        logits = torch.where(src_live[:, None, None, :].bool(), logits,
                             -1e30)
    probs = torch.softmax(logits, dim=-1).to(mem_v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), mem_v.float())
    return out.to(q.dtype)


@torch.no_grad()
def t5_generate(params: Params, src_tokens: torch.Tensor, cfg: T5Config,
                *, bos_id: int = 1, max_new_tokens: int = 32,
                greedy: bool = True, temperature: float = 1.0,
                eos_id: Optional[int] = None,
                src_live: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """src_tokens [B, S] -> generated target tokens [B, max_new_tokens]
    int32 (starting after bos, which is NOT returned).

    The encoder runs once, every decoder layer's cross-attention K/V
    over the memory are computed once, and the decode loop runs a static
    trip count over a preallocated self-attention cache. After
    ``eos_id`` a row emits ``eos_id``. Sampling (``greedy=False``) draws
    from ``rng`` (a `torch.Generator` on the tokens' device): its bits
    are not JAX's threefry bits."""
    B = src_tokens.shape[0]
    dt = cfg.dtype
    dev = src_tokens.device
    memory = t5_encode(params, src_tokens, cfg)
    dec = params["decoder"]
    mem_k = torch.einsum("bsd,ldhk->lbshk", memory,
                         dec["cross_wk"].to(dt))       # [L, B, S, H, D]
    mem_v = torch.einsum("bsd,ldhk->lbshk", memory, dec["cross_wv"].to(dt))
    shape = (cfg.n_layers, B, max_new_tokens, cfg.n_heads, cfg.head_dim)
    self_k = torch.zeros(shape, dtype=dt, device=dev)
    self_v = torch.zeros(shape, dtype=dt, device=dev)
    per_layer = [{name: w[i] for name, w in dec.items()}
                 for i in range(cfg.n_layers)]
    embed = params["embed"]

    def decode_step(tok, slot):
        h = embed[tok.long()[:, None]].to(dt)               # [B, 1, d]
        positions = torch.full((B, 1), slot, device=dev)
        for i, layer in enumerate(per_layer):
            x = _rmsnorm(h, layer["self_norm"], cfg.norm_eps)
            q = _rope(_proj(x, layer["self_wq"], dt), positions,
                      cfg.rope_theta)
            k = _rope(_proj(x, layer["self_wk"], dt), positions,
                      cfg.rope_theta)
            v = _proj(x, layer["self_wv"], dt)
            self_k[i, :, slot] = k[:, 0]
            self_v[i, :, slot] = v[:, 0]
            o = _cached_self_attention(q, self_k[i], self_v[i], slot, cfg)
            h = h + torch.einsum("bshk,hkd->bsd", o,
                                 layer["self_wo"].to(dt))
            x = _rmsnorm(h, layer["cross_norm"], cfg.norm_eps)
            q = _proj(x, layer["cross_wq"], dt)
            o = _memory_attention(q, mem_k[i], mem_v[i], src_live, cfg)
            h = h + torch.einsum("bshk,hkd->bsd", o,
                                 layer["cross_wo"].to(dt))
            x = _rmsnorm(h, layer["mlp_norm"], cfg.norm_eps)
            h = h + _mlp(x, layer, cfg)
        h = _rmsnorm(h, params["dec_final_norm"], cfg.norm_eps)
        return _tied_logits(h, embed)[:, 0]

    tok = torch.full((B,), bos_id, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    out = torch.empty((B, max_new_tokens), dtype=torch.int32, device=dev)
    for slot in range(max_new_tokens):
        logits = decode_step(tok, slot)
        if greedy:
            nxt = logits.argmax(-1).to(torch.int32)
        else:
            probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=rng)[:, 0].to(
                torch.int32)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out[:, slot] = nxt
        tok = nxt
    return out


def t5_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: T5Config, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """batch: {'src': [B,S], 'tgt': [B,T+1]} — teacher forcing: the
    decoder sees tgt[:, :-1] and predicts tgt[:, 1:]; pad positions
    (cfg.pad_id) in the LABELS are masked out of the mean. ``tp``: the
    params are this rank's tp shards (the module docstring), the loss
    the same on every rank of the group."""
    dp.refuse_model_split("t5_loss")
    src = batch["src"]
    tgt_in = batch["tgt"][:, :-1]
    labels = batch["tgt"][:, 1:]
    h = _decode_hidden(params, t5_encode(params, src, cfg, tp), tgt_in,
                       cfg, tp)
    # the tied head: the embed's rows are the classes
    nll = vocab_nll(h, params["embed"], labels, tp, cfg.vocab_size,
                    _tied_logits, axis=0)
    live = (labels != cfg.pad_id).float()
    dp.count_tokens(live.sum())
    return (nll * live).sum() / torch.clamp(live.sum(), min=1.0)
