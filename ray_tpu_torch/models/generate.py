"""Autoregressive generation with a KV cache.

Port of `ray_tpu/models/generate.py`: the cache, the decoder-layer math
every cached path shares (`_layer_body`, with its `write_kv`/`attend`
injection seam), the cached forwards (with ragged-batch positions and
dead-slot masks), the sampling filters, solo `generate`, the streaming
`generate_stream` and `pad_prompts`. PyTorch runs eagerly, so the caches
are updated IN PLACE (the JAX functions return new arrays; the port
returns the same dict it was given, mutated), and JAX's jitted
streaming helpers are plain functions.

Sampling key schedule. Every sampled token is the argmax of the
temperature-scaled, filtered logits plus Gumbel noise, and the noise of
a row's i-th token depends only on (the request's seed, i, the vocab
index): a counter-based integer hash evaluated on the device, the role
`step_rng_key` (``fold_in(rng, i)``) plays in JAX. So a request's
sampled stream is the same whichever batch, row or step samples it,
which is what lets the engine reproduce solo `generate`. The hash does
not reproduce JAX's threefry bits: sampled tokens match the port's own
solo run, not the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import LlamaConfig, _logits, _rmsnorm, _rope

Params = Dict[str, Any]
Cache = Dict[str, Any]  # {"k","v": [L, B, max_len, KV, D]}

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def init_cache(cfg: LlamaConfig, batch_size: int,
               max_len: Optional[int] = None, *, device="cuda") -> Cache:
    """Zero KV cache ``[L, B, max_len, KV, D]`` in cfg.dtype."""
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _cached_attention(q, k_cache, v_cache, q_slots, kv_valid_len,
                      cfg: LlamaConfig, slot_live=None):
    """q: [B, S, H, D]; caches [B, max_len, KV, D]. Attends q (written
    at cache slots q_slots [B, S]) over cache slots < kv_valid_len,
    causally (slot index <= query slot). ``slot_live`` [B, max_len]
    (optional) additionally masks dead slots — left-pad positions in a
    ragged batch."""
    B, S, H, D = q.shape
    max_len = k_cache.shape[1]
    rep = H // k_cache.shape[2]
    k = k_cache.repeat_interleave(rep, dim=2)  # [B, max_len, H, D]
    v = v_cache.repeat_interleave(rep, dim=2)
    # f32 operands == the bf16 einsum with f32 accumulation (exact
    # products), the JAX preferred_element_type=float32.
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    logits = logits * (D ** -0.5)
    slots = torch.arange(max_len, device=q.device)
    mask = (slots[None, None, None, :] <= q_slots[:, None, :, None]) \
        & (slots[None, None, None, :] < kv_valid_len)
    if slot_live is not None:
        mask = mask & slot_live[:, None, None, :]
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)


def _lora_delta(x, ab, slots, dt):
    """Per-row gathered low-rank delta: x [B, S, n_in] through the
    row-selected adapter factors a [A, n_in, r] / b [A, r, n_out] (b
    pre-scaled by alpha/rank at pool registration) -> [B, S, n_out] in
    ``dt``. The gathered factors are cast to ``dt``, then ``(x @ a) @
    b`` per row, in the JAX op order. Slot 0 holds the all-zero null
    adapter, so base-only rows get an exactly-zero delta from the same
    ops."""
    a = ab["a"][slots].to(dt)                     # [B, n_in, r]
    b = ab["b"][slots].to(dt)                     # [B, r, n_out]
    return torch.bmm(torch.bmm(x, a), b)


def _layer_body(h, layer, k_cache, v_cache, positions, write_kv,
                q_slots, kv_valid_len, cfg: LlamaConfig, slot_live=None,
                attend=None, lora=None, lora_slots=None):
    """The decoder-layer math shared by ALL cached decode paths:
    rmsnorm → q/k/v projections → RoPE → cache write → causal cached
    attention → attn residual → gated MLP residual.

    The only things that differ between the paths are how this chunk's
    K/V land in storage and how attention reads them back, so exactly
    those are injected: ``write_kv(k_cache, v_cache, k, v) -> (k_cache,
    v_cache)`` always, and optionally ``attend(q, k_cache, v_cache) ->
    o`` when the storage is not a dense [B, max_len] cache row (the
    paged engine passes `ops.attention.paged_attention`, and the dense
    engine the same kernel over a block-table view of its cache).

    Multi-LoRA: ``lora`` (optional) is ONE layer's slice of the adapter
    pool's stacks ({name: {"a": [A, n_in, r], "b": [A, r, n_out]}}) and
    ``lora_slots`` [B] maps each row to its adapter slot; every
    projection named in the stacks gains a per-row `_lora_delta` on top
    of the shared base matmul (q/k/v before RoPE, wo on the flattened
    attention output, w_gate/w_up on x, w_down on ``silu(gate) * up``).
    With lora=None the body runs exactly the ops it ran before adapters
    existed."""
    dt = cfg.dtype
    x = _rmsnorm(h, layer["attn_norm"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", x, layer["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, layer["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, layer["wv"])
    if lora is not None:
        if "wq" in lora:
            q = q + _lora_delta(x, lora["wq"], lora_slots,
                                dt).reshape(q.shape)
        if "wk" in lora:
            k = k + _lora_delta(x, lora["wk"], lora_slots,
                                dt).reshape(k.shape)
        if "wv" in lora:
            v = v + _lora_delta(x, lora["wv"], lora_slots,
                                dt).reshape(v.shape)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    k_cache, v_cache = write_kv(k_cache, v_cache, k, v)
    if attend is not None:
        o = attend(q, k_cache, v_cache)
    else:
        o = _cached_attention(q, k_cache, v_cache, q_slots, kv_valid_len,
                              cfg, slot_live=slot_live)
    attn_out = torch.einsum("bshk,hkd->bsd", o, layer["wo"])
    if lora is not None and "wo" in lora:
        o_flat = o.reshape(o.shape[0], o.shape[1], -1)
        attn_out = attn_out + _lora_delta(o_flat, lora["wo"], lora_slots,
                                          dt)
    h = h + attn_out
    x = _rmsnorm(h, layer["mlp_norm"], cfg.norm_eps)
    gate = torch.einsum("bsd,df->bsf", x, layer["w_gate"])
    up = torch.einsum("bsd,df->bsf", x, layer["w_up"])
    if lora is not None:
        if "w_gate" in lora:
            gate = gate + _lora_delta(x, lora["w_gate"], lora_slots, dt)
        if "w_up" in lora:
            up = up + _lora_delta(x, lora["w_up"], lora_slots, dt)
    act = F.silu(gate) * up
    mlp_out = torch.einsum("bsf,fd->bsd", act, layer["w_down"])
    if lora is not None and "w_down" in lora:
        mlp_out = mlp_out + _lora_delta(act, lora["w_down"], lora_slots, dt)
    h = h + mlp_out
    return h, k_cache, v_cache


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's slice of the stacked weights."""
    return {name: w[i] for name, w in params["layers"].items()}


def _lora_layer(adapters: Optional[Params], i: int) -> Optional[Params]:
    """Layer i's slice of the adapter pool's stacks ({name: {"a": [L, A,
    n_in, r], "b": [L, A, r, n_out]}}), or None without adapters. The
    slices are views: a decode graph captured over them reads the
    stacks' storage, which the pool only ever writes in place."""
    if adapters is None:
        return None
    return {name: {"a": ab["a"][i], "b": ab["b"][i]}
            for name, ab in adapters.items()}


def forward_cached(params: Params, tokens: torch.Tensor, cache: Cache,
                   start: int, cfg: LlamaConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   slot_live: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """Run a token chunk [B, S] at cache offset `start`, writing its
    K/V into the cache in place. Returns (logits [B, S, vocab] f32,
    cache). Prefill is one call with the whole prompt; decode is S=1
    calls. ``positions`` overrides the RoPE position ids (ragged
    batches: left-pad rows start their real tokens at position 0);
    ``slot_live`` [B, max_len] masks dead (pad) cache slots out of every
    attention."""
    B, S = tokens.shape
    h = params["tok_embed"][tokens]
    slot_ids = start + torch.arange(S, device=tokens.device)[None, :]
    slot_ids = slot_ids.expand(B, S)
    if positions is None:
        positions = slot_ids
    kv_valid_len = start + S

    def write_kv(k_cache, v_cache, k, v):
        k_cache[:, start:start + S] = k.to(k_cache.dtype)
        v_cache[:, start:start + S] = v.to(v_cache.dtype)
        return k_cache, v_cache

    for i in range(cfg.n_layers):
        h, _, _ = _layer_body(h, _layer(params, i), cache["k"][i],
                              cache["v"][i], positions, write_kv, slot_ids,
                              kv_valid_len, cfg, slot_live=slot_live)
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params["lm_head"], cfg), cache


def forward_cached_rows(params: Params, tokens: torch.Tensor, cache: Cache,
                        starts: torch.Tensor, cfg: LlamaConfig, *,
                        adapters: Optional[Params] = None,
                        row_slot: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Cache]:
    """Run a token chunk [B, S] with a PER-ROW cache offset: row b's
    tokens land at cache slots ``starts[b] + i`` and attend that row's
    whole prefix ``[0, starts[b] + i]``. Returns (logits [B, S, vocab]
    f32, cache).

    ``cache["k"][i]`` / ``cache["v"][i]`` give layer i's [B, max_len,
    KV, D] view, and assigning it back stores the layer: a stacked
    tensor works as is, and the paged engine passes a per-layer view of
    its block pool, so only one layer's rows are ever materialized.
    Write-before-attend: the chunk's K/V are written before it attends,
    and slots at or beyond the chunk are excluded by the causal mask.

    Multi-LoRA: ``adapters`` is the adapter pool's full stack tree
    ({name: {"a": [L, A, n_in, r], "b": [L, A, r, n_out]}}) and
    ``row_slot`` [B] maps each row to its adapter slot (0 = base only);
    both None run the plain layers."""
    B, S = tokens.shape
    h = params["tok_embed"][tokens]
    slot_ids = starts.long()[:, None] + torch.arange(
        S, device=tokens.device)[None, :]                   # [B, S]
    bidx = torch.arange(B, device=tokens.device)[:, None]

    def write_kv(k_cache, v_cache, k, v):
        k_cache[bidx, slot_ids] = k.to(k_cache.dtype)
        v_cache[bidx, slot_ids] = v.to(v_cache.dtype)
        return k_cache, v_cache

    for i in range(cfg.n_layers):
        k_c, v_c = cache["k"][i], cache["v"][i]
        h, k_c, v_c = _layer_body(h, _layer(params, i), k_c, v_c, slot_ids,
                                  write_kv, slot_ids, k_c.shape[1], cfg,
                                  lora=_lora_layer(adapters, i),
                                  lora_slots=row_slot)
        cache["k"][i] = k_c
        cache["v"][i] = v_c
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params["lm_head"], cfg), cache


def filter_logits(logits: torch.Tensor, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus (top-p) candidate set to
    the float32 min, so sampling never picks them. [..., vocab] -> same
    shape. Top-k applies first, then top-p over the survivors; top_p=1.0
    and top_k >= vocab are no-ops."""
    neg = torch.finfo(torch.float32).min
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_k < logits.shape[-1]:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, neg, logits)
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_p < 1.0:
            # JAX's order: a stable ascending argsort, reversed, so
            # tied logits rank the HIGHER index first.
            idx = torch.argsort(logits, dim=-1, stable=True).flip(-1)
            sort = torch.gather(logits, -1, idx)
            probs = torch.softmax(sort.float(), dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            # keep tokens whose PRECEDING cumulative mass is still below
            # top_p; the argmax always survives (its preceding mass is 0)
            keep = (cum - probs) < top_p
            # scatter the keep-mask back through the argsort rather than
            # thresholding on the logit VALUE: a token tying the smallest
            # kept logit must not ride into the nucleus and inflate it
            inv = torch.argsort(idx, dim=-1)
            keep = torch.gather(keep, -1, inv)
            logits = torch.where(keep, logits, neg)
    return logits


def key_words(seed: int) -> Tuple[int, int]:
    """A 64-bit seed as the two 32-bit words of a sampling key."""
    return seed & _M32, (seed >> 32) & _M32


def key_data(rng) -> Tuple[int, int]:
    """Any accepted form of a sampling key as its two 32-bit words: an
    int is a 64-bit seed (`key_words`); a uint32[2] array or a pair of
    ints is a raw key, taken word for word (the form the fleet pins per
    request, the JAX package's ``_key_data``)."""
    if isinstance(rng, (int, np.integer)):
        return key_words(int(rng))
    words = np.asarray(rng).reshape(-1)
    if words.size != 2:
        raise ValueError(f"a raw sampling key has 2 words, got "
                         f"{words.size}")
    return int(words[0]) & _M32, int(words[1]) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer on int64 lanes holding [0, 2**32)
    (products stay below 2**63, so nothing overflows)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def _gumbel(row_keys: torch.Tensor, tok_idx: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """[B, vocab] f32 Gumbel noise; row b's draw depends only on
    (row_keys[b], tok_idx[b]) and the vocab index."""
    keys = row_keys.long()
    h = _mix32(_mix32(_mix32(keys[:, 0]) ^ keys[:, 1])
               ^ (tok_idx.long() & _M32))                      # [B]
    v = torch.arange(vocab, device=keys.device)
    x = _mix32((h[:, None] + v[None, :] * 0x9E3779B1) & _M32)
    x = _mix32(x ^ h[:, None])
    u = ((x >> 8).float() + 0.5) * 2.0 ** -24                 # (0, 1)
    return -torch.log(-torch.log(u))


def sample_rows(logits: torch.Tensor, row_keys: torch.Tensor,
                tok_idx: torch.Tensor, *, greedy: bool, temperature: float,
                top_k: Optional[int], top_p: Optional[float]
                ) -> torch.Tensor:
    """Per-ROW sampling on the device. logits [B, vocab] f32; row_keys
    [B, 2] (one key per row, two 32-bit words); tok_idx [B] (tokens that
    row has sampled so far). Greedy ignores keys (argmax)."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(temperature, 1e-6)
    scaled = filter_logits(scaled, top_k, top_p)
    return torch.argmax(
        scaled + _gumbel(row_keys, tok_idx, logits.shape[-1]), dim=-1)


def _check_sampling_knobs(greedy: bool, top_k, top_p) -> None:
    """greedy=True argmaxes — refuse to silently drop explicitly
    requested sampling filters."""
    if greedy and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p require greedy=False (greedy decoding ignores "
            "sampling filters)")


def _ragged(prompt_live: Optional[torch.Tensor], B: int, P: int,
            max_new_tokens: int, device):
    """(RoPE positions [B, P] or None, slot_live [B, P + max_new_tokens]
    or None, real prompt tokens per row [B]) for a left-padded batch:
    each row's real tokens take positions 0, 1, ... and pad slots are
    dead to every attention."""
    if prompt_live is None:
        return None, None, torch.full((B,), P, dtype=torch.int64,
                                      device=device)
    live = prompt_live.to(device=device, dtype=torch.bool)
    positions = torch.clamp(torch.cumsum(live.long(), dim=1) - 1, min=0)
    slot_live = torch.cat(
        [live, torch.ones((B, max_new_tokens), dtype=torch.bool,
                          device=device)], dim=1)
    return positions, slot_live, live.sum(dim=1)


@torch.no_grad()
def generate(params: Params, prompt: torch.Tensor, cfg: LlamaConfig, *,
             max_new_tokens: int = 32, temperature: float = 1.0,
             greedy: bool = True, eos_id: Optional[int] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             prompt_live: Optional[torch.Tensor] = None,
             rng=None) -> torch.Tensor:
    """prompt [B, P] int (on the params' device) -> [B, P +
    max_new_tokens].

    Prefill writes the prompt's K/V, then a loop emits max_new_tokens
    steps. With eos_id set, finished rows keep emitting eos (the caller
    trims). Sampling (greedy=False) draws from the temperature-scaled
    distribution restricted by `filter_logits`; token i of every row
    uses the noise of (``rng``, i) — see the module docstring — so a
    row's stream equals the serving engine's for a request submitted
    with the same ``rng`` (an int seed or a raw uint32[2] key,
    `key_data`).

    Ragged batches: LEFT-pad prompts to a common length and pass
    ``prompt_live`` [B, P] (True = real token). Pad slots are masked out
    of every attention and RoPE positions start at 0 on each row's
    first real token, so rows of different prompt lengths decode in one
    loop (see `pad_prompts`)."""
    B, P = prompt.shape
    max_len = P + max_new_tokens
    if max_len > cfg.max_seq_len:
        raise ValueError(f"{max_len} exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    _check_sampling_knobs(greedy, top_k, top_p)
    device = prompt.device
    positions, slot_live, pos = _ragged(prompt_live, B, P, max_new_tokens,
                                        device)
    cache = init_cache(cfg, B, max_len, device=device)
    logits, cache = forward_cached(params, prompt, cache, 0, cfg,
                                   positions=positions, slot_live=slot_live)
    last = logits[:, -1]
    keys = torch.tensor([key_data(0 if rng is None else rng)] * B,
                        dtype=torch.int64, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    toks = []
    for i in range(max_new_tokens):
        tok = sample_rows(last, keys,
                          torch.full((B,), i, device=device),
                          greedy=greedy, temperature=temperature,
                          top_k=top_k, top_p=top_p)
        if eos_id is not None:
            tok = torch.where(done, eos_id, tok)
            done = done | (tok == eos_id)
        toks.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = forward_cached(
                params, tok[:, None], cache, P + i, cfg,
                positions=(pos + i)[:, None], slot_live=slot_live)
            last = logits[:, 0]
    return torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)],
                     dim=1)


def generate_stream(params: Params, prompt: torch.Tensor,
                    cfg: LlamaConfig, *, max_new_tokens: int = 32,
                    eos_id: Optional[int] = None, temperature: float = 1.0,
                    greedy: bool = True, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    prompt_live: Optional[torch.Tensor] = None,
                    rng=None):
    """Decode as a Python generator yielding one [B] numpy token array
    per step — the token-streaming path (`generate` is the batch path).
    Stops early once every row has emitted eos. Ragged batches and
    sampling take `generate`'s arguments and key schedule, so a
    streamed run yields `generate`'s tokens. Validation runs eagerly:
    bad knobs fail at the call site, not at the first ``next()``."""
    B, P = prompt.shape
    if P + max_new_tokens > cfg.max_seq_len:
        raise ValueError(f"{P + max_new_tokens} exceeds max_seq_len "
                         f"{cfg.max_seq_len}")
    _check_sampling_knobs(greedy, top_k, top_p)
    return _stream_inner(params, prompt, cfg, max_new_tokens, eos_id,
                         temperature, greedy, top_k, top_p, prompt_live,
                         rng)


@torch.no_grad()
def _prefill_step(params, prompt, cache, cfg, positions=None,
                  slot_live=None):
    return forward_cached(params, prompt, cache, 0, cfg,
                          positions=positions, slot_live=slot_live)


@torch.no_grad()
def _decode_step(params, tok, cache, slot, pos_ids, cfg, slot_live=None):
    return forward_cached(params, tok[:, None], cache, slot, cfg,
                          positions=pos_ids[:, None], slot_live=slot_live)


def _stream_inner(params, prompt, cfg, max_new_tokens, eos_id,
                  temperature, greedy, top_k, top_p, prompt_live, rng):
    B, P = prompt.shape
    device = prompt.device
    positions, slot_live, pos = _ragged(prompt_live, B, P, max_new_tokens,
                                        device)
    cache = init_cache(cfg, B, P + max_new_tokens, device=device)
    logits, cache = _prefill_step(params, prompt, cache, cfg,
                                  positions=positions, slot_live=slot_live)
    last = logits[:, -1]
    keys = torch.tensor([key_data(0 if rng is None else rng)] * B,
                        dtype=torch.int64, device=device)
    done = np.zeros((B,), bool)
    for step in range(max_new_tokens):
        tok = sample_rows(last, keys, torch.full((B,), step, device=device),
                          greedy=greedy, temperature=temperature,
                          top_k=top_k, top_p=top_p)
        if eos_id is not None:
            tok = torch.where(torch.from_numpy(done).to(device), eos_id, tok)
        # one host token per step is this path's contract
        tok_np = tok.cpu().numpy()
        yield tok_np
        if eos_id is not None:
            done = done | (tok_np == eos_id)
            if done.all():
                return
        if step + 1 < max_new_tokens:
            logits, cache = _decode_step(params, tok, cache, P + step,
                                         pos + step, cfg,
                                         slot_live=slot_live)
            last = logits[:, 0]


def pad_prompts(prompts, pad_id: int = 0, *, bucket_len: bool = False,
                pad_batch_to: Optional[int] = None):
    """Left-pad a ragged list of token lists to a dense [B, P] int32
    numpy array + the matching ``prompt_live`` mask for `generate`.

    Empty prompts are rejected: a fully-dead row has no last real token
    to sample from — prepend a BOS token instead. ``bucket_len=True``
    rounds P up to the next power of two, and ``pad_batch_to=N`` appends
    single-token filler rows up to batch N (the caller slices its
    outputs back to the real row count)."""
    if not prompts:
        raise ValueError("pad_prompts needs at least one prompt")
    if any(len(p) == 0 for p in prompts):
        raise ValueError(
            "empty prompt: generation needs at least one real token "
            "per row (prepend a BOS token)")
    rows = list(prompts)
    if pad_batch_to is not None and len(rows) < pad_batch_to:
        rows += [[pad_id]] * (pad_batch_to - len(rows))
    P = max(len(p) for p in rows)
    if bucket_len:
        P = 1 << (P - 1).bit_length()
    out = np.full((len(rows), P), pad_id, np.int32)
    live = np.zeros((len(rows), P), bool)
    for i, p in enumerate(rows):
        out[i, P - len(p):] = np.asarray(p, np.int32)
        live[i, P - len(p):] = True
    return out, live
