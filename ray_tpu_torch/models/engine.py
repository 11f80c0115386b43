"""Continuous-batching decode engine: a dense per-slot KV cache or a
paged KV block pool, fused multi-step decode, an async run-ahead ring,
and the paged engine's memory plane.

Port of `ray_tpu/models/engine.py`. B fixed decode slots advance
together, every row at its OWN cache offset, in one of two KV layouts:

- dense (the default, ``paged=False``): one cache ``[L, B, max_len, KV,
  D]`` (`generate.init_cache`), row b's K/V in slot row b;
- paged (``paged=True``): every row's K/V in refcounted blocks of ONE
  pool ``[L, NB, T, KV, D]`` addressed through per-row block tables
  (`models/block_pool.py`). When decode growth runs the pool dry, the
  newest row is PREEMPTED and re-queued at the front: ``preempt="swap"``
  (the default) copies its blocks to pinned host memory and scatters
  them back into a fresh chain on re-admission; ``preempt="recompute"``
  drops them and re-prefills prompt + emitted tokens.

The paged pool may hold int8 or fp8-e4m3 values (``kv_quant=``) with two
f32 scale slabs ``[L, NB, KV]`` indexed by the same block ids
(`ops/kv_quant.py`): prefill dequantizes the rows' view to f32 and
requantizes it on write-back, decode writes through `paged_quant_write`
and B2 dequantizes inside its page loads. Copy-on-write and swap move
the quantized bytes and their scales verbatim.

The prefix cache (``prefix_cache=True``, `models/prefix_cache.py`)
indexes full prompt blocks in a trie. The dense engine copies matched
blocks from its own pool into the row (`_prefix_copy_in`) and copies
newly prefilled ones out (`_prefix_copy_out`); the paged engine SHARES
them by reference count with zero copies, and a full-prompt hit copies
only its tail block (copy-on-write). ``scheduler="prefix"`` defers a
burst's followers one round so they admit warm. ``prefill_chunk=``
splits each prompt into chunks, one per step, interleaved with decode.

Admission binds a request to its slot row and prefills its prompt:
same-length-bucket admissions share one batched prefill (`_prefill_rows`
/ `_prefill_rows_paged`), padded to a power of two rows by repeating the
last, which runs the shared `forward_cached_rows` math one layer at a
time over row views of the cache. The last-prompt logits stay on the
device in `_last_logits`; the decode loop samples the first token from
them.

Decode runs H iterations per dispatch (`_decode_multi` /
`_decode_multi_paged`, one horizon loop) with every per-row decision on
the device: per-row sampling, eos/budget/room freezing, the K/V write at
each row's frontier slot, attention. The loop reads its row state from
persistent device buffers and writes it back there, so a RUN-AHEAD
dispatch chains off the previous one on the device with no host sync
(the JAX engine's ``chain``). The [H, B] token block goes to the host in
one asynchronous copy (`_host_async`) and is pulled one or more
dispatches later (`_device_get`) and replayed (`_emit_block`).
``pipeline_depth`` (default 2) bounds the ring of dispatched, undrained
blocks during pure-decode stretches; the ring flushes before any
admission and at end of stream. Tokens are identical at every depth.

On the card the decode loop is a CUDA graph per (H, all-greedy) key —
the port's form of JAX's one compiled program per horizon; on the CPU
the same function runs eagerly. Every device write outside the loop
(prefill, copy-in/out, copy-on-write, swap-in) is in place, so the
graphs keep reading the same tensors. Decode attention runs on the
hand-written paged-attention kernel (`ops.attention.paged_attention`,
B2): through the block tables on the paged path (bf16, int8 or fp8
pages), and over a fixed block-table VIEW of the dense cache on the
dense path (no copy: row b's slots are blocks b*MB .. b*MB + MB - 1).
The CPU and ``attn_impl="reference"`` take the plain attention.

Consistency contract (tested on the CPU): greedy output equals the JAX
package's engine (dense and paged, every pipeline depth and horizon,
swap and recompute preemption, the prefix cache and chunked prefill)
and solo `generate`; a quantized pool's bytes and scales equal the JAX
engine's after prefill and decode; sampled output equals the port's own
solo `generate` under the same per-request seed.

Speculative decoding (``draft_params=``, ``draft_cfg=``,
``spec_window=``) turns each decode dispatch into ONE batched
draft-propose / target-verify round (`_spec_loop`): the draft's K/V live
in a second plane (a dense cache, or a private block pool of the target
pool's dtype with its own scale slabs), the round writes both planes
and accepts on the device (`_spec_accept`), and on the card it is a
CUDA graph per ("spec", W, all-greedy) key whose attention runs on B2
at S = W+1 query rows (verify) and S = 2 / 1 (draft). Greedy rows emit
solo greedy `generate`'s tokens whatever the draft proposes; sampled
rows take one sampled token per round.

Multi-LoRA serving (``lora=LoraConfig(...)``, ``max_live_adapters=``)
serves many fine-tunes of the base model in one batch: each row adds its
adapter's low-rank delta on the q/k/v/o and MLP projections
(`generate._lora_delta`), gathered per row from the device stacks of
`models/adapter_pool.py` through a [B] slot lane in `_din` (slot 0 is
the all-zero null adapter, so base rows are exact). A cold adapter
defers its request at the admission gate while its weights are copied
to the device; the copy is committed into a slot IN PLACE, with no
dispatch in flight, so the decode graphs stay valid. Adapter rows
bypass the prefix cache. ``scheduler="adapter"`` groups admissions by
residency. Speculative decoding and LoRA are exclusive, as in JAX.

The fleet surface (`models/fleet.py` serves N engines as one system):
``submit(resume_tokens=)`` resumes a request that already emitted tokens
on a replica that died (prompt + those tokens are re-prefilled, the
budget and the sampling stream continue at their count); `halt`
abandons the engine's work without completing it and keeps ``results``
for the fleet to rebuild from; ``prefill_only`` parks each row whose
prefill completed (`handoff_ready`) instead of decoding it, and
`export_request` / `import_request` move such a request to another
engine: a paged payload carries the row's pages (quantized bytes and
scale rows verbatim) and its logits, which the importer scatters back
through the swap path with no re-prefill; anything else re-prefills.
Every engine registers weakly with `ray_tpu_torch.util.state.serving`.

Tensor parallelism (``tp=n`` or ``mesh=`` with a "tp" axis, one
process per rank, `parallel.tensor_parallel`): each rank holds its
shards of the weights (heads, MLP columns and vocab rows by JAX's
pruned serving rules, ``"kv"`` on tp) and a cache or pool of the kv
heads its q heads read (the KV axis splits when ``n_kv_heads`` divides
tp); the draft plane and the adapter stacks shard the same way. Every
rank runs the same host loop on the same submits and takes the same
decisions (those that read the clock use rank 0's reading), the logits
are gathered whole, so every rank samples the same replicated [H, B]
token block, and host-transfer bytes per token do not grow with tp. The
decode loop is captured only when the group's collectives can be
(NCCL); a handoff payload is made whole over tp, so any engine imports
it.

Not ported yet, raising NotImplementedError that names its ROADMAP.md
item: the runtime sanitizer (A14).
"""

from __future__ import annotations

import collections
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.models.block_pool import BlockPool
from ray_tpu_torch.models.engine_metrics import (EngineMetrics,
                                                 NullEngineMetrics)
from ray_tpu_torch.models.engine_trace import resolve_tracer
from ray_tpu_torch.models.adapter_pool import (ADAPTER_STATS_KEYS,
                                               AdapterPool)
from ray_tpu_torch.models.generate import (_check_sampling_knobs, _embed,
                                           _head, _layer, _layer_body,
                                           _lora_layer, _rows_logits,
                                           init_cache, key_data, key_words,
                                           sample_rows)
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.models.prefix_cache import PrefixCacheIndex, block_bytes
from ray_tpu_torch.models.scheduler import (EngineDraining,
                                            EngineOverloaded, FIFOPolicy,
                                            SchedulerPolicy, SubmitTimeout,
                                            make_policy)
from ray_tpu_torch.models.speculative import SpecMetrics, SpecStats
from ray_tpu_torch.ops import paged_attention_kernel as pak
from ray_tpu_torch.ops.attention import paged_attention
from ray_tpu_torch.ops.kv_quant import (KVQuantSpec, block_scale,
                                        dequantize, paged_quant_write,
                                        quantize, raw, resolve_kv_quant)
from ray_tpu_torch.parallel.tensor_parallel import (TPGroup, collective,
                                                    gather_logits, is_split,
                                                    local_heads, tp_group)
from ray_tpu_torch.util.state.serving import register_engine

Params = Dict[str, Any]

# Slots per block of the dense cache's block-table view on the card
# (B2's paged path serves 32-slot blocks at the same widths).
DENSE_VIEW_TOKENS = 32


def _pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP.md, Queue A "
        f"item {item})")


# ---------------------------------------------------------------------------
# Device->host transfer funnels
# ---------------------------------------------------------------------------

class _HostBlock:
    """A dispatched token block on its way to the host: the tensor that
    will hold it (pinned host memory on the card) and the CUDA event
    recorded after its copy (None on the CPU, where the block already
    is host memory)."""

    __slots__ = ("data", "event")

    def __init__(self, data: torch.Tensor, event):
        self.data = data
        self.event = event


def _host_async(x: torch.Tensor) -> _HostBlock:
    """Start the engine's async device->host copy of a dispatched token
    block (pairs with the `_device_get` wait in `_drain_one`). On the
    card: a ``non_blocking`` copy into pinned host memory and an event
    recorded after it, so the host never waits here. The pinned buffer
    comes from PyTorch's caching host allocator, which records the copy
    on it and does not hand it out again before the copy is done."""
    if not x.is_cuda:
        return _HostBlock(x, None)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return _HostBlock(host, event)


def _device_get(x: _HostBlock) -> np.ndarray:
    """The engine's ONLY device->host transfer of a token block: wait
    for its copy and return it. Every pull in the serving loop funnels
    through here so the engine counts host syncs
    (`host_syncs_per_token`) and tests can wrap it to GATE the transfer
    budget: one pull per dispatched block, and under the async pipeline
    the next dispatch is issued BEFORE this wait."""
    if x.event is not None:
        x.event.synchronize()
    return x.data.numpy()


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

class _DenseRows:
    """Layer-at-a-time row view of one dense cache tensor for prefill:
    ``view[i]`` gathers layer i's [N, max_len, KV, D] rows ``rows``;
    ``view[i] = x`` scatters them back (each row only modified its own
    suffix slots)."""

    def __init__(self, cache: torch.Tensor, rows: torch.Tensor):
        self.cache = cache
        self.rows = rows.long()

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.cache[i][self.rows]

    def __setitem__(self, i: int, view: torch.Tensor) -> None:
        self.cache[i][self.rows] = view


class _PagedRows:
    """Layer-at-a-time row view of one pool tensor for prefill:
    ``view[i]`` gathers layer i's [N, MB*T, KV, D] rows through the
    block tables ``bt`` [N, MB]; ``view[i] = x`` scatters them back.
    Because MB*T == max_len, the view has the dense cache row's shape.
    The whole-view write-back is safe: each row only modifies its own
    suffix slots (shared prefix blocks sit below its start and are
    rewritten with the bytes just gathered), and duplicate table
    entries are shared blocks (same bytes), padded rows (same values)
    or the null block (garbage nobody reads)."""

    def __init__(self, pool: torch.Tensor, bt: torch.Tensor):
        self.pool = pool
        self.bt = bt.long()

    def __getitem__(self, i: int) -> torch.Tensor:
        blk = self.pool[i][self.bt]                # [N, MB, T, KV, D]
        return blk.reshape(blk.shape[0], -1, *blk.shape[3:])

    def __setitem__(self, i: int, view: torch.Tensor) -> None:
        T = self.pool.shape[2]
        self.pool[i][self.bt] = view.reshape(
            view.shape[0], -1, T, *view.shape[2:])


class _QuantPagedRows(_PagedRows):
    """`_PagedRows` over a quantized pool and its scale slab ``scales``
    [L, NB, KV]: ``view[i]`` dequantizes the gathered blocks to an f32
    view (kept f32 end to end: requantization is byte-stable only
    then); ``view[i] = x`` zeroes every slot at or past the row's valid
    length ``valid`` [N] (bucket filler and a previous tenant's garbage
    must not coarsen a block's absmax), recomputes each block's scale
    and requantizes the whole view. Shared prefix blocks come back
    byte-identical."""

    def __init__(self, pool: torch.Tensor, scales: torch.Tensor,
                 bt: torch.Tensor, valid: torch.Tensor, qspec: KVQuantSpec):
        super().__init__(pool, bt)
        self.scales = scales
        self.qspec = qspec
        N, MB = bt.shape
        T = pool.shape[2]
        slots = torch.arange(MB * T, device=bt.device)
        self.live = (slots[None, :] < valid[:, None]).view(N, MB, T, 1, 1)

    def __getitem__(self, i: int) -> torch.Tensor:
        blk = raw(self.pool[i])[self.bt].view(self.pool.dtype)
        x = dequantize(blk, self.scales[i][self.bt][:, :, None, :, None])
        return x.reshape(x.shape[0], -1, *x.shape[3:])

    def __setitem__(self, i: int, view: torch.Tensor) -> None:
        T = self.pool.shape[2]
        x = view.float().reshape(view.shape[0], -1, T, *view.shape[2:])
        x = torch.where(self.live, x, 0.0)
        s = block_scale(x.abs().amax(dim=(2, 4)), self.qspec)  # [N,MB,KV]
        raw(self.pool[i])[self.bt] = raw(
            quantize(x, s[:, :, None, :, None], self.qspec))
        self.scales[i][self.bt] = s


def _prefill_views(params: Params, prompts: torch.Tensor, cache,
                   last_logits: torch.Tensor, rows: torch.Tensor,
                   starts: torch.Tensor, last_idx: torch.Tensor,
                   cfg: LlamaConfig, adapters: Optional[Params] = None,
                   row_slot: Optional[torch.Tensor] = None,
                   tp: Optional[TPGroup] = None) -> None:
    """N same-bucket chunks [N, Cb] run `forward_cached_rows` over the
    row views ``cache``, and each row's last-real-token logits land in
    ``last_logits[rows]``. Filler tokens past a chunk's true length
    write K/V beyond its frontier, which every later mask excludes until
    the next chunk or decode overwrites them; only the logits at
    ``last_idx`` are read. ``rows`` may repeat (power-of-two padding
    repeats the last row verbatim): duplicate scatters write identical
    values. ``adapters`` / ``row_slot`` (the adapter pool's stacks and
    this batch's per-chunk slot lane [N]) add the rows' LoRA deltas.
    Under ``tp`` only the rows' last-token logits are gathered whole."""
    logits = _rows_logits(params, prompts, cache, starts, cfg, adapters,
                          row_slot, tp)
    n = prompts.shape[0]
    last_logits[rows.long()] = gather_logits(
        logits[torch.arange(n, device=logits.device), last_idx.long()], tp,
        cfg.vocab_size)


@torch.no_grad()
def _prefill_rows(params: Params, prompts: torch.Tensor, cache,
                  last_logits: torch.Tensor, rows: torch.Tensor,
                  starts: torch.Tensor, last_idx: torch.Tensor,
                  cfg: LlamaConfig, adapters: Optional[Params] = None,
                  row_slot: Optional[torch.Tensor] = None,
                  tp: Optional[TPGroup] = None) -> None:
    """Batched admission prefill into the dense cache, in place: row
    ``rows[n]`` of the cache takes chunk n at offset ``starts[n]`` (0
    cold, the copied prefix warm, the chunk frontier chunked)."""
    views = {"k": _DenseRows(cache["k"], rows),
             "v": _DenseRows(cache["v"], rows)}
    _prefill_views(params, prompts, views, last_logits, rows, starts,
                   last_idx, cfg, adapters, row_slot, tp)


@torch.no_grad()
def _prefill_rows_paged(params: Params, prompts: torch.Tensor,
                        pool_k: torch.Tensor, pool_v: torch.Tensor,
                        last_logits: torch.Tensor, bt: torch.Tensor,
                        rows: torch.Tensor, starts: torch.Tensor,
                        last_idx: torch.Tensor, cfg: LlamaConfig,
                        scale_k: Optional[torch.Tensor] = None,
                        scale_v: Optional[torch.Tensor] = None,
                        qspec: Optional[KVQuantSpec] = None,
                        adapters: Optional[Params] = None,
                        row_slot: Optional[torch.Tensor] = None,
                        tp: Optional[TPGroup] = None) -> None:
    """Batched admission prefill into the pool, in place, through the
    rows' block tables ``bt`` [N, MB]. A quantized pool (``qspec`` and
    the f32 scale slabs) runs the same math on the dequantized f32 view
    and requantizes it on write-back over each row's valid slots
    ``[0, starts + last_idx + 1)``."""
    if qspec is None:
        views = {"k": _PagedRows(pool_k, bt), "v": _PagedRows(pool_v, bt)}
    else:
        valid = starts + last_idx + 1
        views = {"k": _QuantPagedRows(pool_k, scale_k, bt, valid, qspec),
                 "v": _QuantPagedRows(pool_v, scale_v, bt, valid, qspec)}
    _prefill_views(params, prompts, views, last_logits, rows, starts,
                   last_idx, cfg, adapters, row_slot, tp)


@torch.no_grad()
def _prefix_copy_in(cache, pool_k: torch.Tensor, pool_v: torch.Tensor,
                    block_ids: torch.Tensor, rows: torch.Tensor,
                    block_tokens: int) -> None:
    """Copy cached prefix blocks into dense slot rows, in place: row
    ``rows[n]`` takes blocks ``block_ids[n]`` [N, nb] at slots [0,
    nb*T). N and nb are power-of-two padded by the caller (repeat the
    last row / the last block): duplicate rows write identical values,
    and padded trailing blocks write garbage beyond the matched prefix,
    which the suffix prefill and decode overwrite before any mask
    admits it."""
    bids = block_ids.long()
    span = bids.shape[1] * block_tokens
    for name, pool in (("k", pool_k), ("v", pool_v)):
        blk = pool[:, bids]                       # [L, N, nb, T, KV, D]
        cache[name][:, rows.long(), :span] = blk.reshape(
            blk.shape[0], blk.shape[1], span, *blk.shape[4:])


@torch.no_grad()
def _prefix_copy_out(cache, pool_k: torch.Tensor, pool_v: torch.Tensor,
                     row: int, start_slot: int, block_ids: torch.Tensor,
                     block_tokens: int) -> None:
    """Insert a freshly prefilled prefix segment into the pool, in
    place: slots [start_slot, start_slot + nb*T) of slot row ``row`` go
    to blocks ``block_ids`` [nb]. nb is power-of-two padded with the
    scratch block 0, which takes the padding's clamped slots and is
    never indexed. Enqueued right after the prefill that produced the
    segment, so a copy-in enqueued earlier still reads the blocks' old
    content."""
    nb = block_ids.shape[0]
    span = nb * block_tokens
    slots = torch.arange(start_slot, start_slot + span,
                         device=block_ids.device).clamp_(
                             max=cache["k"].shape[2] - 1)
    for name, pool in (("k", pool_k), ("v", pool_v)):
        seg = cache[name][:, row][:, slots]           # [L, span, KV, D]
        pool[:, block_ids.long()] = seg.reshape(
            seg.shape[0], nb, block_tokens, *seg.shape[2:])


def _decode_layer_rows(h, layer, k_cache, v_cache, slots,
                       cfg: LlamaConfig, max_len: int, view_bt=None,
                       lora=None, lora_slots=None,
                       tp: Optional[TPGroup] = None):
    """One decoder layer, S new tokens per row (S=1 in decode, S > 1 in
    a speculative round), each row writing its K/V at its own slots and
    attending its own prefix, per query causally. h: [B, S, d]; caches
    [B, span, KV, D] (span >= max_len); slots: [B, S].

    ``view_bt`` [B, span/T] int32 (the card) runs attention on B2 over
    the cache viewed as pages of T slots — ``bt[b, p] = b*(span/T) +
    p``, no copy — with ``kv_valid_len = max_len``; it computes the
    dense mask exactly (``slot <= q_slot`` and ``slot < max_len``).
    Without it, the plain `_cached_attention` runs, as in the JAX dense
    path. ``lora`` / ``lora_slots``: this layer's adapter stacks and the
    rows' slot lane (`_layer_body`)."""
    B = h.shape[0]
    bidx = torch.arange(B, device=h.device)[:, None]
    sl = slots.long()

    def write_kv(k_cache, v_cache, k, v):
        k_cache[bidx, sl] = k.to(k_cache.dtype)
        v_cache[bidx, sl] = v.to(v_cache.dtype)
        return k_cache, v_cache

    attend = None
    if view_bt is not None:
        T = k_cache.shape[1] // view_bt.shape[1]
        q_slots = slots.to(torch.int32)

        def attend(q, k_cache, v_cache):
            pages = (-1, T) + tuple(k_cache.shape[2:])
            return paged_attention(q, k_cache.view(pages),
                                   v_cache.view(pages), view_bt, q_slots,
                                   kv_valid_len=max_len, impl="kernel")

    h, _, _ = _layer_body(h, layer, k_cache, v_cache, sl, write_kv, sl,
                          max_len, cfg, attend=attend, lora=lora,
                          lora_slots=lora_slots, tp=tp)
    return h


def _spec_core(params: Params, toks: torch.Tensor, cache,
               starts: torch.Tensor, cfg: LlamaConfig, max_len: int,
               view_bt=None, adapters: Optional[Params] = None,
               row_slot: Optional[torch.Tensor] = None,
               tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Feed each row's chunk ``toks`` [B, S] at slots ``starts[b] +
    arange(S)`` of the dense cache (in place); returns the logits [B, S,
    vocab] f32. Decode is its S=1 case (`_decode_core`); a speculative
    round's draft steps and target verify are the rest. Dead/frozen rows
    compute discarded garbage at their own slots, which every mask
    excludes until the slot's next write. ``adapters`` / ``row_slot``
    (the adapter pool's stacks and the [B] slot lane) add each row's
    LoRA deltas. ``tp``: the rank's shards; the logits come back whole."""
    S = toks.shape[1]
    slots = starts.long()[:, None] + torch.arange(
        S, device=toks.device)[None, :]
    h = _embed(params, toks, cfg, tp)
    for i in range(cfg.n_layers):
        h = _decode_layer_rows(h, _layer(params, i), cache["k"][i],
                               cache["v"][i], slots, cfg, max_len, view_bt,
                               _lora_layer(adapters, i), row_slot, tp)
    return gather_logits(_head(params, h, cfg), tp, cfg.vocab_size)


def _decode_core(params: Params, toks: torch.Tensor, cache,
                 row_len: torch.Tensor, cfg: LlamaConfig, max_len: int,
                 view_bt=None, adapters: Optional[Params] = None,
                 row_slot: Optional[torch.Tensor] = None,
                 tp: Optional[TPGroup] = None) -> torch.Tensor:
    """One decode step for ALL slots of the dense cache: row b's token
    ``toks[b]`` is written at slot ``row_len[b]`` and attends slots
    [0, row_len[b]]. Returns next-token logits [B, vocab] f32; the
    cache is updated in place."""
    return _spec_core(params, toks[:, None], cache, row_len, cfg, max_len,
                      view_bt, adapters, row_slot, tp)[:, 0]


def _decode_layer_rows_paged(h, layer, k_pages, v_pages, bt, slots,
                             cfg: LlamaConfig, k_scale=None, v_scale=None,
                             qspec: Optional[KVQuantSpec] = None,
                             lora=None, lora_slots=None,
                             tp: Optional[TPGroup] = None):
    """One decoder layer, S new tokens per row, against the pool: row
    b's new K/V land in physical blocks ``bt[b, slot // T]`` at offsets
    ``slot % T`` and its S queries attend back through the block table,
    per query causally (slots [B, S]). Frontier blocks are private to
    their row (a full-prompt prefix hit copies its tail block at
    admission), so live rows' writes never collide; retired/empty rows,
    and a speculative round's overshoot slots past a row's chain, write
    garbage into the null block, which no live query attends.

    A quantized pool (``qspec`` with this layer's ``k_scale`` /
    ``v_scale`` [NB, KV]) writes the whole S-wide window through
    `paged_quant_write`'s read-modify-write (a window may straddle a
    block boundary) and hands B2 the scales, which it applies inside
    its page loads."""
    B = h.shape[0]
    T = k_pages.shape[1]
    span = bt.shape[1] * T                 # == engine max_len
    bidx = torch.arange(B, device=h.device)[:, None]
    sl = slots.long()
    q_slots = slots.to(torch.int32)

    if qspec is None:
        blk = bt[bidx, sl // T].long()     # [B, S] physical blocks
        off = sl % T

        def write_kv(k_pages, v_pages, k, v):
            k_pages[blk, off] = k.to(k_pages.dtype)
            v_pages[blk, off] = v.to(v_pages.dtype)
            return k_pages, v_pages
    else:
        def write_kv(k_pages, v_pages, k, v):
            paged_quant_write(k_pages, k_scale, bt, sl[:, 0], k, qspec)
            paged_quant_write(v_pages, v_scale, bt, sl[:, 0], v, qspec)
            return k_pages, v_pages

    def attend(q, k_pages, v_pages):
        return paged_attention(q, k_pages, v_pages, bt, q_slots,
                               kv_valid_len=span, k_scale=k_scale,
                               v_scale=v_scale, impl=cfg.attn_impl)

    h, _, _ = _layer_body(h, layer, k_pages, v_pages, sl, write_kv, sl,
                          span, cfg, attend=attend, lora=lora,
                          lora_slots=lora_slots, tp=tp)
    return h


def _spec_core_paged(params: Params, toks: torch.Tensor,
                     pool_k: torch.Tensor, pool_v: torch.Tensor,
                     bt: torch.Tensor, starts: torch.Tensor,
                     cfg: LlamaConfig, scale_k=None, scale_v=None,
                     qspec: Optional[KVQuantSpec] = None,
                     adapters: Optional[Params] = None,
                     row_slot: Optional[torch.Tensor] = None,
                     tp: Optional[TPGroup] = None) -> torch.Tensor:
    """`_spec_core` against the pool (block tables ``bt``): the chunk
    [B, S] at slots ``starts + arange(S)``, logits [B, S, vocab]; a
    quantized pool passes its scale slabs [L, NB, KV] too."""
    S = toks.shape[1]
    slots = starts.long()[:, None] + torch.arange(
        S, device=toks.device)[None, :]
    h = _embed(params, toks, cfg, tp)
    for i in range(cfg.n_layers):
        scales = ((None, None) if qspec is None
                  else (scale_k[i], scale_v[i]))
        h = _decode_layer_rows_paged(h, _layer(params, i), pool_k[i],
                                     pool_v[i], bt, slots, cfg, *scales,
                                     qspec=qspec,
                                     lora=_lora_layer(adapters, i),
                                     lora_slots=row_slot, tp=tp)
    return gather_logits(_head(params, h, cfg), tp, cfg.vocab_size)


def _decode_core_paged(params: Params, toks: torch.Tensor,
                       pool_k: torch.Tensor, pool_v: torch.Tensor,
                       bt: torch.Tensor, row_len: torch.Tensor,
                       cfg: LlamaConfig, scale_k=None, scale_v=None,
                       qspec: Optional[KVQuantSpec] = None,
                       adapters: Optional[Params] = None,
                       row_slot: Optional[torch.Tensor] = None,
                       tp: Optional[TPGroup] = None) -> torch.Tensor:
    """`_decode_core` against the pool: one token per row at slot
    ``row_len``, next-token logits [B, vocab]."""
    return _spec_core_paged(params, toks[:, None], pool_k, pool_v, bt,
                            row_len, cfg, scale_k, scale_v, qspec,
                            adapters, row_slot, tp)[:, 0]


def _decode_loop(step, last_logits, row_len, active, budget, tok_idx,
                 row_keys, row_greedy, temperature: float, horizon: int,
                 greedy: bool, top_k: Optional[int], top_p: Optional[float],
                 eos_id: Optional[int], max_len: int):
    """`horizon` decode iterations with every per-row decision on the
    device; ``step(tok, row_len) -> logits`` is one decode step of the
    cache layout. Per iteration (mirrored by the host replay in
    `DecodeEngine._emit_block`):

        tok      = sample(last_logits)          # emit if active, else -1
        budget  -= active;  tok_idx += active
        done     = budget <= 0 | row_len+1 >= max_len | tok == eos
        feed tok at slot row_len (all rows; frozen rows write garbage
        one slot past their content, masked everywhere)
        row_len += active & ~done;  last_logits updates where continuing

    ``max_len`` is the ENGINE's, whatever the cache's padded length.
    Returns (toks [horizon, B] int32, last_logits, row_len, active,
    budget, tok_idx): the full carry, so the next dispatch can chain off
    it on the device. ``row_greedy`` [B] bool lets a sampling batch
    argmax the rows that asked for greedy decoding."""
    emits = []
    for _ in range(horizon):
        tok = sample_rows(last_logits, row_keys, tok_idx, greedy=greedy,
                          temperature=temperature, top_k=top_k, top_p=top_p)
        if not greedy:
            tok = torch.where(row_greedy, torch.argmax(last_logits, -1), tok)
        emits.append(torch.where(active, tok, -1))
        live = active.to(budget.dtype)
        budget = budget - live
        tok_idx = tok_idx + live
        done_now = (budget <= 0) | (row_len + 1 >= max_len)
        if eos_id is not None:
            done_now = done_now | (tok == eos_id)
        cont = active & ~done_now
        logits = step(tok, row_len)
        row_len = row_len + cont.to(row_len.dtype)
        last_logits = torch.where(cont[:, None], logits, last_logits)
        active = cont
    return (torch.stack(emits).to(torch.int32), last_logits, row_len,
            active, budget, tok_idx)


@torch.no_grad()
def _decode_multi(params: Params, cache, last_logits, row_len, active,
                  budget, tok_idx, row_keys, row_greedy, temperature: float,
                  cfg: LlamaConfig, horizon: int, greedy: bool,
                  top_k: Optional[int], top_p: Optional[float],
                  eos_id: Optional[int], *, max_len: int, view_bt=None,
                  adapters: Optional[Params] = None,
                  row_slot: Optional[torch.Tensor] = None,
                  tp: Optional[TPGroup] = None):
    """The dense decode loop (`_decode_loop` over `_decode_core`);
    ``adapters`` / ``row_slot`` add each row's LoRA deltas."""
    return _decode_loop(
        lambda tok, rl: _decode_core(params, tok, cache, rl, cfg, max_len,
                                     view_bt, adapters, row_slot, tp),
        last_logits, row_len, active, budget, tok_idx, row_keys, row_greedy,
        temperature, horizon, greedy, top_k, top_p, eos_id, max_len)


@torch.no_grad()
def _decode_multi_paged(params: Params, pool_k, pool_v, bt, last_logits,
                        row_len, active, budget, tok_idx, row_keys,
                        row_greedy, temperature: float, cfg: LlamaConfig,
                        horizon: int, greedy: bool, top_k: Optional[int],
                        top_p: Optional[float], eos_id: Optional[int], *,
                        scale_k=None, scale_v=None,
                        qspec: Optional[KVQuantSpec] = None,
                        adapters: Optional[Params] = None,
                        row_slot: Optional[torch.Tensor] = None,
                        tp: Optional[TPGroup] = None):
    """The paged decode loop (`_decode_loop` over `_decode_core_paged`);
    the block table spans exactly max_len slots."""
    return _decode_loop(
        lambda tok, rl: _decode_core_paged(params, tok, pool_k, pool_v, bt,
                                           rl, cfg, scale_k, scale_v,
                                           qspec, adapters, row_slot, tp),
        last_logits, row_len, active, budget, tok_idx, row_keys, row_greedy,
        temperature, horizon, greedy, top_k, top_p, eos_id,
        bt.shape[1] * pool_k.shape[2])


def _spec_accept(chunk, proposals, ver, v_logits, last_logits, row_len,
                 active, budget, tok_idx, d_tok, row_greedy, w_row,
                 window: int, eos_id: Optional[int], max_len: int):
    """Acceptance, correction and freezing of one speculative round on
    the device, shared by the dense and paged rounds (the batched form
    of the solo accept loop in `models/speculative.py`; the host never
    sees logits).

    Per row: the longest prefix of ``proposals`` [B, W] equal to the
    target's argmax continuation ``ver`` [B, W+1], capped at the row's
    adaptive width ``w_row`` and forced to 0 on sampled rows (they emit
    just the t0 they sampled); emit ``[t0, d_1..d_a, correction]`` cut
    at the first eos, the budget and the room exactly as `_decode_loop`
    freezes a row, and carry the correction's logits so the next
    round's t0 is this round's correction. Returns the -1-trailing
    [W+1, B] int32 emit block and the advanced carry (last_logits,
    row_len, active, budget, tok_idx, d_lag, d_tok): after a FULLY
    accepted round the draft has consumed d_1..d_{W-1} and still owes
    d_W (``d_lag`` 1, pending token ``d_tok``); any rejection leaves it
    at the emitted history (``d_lag`` 0)."""
    B = row_len.shape[0]
    dev = row_len.device
    bidx = torch.arange(B, device=dev)
    jW = torch.arange(window, device=dev)
    match = (proposals == ver[:, :window]) \
        & (jW[None, :] < w_row[:, None]) & row_greedy[:, None]
    acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
    pos = torch.arange(window + 1, device=dev)
    valid = pos[None, :] <= acc[:, None]
    if eos_id is not None:
        # keep the first eos, cut everything after it (mid-window eos)
        iseos = ((chunk == eos_id) & valid).long()
        valid = valid & ((torch.cumsum(iseos, dim=1) - iseos) == 0)
    valid = valid & (pos[None, :] < budget[:, None]) & active[:, None]
    n = valid.sum(dim=1)
    emits = torch.where(valid, chunk, -1).T.to(torch.int32)   # [W+1, B]

    budget = budget - n
    tok_idx = tok_idx + n
    last = (n - 1).clamp(min=0)
    done_now = (budget <= 0) | (row_len + n >= max_len)
    if eos_id is not None:
        done_now = done_now | ((n >= 1) & (chunk[bidx, last] == eos_id))
    cont = active & ~done_now
    row_len = row_len + n * cont
    last_logits = torch.where(cont[:, None], v_logits[bidx, last],
                              last_logits)
    full = cont & (n == window + 1)
    d_tok = torch.where(full, chunk[:, window], d_tok)
    d_lag = torch.where(active, full.long(), 0)
    return emits, last_logits, row_len, cont, budget, tok_idx, d_lag, d_tok


def _spec_loop(step, d_step, last_logits, row_len, active, budget, tok_idx,
               d_lag, d_tok, row_keys, row_greedy, w_row,
               temperature: float, window: int, greedy: bool,
               top_k: Optional[int], top_p: Optional[float],
               eos_id: Optional[int], max_len: int):
    """ONE batched draft-propose / target-verify round for every row,
    the speculative replacement of a `_decode_loop` dispatch.
    ``step(toks [B, S], starts) -> logits [B, S, vocab]`` runs the
    target over its cache layout, ``d_step`` the draft over its plane:

      t0      = argmax(last_logits)   (sampled rows: their sampled token)
      draft   consumes the 2-wide chunk [pend, t0] at ``row_len -
              d_lag`` (pend = d_tok when the last round was fully
              accepted, else t0, whose duplicate K/V the first proposal
              overwrites), then W-1 greedy steps at ``row_len + 1 + j``
      verify  ONE target pass over [t0, d_1..d_W] at ``row_len``
      accept  `_spec_accept`

    Stale K/V of rejected candidates lies exactly where the next
    round's writes land first, so nothing is rolled back. Emitted tokens
    are always the target's own argmax chain: a stale or cold draft
    plane only lowers acceptance. Returns `_spec_accept`'s emit block
    and carry."""
    B = row_len.shape[0]
    bidx = torch.arange(B, device=row_len.device)
    t0 = torch.argmax(last_logits, dim=-1)
    if not greedy:
        t0 = torch.where(row_greedy, t0,
                         sample_rows(last_logits, row_keys, tok_idx,
                                     greedy=False, temperature=temperature,
                                     top_k=top_k, top_p=top_p))
    pend = torch.where(d_lag == 1, d_tok, t0)
    d_logits = d_step(torch.stack([pend, t0], dim=1), row_len - d_lag)
    props = [torch.argmax(d_logits[bidx, d_lag], dim=-1)]
    for j in range(window - 1):
        lg = d_step(props[-1][:, None], row_len + 1 + j)
        props.append(torch.argmax(lg[:, 0], dim=-1))
    proposals = torch.stack(props, dim=1)                   # [B, W]
    chunk = torch.cat([t0[:, None], proposals], dim=1)      # [B, W+1]
    v_logits = step(chunk, row_len)
    return _spec_accept(chunk, proposals, torch.argmax(v_logits, dim=-1),
                        v_logits, last_logits, row_len, active, budget,
                        tok_idx, d_tok, row_greedy, w_row, window, eos_id,
                        max_len)


@torch.no_grad()
def _spec_round(params: Params, d_params: Params, cache, d_cache,
                last_logits, row_len, active, budget, tok_idx, d_lag, d_tok,
                row_keys, row_greedy, w_row, temperature: float,
                cfg: LlamaConfig, d_cfg: LlamaConfig, window: int,
                greedy: bool, top_k: Optional[int], top_p: Optional[float],
                eos_id: Optional[int], *, max_len: int, view_bt=None,
                tp: Optional[TPGroup] = None,
                d_tp: Optional[TPGroup] = None):
    """The dense speculative round (`_spec_loop` over `_spec_core` on
    the target cache and the draft cache). ``view_bt`` (the card) runs
    both planes' attention on B2 over block-table views; both caches
    have the same row span, so one view serves both. ``tp`` / ``d_tp``:
    each plane's tp group (the draft's is None when it is replicated)."""
    return _spec_loop(
        lambda t, st: _spec_core(params, t, cache, st, cfg, max_len,
                                 view_bt, tp=tp),
        lambda t, st: _spec_core(d_params, t, d_cache, st, d_cfg, max_len,
                                 view_bt, tp=d_tp),
        last_logits, row_len, active, budget, tok_idx, d_lag, d_tok,
        row_keys, row_greedy, w_row, temperature, window, greedy, top_k,
        top_p, eos_id, max_len)


@torch.no_grad()
def _spec_round_paged(params: Params, d_params: Params, pool_k, pool_v,
                      pool_dk, pool_dv, bt, bt_d, last_logits, row_len,
                      active, budget, tok_idx, d_lag, d_tok, row_keys,
                      row_greedy, w_row, temperature: float,
                      cfg: LlamaConfig, d_cfg: LlamaConfig, window: int,
                      greedy: bool, top_k: Optional[int],
                      top_p: Optional[float], eos_id: Optional[int], *,
                      scale_k=None, scale_v=None, scale_dk=None,
                      scale_dv=None, qspec: Optional[KVQuantSpec] = None,
                      tp: Optional[TPGroup] = None,
                      d_tp: Optional[TPGroup] = None):
    """The speculative round over the block pools: the target through
    ``bt``, the draft through its private table ``bt_d`` (draft blocks
    are never shared: the trie indexes only the target pool). With
    ``qspec`` BOTH planes are quantized, each with its own scale slabs;
    `paged_quant_write` zeroes a rejected window's stale slots out of
    the next overlapping write's absmax."""
    return _spec_loop(
        lambda t, st: _spec_core_paged(params, t, pool_k, pool_v, bt, st,
                                       cfg, scale_k, scale_v, qspec,
                                       tp=tp),
        lambda t, st: _spec_core_paged(d_params, t, pool_dk, pool_dv, bt_d,
                                       st, d_cfg, scale_dk, scale_dv,
                                       qspec, tp=d_tp),
        last_logits, row_len, active, budget, tok_idx, d_lag, d_tok,
        row_keys, row_greedy, w_row, temperature, window, greedy, top_k,
        top_p, eos_id, bt.shape[1] * pool_k.shape[2])


@torch.no_grad()
def _cow_blocks(tensors: List[torch.Tensor], src: torch.Tensor,
                dst: torch.Tensor) -> None:
    """Copy-on-write, in place: block ``src[i]`` of each pool tensor
    (pages, then a quantized pool's scale slabs) is duplicated into
    ``dst[i]`` for every pair of one admission round, one copy per
    tensor: byte-exact, never a requantization. Pairs are power-of-two
    padded with (0, 0): null block onto itself."""
    src, dst = src.long(), dst.long()
    for t in tensors:
        raw(t).index_copy_(1, dst, raw(t).index_select(1, src))


@torch.no_grad()
def _swap_out_gather(tensors: List[torch.Tensor],
                     block_ids: torch.Tensor) -> List[torch.Tensor]:
    """Gather a preemption victim's blocks out of each pool tensor
    (pages [L, n, T, KV, D], a quantized pool's as raw bytes, then its
    scale rows [L, n, KV]) into fresh tensors, which the caller copies
    to the host. ``block_ids`` is power-of-two padded with the null
    block; its garbage rides along and is scattered straight back into
    block 0 at swap-in. No dequantization on either leg: the round trip
    is byte-exact."""
    idx = block_ids.long()
    return [raw(t).index_select(1, idx) for t in tensors]


@torch.no_grad()
def _swap_in_scatter(tensors: List[torch.Tensor], host,
                     block_ids: torch.Tensor) -> None:
    """Scatter a swapped-out request's host copies ``host`` (pinned on
    the card) into a freshly allocated chain ``block_ids`` of the pool
    ``tensors``, in place. The new physical ids need not match the old
    ones: the block table maps them to the same logical slots."""
    idx = block_ids.long()
    for t, h in zip(tensors, host):
        raw(t).index_copy_(1, idx, h.to(t.device, non_blocking=True))


class _DecodeGraphs:
    """The decode loop on the card as CUDA graphs: one per (H,
    all-greedy) key of one engine (so one cache layout), all in one
    memory pool; at most 2 x (log2(decode_horizon) + 1) graphs, and a
    speculative engine's rounds one per ("spec", W, all-greedy) key
    besides (at most 2 x (log2(spec_window) + 1) more).

    A key's FIRST dispatch runs eagerly on a side stream, which is
    torch's warm-up before capture (it builds B2 and sets up cuBLAS for
    the stream) and a real dispatch; the graph is captured right after
    it and every later dispatch of the key replays it. The loop reads
    and writes only the engine's persistent buffers, so a replay needs
    no argument. Capture or replay errors raise: there is no eager
    fallback.

    B2's launch count: its wrapper counts Python calls, and a replay
    makes none, so each graph's count is taken at capture (where nothing
    launches, so the capture's own count is taken back) and added per
    replay."""

    # One warm-up stream per device for every engine of the process:
    # cuBLAS keeps a workspace for each stream it has run on until the
    # process ends, so a stream per engine would hold one per engine.
    _side_streams: Dict[torch.device, torch.cuda.Stream] = {}

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        if device not in self._side_streams:
            self._side_streams[device] = torch.cuda.Stream(device)
        self.side = self._side_streams[device]
        self.graphs: Dict[tuple, tuple] = {}   # key -> (graph, toks, B2)
        self.replays = 0

    def run(self, key: tuple, fn: Callable[[], torch.Tensor]
            ) -> torch.Tensor:
        entry = self.graphs.get(key)
        if entry is not None:
            graph, toks, b2_calls = entry
            graph.replay()
            pak.launches += b2_calls
            self.replays += 1
            return toks
        cur = torch.cuda.current_stream(self.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            toks = fn()
        cur.wait_stream(self.side)
        toks.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        before = pak.launches
        with torch.cuda.graph(graph, pool=self.pool):
            static = fn()
        self.graphs[key] = (graph, static, pak.launches - before)
        pak.launches = before
        return toks

    def release(self) -> None:
        """Wait for the card, then free every captured graph."""
        torch.cuda.synchronize(self.device)
        for graph, _, _ in self.graphs.values():
            graph.reset()
        self.graphs.clear()


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class _Request:
    __slots__ = ("req_id", "prompt", "max_new_tokens", "tokens", "done",
                 "priority", "seq", "rng", "deadline", "shed", "resume",
                 "greedy", "adapter_id", "handoff")

    def __init__(self, req_id: int, prompt: List[int],
                 max_new_tokens: int, priority: int = 0, seq: int = 0,
                 rng: Optional[Tuple[int, int]] = None,
                 deadline: Optional[float] = None):
        self.req_id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.tokens: List[int] = []
        self.done = False
        self.priority = priority    # lower = admitted first (priority policy)
        self.seq = seq              # submission order (FIFO tie-break)
        self.rng = rng              # (word0, word1) per-request key stream
        self.deadline = deadline    # absolute clock time; None = no SLO
        self.shed = False           # retired past-deadline, no prefill run
        self.resume = False         # preempted; re-queued to recompute
        self.greedy = None          # per-request decode-mode override
        self.adapter_id = None      # LoRA adapter (None = base model)
        self.handoff = False        # imported from a prefill-class engine


class _PrefillState:
    """A slot row whose prompt is still to be written: ``pos`` is the
    prefill frontier (slots [0, pos) hold valid K/V: a copied or shared
    prefix plus completed chunks), ``nodes`` the PENDING trie nodes this
    row's prefill fills (each committed once the frontier covers its
    block), ``prompt`` the token sequence being prefilled (the request's
    prompt, or prompt + emitted tokens when a preempted request
    recomputes)."""

    __slots__ = ("req", "pos", "nodes", "prompt")

    def __init__(self, req: _Request, pos: int, nodes: list,
                 prompt: Optional[List[int]] = None):
        self.req = req
        self.pos = pos
        self.nodes = nodes
        self.prompt = req.prompt if prompt is None else prompt


class _SwapState:
    """A preempted request's spilled decode state (paged engine).

    ``host`` holds the host copies (`_HostBlock`: pinned memory and the
    event of its copy on the card) of the victim's gathered pages [L,
    nbp, T, KV, D], K then V, and of a quantized pool's scale rows [L,
    nbp, KV]; ``logits`` its next-token logits. Both are None under
    preempt="recompute", where re-admission re-prefills prompt + emitted
    tokens instead. ``row_len`` / ``tok_idx`` / ``budget`` restore the
    row where it froze; the token stream then continues unchanged,
    because the sampling noise depends only on the request's key and
    token index."""

    __slots__ = ("host", "n_blocks", "row_len", "tok_idx", "budget",
                 "logits")

    def __init__(self, host: Optional[List[_HostBlock]], n_blocks: int,
                 row_len: int, tok_idx: int, budget: int,
                 logits: Optional[_HostBlock]):
        self.host = host
        self.n_blocks = n_blocks
        self.row_len = row_len
        self.tok_idx = tok_idx
        self.budget = budget
        self.logits = logits

    @property
    def nbytes(self) -> int:
        """Bytes the swap moves each way: pages, scales and logits."""
        if self.host is None:
            return 0
        return sum(b.data.nbytes for b in self.host + [self.logits])


class _InflightStep:
    """One dispatched, not yet drained decode step: its token block on
    its way to the host (`_HostBlock`), its horizon (a speculative
    round's W+1), the rows it was dispatched for, and whether it ran
    AHEAD (dispatched before the host had replayed the previous block)
    — only those can hold overrun iterations for rows that had already
    finished. A speculative round also keeps its width ``w_max`` and
    per-row caps ``w_row``: a chained round reuses them, and the drain
    accounts each row's proposals with them."""

    __slots__ = ("toks", "H", "rows", "run_ahead", "spec", "w_max",
                 "w_row")

    def __init__(self, toks: _HostBlock, H: int, rows: List[int],
                 run_ahead: bool, spec: bool = False, w_max: int = 0,
                 w_row: Optional[np.ndarray] = None):
        self.toks = toks
        self.H = H
        self.rows = rows
        self.run_ahead = run_ahead
        self.spec = spec
        self.w_max = w_max
        self.w_row = w_row


class DecodeEngine:
    """Slot-based continuous batching over a dense KV cache (default) or
    a paged KV block pool (``paged=True``).

    `submit()` enqueues a request; `step()` admits queued requests into
    free slots (same-bucket prefills batched), then advances every live
    slot up to `decode_horizon` tokens per dispatch with ONE
    device->host transfer per [H, B] token block; `run()` drains
    everything. The horizon adapts via the scheduler's `horizon_hint`
    (1 while a queued request could take a free slot, else
    `decode_horizon`), capped at the largest remaining budget and
    rounded down to a power of two — `step(horizon=)` pins it.

    `pipeline_depth` (default 2) bounds the async ring of decode steps
    in flight during pure-decode stretches: step N+1 is dispatched
    BEFORE step N's token block is pulled to the host, chained through
    the device-resident row state, and the host drains and replays one
    step behind. The ring flushes whenever the scheduler reports
    pending admissions, so scheduling sees fully replayed host state;
    depth 1 is the synchronous engine. Output is token-identical at
    every depth.

    The device is the params' device: weights from
    `llama_init(..., device="cuda")` or `convert.params_from_numpy`
    serve on the card (the decode loop replayed as CUDA graphs, decode
    attention on B2), weights on the CPU serve on the CPU through the
    same loop run eagerly and the plain attention.

    Greedy by default; sampling (greedy=False) applies `generate`'s
    temperature/top_k/top_p semantics with a per-request key stream:
    ``submit(..., rng=seed)`` pins it, else one is mixed from the engine
    ``rng`` seed and the request id.

    The memory plane (see the module docstring): ``paged=True`` with
    ``kv_block_tokens``, ``kv_pool_bytes``, ``kv_quant`` ("int8" |
    "fp8_e4m3"; paged only) and ``preempt`` ("swap", the default, or
    "recompute"); ``prefix_cache=True`` (dense: its own pool of
    ``prefix_block``-token blocks sized by ``prefix_cache_bytes``;
    paged: the block pool itself) with ``scheduler="prefix"``;
    ``prefill_chunk`` tokens of prefill per row per step.

    Multi-LoRA: ``lora=LoraConfig(...)`` with ``max_live_adapters``
    device slots; `register_adapter`, then ``submit(adapter_id=)``.
    """

    def __init__(self, params: Params, cfg: LlamaConfig, *,
                 batch_slots: int = 8, max_len: Optional[int] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 bucket_lens: bool = True,
                 rng: Optional[int] = None,
                 scheduler: Union[str, SchedulerPolicy] = "fifo",
                 max_queue: Optional[int] = None,
                 on_full: str = "reject",
                 block_timeout_s: Optional[float] = None,
                 max_prefills_per_step: Optional[int] = None,
                 decode_horizon: int = 8,
                 pipeline_depth: int = 2,
                 prefix_cache: bool = False,
                 prefix_block: int = 32,
                 prefix_cache_bytes: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 paged: bool = False,
                 kv_block_tokens: Optional[int] = None,
                 kv_pool_bytes: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 preempt: str = "swap",
                 draft_params: Optional[Params] = None,
                 draft_cfg: Optional[LlamaConfig] = None,
                 spec_window: int = 4,
                 lora=None,
                 max_live_adapters: int = 4,
                 mesh=None,
                 tp: Optional[int] = None,
                 sharding_rules=None,
                 engine_id: Optional[str] = None,
                 enable_metrics: bool = True,
                 trace=None,
                 sanitize=None,
                 clock: Callable[[], float] = time.monotonic):
        _check_sampling_knobs(greedy, top_k, top_p)
        if on_full not in ("reject", "block"):
            raise ValueError(f"on_full must be 'reject' or 'block', "
                             f"got {on_full!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if block_timeout_s is not None and block_timeout_s <= 0:
            raise ValueError("block_timeout_s must be > 0")
        if max_prefills_per_step is not None and max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if prefix_block < 1:
            raise ValueError("prefix_block must be >= 1")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if preempt not in ("swap", "recompute"):
            raise ValueError(f"preempt must be 'swap' or 'recompute', "
                             f"got {preempt!r}")
        if kv_block_tokens is not None and kv_block_tokens < 1:
            raise ValueError("kv_block_tokens must be >= 1")
        self.kv_quant_spec = resolve_kv_quant(kv_quant)
        self.kv_quant = kv_quant
        if self.kv_quant_spec is not None and not paged:
            raise ValueError(
                "kv_quant requires paged=True: quantization scales are "
                "per-block slabs of the paged KV pool")
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: speculative decoding needs a "
                    "shared tokenizer")
            if spec_window < 1:
                raise ValueError("spec_window must be >= 1")
        if lora is not None:
            if draft_params is not None:
                raise ValueError(
                    "lora= and draft_params= are mutually exclusive: the "
                    "speculative draft/verify rounds do not carry per-row "
                    "adapter deltas")
        if sanitize:
            raise _unported("the runtime sanitizer (sanitize=)", "A14")
        self.cfg = cfg
        self.device = params["tok_embed"].device
        self.B = batch_slots
        self._init_tp(mesh, tp, sharding_rules)
        self.params = self._shard(params, cfg, self._rules, self._tp)
        if draft_params is not None:
            draft_params = self._init_draft_tp(draft_params, draft_cfg)
        self.max_len = max_len or cfg.max_seq_len
        if self.max_len > cfg.max_seq_len:
            raise ValueError(f"max_len {self.max_len} exceeds "
                             f"max_seq_len {cfg.max_seq_len}")
        self.greedy = greedy
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.bucket_lens = bucket_lens
        self.scheduler = make_policy(scheduler)
        self.max_queue = max_queue
        self.on_full = on_full
        self.block_timeout_s = block_timeout_s
        self.max_prefills_per_step = max_prefills_per_step
        self.decode_horizon = decode_horizon
        self.pipeline_depth = pipeline_depth
        self.preempt_mode = preempt
        # One clock for telemetry AND deadline shedding.
        self._clock = clock
        self.metrics = (EngineMetrics(engine_id=engine_id,
                                      batch_slots=self.B, clock=clock)
                        if enable_metrics else NullEngineMetrics())
        self.engine_id = engine_id or (self.metrics.engine_id
                                       if enable_metrics else "engine")
        self.trace = resolve_tracer(trace, engine_id=self.engine_id,
                                    clock=clock)
        self.metrics.on_tp_degree(self.tp_degree)

        self.paged = paged
        L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        kv_local = len(self._kv_heads)
        # Next-token logits per slot, device-resident: prefill scatters
        # into it, decode samples from it and writes it back in place.
        self._last_logits = torch.zeros((self.B, cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
        # Shared-prefix cache: a host trie over committed prompt blocks.
        # Paged, it indexes the block pool itself (shares by refcount);
        # dense, it has its own pool of prefix_block-token blocks that
        # admissions copy from and prefills copy into.
        self._prefix: Optional[PrefixCacheIndex] = None
        self._scale_k = self._scale_v = None
        if paged:
            self._init_pool(kv_block_tokens, prefix_block, kv_pool_bytes,
                            prefix_cache_bytes, prefix_cache)
        else:
            self.prefix_block = prefix_block
            # Dense per-slot cache: 2 (K+V) x L x KV x D per token. On
            # the card decode attention reads it through B2 as pages of
            # DENSE_VIEW_TOKENS slots, so its rows are rounded up to
            # whole pages (slots past max_len are masked everywhere).
            self.kv_bytes_per_token = float(2 * L * KV * D
                                            * cfg.dtype.itemsize)
            self.kv_bytes_per_block = 0.0
            use_b2 = cfg.attn_impl in ("kernel", "flash") or (
                cfg.attn_impl == "auto" and self.device.type == "cuda")
            span = self.max_len
            self._view_bt = None
            if use_b2:
                T = DENSE_VIEW_TOKENS
                span = -(-self.max_len // T) * T
                self._view_bt = torch.arange(
                    self.B * (span // T), dtype=torch.int32,
                    device=self.device).view(self.B, span // T)
            self.cache = init_cache(cfg, self.B, span, device=self.device,
                                    n_kv_heads=kv_local)
            self.kv_pool = None
            self._pool_k = self._pool_v = None
            if prefix_cache:
                bb = block_bytes(L, prefix_block, KV, D, cfg.dtype.itemsize)
                self.kv_bytes_per_block = float(bb)
                n_blocks = (1 + (2 * self.B * self.max_len) // prefix_block
                            if prefix_cache_bytes is None
                            else 1 + prefix_cache_bytes // bb)
                self._prefix = PrefixCacheIndex(
                    block_tokens=prefix_block, n_blocks=n_blocks,
                    on_evict=self._on_prefix_evict)
                self._pool_k = torch.zeros(
                    (L, n_blocks, prefix_block, kv_local, D),
                    dtype=cfg.dtype, device=self.device)
                self._pool_v = torch.zeros_like(self._pool_k)
        if self._prefix is not None:
            attach = getattr(self.scheduler, "attach_prefix_probe", None)
            if attach is not None:
                attach(self._prefix_probe)
        self.prefill_chunk = prefill_chunk
        # The speculative plane (`_init_draft_plane`): the draft's K/V
        # beside the target's, and its accounting (all 0 with spec off).
        self.spec_enabled = draft_params is not None
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_window = spec_window
        self.spec_dispatches = 0       # speculative rounds launched
        self.spec_dispatches_by_window: Dict[int, int] = {}   # W -> n
        self.spec_rounds = 0           # per-row rounds replayed
        self.spec_proposed = 0         # draft tokens proposed (w_row)
        self.spec_accepted = 0         # draft tokens emitted
        self.spec_wasted = 0           # proposed but rejected
        self.spec_prefill_dispatches = 0   # draft-plane seedings
        self.spec_metrics: Optional[SpecMetrics] = None
        if self.spec_enabled:
            self._init_draft_plane(enable_metrics)
        # The multi-LoRA plane (`models/adapter_pool.py`): device stacks
        # of up to max_live_adapters adapters, a [B] slot lane mapping
        # each row to its adapter (0 = base only), and the slot
        # reference taken at the ADMISSION GATE carried to the row bind
        # in `_pending_slots`, so a later candidate's prefetch commit in
        # the same round can never evict an adapter a decision was
        # already made against.
        self.adapter_pool: Optional[AdapterPool] = None
        if lora is not None:
            self.adapter_pool = AdapterPool(
                cfg, lora, max_live_adapters=max_live_adapters,
                device=self.device, metrics=self.metrics, trace=self.trace,
                mesh=self.mesh, rules=self._rules)
            self.metrics.on_adapter_slots(max_live_adapters, 0, 0)
            attach = getattr(self.scheduler, "attach_adapter_probe", None)
            if attach is not None:
                attach(self._adapter_probe)
        self._row_slot = np.zeros((self.B,), np.int64)
        self._pending_slots: Dict[int, int] = {}
        self.adapter_deferrals = 0     # cold-adapter admission defers
        # The decode loop's inputs on the device, one int64 buffer, in
        # order: the chained row state (row_len, active, budget,
        # tok_idx, then a speculative engine's draft lanes d_lag and
        # d_tok; a dispatch writes it back, so a run-ahead dispatch
        # chains off it), row keys [B, 2], the greedy lane [B], a
        # speculative round's per-row widths w_row [B], a LoRA engine's
        # adapter-slot lane [B] and, paged, the block tables [B, MB]
        # (and the draft's). A dispatch stages its host part in ONE
        # copy. The buffer and its views are never rebound: the decode
        # graphs read them.
        Bn, spec, use_lora = self.B, self.spec_enabled, lora is not None
        n_state = (6 if spec else 4) * Bn
        self._n_chain = n_state + 2 * Bn   # what a run-ahead keeps
        mb = self._mb if paged else 0
        n_lanes = 1 + spec + use_lora
        n_bt = (1 + spec) if paged else 0
        self._din = torch.zeros((self._n_chain + (n_lanes + n_bt * mb) * Bn,),
                                dtype=torch.int64, device=self.device)
        self._d_state = self._din[:4 * Bn].view(4, Bn)
        self._d_spec = self._din[4 * Bn:n_state].view(2, Bn) if spec \
            else None
        self._d_keys = self._din[n_state:self._n_chain].view(Bn, 2)
        o = self._n_chain
        self._d_greedy = self._din[o:o + Bn]
        o += Bn
        self._d_wrow = self._din[o:o + Bn] if spec else None
        o += spec * Bn
        self._d_slot = self._din[o:o + Bn] if use_lora else None
        o += use_lora * Bn
        self._d_bt = self._din[o:o + Bn * mb].view(Bn, mb) if paged \
            else None
        self._d_bt_d = self._din[o + Bn * mb:].view(Bn, mb) \
            if paged and spec else None
        # Captured only when the tp group's collectives can be (NCCL, or
        # one rank); a gloo group stages through the host, so its loop
        # runs eagerly and stats()["decode_graphs"] stays 0.
        self._graphs = (_DecodeGraphs(self.device)
                        if self.device.type == "cuda"
                        and (self._tp is None or self._tp.capturable)
                        else None)
        self.row_len = np.zeros((self.B,), np.int32)   # written slots
        self.row_req: List[Optional[_Request]] = [None] * self.B
        self.row_budget = np.zeros((self.B,), np.int32)
        self._tok_idx = np.zeros((self.B,), np.int32)  # sampled so far
        self._row_keys = np.zeros((self.B, 2), np.int64)
        self._row_greedy = np.full((self.B,), bool(greedy), bool)
        self._base_key = key_words(0 if rng is None else rng)
        self._next_id = 0
        self.results: Dict[int, _Request] = {}
        self.finished: set = set()      # done but not yet popped
        self.shed_ids: set = set()      # finished as past-deadline sheds
        self.requests_shed = 0
        self.draining = False
        self.halted = False             # `halt`: work abandoned
        self._row_prefill: Dict[int, _PrefillState] = {}
        # Plain-int accounting (reported with enable_metrics=False too).
        self.decode_dispatches = 0     # decode loops launched
        self.decode_iterations = 0     # decode iterations (sum of H)
        self.prefill_dispatches = 0    # batched prefills
        self.host_syncs = 0            # device->host token transfers
        self.host_transfer_bytes = 0
        self.tokens_out = 0
        self.prefill_real_tokens = 0
        self.prefill_padded_tokens = 0  # bucket + pow2-group filler
        self.prefix_lookups = 0        # admissions probed in the trie
        self.prefix_hits = 0           # ... that matched >= 1 block
        self.prefix_reused_tokens = 0  # prompt tokens copied or shared
        self.prefix_evictions = 0      # LRU blocks recycled
        self.prefix_copy_dispatches = 0  # dense pool copy-in/out
        self.chunked_prefill_stalls = 0  # steps with a row mid-prefill
        self.kv_blocks_shared = 0      # warm-admission zero-copy shares
        self.kv_block_cows = 0         # tail blocks duplicated on write
        self.preemptions = 0
        self.swap_ins = 0              # preempted rows re-admitted
        self.swap_outs = 0             # swap-mode spills to the host
        self.swap_in_bytes = 0         # host->device swap traffic
        self.swap_out_bytes = 0        # device->host swap traffic
        # The disaggregated prefill/decode plane: the fleet sets
        # `prefill_only` on prefill-class replicas, whose step() then
        # parks each row whose prefill completed in `_handoff_ready`
        # instead of decoding it, for `export_request`.
        self.prefill_only = False
        self.replica_class = None      # "prefill" / "decode" / None
        self._handoff_ready: List[int] = []   # parked req ids, oldest first
        self._handoff_ready_set: set = set()
        self.handoffs_out = 0          # requests exported post-prefill
        self.handoffs_in = 0           # requests imported for decode
        self.handoff_out_bytes = 0     # KV + logits bytes staged to host
        self.handoff_in_bytes = 0      # KV + logits bytes accepted
        # Async pipeline: dispatched-but-undrained decode steps, oldest
        # first.
        self._ring: collections.deque = collections.deque()
        self.pipeline_flushes = 0      # forced full drains of the ring
        self.pipeline_overrun_tokens = 0  # masked run-ahead iterations
        self._pl_depth_sum = 0         # ring depth sampled at each drain
        self._pl_depth_n = 0
        self._start_t = clock()
        self.steps_total = 0
        # Weak: the serving state API lists the engine while it lives.
        register_engine(self)

    def _init_tp(self, mesh, tp: Optional[int], sharding_rules) -> None:
        """The tensor-parallel plane, with JAX's checks: ``tp=n`` builds
        a mesh over the world (``{"tp": n}``, or ``{"dp": world / n,
        "tp": n}`` whose dp replicas each serve on their own), ``mesh=``
        hands over one with a "tp" axis; ``tp=1`` needs no process
        group. The rules are JAX's serving table (``"kv"`` on tp) pruned
        against the tp axis and the model's dims (`self._rules`)."""
        from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                     mesh_axis_sizes,
                                                     prune_rules_for_mesh)

        if tp is not None:
            if mesh is not None:
                raise ValueError("pass mesh= or tp=, not both")
            if tp < 1:
                raise ValueError("tp must be >= 1")
            if tp > 1:
                mesh = self._tp_mesh(tp)
        if mesh is not None and "tp" not in mesh.mesh_dim_names:
            raise ValueError(
                "serving mesh needs a 'tp' axis, got axes "
                f"{tuple(mesh.mesh_dim_names)}")
        degree = (1 if mesh is None
                  else mesh_axis_sizes(mesh)["tp"])
        self.mesh = mesh
        self.tp_degree = degree
        cfg = self.cfg
        self._rules = None
        if mesh is not None or tp is not None:
            self._rules = (sharding_rules if sharding_rules is not None
                           else prune_rules_for_mesh(
                               dict(DEFAULT_RULES, kv="tp"), {"tp": degree},
                               self._dims(cfg)))
        self._tp: Optional[TPGroup] = None
        if degree > 1:
            self._tp = tp_group(mesh, host=True)
        _, self._kv_heads = local_heads(
            cfg, self._rules, 0 if self._tp is None else self._tp.rank,
            degree)
        self._d_tp: Optional[TPGroup] = None

    def _tp_mesh(self, tp: int):
        from ray_tpu_torch.parallel.bootstrap import distributed_info
        from ray_tpu_torch.parallel.mesh import create_mesh

        world = distributed_info().num_processes
        if tp > world or world % tp:
            raise ValueError(
                f"tp={tp} exceeds the {world}-rank world (or does not "
                "divide it): start one process per rank and call "
                "ray_tpu_torch.parallel.initialize_distributed first")
        axes = {"tp": tp} if world == tp else {"dp": world // tp, "tp": tp}
        return create_mesh(axes, device_type=self.device.type)

    def _dims(self, cfg: LlamaConfig) -> Dict[str, int]:
        """The logical dims the serving rules are pruned against (JAX's
        ``dims``)."""
        return {"heads": cfg.n_heads, "qkv": cfg.n_heads,
                "kv": cfg.n_kv_heads, "mlp": cfg.ffn_dim,
                "vocab": cfg.vocab_size, "embed": cfg.dim, "batch": self.B}

    def _shard(self, params: Params, cfg: LlamaConfig, rules,
               tp: Optional[TPGroup]) -> Params:
        """This rank's shards of a full param tree: the region JAX's
        `NamedSharding` gives its device under ``rules``, with wk/wv cut
        to the kv heads its q heads read when the kv axis replicates.
        Without a split tp group the tree is used as given."""
        if not is_split(tp):
            return params
        from ray_tpu_torch.models.llama import llama_param_specs
        from ray_tpu_torch.parallel.sharding import local_region

        _, kv = local_heads(cfg, rules, tp.rank, tp.size)
        specs = llama_param_specs(cfg, rules)

        def cut(x, spec, name=None):
            x = x[local_region(x.shape, spec, {"tp": tp.size},
                               {"tp": tp.rank})]
            if name in ("wk", "wv") and x.shape[2] == cfg.n_kv_heads:
                x = x.index_select(2, torch.tensor(kv, device=x.device))
            return x.to(self.device, copy=True).contiguous()

        out = {k: cut(params[k], specs[k])
               for k in ("tok_embed", "final_norm", "lm_head")}
        out["layers"] = {k: cut(w, specs["layers"][k], k)
                         for k, w in params["layers"].items()}
        return out

    def _init_draft_tp(self, draft_params: Params,
                       draft_cfg: LlamaConfig) -> Params:
        """The draft shards over the same tp group with its OWN pruned
        rules (a draft whose kv heads do not divide tp replicates them
        while the target splits its). A draft whose q heads do not
        split over tp runs whole on every rank, with no collective."""
        from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                     prune_rules_for_mesh)

        self._d_kv_heads = list(range(draft_cfg.n_kv_heads))
        if not is_split(self._tp):
            return draft_params
        self._d_rules = prune_rules_for_mesh(
            dict(DEFAULT_RULES, kv="tp"), {"tp": self._tp.size},
            self._dims(draft_cfg))
        if self._d_rules["heads"] != "tp":
            return draft_params
        self._d_tp = self._tp
        _, self._d_kv_heads = local_heads(draft_cfg, self._d_rules,
                                          self._tp.rank, self._tp.size)
        return self._shard(draft_params, draft_cfg, self._d_rules,
                           self._tp)

    def _decision_clock(self) -> float:
        """The clock a host decision reads (deadline shedding, the
        blocking submit's timeout). Every tp rank runs the host loop and
        must take the same decision, so under tp they all use rank 0's
        reading, sent on the host group."""
        if not is_split(self._tp):
            return self._clock()
        now = torch.tensor([self._clock()], dtype=torch.float64)
        return float(collective("broadcast", now, self._tp, host=True)[0])

    def _heads_whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A host tensor of this rank's kv heads (along ``dim``) made
        whole over tp: each global head placed by the lowest rank that
        holds it into a zeroed buffer, summed over the host group as raw
        bytes (exact: every other contribution is zero). What a one-card
        engine's payload holds."""
        tp = self._tp
        if not is_split(tp):
            return x
        KV = self.cfg.n_kv_heads
        owner = {}
        for r in range(tp.size):
            for j in local_heads(self.cfg, self._rules, r, tp.size)[1]:
                owner.setdefault(j, r)
        u = x.unsqueeze(-1).view(torch.uint8)
        shape = list(u.shape)
        shape[dim] = KV
        full = torch.zeros(shape, dtype=torch.uint8)
        for i, j in enumerate(self._kv_heads):
            if owner[j] == tp.rank:
                full.select(dim, j).copy_(u.select(dim, i))
        collective("sum", full, tp, host=True)
        return full.view(x.dtype).squeeze(-1)

    def _init_pool(self, kv_block_tokens: Optional[int], prefix_block: int,
                   kv_pool_bytes: Optional[int],
                   prefix_cache_bytes: Optional[int],
                   prefix_cache: bool) -> None:
        """The paged engine's block pool (pages, and the scale slabs of
        a quantized pool), its host ledger, tables and prefix trie."""
        cfg = self.cfg
        self.kv_block_tokens = (kv_block_tokens
                                if kv_block_tokens is not None
                                else prefix_block)
        T = self.prefix_block = self.kv_block_tokens
        if self.max_len % T:
            raise ValueError(
                f"paged engine needs max_len ({self.max_len}) "
                f"divisible by kv_block_tokens ({T}): the block view "
                "must span exactly the dense cache row")
        L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        qspec = self.kv_quant_spec
        if qspec is not None:
            # 1-byte values plus the two slabs' f32 scale per layer and
            # kv head.
            pool_dtype = qspec.dtype
            bb = block_bytes(L, T, KV, D, qspec.itemsize) + 2 * L * KV * 4
        else:
            pool_dtype = cfg.dtype
            bb = block_bytes(L, T, KV, D, cfg.dtype.itemsize)
        self.kv_bytes_per_block = float(bb)
        self.kv_bytes_per_token = bb / T
        budget_bytes = (kv_pool_bytes if kv_pool_bytes is not None
                        else prefix_cache_bytes)
        if budget_bytes is None:
            # Default: room for two full batches of max_len tokens.
            n_blocks = 1 + (2 * self.B * self.max_len) // T
        else:
            n_blocks = 1 + budget_bytes // bb
        self._mb = self.max_len // T       # block-table width
        self.kv_pool = BlockPool(n_blocks)
        self._bt = np.zeros((self.B, self._mb), np.int32)
        self._row_blocks: List[List[int]] = [[] for _ in range(self.B)]
        self._swapped: Dict[int, _SwapState] = {}   # preempted req ids
        self._admit_seq = 0            # preemption recency order
        self._row_admit_seq = np.zeros((self.B,), np.int64)
        kv_local = len(self._kv_heads)
        self._pool_k = torch.zeros((L, n_blocks, T, kv_local, D),
                                   dtype=pool_dtype, device=self.device)
        self._pool_v = torch.zeros_like(self._pool_k)
        if qspec is not None:
            # Zero scales: the zero pool (the null block included)
            # dequantizes to exactly 0.
            self._scale_k = torch.zeros((L, n_blocks, kv_local),
                                        dtype=torch.float32,
                                        device=self.device)
            self._scale_v = torch.zeros_like(self._scale_k)
        if prefix_cache:
            self._prefix = PrefixCacheIndex(
                block_tokens=T, n_blocks=n_blocks,
                on_evict=self._on_prefix_evict, pool=self.kv_pool)

    def _init_draft_plane(self, enable_metrics: bool) -> None:
        """The speculative plane: the DRAFT model's K/V in a dense cache
        of the target's row span, or (paged) in a private block pool and
        table — draft blocks are never shared or in the trie, and the
        pool holds a full row for every slot, so it never runs dry — of
        the target pool's dtype (a quantized pool's draft plane has its
        own scale slabs). Host lanes mirror the device's draft-lag carry
        and keep each row's acceptance over its last 16 rounds for the
        adaptive window."""
        dcfg = self.draft_cfg
        if dcfg.max_seq_len < self.max_len:
            raise ValueError(f"draft max_seq_len {dcfg.max_seq_len} < "
                             f"engine max_len {self.max_len}")
        if self.draft_params["final_norm"].device != self.device:
            raise ValueError(
                f"draft params on {self.draft_params['final_norm'].device},"
                f" target params on {self.device}")
        B = self.B
        self._d_lag = np.zeros((B,), np.int64)
        self._d_tok = np.zeros((B,), np.int64)
        self._spec_hist: List[collections.deque] = [
            collections.deque(maxlen=16) for _ in range(B)]
        # the draft prefill's logits: written, never read
        self._d_last_logits = torch.zeros((B, dcfg.vocab_size),
                                          dtype=torch.float32,
                                          device=self.device)
        L, KV, D = dcfg.n_layers, len(self._d_kv_heads), dcfg.head_dim
        self._scale_dk = self._scale_dv = None
        self._d_cache = None
        self.kv_pool_d = None
        if not self.paged:
            self._d_cache = init_cache(dcfg, B, self.cache["k"].shape[2],
                                       device=self.device, n_kv_heads=KV)
        else:
            n_blocks = 1 + B * self._mb
            self.kv_pool_d = BlockPool(n_blocks, label="draft_kv")
            self._bt_d = np.zeros((B, self._mb), np.int32)
            self._row_blocks_d: List[List[int]] = [[] for _ in range(B)]
            qspec = self.kv_quant_spec
            self._pool_dk = torch.zeros(
                (L, n_blocks, self.kv_block_tokens, KV, D),
                dtype=dcfg.dtype if qspec is None else qspec.dtype,
                device=self.device)
            self._pool_dv = torch.zeros_like(self._pool_dk)
            if qspec is not None:
                self._scale_dk = torch.zeros((L, n_blocks, KV),
                                             dtype=torch.float32,
                                             device=self.device)
                self._scale_dv = torch.zeros_like(self._scale_dk)
        if enable_metrics:
            # the llm_spec_* series carry the engine's id
            self.spec_metrics = SpecMetrics(spec_id=self.engine_id)

    def _pool_tensors(self) -> List[torch.Tensor]:
        """The paged pool's device tensors that blocks index: pages K
        and V, then a quantized pool's scale slabs."""
        return [t for t in (self._pool_k, self._pool_v, self._scale_k,
                            self._scale_v) if t is not None]

    # -- public API --------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               priority: int = 0, rng=None,
               deadline_s: Optional[float] = None,
               greedy: Optional[bool] = None,
               resume_tokens: Optional[List[int]] = None,
               adapter_id: Optional[str] = None) -> int:
        """Enqueue a request; returns its id.

        ``priority`` (lower = sooner) orders the priority policy. A full
        bounded queue raises EngineOverloaded (on_full="reject") or
        drives the engine until a slot frees (on_full="block"). ``rng``
        (an int seed, or a raw uint32[2] key such as the one a fleet
        pins: `generate.key_data`) pins this request's sampling stream:
        its sampled tokens then equal solo ``generate(..., rng=rng)``.
        ``greedy``
        overrides the engine-wide decode mode for this request.
        ``deadline_s`` is the admission SLO: a request still queued when
        it passes is SHED (finished with zero tokens, listed in
        ``shed_ids``). ``adapter_id`` routes the request through a
        registered LoRA adapter (`register_adapter`): its rows decode
        with that adapter's low-rank delta in the SAME batched program
        as every other row; a cold adapter defers the request at the
        admission gate while its weights are copied to the device.
        None serves the base model, token-identical to an engine without
        lora=.

        ``resume_tokens`` is the fleet's failover path: tokens this
        request ALREADY emitted on a replica that died. Admission
        re-prefills prompt + resume_tokens (as a recompute preemption
        does), the budget and the sampling-stream index start at
        len(resume_tokens), and the final ``tokens`` list is
        resume_tokens plus what is decoded here: the same stream as a
        run that never failed, since a token's noise depends only on the
        request's key and its index. Pass the original ``rng``. A
        resumed request is exempt from deadline shedding, and its replay
        is not registered in the prefix trie."""
        if adapter_id is not None:
            if self.adapter_pool is None:
                raise ValueError(
                    "adapter_id= needs an engine built with lora= "
                    "(multi-LoRA serving)")
            if not self.adapter_pool.registered(adapter_id):
                raise KeyError(
                    f"unknown adapter_id {adapter_id!r}: call "
                    "register_adapter first")
        if self.draining:
            raise EngineDraining(
                "engine is draining (begin_drain was called): it will "
                "finish in-flight work but accepts no new requests")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt: need at least one token "
                             "(prepend a BOS token)")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds engine max_len "
                f"{self.max_len}")
        if (self.spec_enabled and len(prompt) + max_new_tokens
                + self.spec_window > self.max_len):
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) + spec_window ({self.spec_window}) "
                f"exceeds engine max_len {self.max_len}: the verify chunk "
                "writes up to spec_window slots past the last emitted "
                "token, so speculative engines need that margin")
        resume = None
        if resume_tokens:
            resume = [int(t) for t in resume_tokens]
            if len(resume) >= max_new_tokens:
                raise ValueError(
                    f"resume_tokens ({len(resume)}) must be shorter than "
                    f"max_new_tokens ({max_new_tokens}): a completed "
                    "request has nothing to resume")
            if deadline_s is not None:
                raise ValueError(
                    "resume_tokens and deadline_s are mutually exclusive: "
                    "a resumed request was admitted once and is exempt "
                    "from deadline shedding")
        if self.paged:
            # A request must fit the pool alone in the worst case (every
            # other row preempted) or it could never complete.
            T = self.kv_block_tokens
            need = -(-(len(prompt) + max_new_tokens) // T)
            if need > self.kv_pool.blocks_total:
                raise ValueError(
                    f"request needs {need} KV blocks ({len(prompt)} prompt"
                    f" + {max_new_tokens} new tokens at {T} tokens/block) "
                    f"but the pool holds only {self.kv_pool.blocks_total};"
                    " raise kv_pool_bytes or shrink the request")
        deadline = (None if deadline_s is None
                    else self._decision_clock() + deadline_s)
        key = None if rng is None else key_data(rng)
        req = _Request(self._next_id, prompt, max_new_tokens,
                       priority=priority, seq=self._next_id, rng=key,
                       deadline=deadline)
        req.greedy = greedy
        req.adapter_id = adapter_id
        if deadline is not None and self._decision_clock() >= deadline:
            # Dead on arrival: shed before the bounded-queue check.
            self._next_id += 1
            self.results[req.req_id] = req
            self.metrics.on_submit(req.req_id)
            if self.trace.enabled:
                self.trace.open("queue_wait", req.req_id)
            self._shed(req)
            return req.req_id
        if self.max_queue is not None and \
                len(self.scheduler) >= self.max_queue:
            if self.on_full == "reject":
                self.metrics.on_reject()
                raise EngineOverloaded(
                    f"queue full ({self.max_queue} queued requests); "
                    f"shed load or use on_full='block'")
            t_block = self._decision_clock()
            while len(self.scheduler) >= self.max_queue:
                if self.block_timeout_s is not None and \
                        self._decision_clock() - t_block \
                        >= self.block_timeout_s:
                    self.metrics.on_reject()
                    raise SubmitTimeout(
                        f"queue still full ({self.max_queue} queued "
                        f"requests) after blocking {self.block_timeout_s}s")
                self.step()
        if resume is not None:
            # Continue, not restart: admission replays prompt + these
            # tokens and the sampling stream picks up at len(resume).
            req.tokens = resume
            req.resume = True
            if self.paged:
                # the recompute swap-in path replays prompt + tokens
                self._swapped[req.req_id] = _SwapState(
                    None, 0, 0, len(resume), max_new_tokens - len(resume),
                    None)
        self._next_id += 1
        self.scheduler.push(req)
        self.results[req.req_id] = req
        self.metrics.on_submit(req.req_id)
        self.metrics.observe_queue_depth(len(self.scheduler))
        if self.trace.enabled:
            self.trace.instant(
                "submit", req.req_id,
                {"prompt_tokens": len(prompt),
                 "max_new_tokens": max_new_tokens, "priority": priority})
            self.trace.open("queue_wait", req.req_id)
        return req.req_id

    # -- multi-LoRA adapter table ------------------------------------------

    def register_adapter(self, adapter_id: str, lora_params: Params
                         ) -> None:
        """Admit a LoRA adapter's weights (a `lora_init`-shaped tree) to
        the engine's host-side adapter table. The device is untouched
        until traffic warms the adapter through the prefetch path."""
        if self.adapter_pool is None:
            raise ValueError(
                "register_adapter needs an engine built with lora=")
        self.adapter_pool.register(adapter_id, lora_params)

    def unregister_adapter(self, adapter_id: str) -> bool:
        """Drop an adapter (deferred until its last live row retires:
        returns False then). Queued requests naming it fail at
        admission, so callers drain them first."""
        if self.adapter_pool is None:
            return True
        return self.adapter_pool.unregister(adapter_id)

    def adapter_resident(self, adapter_id: str) -> bool:
        """True when the adapter occupies a device slot now."""
        return (self.adapter_pool is not None
                and self.adapter_pool.resident(adapter_id))

    def _adapter_probe(self, adapter_id: Optional[str]
                       ) -> Tuple[bool, bool]:
        """(resident, fetching) for the adapter-affinity scheduler."""
        if adapter_id is None or self.adapter_pool is None:
            return True, False
        return (self.adapter_pool.resident(adapter_id),
                self.adapter_pool.fetching(adapter_id))

    def pending(self) -> bool:
        return bool(len(self.scheduler)) or any(
            r is not None for r in self.row_req)

    def step(self, horizon: Optional[int] = None) -> Dict[int, List[int]]:
        """Admit queued requests into free slots (at most
        max_prefills_per_step, same-bucket admissions batched into one
        prefill each), then advance every live slot up to `horizon`
        tokens with ONE device->host transfer. Returns {req_id:
        [tokens]} emitted this step. ``horizon=None`` adapts (see the
        class docstring), capped at the largest remaining budget and
        rounded down to a power of two.

        With `pipeline_depth >= 2` in a pure-decode stretch (queue
        empty), the step tops the in-flight ring up to `pipeline_depth`
        dispatches, each chained off the previous one's device row
        state, BEFORE pulling the oldest block, so the device computes
        step N+1 while the host replays step N. Each call still drains
        exactly one block, so per-call emissions equal the synchronous
        engine's."""
        if horizon is not None and horizon < 1:
            raise ValueError("horizon must be >= 1")
        self.steps_total += 1
        emitted: Dict[int, List[int]] = {}
        # Flush the pipeline before any admission / prefill: those read
        # row and slot state and write the cache from the host side, so
        # every in-flight run-ahead block must be replayed first.
        if self._ring and (self.scheduler.admissions_pending()
                           or self._row_prefill):
            self._flush_pipeline(emitted)
        self._admission_round()

        live = [b for b in range(self.B) if self.row_req[b] is not None]
        if not live:
            if self._ring:             # defensive: never strand blocks
                self._flush_pipeline(emitted)
            return emitted
        # Rows mid-chunked-prefill are not decodable: their last_logits
        # hold an intermediate chunk's. They ride along frozen and take
        # their next chunk next step.
        decodable = [b for b in live if b not in self._row_prefill]
        if self.prefill_only:
            # Prefill-class replica: a row whose prefill completed holds
            # its final last_logits at token index 0, a preemption at
            # its first token. Park it for `export_request` instead of
            # decoding: no decode dispatch runs here, so the ring stays
            # empty and no parked row enters a decode graph.
            for b in decodable:
                rid = self.row_req[b].req_id
                if rid not in self._handoff_ready_set:
                    self._handoff_ready_set.add(rid)
                    self._handoff_ready.append(rid)
                    if self.trace.enabled:
                        self.trace.instant(
                            "handoff_ready", lane="events",
                            args={"req": rid,
                                  "prompt_tokens": int(self.row_len[b])})
            self.metrics.on_step(len(live), len(self.scheduler), 0)
            return emitted
        if len(decodable) < len(live):
            self.chunked_prefill_stalls += 1
            self.metrics.on_prefill_stall()
        if not decodable:
            self.metrics.on_step(len(live), len(self.scheduler), 0)
            return emitted
        if not self._ring:
            decodable = self._dispatch_primary(decodable, live, horizon)
        self._top_up_pipeline(decodable, horizon)
        self._drain_one(emitted)
        # End of stream: every request retired, but run-ahead blocks may
        # remain (all-masked overrun). Drain them now so pending() reads
        # true and the ring never outlives its requests.
        if self._ring and not any(r is not None for r in self.row_req):
            self._flush_pipeline(emitted)
        n_tokens = sum(len(t) for t in emitted.values())
        self.tokens_out += n_tokens
        self.metrics.on_step(sum(r is not None for r in self.row_req),
                             len(self.scheduler), n_tokens)
        if self.paged:
            self.metrics.on_kv_pool(self.kv_pool.blocks_total,
                                    self.kv_pool.blocks_in_use,
                                    self.kv_pool.free_blocks,
                                    bytes_per_token=self.kv_bytes_per_token)
        return emitted

    # -- async pipeline ----------------------------------------------------

    def _dispatch_primary(self, decodable: List[int], live: List[int],
                          horizon: Optional[int]) -> List[int]:
        """Launch the step's PRIMARY dispatch (ring empty, host state
        fully replayed): a speculative draft/verify round when the
        engine has a draft plane and a decodable greedy row with budget
        to speculate into, else the plain loop at the adaptive horizon.
        A step with a row mid-chunked-prefill always decodes plainly at
        H=1: the chunk cadence outranks speculation depth. Returns the
        possibly narrowed decodable set (paged reservation may
        preempt)."""
        if self.spec_enabled and len(decodable) == len(live):
            W, w_row = self._spec_plan(decodable)
            if W:
                if self.paged:
                    decodable, Hr = self._reserve_decode_blocks(decodable,
                                                                W + 1)
                    if Hr < W + 1:
                        # The pool cannot cover the verify chunk even
                        # after preemption: decode plainly at the
                        # horizon the reservation holds.
                        self._dispatch_decode(Hr, decodable,
                                              run_ahead=False)
                        return decodable
                self._dispatch_spec(W, w_row, decodable, run_ahead=False)
                return decodable
        H = horizon
        if H is None:
            H = self.scheduler.horizon_hint(
                free_slots=self.B - len(live),
                max_horizon=self.decode_horizon)
            if len(decodable) < len(live):
                H = 1      # keep the chunk cadence: a mid-prefill row
                #            must not wait a long horizon for its next
                #            chunk (bounded TTFT)
            H = min(H, int(self.row_budget[decodable].max()))
            H = 1 << max(0, H.bit_length() - 1)
        if self.paged:
            # Grow every decodable row's chain to cover the horizon,
            # preempting victims if the pool runs dry.
            decodable, H = self._reserve_decode_blocks(decodable, H)
        self._dispatch_decode(H, decodable, run_ahead=False)
        return decodable

    def _stage_inputs(self, run_ahead: bool,
                      w_row: Optional[np.ndarray] = None) -> None:
        """Copy the host inputs of a dispatch into `_din` in one copy:
        the row state (with a speculative engine's draft lanes) and keys
        for a primary dispatch, then the greedy lane, a speculative
        round's widths ``w_row`` (1s for a plain dispatch, which reads
        none), a LoRA engine's adapter-slot lane and (paged) the block
        tables, snapshotted here, so
        host-side growth only reaches later dispatches. A run-ahead
        dispatch keeps the row state the previous dispatch left on the
        device. On the card the staging buffer is pinned and the copy
        does not block; the caching host allocator keeps the buffer
        from reuse until the copy has run."""
        B = self.B
        lo = self._n_chain if run_ahead else 0
        parts: List[Any] = []
        if not run_ahead:
            parts += [self.row_len,
                      [r is not None and b not in self._row_prefill
                       for b, r in enumerate(self.row_req)],
                      self.row_budget, self._tok_idx]
            if self.spec_enabled:
                parts += [self._d_lag, self._d_tok]
            parts.append(self._row_keys)
        parts.append(self._row_greedy)
        if self.spec_enabled:
            parts.append(np.ones((B,), np.int64) if w_row is None
                         else w_row)
        if self.adapter_pool is not None:
            parts.append(self._row_slot)
        if self.paged:
            parts.append(self._bt)
            if self.spec_enabled:
                parts.append(self._bt_d)
        buf = torch.empty((self._din.numel() - lo,), dtype=torch.int64,
                          pin_memory=self.device.type == "cuda")
        a = buf.numpy()
        o = 0
        for x in parts:
            x = np.asarray(x).reshape(-1)
            a[o:o + x.size] = x
            o += x.size
        self._din[lo:].copy_(buf, non_blocking=True)

    def _decode_body(self, H: int, greedy: bool) -> torch.Tensor:
        """One dispatch's H-iteration decode loop over the persistent
        device buffers: it reads the row state from `_din`, writes the
        final state and `_last_logits` back in place and returns the
        [H, B] token block. The same function runs eagerly on the CPU
        and is captured as a CUDA graph on the card."""
        st = self._d_state
        args = (self._last_logits, st[0], st[1] != 0, st[2], st[3],
                self._d_keys, self._d_greedy != 0, self.temperature,
                self.cfg, H, greedy, self.top_k, self.top_p, self.eos_id)
        lora = {}
        if self.adapter_pool is not None:
            lora = dict(adapters=self.adapter_pool.stacks,
                        row_slot=self._d_slot)
        if self.paged:
            out = _decode_multi_paged(self.params, self._pool_k,
                                      self._pool_v,
                                      self._d_bt.to(torch.int32), *args,
                                      scale_k=self._scale_k,
                                      scale_v=self._scale_v,
                                      qspec=self.kv_quant_spec, tp=self._tp,
                                      **lora)
        else:
            out = _decode_multi(self.params, self.cache, *args,
                                max_len=self.max_len,
                                view_bt=self._view_bt, tp=self._tp, **lora)
        toks, last_logits, row_len, active, budget, tok_idx = out
        self._last_logits.copy_(last_logits)
        st.copy_(torch.stack([row_len, active.to(st.dtype), budget,
                              tok_idx]))
        return toks

    def _spec_body(self, W: int, greedy: bool) -> torch.Tensor:
        """One speculative round over the persistent device buffers
        (both planes, `_last_logits`, the row state, the draft lanes,
        keys, greedy lane, widths and block tables), writing the carry
        back in place; returns the [W+1, B] emit block. Runs eagerly on
        the CPU and is captured as a CUDA graph on the card."""
        st, dl = self._d_state, self._d_spec
        args = (self._last_logits, st[0], st[1] != 0, st[2], st[3], dl[0],
                dl[1], self._d_keys, self._d_greedy != 0, self._d_wrow,
                self.temperature, self.cfg, self.draft_cfg, W, greedy,
                self.top_k, self.top_p, self.eos_id)
        if self.paged:
            out = _spec_round_paged(
                self.params, self.draft_params, self._pool_k, self._pool_v,
                self._pool_dk, self._pool_dv, self._d_bt.to(torch.int32),
                self._d_bt_d.to(torch.int32), *args, scale_k=self._scale_k,
                scale_v=self._scale_v, scale_dk=self._scale_dk,
                scale_dv=self._scale_dv, qspec=self.kv_quant_spec,
                tp=self._tp, d_tp=self._d_tp)
        else:
            out = _spec_round(self.params, self.draft_params, self.cache,
                              self._d_cache, *args, max_len=self.max_len,
                              view_bt=self._view_bt, tp=self._tp,
                              d_tp=self._d_tp)
        emits, last_logits, row_len, active, budget, tok_idx, d_lag, \
            d_tok = out
        self._last_logits.copy_(last_logits)
        st.copy_(torch.stack([row_len, active.to(st.dtype), budget,
                              tok_idx]))
        dl.copy_(torch.stack([d_lag, d_tok]))
        return emits

    def _spec_plan(self, decodable: List[int]
                   ) -> Tuple[int, Optional[np.ndarray]]:
        """This dispatch's draft width. Each greedy decodable row's
        acceptance over its last 16 rounds feeds
        `SchedulerPolicy.spec_window_hint`; the dispatch width W is the
        largest hint rounded UP to a power of two (a bounded number of
        graphs, as with the horizon) and capped at `spec_window`, and
        each row keeps its own hint as its acceptance cap ``w_row``, so
        a narrowing row changes no graph. (0, None) declines: no
        decodable greedy row, or every greedy row down to its last
        budgeted token (a plain step emits that one token for less)."""
        greedy_rows = [b for b in decodable if self._row_greedy[b]]
        if not greedy_rows:
            return 0, None
        if int(self.row_budget[greedy_rows].max()) <= 1:
            return 0, None
        rates: List[Optional[float]] = []
        for b in greedy_rows:
            prop = sum(p for p, _ in self._spec_hist[b])
            acc = sum(a for _, a in self._spec_hist[b])
            rates.append(acc / prop if prop else None)
        hints = self.scheduler.spec_window_hint(
            rates=rates, spec_window=self.spec_window)
        w_row = np.ones((self.B,), np.int64)
        wmax = 1
        for b, w in zip(greedy_rows, hints):
            w = max(1, min(int(w), self.spec_window))
            w_row[b] = w
            wmax = max(wmax, w)
        return min(self.spec_window, _pow2(wmax)), w_row

    def _dispatch_spec(self, W: int, w_row: np.ndarray, rows: List[int],
                       run_ahead: bool) -> None:
        """Launch ONE speculative round, the twin of `_dispatch_decode`
        with the same async contract: the emit block's copy to the host
        starts at once, the carry (the draft lanes with it) stays on the
        device for a chained round, and the host pulls the block once,
        at drain. The ring entry's H is W+1, the block's height and the
        pessimistic count of tokens in flight."""
        tr = self.trace
        t0 = tr.now() if tr.enabled else 0.0
        self._stage_inputs(run_ahead, w_row)
        all_greedy = bool(self._row_greedy.all())
        body = functools.partial(self._spec_body, W, all_greedy)
        if self._graphs is None:
            toks = body()
        else:
            toks = self._graphs.run(("spec", W, all_greedy), body)
        self._ring.append(_InflightStep(
            _host_async(toks), W + 1, list(rows), run_ahead, spec=True,
            w_max=W, w_row=np.array(w_row, np.int64)))
        self.decode_dispatches += 1
        self.spec_dispatches += 1
        self.spec_dispatches_by_window[W] = \
            self.spec_dispatches_by_window.get(W, 0) + 1
        self.metrics.on_dispatch(W + 1, host_syncs=0)
        if tr.enabled:
            # the round's acceptance is known only at drain, where its
            # spec_verify span lands
            tr.add("spec_draft", t0, tr.now() - t0, lane="dispatch",
                   args={"window": W, "proposed": int(w_row[rows].sum()),
                         "rows": len(rows), "run_ahead": run_ahead})

    def _dispatch_decode(self, H: int, rows: List[int],
                         run_ahead: bool) -> None:
        """Launch ONE H-iteration decode step without waiting on
        anything: from replayed host state (primary) or chained off the
        previous dispatch's device row state (run-ahead). The token
        block's async copy to the host is issued at once, so it overlaps
        the device computing any queued successors."""
        tr = self.trace
        t0 = tr.now() if tr.enabled else 0.0
        self._stage_inputs(run_ahead)
        all_greedy = bool(self._row_greedy.all())
        body = functools.partial(self._decode_body, H, all_greedy)
        if self._graphs is None:
            toks = body()
        else:
            toks = self._graphs.run((H, all_greedy), body)
        self._ring.append(_InflightStep(_host_async(toks), H, list(rows),
                                        run_ahead))
        self.decode_dispatches += 1
        self.decode_iterations += H
        self.metrics.on_dispatch(H, host_syncs=0)
        if tr.enabled:
            tr.add("dispatch", t0, tr.now() - t0, lane="dispatch",
                   args={"horizon": H, "rows": len(rows),
                         "run_ahead": run_ahead})

    def _top_up_pipeline(self, rows: List[int],
                         horizon: Optional[int]) -> None:
        """Run ahead: keep up to `pipeline_depth` decode steps in flight
        while the engine is in a pure-decode stretch. Each queued step
        chains the previous dispatch's device row state. Horizons come
        from host budgets minus everything already in flight —
        pessimistic, so a queued step is never provably all-frozen; rows
        that finish mid-flight mask their tail iterations on the device
        (`pipeline_overrun_tokens`)."""
        if (self.pipeline_depth < 2 or self._row_prefill
                or self.scheduler.admissions_pending()):
            return
        while len(self._ring) < self.pipeline_depth:
            last = self._ring[-1]
            inflight = sum(e.H for e in self._ring)
            rem = int(self.row_budget[rows].max()) - inflight
            if rem <= 0:
                break              # every further iteration would overrun
            if last.spec:
                # Chain another round at the SAME widths: the adaptive
                # window moves only once the host has replayed
                # acceptance, and unchanged widths replay the same graph.
                if self.paged and not self._ensure_decode_blocks(
                        rows, last.w_max + 1, inflight):
                    break
                self._dispatch_spec(last.w_max, last.w_row, rows,
                                    run_ahead=True)
                continue
            if horizon is not None:
                Hn = horizon
            else:
                Hn = self.scheduler.horizon_hint(
                    free_slots=self.B - sum(r is not None
                                            for r in self.row_req),
                    max_horizon=self.decode_horizon)
                Hn = min(Hn, rem)
                Hn = 1 << max(0, Hn.bit_length() - 1)
            if self.paged and not self._ensure_decode_blocks(
                    rows, Hn, inflight):
                # Pool dry: no run-ahead. Preemption needs replayed host
                # state, so it only runs on the primary dispatch.
                break
            self._dispatch_decode(Hn, rows, run_ahead=True)

    def _drain_one(self, emitted: Dict[int, List[int]]) -> None:
        """Pull the OLDEST in-flight token block to the host (its async
        copy has been under way since dispatch) and replay it. With the
        ring topped up first, the device already computes the next
        step(s) while this replay runs."""
        tr = self.trace
        t0 = tr.now() if tr.enabled else 0.0
        entry = self._ring.popleft()
        depth = len(self._ring) + 1    # steps in flight at this drain
        self._pl_depth_sum += depth
        self._pl_depth_n += 1
        block = _device_get(entry.toks)
        self.host_syncs += 1
        self.host_transfer_bytes += block.nbytes
        self.metrics.on_host_sync(nbytes=block.nbytes)
        rounds, proposed, accepted = self._emit_block(block, entry,
                                                      emitted)
        self.metrics.on_pipeline_drain(depth, len(self._ring))
        if entry.spec and rounds:
            self.metrics.on_spec_round(rounds, proposed, accepted)
            if self.spec_metrics is not None:
                self.spec_metrics.observe(SpecStats(
                    rounds=rounds, proposed=proposed, accepted=accepted))
        if entry.spec and tr.enabled:
            tr.add("spec_verify", t0, tr.now() - t0, lane="drain",
                   args={"window": entry.w_max, "rounds": rounds,
                         "proposed": proposed, "accepted": accepted})
        if tr.enabled:
            tr.add("host_drain", t0, tr.now() - t0, lane="drain",
                   args={"horizon": entry.H, "depth": depth,
                         "bytes": block.nbytes})

    def _flush_pipeline(self, emitted: Dict[int, List[int]]) -> None:
        """Drain EVERY in-flight step: before any admission / prefill,
        and at end of stream, where host state must be fully caught up
        with the device."""
        if not self._ring:
            return
        self.pipeline_flushes += 1
        self.metrics.on_pipeline_flush()
        tr = self.trace
        t0 = tr.now() if tr.enabled else 0.0
        steps = len(self._ring)
        while self._ring:
            self._drain_one(emitted)
        if tr.enabled:
            tr.add("pipeline_flush", t0, tr.now() - t0, lane="drain",
                   args={"steps": steps})

    def run(self) -> Dict[int, List[int]]:
        """Drain queue + slots; returns {req_id: generated tokens} for
        every finished request and POPS them from the engine."""
        while self.pending():
            self.step()
        return {rid: self.pop_result(rid) for rid in list(self.finished)}

    def pop_result(self, req_id: int) -> List[int]:
        """Remove a FINISHED request and return its generated tokens. A
        shed request pops an empty list — check `shed_ids` first."""
        if req_id not in self.finished:
            raise KeyError(f"request {req_id} unknown or not finished")
        self.finished.discard(req_id)
        self.shed_ids.discard(req_id)
        return self.results.pop(req_id).tokens

    def begin_drain(self) -> None:
        """Stop accepting new requests; queued and in-flight ones still
        run to completion. Idempotent."""
        self.draining = True

    def drain(self) -> Dict[int, List[int]]:
        """`begin_drain()` + run to empty."""
        self.begin_drain()
        return self.run()

    def release_graphs(self) -> None:
        """Free the decode loop's captured CUDA graphs, after the card
        has finished with them. Under tensor parallelism over NCCL every
        rank calls it on each of its engines before the process group is
        destroyed: a graph that captured the group's collectives holds
        its communicator, and NCCL's teardown waits for every such graph
        to be freed, so with one alive `destroy_process_group` never
        returns. The engine stays usable: a key's next dispatch captures
        its graph again."""
        if self._graphs is not None:
            self._graphs.release()

    def halt(self) -> None:
        """Abandon this engine's work WITHOUT completing it: the fleet's
        failure path, the opposite of drain. Discards the async ring (its
        blocks are never replayed) and the prefill frontiers, releases
        every live row's paged blocks (blocks the prefix trie shares
        survive through the trie's own references) and every row's and
        pending admission's adapter-slot reference, drops the handoff
        lists, the swap ledger and the queue, and refuses new submits.
        ``results`` (prompt, emitted tokens, priority) is KEPT: the
        fleet rebuilds failover resubmissions from it. Idempotent; never
        raises, since the engine may be arbitrarily broken."""
        if self.halted:
            return
        self.halted = True
        self.draining = True
        if self.trace.enabled:
            self.trace.instant(
                "halt", lane="events",
                args={"queued": len(self.scheduler),
                      "live_rows": sum(r is not None for r in self.row_req),
                      "inflight_steps": len(self._ring)})
        self._ring.clear()
        self._row_prefill.clear()
        for row in range(self.B):
            if self.paged:
                try:
                    self._release_row_blocks(row)
                except Exception:    # never raise: the engine may be broken
                    pass
            if self._row_slot[row] and self.adapter_pool is not None:
                try:
                    self.adapter_pool.decref(int(self._row_slot[row]))
                except Exception:
                    pass
            self._row_slot[row] = 0
            self.row_req[row] = None
            self.row_len[row] = 0
            self.row_budget[row] = 0
            self._tok_idx[row] = 0
        if self.adapter_pool is not None:
            for slot in self._pending_slots.values():
                try:
                    self.adapter_pool.decref(slot)
                except Exception:
                    pass
        self._pending_slots.clear()
        self._handoff_ready.clear()
        self._handoff_ready_set.clear()
        if self.paged:
            self._swapped.clear()
        # A fresh empty policy, not N pops: a deferring policy could
        # return None forever once its probe's world is gone. The queued
        # requests stay reachable through `results`.
        self.scheduler = FIFOPolicy()

    def dump_trace(self, path: Optional[str] = None) -> List[dict]:
        """chrome://tracing export of the request-lifecycle spans."""
        return self.trace.dump(path, pid=self.engine_id)

    def kv_free_blocks(self) -> int:
        """KV blocks an admission could claim right now: free plus
        evictable cold prefix blocks. 0 for the dense engine (no pool).
        Pure host arithmetic."""
        if not self.paged:
            return 0
        n = self.kv_pool.free_blocks
        if self._prefix is not None:
            n += self._prefix.evictable_blocks()
        return n

    def kv_used_fraction(self) -> float:
        """Unreclaimable KV pressure in [0, 1]. Paged: fraction of pool
        blocks neither free nor evictable-cold. Dense: live slots /
        batch slots (each live slot pins a full max_len cache row)."""
        if self.paged:
            total = self.kv_pool.blocks_total
            return max(0.0, 1.0 - self.kv_free_blocks() / total)
        return sum(r is not None for r in self.row_req) / self.B

    def pending_prefill_tokens(self) -> int:
        """Prompt tokens accepted but not yet prefilled: every queued
        request's prompt (a recompute re-admission: prompt + emitted
        tokens; a swap-in owes none) plus the uncovered suffix of every
        row mid-chunked-prefill. A pure host count."""
        n = sum(len(st.prompt) - st.pos
                for st in self._row_prefill.values())
        try:
            queued = self.scheduler.queued_requests()
        except NotImplementedError:
            return n       # custom policy without the probe: rows only
        for r in queued:
            swap = self._swapped.get(r.req_id) if self.paged else None
            if swap is None:
                n += len(r.prompt)
            elif swap.host is None:
                n += len(r.prompt) + len(r.tokens)
        return n

    def prefix_match_tokens(self, prompt: List[int]) -> int:
        """Prompt tokens this engine could take from its prefix cache
        instead of prefilling, right now (0 without one). A host trie
        walk with peek=True: probing leaves LRU recency untouched."""
        if self._prefix is None:
            return 0
        ids, _ = self._prefix.match(prompt, peek=True)
        return len(ids) * self.prefix_block

    def stats(self) -> Dict[str, float]:
        """Flat numeric telemetry snapshot (EngineMetrics.stats) plus
        the engine's plain-int accounting and queue/slot/pipeline/pool
        state. The pipeline plane: ``pipeline_depth_effective`` is the
        mean number of steps in flight at each drain (1.0 =
        synchronous), ``host_lag_steps`` the ring length now, overrun
        tokens the masked run-ahead iterations of finished rows. The
        memory plane: ``prefix_*`` (lookups, hits, reused tokens,
        evictions, dense copies), ``kv_blocks_shared`` /
        ``kv_block_cows``, ``swap_*`` (swap-outs, bytes each way),
        ``chunked_prefill_stalls``, ``pending_prefill_tokens`` and
        ``kv_quant_enabled``. The speculative plane: ``spec_*``
        (dispatches, per-row rounds, proposed / accepted / wasted draft
        tokens, the lifetime acceptance rate, ``window_effective`` =
        proposed / rounds, draft seedings). The multi-LoRA plane:
        ``adapter_enabled``, ``adapter_prefetch_deferrals`` and the
        adapter pool's ``adapter_*`` keys (registered, slots, resident,
        pinned, lookups, hits, hit rate, prefetches, evictions). The
        handoff plane: ``prefill_only``, ``handoffs_*``,
        ``handoff_*_bytes``, ``requests_handoff_ready``; the tp plane:
        ``tp_degree`` (``decode_graphs`` stays 0 when the tp group's
        collectives cannot be captured). Every key is published, 0 where
        its feature is off."""
        def _ratio(num: float, den: float) -> float:
            return num / den if den else 0.0

        out = self.metrics.stats()
        live = float(sum(r is not None for r in self.row_req))
        out.update({
            "queue_depth": float(len(self.scheduler)),
            "live_slots": live,
            "slot_occupancy": live / self.B,
            "requests_shed": float(self.requests_shed),
            "draining": 1.0 if self.draining else 0.0,
            "uptime_s": max(0.0, self._clock() - self._start_t),
            "steps_total": float(self.steps_total),
            "decode_dispatches": float(self.decode_dispatches),
            "decode_iterations": float(self.decode_iterations),
            "prefill_dispatches": float(self.prefill_dispatches),
            "host_syncs": float(self.host_syncs),
            "host_syncs_per_token": _ratio(self.host_syncs,
                                           self.tokens_out),
            "host_transfer_bytes": float(self.host_transfer_bytes),
            "host_transfer_bytes_per_token": _ratio(
                self.host_transfer_bytes, self.tokens_out),
            "dispatches_per_token": _ratio(self.decode_dispatches,
                                           self.tokens_out),
            "prefill_real_tokens": float(self.prefill_real_tokens),
            "prefill_padded_tokens": float(self.prefill_padded_tokens),
            "prefill_padding_waste_frac": _ratio(
                self.prefill_padded_tokens,
                self.prefill_real_tokens + self.prefill_padded_tokens),
            "pending_prefill_tokens": float(self.pending_prefill_tokens()),
            "prefix_lookups": float(self.prefix_lookups),
            "prefix_hits": float(self.prefix_hits),
            "prefix_hit_rate": _ratio(self.prefix_hits,
                                      self.prefix_lookups),
            "prefix_reused_tokens": float(self.prefix_reused_tokens),
            "prefix_reused_frac": _ratio(
                self.prefix_reused_tokens,
                self.prefix_reused_tokens + self.prefill_real_tokens),
            "prefix_evictions": float(self.prefix_evictions),
            "prefix_copy_dispatches": float(self.prefix_copy_dispatches),
            "chunked_prefill_stalls": float(self.chunked_prefill_stalls),
            "pipeline_depth": float(self.pipeline_depth),
            "pipeline_depth_effective": _ratio(self._pl_depth_sum,
                                               self._pl_depth_n),
            "pipeline_flushes": float(self.pipeline_flushes),
            "pipeline_overrun_tokens": float(self.pipeline_overrun_tokens),
            "host_lag_steps": float(len(self._ring)),
            "decode_graphs": float(len(self._graphs.graphs)
                                   if self._graphs else 0),
            "decode_graph_replays": float(self._graphs.replays
                                          if self._graphs else 0),
            "paged": 1.0 if self.paged else 0.0,
            "kv_blocks_shared": float(self.kv_blocks_shared),
            "kv_block_cows": float(self.kv_block_cows),
            "preemptions": float(self.preemptions),
            "swap_ins": float(self.swap_ins),
            "swap_outs": float(self.swap_outs),
            "swap_in_bytes": float(self.swap_in_bytes),
            "swap_out_bytes": float(self.swap_out_bytes),
            "kv_used_fraction": self.kv_used_fraction(),
            "kv_quant_enabled": 1.0 if self.kv_quant else 0.0,
            "kv_bytes_per_token": float(self.kv_bytes_per_token),
            "kv_bytes_per_block": float(self.kv_bytes_per_block),
        })
        if self.paged:
            pool = self.kv_pool
            out.update({
                "kv_pool_blocks_total": float(pool.blocks_total),
                "kv_pool_blocks_in_use": float(pool.blocks_in_use),
                "kv_pool_blocks_free": float(pool.free_blocks),
                "kv_pool_occupancy": _ratio(pool.blocks_in_use,
                                            pool.blocks_total),
                "kv_free_blocks": float(self.kv_free_blocks()),
                "requests_swapped": float(len(self._swapped)),
            })
        if self._prefix is not None:
            out["prefix_blocks_in_use"] = float(self._prefix.blocks_in_use)
            out["prefix_blocks_total"] = float(self._prefix.blocks_total)
        out.update({
            "spec_enabled": 1.0 if self.spec_enabled else 0.0,
            "spec_window": float(self.spec_window if self.spec_enabled
                                 else 0),
            "spec_dispatches": float(self.spec_dispatches),
            "spec_rounds": float(self.spec_rounds),
            "spec_proposed": float(self.spec_proposed),
            "spec_accepted": float(self.spec_accepted),
            "spec_acceptance_rate": _ratio(self.spec_accepted,
                                           self.spec_proposed),
            "spec_window_effective": _ratio(self.spec_proposed,
                                            self.spec_rounds),
            "spec_draft_tokens_wasted": float(self.spec_wasted),
            "spec_prefill_dispatches": float(self.spec_prefill_dispatches),
        })
        if self.spec_enabled and self.paged:
            out["spec_kv_pool_blocks_in_use"] = float(
                self.kv_pool_d.blocks_in_use)
        # The multi-LoRA plane: identically 0.0 with no adapter pool.
        # The disaggregated-handoff plane: 0 on a colocated engine.
        out.update({
            "prefill_only": 1.0 if self.prefill_only else 0.0,
            "handoffs_out": float(self.handoffs_out),
            "handoffs_in": float(self.handoffs_in),
            "handoff_out_bytes": float(self.handoff_out_bytes),
            "handoff_in_bytes": float(self.handoff_in_bytes),
            "requests_handoff_ready": float(len(self._handoff_ready)),
            "tp_degree": float(self.tp_degree),
        })
        out["adapter_enabled"] = (1.0 if self.adapter_pool is not None
                                  else 0.0)
        out["adapter_prefetch_deferrals"] = float(self.adapter_deferrals)
        out.update(self.adapter_pool.stats() if self.adapter_pool is not None
                   else dict.fromkeys(ADAPTER_STATS_KEYS, 0.0))
        return out

    # -- internals ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        if not self.bucket_lens:
            return n
        return min(1 << (n - 1).bit_length(), self.max_len)

    def _req_key(self, req: _Request) -> Tuple[int, int]:
        """Per-request sampling stream: the submitted key verbatim, or
        one mixed host-side from the engine key and the request id."""
        if req.rng is not None:
            return req.rng
        mix0 = (req.req_id * 0x9E3779B9 + 1) & 0xFFFFFFFF
        mix1 = (req.req_id * 0x85EBCA6B + 1) & 0xFFFFFFFF
        return self._base_key[0] ^ mix0, self._base_key[1] ^ mix1

    def _shed(self, req: _Request) -> None:
        """Retire a past-deadline request WITHOUT admitting it."""
        req.done = True
        req.shed = True
        self.finished.add(req.req_id)
        self.shed_ids.add(req.req_id)
        self.requests_shed += 1
        self.metrics.on_shed(req.req_id)
        if self.trace.enabled:
            self.trace.close("queue_wait", req.req_id, {"shed": True})
            self.trace.finish(req.req_id, {"shed": True}, name="shed")

    def _on_prefix_evict(self, n: int) -> None:
        self.prefix_evictions += n
        self.metrics.on_prefix_evictions(n)

    def _prefix_probe(self, prompt) -> Tuple[int, Optional[tuple], bool]:
        """(matched_tokens, prefix_group_key, next_block_pending) for
        the prefix-affinity scheduler: a pure host trie walk. The group
        key (the prompt's first block) is None for prompts too short to
        ever share a block."""
        ids, pending = self._prefix.match(prompt)
        T = self.prefix_block
        key = tuple(prompt[:T]) if len(prompt) > T else None
        return len(ids) * T, key, pending

    def _admission_round(self) -> None:
        """One round of the admission gate (`step`, after its flush):
        commit landed adapter prefetches, pop queued requests into free
        rows (shedding expired ones, deferring on pool capacity or on a
        cold adapter, whose prefetch starts here), bind and prefill the
        admitted rows, and advance every chunked prefill by one chunk."""
        budget = self.max_prefills_per_step or self.B
        admissions: List[Tuple[int, _Request]] = []
        begin = getattr(self.scheduler, "begin_admission_round", None)
        if begin is not None:
            begin()
        # Commit landed adapter prefetches before gating, only with the
        # ring empty (`step` flushes it whenever admissions are pending):
        # as in JAX, no in-flight dispatch reads a slot being rewritten.
        if self.adapter_pool is not None and not self._ring:
            self.adapter_pool.drain_prefetches()
        deferred = False
        for row in range(self.B):
            if budget <= 0 or deferred:
                break
            if self.row_req[row] is not None:
                continue
            req = None
            while len(self.scheduler):
                cand = self.scheduler.pop()
                if cand is None:
                    deferred = True    # the prefix policy deferred all
                    break
                if cand.deadline is not None and \
                        self._decision_clock() >= cand.deadline and \
                        not cand.resume:
                    # Expired mid-queue: shed at the admission gate (a
                    # preempted request was admitted once and is exempt).
                    self._shed(cand)
                    continue
                if self.paged and not self._fits_now(cand):
                    # Capacity, not order, is the constraint: stop
                    # admitting and retry when retirements free blocks.
                    self._requeue_front(cand)
                    deferred = True
                    break
                if cand.adapter_id is not None:
                    # Adapter residency gate: acquire the slot HERE
                    # (refcount taken) so nothing admitted later this
                    # round can evict it; a cold adapter starts its
                    # prefetch and the request waits at the queue front
                    # instead of stalling the step.
                    slot = self.adapter_pool.alloc(cand.adapter_id)
                    if slot is None:
                        self.adapter_pool.prefetch(cand.adapter_id)
                        self._requeue_front(cand)
                        self.adapter_deferrals += 1
                        self.metrics.on_adapter_defer()
                        deferred = True
                        break
                    self._pending_slots[cand.req_id] = slot
                req = cand
                break
            if req is None:
                continue
            admissions.append((row, req))
            budget -= 1
        if deferred and self.trace.enabled:
            self.trace.instant("admission_defer", lane="events",
                               args={"queued": len(self.scheduler)})
        if admissions:
            self._admit_rows(admissions)
        self._advance_prefills()

    def _admit_rows(self, admissions: List[Tuple[int, _Request]]) -> None:
        """Bind this step's admissions to their rows and queue their
        prefills (run by `_advance_prefills` this step). With the prefix
        cache on, each admission first probes the trie: a warm prompt's
        matched blocks are COPIED from the prefix pool into the row
        (same-chain-length copies share one `_prefix_copy_in`) and only
        the suffix is prefilled; novel full blocks are registered
        PENDING and copied out as the row's prefill covers them. First
        tokens are NOT sampled here: each row's last-prompt logits stay
        on the device in `_last_logits` and the decode loop samples
        them. The paged engine admits through `_admit_rows_paged`."""
        if self.paged:
            self._admit_rows_paged(admissions)
            return
        copy_groups: Dict[int, List[Tuple[int, List[int]]]] = {}
        draft_seeds: List[Tuple[int, List[int]]] = []
        T = self.prefix_block
        for row, req in admissions:
            self.metrics.on_admit(req.req_id)
            if self.trace.enabled:
                self.trace.close("queue_wait", req.req_id)
                self.trace.instant("admit", req.req_id, {"row": row})
            if req.resume and req.tokens:
                # Fleet failover resume: re-prefill prompt + emitted
                # tokens (the K/V the dead replica held) and continue at
                # the saved token index. No trie traffic: emitted tokens
                # are not a shareable prompt.
                replay = list(req.prompt) + list(req.tokens)
                self._bind_row(row, req, [], 0)
                self.row_budget[row] = req.max_new_tokens - len(req.tokens)
                self._tok_idx[row] = len(req.tokens)
                self._row_prefill[row] = _PrefillState(req, 0, [],
                                                       prompt=replay)
                draft_seeds.append((row, replay))
                continue
            start = 0
            nodes: list = []
            # Adapter rows BYPASS the prefix trie: their K/V depends on
            # the adapter's deltas, so a block produced under adapter X
            # must never be matched by, or registered for, a request
            # under another adapter or the base model.
            if self._prefix is not None and req.adapter_id is None:
                ids, _ = self._prefix.match(req.prompt)
                self.prefix_lookups += 1
                if ids:
                    self.prefix_hits += 1
                    start = len(ids) * T
                    self.prefix_reused_tokens += start
                    # Pad the chain to a power of two by repeating its
                    # last block: the rewrite lands past the matched
                    # prefix, where the suffix prefill overwrites it.
                    nbp = _pow2(len(ids))
                    if nbp * T > self.max_len:
                        nbp = len(ids)
                    ids_p = list(ids) + [ids[-1]] * (nbp - len(ids))
                    copy_groups.setdefault(nbp, []).append((row, ids_p))
                nodes = self._prefix.extend(req.prompt)
                self.metrics.on_prefix(hit=bool(ids), reused_tokens=start)
                if self.trace.enabled:
                    self.trace.instant(
                        "prefix_match", req.req_id,
                        {"hit": bool(ids), "matched_tokens": start})
            self._bind_row(row, req, [], start)
            self._row_prefill[row] = _PrefillState(req, start, nodes)
            # the draft plane has no prefix cache: it is seeded with the
            # FULL prompt, even after a warm target admission
            draft_seeds.append((row, req.prompt))
        for nbp in sorted(copy_groups):
            grp = copy_groups[nbp]
            n = len(grp)
            rows = np.zeros((_pow2(n),), np.int64)
            bids = np.zeros((_pow2(n), nbp), np.int64)
            for i, (row, ids_p) in enumerate(grp):
                rows[i] = row
                bids[i] = ids_p
            rows[n:] = rows[n - 1]     # duplicate scatters: identical
            bids[n:] = bids[n - 1]     # values
            _prefix_copy_in(self.cache, self._pool_k, self._pool_v,
                            self._dev(bids), self._dev(rows), T)
            self.prefix_copy_dispatches += 1
        self._seed_draft_rows(draft_seeds)

    def _admit_rows_paged(
            self, admissions: List[Tuple[int, _Request]]) -> None:
        """Bind each admission to a BLOCK CHAIN and queue its prefill
        (run by `_advance_prefills` this step). A warm prompt's matched
        blocks are SHARED by incref, zero bytes moved; a FULL-prompt
        match shares all but the tail block, which is copied once
        (copy-on-write: the row's first generated token extends it; all
        the round's copies go in one `_cow_blocks`) and whose last token
        the prefill recomputes for its logits. Novel prompt blocks are
        fresh, registered PENDING in the trie and committed as the
        prefill covers them, with no copy. A preempted request re-binds
        through `_swap_in_row` instead."""
        T = self.prefix_block
        cow_pairs: List[Tuple[int, int]] = []
        draft_seeds: List[Tuple[int, List[int]]] = []
        for row, req in admissions:
            self.metrics.on_admit(req.req_id)
            swap = self._swapped.pop(req.req_id, None)
            if swap is not None:
                if not self._swap_in_row(row, req, swap):
                    # The gate's estimate went stale: requeue.
                    self._swapped[req.req_id] = swap
                    self._drop_pending_slot(req)
                    self._requeue_front(req)
                else:
                    # The swap never carries the draft plane: re-seed it
                    # from prompt + emitted, the sequence the target's
                    # restored K/V holds.
                    draft_seeds.append((row, req.prompt + req.tokens))
                continue
            if self.trace.enabled:
                self.trace.close("queue_wait", req.req_id)
                self.trace.instant("admit", req.req_id, {"row": row})
            start = 0
            shared: List[int] = []
            cow_src: Optional[int] = None
            nodes: list = []
            # Adapter rows bypass the trie (see `_admit_rows`).
            if self._prefix is not None and req.adapter_id is None:
                ids, _ = self._prefix.match(req.prompt, allow_full=True)
                self.prefix_lookups += 1
                if ids and len(ids) * T == len(req.prompt):
                    cow_src = int(ids[-1])
                    shared = [int(i) for i in ids[:-1]]
                    start = len(req.prompt) - 1
                elif ids:
                    shared = [int(i) for i in ids]
                    start = len(shared) * T
            n_total = -(-len(req.prompt) // T)
            # Pin the shared blocks FIRST: the eviction inside
            # _pool_alloc can then never recycle them under this row.
            self.kv_pool.incref(shared)
            new_ids = self._pool_alloc(n_total - len(shared))
            if new_ids is None:
                self.kv_pool.decref(shared)
                self._drop_pending_slot(req)
                if self.trace.enabled:
                    self.trace.open("queue_wait", req.req_id)
                self._requeue_front(req)
                continue
            if cow_src is not None:
                cow_pairs.append((cow_src, new_ids[0]))
                self.kv_block_cows += 1
                self.metrics.on_kv_cow()
            chain = shared + new_ids
            if self._prefix is not None and req.adapter_id is None:
                hit = bool(shared) or cow_src is not None
                if hit:
                    self.prefix_hits += 1
                self.prefix_reused_tokens += start
                self.kv_blocks_shared += len(shared)
                if shared:
                    self.metrics.on_kv_shared(len(shared))
                self.metrics.on_prefix(hit=hit, reused_tokens=start)
                if self.trace.enabled:
                    self.trace.instant(
                        "prefix_match", req.req_id,
                        {"hit": hit, "matched_tokens": start,
                         "shared_blocks": len(shared),
                         "cow": cow_src is not None})
                nodes = self._prefix.register(req.prompt, chain)
            self._bind_row(row, req, chain, start)
            self._row_prefill[row] = _PrefillState(req, start, nodes)
            draft_seeds.append((row, req.prompt))
        if cow_pairs:
            n_pad = _pow2(len(cow_pairs))
            src = np.zeros((n_pad,), np.int64)   # pad = null block:
            dst = np.zeros((n_pad,), np.int64)   # 0 -> 0 is a no-op
            for i, (a, b) in enumerate(cow_pairs):
                src[i] = a
                dst[i] = b
            _cow_blocks(self._pool_tensors(), self._dev(src),
                        self._dev(dst))
        self._seed_draft_rows(draft_seeds)

    def _seed_draft_rows(self, seeds: List[Tuple[int, List[int]]]) -> None:
        """Seed the DRAFT plane of freshly (re)bound rows: one
        full-sequence draft prefill per length bucket, in the admission
        step (the draft is cheap; the target's chunked prefill still
        paces TTFT), in place, padded to a power of two rows by
        repeating the last. Each seeded row's draft lanes and acceptance
        history restart. A draft chain that cannot be allocated skips
        the seed: a cold draft only lowers acceptance, never the tokens.
        A no-op without a draft plane."""
        if not self.spec_enabled or not seeds:
            return
        T = self.prefix_block
        groups: Dict[int, List[Tuple[int, List[int]]]] = {}
        for row, toks in seeds:
            self._d_lag[row] = 0
            self._d_tok[row] = 0
            self._spec_hist[row].clear()
            if self.paged and not self._ensure_draft_blocks(
                    row, -(-len(toks) // T)):
                continue
            Cb = min(self._bucket(len(toks)), self.max_len)
            groups.setdefault(Cb, []).append((row, toks))
        for Cb in sorted(groups):
            grp = groups[Cb]
            n = len(grp)
            t0 = self.trace.now() if self.trace.enabled else 0.0
            n_pad = _pow2(n)
            prompts = np.zeros((n_pad, Cb), np.int64)
            rows = np.zeros((n_pad,), np.int64)
            last_idx = np.zeros((n_pad,), np.int64)
            for i, (row, toks) in enumerate(grp):
                prompts[i, :len(toks)] = toks
                rows[i] = row
                last_idx[i] = len(toks) - 1
            prompts[n:] = prompts[n - 1]    # filler: repeat the last row,
            rows[n:] = rows[n - 1]          # whose duplicate scatters
            last_idx[n:] = last_idx[n - 1]  # write identical values
            args = (self._dev(rows), self._dev(np.zeros_like(rows)),
                    self._dev(last_idx), self.draft_cfg)
            if self.paged:
                _prefill_rows_paged(
                    self.draft_params, self._dev(prompts), self._pool_dk,
                    self._pool_dv, self._d_last_logits,
                    self._dev(self._bt_d[rows]), *args,
                    scale_k=self._scale_dk, scale_v=self._scale_dv,
                    qspec=self.kv_quant_spec, tp=self._d_tp)
            else:
                _prefill_rows(self.draft_params, self._dev(prompts),
                              self._d_cache, self._d_last_logits, *args,
                              tp=self._d_tp)
            self.spec_prefill_dispatches += 1
            if self.trace.enabled:
                self.trace.add("spec_draft_prefill", t0,
                               self.trace.now() - t0, lane="dispatch",
                               args={"bucket": Cb, "rows": n})

    def _bind_row(self, row: int, req: _Request, chain: List[int],
                  start: int) -> None:
        """Reset a slot row's decode state for `req` and, paged, point
        it at its block chain (budget/tok_idx are overridden by the
        swap-in path, which restores rather than restarts)."""
        self.row_req[row] = req
        self.row_len[row] = start
        self.row_budget[row] = req.max_new_tokens
        self._tok_idx[row] = 0
        self._row_keys[row] = self._req_key(req)
        self._row_greedy[row] = (self.greedy if req.greedy is None
                                 else bool(req.greedy))
        self._row_slot[row] = self._pending_slots.pop(req.req_id, 0)
        if self.paged:
            self._row_blocks[row] = list(chain)
            self._bt[row, :] = 0
            self._bt[row, :len(chain)] = chain
            self._row_admit_seq[row] = self._admit_seq
            self._admit_seq += 1

    def _requeue_front(self, req: _Request) -> None:
        self.scheduler.push_front(req)
        self.metrics.observe_queue_depth(len(self.scheduler))

    def _drop_pending_slot(self, req: _Request) -> None:
        """Return the adapter-slot reference the admission gate took for
        a request requeued AFTER the gate (stale capacity estimate,
        swap-in failure): it re-allocs at the gate next round, so the
        pending reference must go or the slot leaks a count and can
        never evict."""
        slot = self._pending_slots.pop(req.req_id, 0)
        if slot:
            self.adapter_pool.decref(slot)

    def _release_row_slot(self, row: int) -> None:
        """Drop a retiring or preempted row's adapter-slot reference; a
        refcount-0 slot stays RESIDENT (LRU), so the next same-adapter
        request is a hit. The gate re-allocs at re-admission."""
        if self._row_slot[row]:
            self.adapter_pool.decref(int(self._row_slot[row]))
            self._row_slot[row] = 0

    def _pool_alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks, evicting cold committed prefix blocks LRU
        first when the free list runs short (the trie never evicts a
        block any row still holds). None when nothing more can be
        evicted: the caller preempts a row or defers the admission."""
        if n <= 0:
            return []
        ids = self.kv_pool.alloc(n)
        while ids is None:
            if self._prefix is None or not self._prefix.evict_one():
                return None
            ids = self.kv_pool.alloc(n)
        return ids

    def _ensure_decode_blocks(self, rows: List[int], H: int,
                              inflight: int = 0) -> bool:
        """Grow each row's chain to cover ``row_len + inflight + H``
        slots (capped at the row's completion point and at max_len).
        Growth appends to the host block table only; in-flight
        dispatches hold their own device snapshot. False when the pool
        cannot cover it; rows already grown keep their blocks (no leak:
        the retry after preemption re-walks them as no-ops)."""
        T = self.kv_block_tokens
        for b in rows:
            req = self.row_req[b]
            lim = min(len(req.prompt) + req.max_new_tokens, self.max_len)
            need_slots = min(int(self.row_len[b]) + inflight + H, lim)
            nb = -(-need_slots // T)
            have = len(self._row_blocks[b])
            if nb > have:
                got = self._pool_alloc(nb - have)
                if got is None:
                    return False
                self._row_blocks[b].extend(got)
                self._bt[b, have:have + len(got)] = got
            if self.spec_enabled and not self._ensure_draft_blocks(b, nb):
                return False
        return True

    def _ensure_draft_blocks(self, b: int, nb: int) -> bool:
        """Grow row ``b``'s DRAFT chain to ``nb`` blocks. The draft pool
        holds a full chain for every slot, so this cannot fail for live
        rows; False is returned defensively (callers treat it as a dry
        target pool). Coverage is for acceptance, not correctness: a
        draft write past the chain lands in the null block, which no
        live query attends, and a garbage draft only lowers
        acceptance."""
        have = len(self._row_blocks_d[b])
        if nb <= have:
            return True
        got = self.kv_pool_d.alloc(nb - have)
        if got is None:
            return False
        self._row_blocks_d[b].extend(got)
        self._bt_d[b, have:have + len(got)] = got
        return True

    def _reserve_decode_blocks(self, decodable: List[int],
                               H: int) -> Tuple[List[int], int]:
        """Every decodable row must own the blocks its next H tokens
        write. When the pool runs dry, PREEMPT victims (newest admission
        first) until the survivors fit. Only called with the pipeline
        ring empty: preemption reads host row state, which must be fully
        replayed."""
        decodable = list(decodable)
        while not self._ensure_decode_blocks(decodable, H):
            if len(decodable) <= 1:
                if H > 1:
                    H = 1      # shrink the horizon before giving up
                    continue
                raise RuntimeError(
                    "paged KV pool exhausted with a single decodable row "
                    "at horizon 1 — kv_pool_bytes is too small for this "
                    "request shape")
            victim = self._choose_victim(decodable)
            self._preempt_row(victim)
            decodable.remove(victim)
        return decodable, H

    def _choose_victim(self, rows: List[int]) -> int:
        """Rows go to the scheduler's `choose_victim` oldest-admission
        first; the built-in policies take the newest (LIFO)."""
        ordered = sorted(rows, key=lambda b: self._row_admit_seq[b])
        return self.scheduler.choose_victim(ordered, self.row_req)

    def _preempt_row(self, row: int) -> None:
        """Evict a live row mid-decode and requeue it at the FRONT.
        preempt="swap" gathers its blocks (and a quantized pool's scale
        rows) into fresh tensors and starts their copy to pinned host
        memory (`_host_async`: an event, no wait); the blocks go back to
        the pool at once, since anything later that reuses them is
        enqueued after the gather. preempt="recompute" just drops them;
        re-admission replays prompt + emitted tokens. Either way the
        token stream continues unchanged: the sampling noise depends
        only on the request's key and token index. Needs a drained ring:
        the swap ledger reads the row's replayed host state."""
        assert not self._ring, "preemption needs a drained pipeline"
        req = self.row_req[row]
        ids = self._row_blocks[row]
        host = logits = None
        if self.preempt_mode == "swap":
            nbp = _pow2(max(1, len(ids)))
            bids = np.zeros((nbp,), np.int64)
            bids[:len(ids)] = ids
            parts = _swap_out_gather(self._pool_tensors(), self._dev(bids))
            host = [_host_async(x) for x in parts]
            logits = _host_async(self._last_logits[row].clone())
        swap = _SwapState(host, len(ids), int(self.row_len[row]),
                          int(self._tok_idx[row]),
                          int(self.row_budget[row]), logits)
        self._swapped[req.req_id] = swap
        if host is not None:
            self.swap_outs += 1
            self.swap_out_bytes += swap.nbytes
            self.metrics.on_swap_out(swap.nbytes)
        self._release_row_blocks(row)
        self._release_row_slot(row)
        self.row_req[row] = None
        self.row_len[row] = 0
        self.row_budget[row] = 0
        self._tok_idx[row] = 0
        self.preemptions += 1
        self.metrics.on_preempt()
        if self.trace.enabled:
            self.trace.span_since_mark(
                "preempt_swap_out", req.req_id,
                {"mode": self.preempt_mode, "blocks": len(ids),
                 "bytes": swap.nbytes})
        req.resume = True
        self._requeue_front(req)

    def _swap_in_row(self, row: int, req: _Request,
                     swap: _SwapState) -> bool:
        """Re-admit a preempted request. Swap mode scatters its host
        copies into a fresh chain and restores the row exactly where it
        froze: decodable this very step, no prefill. Recompute mode
        re-prefills prompt + emitted tokens and continues the stream at
        the saved token index. False if the pool cannot cover it now
        (the caller requeues)."""
        T = self.prefix_block
        if swap.host is None:
            replay = list(req.prompt) + list(req.tokens)
            ids = self._pool_alloc(-(-len(replay) // T))
            if ids is None:
                return False
            self._bind_row(row, req, ids, 0)
            self.row_budget[row] = req.max_new_tokens - len(req.tokens)
            self._tok_idx[row] = len(req.tokens)
            # No trie registration: emitted tokens are not a prompt.
            self._row_prefill[row] = _PrefillState(req, 0, [],
                                                   prompt=replay)
            self.swap_ins += 1
            if self.trace.enabled:
                self.trace.span_since_mark(
                    "swap_in", req.req_id,
                    {"mode": "recompute", "replay_tokens": len(replay)})
            return True
        ids = self._pool_alloc(swap.n_blocks)
        if ids is None:
            return False
        nbp = _pow2(max(1, swap.n_blocks))
        bids = np.zeros((nbp,), np.int64)     # pad = null block: the
        bids[:swap.n_blocks] = ids            # gather's padding lands
        #                                       back where it came from
        _swap_in_scatter(self._pool_tensors(), [b.data for b in swap.host],
                         self._dev(bids))
        self._last_logits[row].copy_(swap.logits.data, non_blocking=True)
        self._bind_row(row, req, ids, swap.row_len)
        self.row_budget[row] = swap.budget
        self._tok_idx[row] = swap.tok_idx
        self.swap_ins += 1
        self.swap_in_bytes += swap.nbytes
        self.metrics.on_swap_in(swap.nbytes)
        if self.trace.enabled:
            self.trace.span_since_mark(
                "swap_in", req.req_id,
                {"mode": "swap", "bytes": swap.nbytes,
                 "blocks": swap.n_blocks})
        return True

    # -- disaggregated prefill/decode handoff ------------------------------

    def handoff_ready(self) -> List[int]:
        """Request ids parked after their prefill on a prefill-only
        engine, oldest first, each waiting for the fleet to
        `export_request` it. Always empty on a colocated engine."""
        return list(self._handoff_ready)

    def _pool_shape(self) -> Tuple[int, int, int]:
        """(L, KV, D) of the paged pool, KV counting every kv head of
        the model (a tp rank holds some of them): what a handoff payload
        must match to be scattered in verbatim."""
        return (int(self._pool_k.shape[0]), self.cfg.n_kv_heads,
                int(self._pool_k.shape[4]))

    def export_request(self, req_id: int) -> dict:
        """Extract a request whose prefill completed: the engine half of
        the disaggregated prefill->decode handoff.

        The request must be bound to a live row that is NOT
        mid-chunked-prefill, with the ring empty (a prefill-only engine
        never dispatches decode, so its ring always is). A paged engine
        gathers the row's blocks through `_swap_out_gather` (pages, a
        quantized pool's raw bytes and scale rows, verbatim) with the
        row's next-token logits, and waits for their copy to pinned host
        memory; a dense engine exports no bytes and the importer
        re-prefills. Either way the row's blocks and adapter pin are
        released, and the request leaves this engine, ``results``
        included.

        The payload has the JAX package's keys: ``req_id``, ``prompt``,
        ``max_new_tokens``, ``priority``, ``greedy``, ``rng``,
        ``adapter_id``, ``tokens`` and ``kv`` (None, or ``k``, ``v``,
        ``sk``, ``sv`` [host tensors], ``n_blocks``, ``row_len``,
        ``tok_idx``, ``budget``, ``logits``, ``block_tokens``, ``quant``
        and ``pool_shape``). Token identity holds because a completed
        prefill IS a preemption at token index 0: the importer samples
        the first token from the carried logits with the same key."""
        row = next((b for b, r in enumerate(self.row_req)
                    if r is not None and r.req_id == req_id), None)
        if row is None:
            raise RuntimeError(
                f"export_request: request {req_id} is not bound to a row "
                "(still queued, already finished, or unknown)")
        if row in self._row_prefill:
            raise RuntimeError(
                f"export_request: request {req_id} is still mid-chunked-"
                "prefill; export only after its frontier completes (see "
                "handoff_ready())")
        if self._ring:
            raise RuntimeError(
                "export_request needs a drained pipeline (in-flight decode "
                "blocks still reference row state); export between steps")
        req = self.row_req[row]
        kv = None
        nbytes = 0
        if self.paged:
            ids = self._row_blocks[row]
            nbp = _pow2(max(1, len(ids)))
            bids = np.zeros((nbp,), np.int64)
            bids[:len(ids)] = ids
            parts = _swap_out_gather(self._pool_tensors(), self._dev(bids))
            blocks = [_host_async(x) for x in
                      parts + [self._last_logits[row].clone()]]
            for b in blocks:
                if b.event is not None:
                    b.event.synchronize()
            host = [b.data for b in blocks]
            # under tp the payload is made whole, as a one-card engine's
            host[:-1] = [self._heads_whole(x, 3 if x.dim() == 5 else 2)
                         for x in host[:-1]]
            k, v, lg = host[0], host[1], host[-1]
            sk, sv = (host[2], host[3]) if len(host) == 5 else (None, None)
            nbytes = sum(x.nbytes for x in host)
            kv = {"k": k, "v": v, "sk": sk, "sv": sv,
                  "n_blocks": len(ids),
                  "row_len": int(self.row_len[row]),
                  "tok_idx": int(self._tok_idx[row]),
                  "budget": int(self.row_budget[row]),
                  "logits": lg,
                  "block_tokens": self.prefix_block,
                  "quant": self.kv_quant,
                  "pool_shape": self._pool_shape()}
            self._release_row_blocks(row)
        # the importer's admission gate re-pins on its own pool
        self._release_row_slot(row)
        handoff = {"req_id": req.req_id,
                   "prompt": list(req.prompt),
                   "max_new_tokens": req.max_new_tokens,
                   "priority": req.priority,
                   "greedy": req.greedy,
                   "rng": req.rng,
                   "adapter_id": req.adapter_id,
                   "tokens": list(req.tokens),
                   "kv": kv}
        self.row_req[row] = None
        self.row_len[row] = 0
        self.row_budget[row] = 0
        self._tok_idx[row] = 0
        self._row_greedy[row] = bool(self.greedy)
        self.results.pop(req.req_id, None)
        if req.req_id in self._handoff_ready_set:
            self._handoff_ready_set.discard(req.req_id)
            self._handoff_ready.remove(req.req_id)
        self.handoffs_out += 1
        self.handoff_out_bytes += nbytes
        self.metrics.on_handoff_out(req.req_id, nbytes)
        if self.trace.enabled:
            self.trace.span_since_mark(
                "handoff_export", req.req_id,
                {"bytes": nbytes,
                 "blocks": 0 if kv is None else kv["n_blocks"],
                 "tokens": len(req.tokens)})
        return handoff

    def import_request(self, handoff: dict) -> int:
        """Admit a request exported from another engine: the decode half
        of the handoff. It is submitted under THIS engine's queue
        discipline (same key, greedy mode, priority, adapter). A payload
        that fits this pool (paged, same block size, same quantization,
        same (L, KV, D)) seeds the swap ledger, so admission scatters
        its bytes back through `_swap_in_scatter` and the row decodes at
        once, with no re-prefill; any other payload runs by recompute
        (prompt + emitted tokens re-prefilled), slower but the same
        tokens. Returns the request's id on this engine."""
        kv = handoff.get("kv")
        toks = handoff.get("tokens") or []
        rid = self.submit(
            handoff["prompt"], handoff["max_new_tokens"],
            priority=handoff.get("priority", 0), rng=handoff.get("rng"),
            greedy=handoff.get("greedy"), resume_tokens=toks or None,
            adapter_id=handoff.get("adapter_id"))
        req = self.results[rid]
        req.handoff = True
        compatible = (
            kv is not None and self.paged
            and kv["block_tokens"] == self.prefix_block
            and kv["quant"] == self.kv_quant
            and tuple(kv["pool_shape"]) == self._pool_shape())
        nbytes = 0
        if compatible:
            # replaces the recompute entry a resume may have planted
            parts = [kv["k"], kv["v"]]
            if kv["sk"] is not None:
                parts += [kv["sk"], kv["sv"]]
            if is_split(self._tp):
                # this rank's kv heads of the whole payload
                heads = torch.tensor(self._kv_heads)
                parts = [x.index_select(3 if x.dim() == 5 else 2, heads)
                         for x in parts]
            swap = _SwapState([_HostBlock(x, None) for x in parts],
                              kv["n_blocks"], kv["row_len"], kv["tok_idx"],
                              kv["budget"], _HostBlock(kv["logits"], None))
            self._swapped[rid] = swap
            req.resume = True
            nbytes = swap.nbytes
        self.handoffs_in += 1
        self.handoff_in_bytes += nbytes
        self.metrics.on_handoff_in(nbytes)
        if self.trace.enabled:
            self.trace.span_since_mark(
                "handoff_import", rid,
                {"bytes": nbytes,
                 "mode": "swap" if compatible else "recompute"})
        return rid

    def _release_row_blocks(self, row: int) -> None:
        """Drop the row's reference on its chain and point the table
        back at the null block."""
        ids = self._row_blocks[row]
        if ids:
            self.kv_pool.decref(ids)
        self._row_blocks[row] = []
        self._bt[row, :] = 0
        if self.spec_enabled:
            # draft chains are private: decref frees them, and the plane
            # is seeded anew at (re-)admission
            d_ids = self._row_blocks_d[row]
            if d_ids:
                self.kv_pool_d.decref(d_ids)
            self._row_blocks_d[row] = []
            self._bt_d[row, :] = 0

    def _fits_now(self, req: _Request) -> bool:
        """Admission gate: would this request's NEW blocks fit the pool
        right now, counting evictable cold trie blocks? A pure host
        probe (peek=True: deferring must not touch LRU recency). A stale
        optimistic answer is safe: `_admit_rows_paged` re-checks."""
        T = self.prefix_block
        swap = self._swapped.get(req.req_id)
        if swap is not None:
            if swap.host is not None:
                need = swap.n_blocks
            else:
                need = -(-(len(req.prompt) + len(req.tokens)) // T)
        else:
            need = -(-len(req.prompt) // T)
            # Adapter rows take no prefix credit: they bypass the trie.
            if self._prefix is not None and req.adapter_id is None:
                ids, _ = self._prefix.match(req.prompt, peek=True,
                                            allow_full=True)
                if ids and len(ids) * T == len(req.prompt):
                    need -= len(ids) - 1   # the tail block is copied
                else:
                    need -= len(ids)
        return need <= self.kv_free_blocks()

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card it goes
        through pinned memory with a non-blocking copy, so the host
        does not wait for the stream to reach it."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _advance_prefills(self) -> None:
        """Advance every mid-prefill row by one chunk (the whole
        remaining prompt when `prefill_chunk` is None), same-bucket
        chunks batched into ONE `_prefill_rows` / `_prefill_rows_paged`
        call, padded to a power of two rows by repeating the last. A row
        whose frontier reaches its prompt's end leaves `_row_prefill`
        and is decodable this same step (its last chunk scattered the
        true last-prompt logits). Prefix blocks the frontier has passed
        are committed to the trie (paged) or copied out to the prefix
        pool first (dense)."""
        if not self._row_prefill:
            return
        groups: Dict[int, List[Tuple[int, _PrefillState, int]]] = {}
        for row, st in self._row_prefill.items():
            C = len(st.prompt) - st.pos
            if self.prefill_chunk is not None:
                C = min(C, self.prefill_chunk)
            # Bucket the chunk, capped so the write never runs past
            # max_len.
            Cb = min(self._bucket(C), self.max_len - st.pos)
            groups.setdefault(Cb, []).append((row, st, C))
        for Cb in sorted(groups):
            grp = groups[Cb]
            n = len(grp)
            t0 = self.trace.now() if self.trace.enabled else 0.0
            n_pad = _pow2(n)
            prompts = np.zeros((n_pad, Cb), np.int64)
            rows = np.zeros((n_pad,), np.int64)
            starts = np.zeros((n_pad,), np.int64)
            last_idx = np.zeros((n_pad,), np.int64)
            real = 0
            for i, (row, st, C) in enumerate(grp):
                prompts[i, :C] = st.prompt[st.pos:st.pos + C]
                rows[i] = row
                starts[i] = st.pos
                last_idx[i] = C - 1
                real += C
            prompts[n:] = prompts[n - 1]   # filler: repeat the last row,
            rows[n:] = rows[n - 1]         # whose duplicate scatters
            starts[n:] = starts[n - 1]     # write identical values
            last_idx[n:] = last_idx[n - 1]
            args = (self._dev(rows), self._dev(starts), self._dev(last_idx),
                    self.cfg)
            # The chunks' adapter-slot lane, gathered from the engine's
            # [B] lane (filler rows repeat the last real row's slot).
            lora = {}
            if self.adapter_pool is not None:
                lora = dict(adapters=self.adapter_pool.stacks,
                            row_slot=self._dev(self._row_slot[rows]))
            if self.paged:
                _prefill_rows_paged(
                    self.params, self._dev(prompts), self._pool_k,
                    self._pool_v, self._last_logits,
                    self._dev(self._bt[rows]), *args,
                    scale_k=self._scale_k, scale_v=self._scale_v,
                    qspec=self.kv_quant_spec, tp=self._tp, **lora)
            else:
                _prefill_rows(self.params, self._dev(prompts), self.cache,
                              self._last_logits, *args, tp=self._tp, **lora)
            self.prefill_dispatches += 1
            padded = n_pad * Cb - real
            self.prefill_real_tokens += real
            self.prefill_padded_tokens += padded
            self.metrics.on_prefill_batch(real, padded)
            if self.trace.enabled:
                self.trace.add("prefill_dispatch", t0,
                               self.trace.now() - t0, lane="dispatch",
                               args={"bucket": Cb, "rows": n,
                                     "real": real, "padded": padded})
        done_rows = []
        for grp in groups.values():
            for row, st, C in grp:
                st.pos += C
                self.row_len[row] = st.pos
                if self.trace.enabled:
                    self.trace.span_since_mark(
                        "prefill_chunk", st.req.req_id,
                        {"pos": st.pos, "tokens": C,
                         "prompt_tokens": len(st.prompt)})
                if self._prefix is not None:
                    if self.paged:
                        self._commit_covered(st)
                    else:
                        self._flush_copy_out(row, st)
                if st.pos >= len(st.prompt):
                    done_rows.append(row)
        for row in done_rows:
            del self._row_prefill[row]

    def _commit_covered(self, st: _PrefillState) -> None:
        """Paged twin of `_flush_copy_out`: the row's prefill wrote the
        trie's blocks in place (they ARE its chain), so a pending block
        the frontier has covered just commits, with no copy."""
        T = self.prefix_block
        while st.nodes and (st.nodes[0][0] + 1) * T <= st.pos:
            _, node = st.nodes.pop(0)
            self._prefix.commit(node)

    def _flush_copy_out(self, row: int, st: _PrefillState) -> None:
        """Copy every pending prefix block the row's frontier now covers
        out to the prefix pool (one `_prefix_copy_out` per consecutive
        run, padded to a power of two with the scratch block) and COMMIT
        it: from the next admission round on, `match` hands the block to
        warm requests."""
        T = self.prefix_block
        while st.nodes and (st.nodes[0][0] + 1) * T <= st.pos:
            run = [st.nodes.pop(0)]
            while st.nodes and st.nodes[0][0] == run[-1][0] + 1 and \
                    (st.nodes[0][0] + 1) * T <= st.pos:
                run.append(st.nodes.pop(0))
            bids = np.zeros((_pow2(len(run)),), np.int64)
            for i, (_, node) in enumerate(run):
                bids[i] = node.block_id
            _prefix_copy_out(self.cache, self._pool_k, self._pool_v, row,
                             run[0][0] * T, self._dev(bids), T)
            self.prefix_copy_dispatches += 1
            for _, node in run:
                self._prefix.commit(node)

    def _emit_block(self, block: np.ndarray, entry: _InflightStep,
                    emitted: Dict[int, List[int]]) -> Tuple[int, int, int]:
        """Host replay of one [H, B] token block, mirroring
        `_decode_loop`'s per-iteration transition. Each column is a
        prefix of real tokens followed by -1s (a row freezes once and
        stays frozen), so replaying the transition once with the count
        of real tokens equals replaying it token by token:
            budget  -= count;  tok_idx += count
            done     = budget <= 0 | row_len + count >= max_len
                       | last_tok == eos
            row_len += count if continuing
        Rows found already retired only occur in run-ahead blocks
        dispatched before the host replayed the retiring block; their
        columns are all-masked on the device and accounted as
        `pipeline_overrun_tokens`.

        A speculative round's [W+1, B] block replays the same way, and
        returns (rounds, proposed, accepted) for `_drain_one` (all 0 for
        a plain block): each live greedy row is one round that proposed
        ``w_row[b]`` draft tokens, of which ``count - 1`` were accepted
        (the verify pass's own token is free). The host draft lanes
        mirror the device's: a fully emitted round leaves its last token
        owed to the draft (lag 1), any other leaves none (lag 0)."""
        tr = self.trace
        rounds = proposed = accepted = 0
        for b in entry.rows:
            req = self.row_req[b]
            if req is None:
                if entry.run_ahead:
                    self.pipeline_overrun_tokens += entry.H
                    self.metrics.on_pipeline_overrun(entry.H)
                continue
            col = block[:, b]
            count = int((col != -1).sum())
            if count == 0:
                continue
            toks = col[:count].tolist()
            req.tokens.extend(toks)
            emitted.setdefault(req.req_id, []).extend(toks)
            self.metrics.on_tokens(req.req_id, count)
            if tr.enabled:
                tr.span_since_mark("decode_block", req.req_id,
                                   {"tokens": count, "horizon": entry.H,
                                    "batch": len(entry.rows)})
            if entry.spec and self._row_greedy[b]:
                prop_b, acc_b = int(entry.w_row[b]), count - 1
                rounds += 1
                proposed += prop_b
                accepted += acc_b
                self.spec_rounds += 1
                self.spec_proposed += prop_b
                self.spec_accepted += acc_b
                self.spec_wasted += prop_b - acc_b
                self._spec_hist[b].append((prop_b, acc_b))
            self.row_budget[b] -= count
            self._tok_idx[b] += count
            out_of_room = self.row_len[b] + count >= self.max_len
            if (self.row_budget[b] <= 0 or out_of_room
                    or (self.eos_id is not None
                        and toks[-1] == self.eos_id)):
                req.done = True
                self.finished.add(req.req_id)
                self.metrics.on_finish(req.req_id)
                if tr.enabled:
                    tr.finish(req.req_id, {"tokens": len(req.tokens)})
                self.row_req[b] = None
                self.row_len[b] = 0
                self.row_budget[b] = 0
                self._tok_idx[b] = 0
                self._row_greedy[b] = bool(self.greedy)
                if self.spec_enabled:
                    self._d_lag[b] = 0
                    self._d_tok[b] = 0
                if self.paged:
                    # The blocks return to the pool NOW, so admission
                    # capacity tracks finished tokens, not live slots.
                    self._release_row_blocks(b)
                self._release_row_slot(b)
            else:
                self.row_len[b] += count
                if entry.spec:
                    full = count == entry.H
                    self._d_lag[b] = 1 if full else 0
                    self._d_tok[b] = toks[-1] if full else 0
        return rounds, proposed, accepted
