"""Continuous-batching decode engine: a dense per-slot KV cache or a
paged KV block pool, fused multi-step decode, an async run-ahead ring.

Port of `ray_tpu/models/engine.py`. B fixed decode slots advance
together, every row at its OWN cache offset, in one of two KV layouts:

- dense (the default, ``paged=False``): one cache ``[L, B, max_len, KV,
  D]`` (`generate.init_cache`), row b's K/V in slot row b;
- paged (``paged=True``): every row's K/V in refcounted blocks of ONE
  pool ``[L, NB, T, KV, D]`` addressed through per-row block tables
  (`models/block_pool.py`); when decode growth runs the pool dry, the
  newest row is PREEMPTED (its blocks freed, re-queued at the front,
  prompt + emitted tokens re-prefilled on re-admission:
  ``preempt="recompute"``).

Admission binds a request to its slot row and prefills its prompt:
same-length-bucket admissions share one batched prefill (`_prefill_rows`
/ `_prefill_rows_paged`), which runs the shared `forward_cached_rows`
math one layer at a time over row views of the cache. The last-prompt
logits stay on the device in `_last_logits`; the decode loop samples the
first token from them.

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
the same function runs eagerly. Decode attention runs on the
hand-written paged-attention kernel (`ops.attention.paged_attention`,
B2): through the block tables on the paged path, and over a fixed
block-table VIEW of the dense cache on the dense path (no copy: row b's
slots are blocks b*MB .. b*MB + MB - 1). The CPU and
``attn_impl="reference"`` take the plain attention.

Consistency contract (tested on the CPU): greedy output equals the JAX
package's engine (dense and paged, every pipeline depth and horizon) and
solo `generate`; sampled output equals the port's own solo `generate`
under the same per-request seed.

Not ported yet, each raising NotImplementedError that names its
ROADMAP.md item: swap preemption, the prefix cache, chunked prefill,
quantized KV, speculative decoding, multi-LoRA, tensor parallelism and
the runtime sanitizer.
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
from ray_tpu_torch.models.generate import (_check_sampling_knobs, _layer,
                                           _layer_body, forward_cached_rows,
                                           init_cache, key_words,
                                           sample_rows)
from ray_tpu_torch.models.llama import LlamaConfig, _logits, _rmsnorm
from ray_tpu_torch.models.prefix_cache import block_bytes
from ray_tpu_torch.models.scheduler import (EngineDraining,
                                            EngineOverloaded,
                                            SchedulerPolicy, SubmitTimeout,
                                            make_policy)
from ray_tpu_torch.ops import paged_attention_kernel as pak
from ray_tpu_torch.ops.attention import paged_attention

Params = Dict[str, Any]

# Slots per block of the dense cache's block-table view on the card
# (B2's paged path serves 32-slot blocks at the same widths).
DENSE_VIEW_TOKENS = 32


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
    suffix slots, and duplicate table entries are the null block
    (garbage nobody reads)."""

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


def _prefill_views(params: Params, prompts: torch.Tensor, cache,
                   last_logits: torch.Tensor, rows: torch.Tensor,
                   starts: torch.Tensor, last_idx: torch.Tensor,
                   cfg: LlamaConfig) -> None:
    """N same-bucket prompts [N, Cb] run `forward_cached_rows` over the
    row views ``cache``, and each row's last-real-token logits land in
    ``last_logits[rows]``. Filler tokens past a prompt's true length
    write K/V beyond its frontier, which every later mask excludes until
    decode overwrites them; only the logits at ``last_idx`` are read."""
    logits, _ = forward_cached_rows(params, prompts, cache, starts, cfg)
    n = prompts.shape[0]
    last_logits[rows.long()] = logits[torch.arange(n, device=logits.device),
                                      last_idx.long()]


@torch.no_grad()
def _prefill_rows(params: Params, prompts: torch.Tensor, cache,
                  last_logits: torch.Tensor, rows: torch.Tensor,
                  starts: torch.Tensor, last_idx: torch.Tensor,
                  cfg: LlamaConfig) -> None:
    """Batched admission prefill into the dense cache, in place: row
    ``rows[n]`` of the cache takes prompt n at offset ``starts[n]``."""
    views = {"k": _DenseRows(cache["k"], rows),
             "v": _DenseRows(cache["v"], rows)}
    _prefill_views(params, prompts, views, last_logits, rows, starts,
                   last_idx, cfg)


@torch.no_grad()
def _prefill_rows_paged(params: Params, prompts: torch.Tensor,
                        pool_k: torch.Tensor, pool_v: torch.Tensor,
                        last_logits: torch.Tensor, bt: torch.Tensor,
                        rows: torch.Tensor, starts: torch.Tensor,
                        last_idx: torch.Tensor, cfg: LlamaConfig) -> None:
    """Batched admission prefill into the pool, in place, through the
    rows' block tables ``bt`` [N, MB]."""
    views = {"k": _PagedRows(pool_k, bt), "v": _PagedRows(pool_v, bt)}
    _prefill_views(params, prompts, views, last_logits, rows, starts,
                   last_idx, cfg)


def _decode_layer_rows(h, layer, k_cache, v_cache, write_slots,
                       cfg: LlamaConfig, max_len: int, view_bt=None):
    """One decoder layer, one new token per row, each row writing its
    K/V at its own slot and attending its own prefix. h: [B, 1, d];
    caches [B, S, KV, D] (S >= max_len); write_slots: [B].

    ``view_bt`` [B, S/T] int32 (the card) runs attention on B2 over the
    cache viewed as pages of T slots — ``bt[b, p] = b*(S/T) + p``, no
    copy — with ``kv_valid_len = max_len``; it computes the dense mask
    exactly (``slot <= q_slot`` and ``slot < max_len``). Without it,
    the plain `_cached_attention` runs, as in the JAX dense path."""
    B = h.shape[0]
    bidx = torch.arange(B, device=h.device)
    wl = write_slots.long()

    def write_kv(k_cache, v_cache, k, v):
        k_cache[bidx, wl] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, wl] = v[:, 0].to(v_cache.dtype)
        return k_cache, v_cache

    attend = None
    if view_bt is not None:
        T = k_cache.shape[1] // view_bt.shape[1]
        q_slots = write_slots.to(torch.int32)[:, None]

        def attend(q, k_cache, v_cache):
            pages = (-1, T) + tuple(k_cache.shape[2:])
            return paged_attention(q, k_cache.view(pages),
                                   v_cache.view(pages), view_bt, q_slots,
                                   kv_valid_len=max_len, impl="kernel")

    h, _, _ = _layer_body(h, layer, k_cache, v_cache, wl[:, None], write_kv,
                          wl[:, None], max_len, cfg, attend=attend)
    return h


def _decode_core(params: Params, toks: torch.Tensor, cache,
                 row_len: torch.Tensor, cfg: LlamaConfig, max_len: int,
                 view_bt=None) -> torch.Tensor:
    """One decode step for ALL slots of the dense cache: row b's token
    ``toks[b]`` is written at slot ``row_len[b]`` and attends slots
    [0, row_len[b]]. Dead/frozen rows compute discarded garbage at their
    frontier slot, which every mask excludes until the slot's next
    prefill overwrites it. Returns next-token logits [B, vocab] f32; the
    cache is updated in place."""
    h = params["tok_embed"][toks[:, None]]
    for i in range(cfg.n_layers):
        h = _decode_layer_rows(h, _layer(params, i), cache["k"][i],
                               cache["v"][i], row_len, cfg, max_len,
                               view_bt)
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params["lm_head"], cfg)[:, 0]


def _decode_layer_rows_paged(h, layer, k_pages, v_pages, bt, write_slots,
                             cfg: LlamaConfig):
    """One decoder layer, one new token per row, against the pool: row
    b's new K/V land in physical block ``bt[b, slot // T]`` at offset
    ``slot % T`` and attention reads back through the block table.
    Frontier blocks are private to their row, so live rows' writes never
    collide; retired/empty rows write garbage into the null block."""
    B = h.shape[0]
    T = k_pages.shape[1]
    span = bt.shape[1] * T                 # == engine max_len
    bidx = torch.arange(B, device=h.device)
    wl = write_slots.long()
    blk = bt[bidx, wl // T].long()         # [B] physical frontier block
    off = wl % T
    q_slots = write_slots.to(torch.int32)[:, None]

    def write_kv(k_pages, v_pages, k, v):
        k_pages[blk, off] = k[:, 0].to(k_pages.dtype)
        v_pages[blk, off] = v[:, 0].to(v_pages.dtype)
        return k_pages, v_pages

    def attend(q, k_pages, v_pages):
        return paged_attention(q, k_pages, v_pages, bt, q_slots,
                               kv_valid_len=span, impl=cfg.attn_impl)

    h, _, _ = _layer_body(h, layer, k_pages, v_pages, wl[:, None],
                          write_kv, wl[:, None], span, cfg, attend=attend)
    return h


def _decode_core_paged(params: Params, toks: torch.Tensor,
                       pool_k: torch.Tensor, pool_v: torch.Tensor,
                       bt: torch.Tensor, row_len: torch.Tensor,
                       cfg: LlamaConfig) -> torch.Tensor:
    """`_decode_core` against the pool (block tables ``bt``)."""
    h = params["tok_embed"][toks[:, None]]
    for i in range(cfg.n_layers):
        h = _decode_layer_rows_paged(h, _layer(params, i), pool_k[i],
                                     pool_v[i], bt, row_len, cfg)
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params["lm_head"], cfg)[:, 0]


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
                  eos_id: Optional[int], *, max_len: int, view_bt=None):
    """The dense decode loop (`_decode_loop` over `_decode_core`)."""
    return _decode_loop(
        lambda tok, rl: _decode_core(params, tok, cache, rl, cfg, max_len,
                                     view_bt),
        last_logits, row_len, active, budget, tok_idx, row_keys, row_greedy,
        temperature, horizon, greedy, top_k, top_p, eos_id, max_len)


@torch.no_grad()
def _decode_multi_paged(params: Params, pool_k, pool_v, bt, last_logits,
                        row_len, active, budget, tok_idx, row_keys,
                        row_greedy, temperature: float, cfg: LlamaConfig,
                        horizon: int, greedy: bool, top_k: Optional[int],
                        top_p: Optional[float], eos_id: Optional[int]):
    """The paged decode loop (`_decode_loop` over `_decode_core_paged`);
    the block table spans exactly max_len slots."""
    return _decode_loop(
        lambda tok, rl: _decode_core_paged(params, tok, pool_k, pool_v, bt,
                                           rl, cfg),
        last_logits, row_len, active, budget, tok_idx, row_keys, row_greedy,
        temperature, horizon, greedy, top_k, top_p, eos_id,
        bt.shape[1] * pool_k.shape[2])


class _DecodeGraphs:
    """The decode loop on the card as CUDA graphs: one per (H,
    all-greedy) key of one engine (so one cache layout), all in one
    memory pool; at most 2 x (log2(decode_horizon) + 1) graphs.

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


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class _Request:
    __slots__ = ("req_id", "prompt", "max_new_tokens", "tokens", "done",
                 "priority", "seq", "rng", "deadline", "shed", "resume",
                 "greedy")

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


class _PrefillState:
    """A slot row whose prompt is still to be written: ``pos`` is the
    prefill frontier, ``prompt`` the token sequence being prefilled
    (the request's prompt, or prompt + emitted tokens when a preempted
    request recomputes)."""

    __slots__ = ("req", "pos", "prompt")

    def __init__(self, req: _Request, pos: int,
                 prompt: Optional[List[int]] = None):
        self.req = req
        self.pos = pos
        self.prompt = req.prompt if prompt is None else prompt


class _InflightStep:
    """One dispatched, not yet drained decode step: its token block on
    its way to the host (`_HostBlock`), its horizon, the rows it was
    dispatched for, and whether it ran AHEAD (dispatched before the host
    had replayed the previous block) — only those can hold overrun
    iterations for rows that had already finished."""

    __slots__ = ("toks", "H", "rows", "run_ahead")

    def __init__(self, toks: _HostBlock, H: int, rows: List[int],
                 run_ahead: bool):
        self.toks = toks
        self.H = H
        self.rows = rows
        self.run_ahead = run_ahead


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

    A port default differs from the JAX engine: ``preempt="recompute"``
    (JAX: "swap"), because swap preemption is not ported yet. The JAX
    engine's tokens are identical under swap and recompute alike, so
    this changes no token.
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
                 preempt: str = "recompute",
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
        if preempt not in ("swap", "recompute"):
            raise ValueError(f"preempt must be 'swap' or 'recompute', "
                             f"got {preempt!r}")
        if kv_block_tokens is not None and kv_block_tokens < 1:
            raise ValueError("kv_block_tokens must be >= 1")
        if preempt == "swap":
            raise _unported("swap preemption (preempt='swap')", "A5b")
        if kv_quant is not None:
            raise _unported("quantized paged KV (kv_quant=)", "A6")
        if prefix_cache:
            raise _unported("the prefix cache (prefix_cache=True)", "A7")
        if prefill_chunk is not None:
            raise _unported("chunked prefill (prefill_chunk=)", "A7")
        if draft_params is not None:
            raise _unported("speculative decoding (draft_params=)", "A7")
        if lora is not None:
            raise _unported("multi-LoRA serving (lora=)", "A8")
        if mesh is not None or tp is not None:
            raise _unported("tensor parallelism (mesh= / tp=)", "A9")
        if sanitize:
            raise _unported("the runtime sanitizer (sanitize=)", "A14")
        self.params = params
        self.cfg = cfg
        self.device = params["tok_embed"].device
        self.B = batch_slots
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

        self.paged = paged
        L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        # Next-token logits per slot, device-resident: prefill scatters
        # into it, decode samples from it and writes it back in place.
        self._last_logits = torch.zeros((self.B, cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
        if paged:
            self._init_pool(kv_block_tokens, prefix_block, kv_pool_bytes,
                            prefix_cache_bytes)
        else:
            # Dense per-slot cache: 2 (K+V) x L x KV x D per token. On
            # the card decode attention reads it through B2 as pages of
            # DENSE_VIEW_TOKENS slots, so its rows are rounded up to
            # whole pages (slots past max_len are masked everywhere).
            self.kv_bytes_per_token = float(2 * L * KV * D
                                            * cfg.dtype.itemsize)
            self.kv_bytes_per_block = 0.0
            use_b2 = cfg.attn_impl == "kernel" or (
                cfg.attn_impl == "auto" and self.device.type == "cuda")
            span = self.max_len
            self._view_bt = None
            if use_b2:
                T = DENSE_VIEW_TOKENS
                span = -(-self.max_len // T) * T
                self._view_bt = torch.arange(
                    self.B * (span // T), dtype=torch.int32,
                    device=self.device).view(self.B, span // T)
            self.cache = init_cache(cfg, self.B, span, device=self.device)
        # The decode loop's inputs on the device, one int64 buffer: row
        # state [4, B] (row_len, active, budget, tok_idx; the loop
        # writes it back, so a run-ahead dispatch chains off it), row
        # keys [B, 2], the greedy lane [B] and, paged, the block tables
        # [B, MB]. A dispatch stages its host half in ONE copy.
        Bn = self.B
        n_in = 7 * Bn + (Bn * self._mb if paged else 0)
        self._din = torch.zeros((n_in,), dtype=torch.int64,
                                device=self.device)
        self._d_state = self._din[:4 * Bn].view(4, Bn)
        self._d_keys = self._din[4 * Bn:6 * Bn].view(Bn, 2)
        self._d_greedy = self._din[6 * Bn:7 * Bn]
        self._d_bt = self._din[7 * Bn:].view(Bn, -1) if paged else None
        self._graphs = (_DecodeGraphs(self.device)
                        if self.device.type == "cuda" else None)
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
        self._row_prefill: Dict[int, _PrefillState] = {}
        # Plain-int accounting (reported with enable_metrics=False too).
        self.decode_dispatches = 0     # decode loops launched
        self.decode_iterations = 0     # decode iterations (sum of H)
        self.prefill_dispatches = 0    # batched prefills
        self.host_syncs = 0            # device->host token transfers
        self.host_transfer_bytes = 0
        self.tokens_out = 0
        self.prefill_real_tokens = 0
        self.prefill_padded_tokens = 0
        self.preemptions = 0
        self.swap_ins = 0              # preempted rows re-admitted
        # Async pipeline: dispatched-but-undrained decode steps, oldest
        # first.
        self._ring: collections.deque = collections.deque()
        self.pipeline_flushes = 0      # forced full drains of the ring
        self.pipeline_overrun_tokens = 0  # masked run-ahead iterations
        self._pl_depth_sum = 0         # ring depth sampled at each drain
        self._pl_depth_n = 0
        self._start_t = clock()
        self.steps_total = 0

    def _init_pool(self, kv_block_tokens: Optional[int], prefix_block: int,
                   kv_pool_bytes: Optional[int],
                   prefix_cache_bytes: Optional[int]) -> None:
        """The paged engine's block pool, its host ledger and tables."""
        cfg = self.cfg
        self.kv_block_tokens = (kv_block_tokens
                                if kv_block_tokens is not None
                                else prefix_block)
        T = self.kv_block_tokens
        if self.max_len % T:
            raise ValueError(
                f"paged engine needs max_len ({self.max_len}) "
                f"divisible by kv_block_tokens ({T}): the block view "
                "must span exactly the dense cache row")
        L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
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
        self._preempted: set = set()   # req ids owed a recompute replay
        self._admit_seq = 0            # preemption recency order
        self._row_admit_seq = np.zeros((self.B,), np.int64)
        self._pool_k = torch.zeros((L, n_blocks, T, KV, D),
                                   dtype=cfg.dtype, device=self.device)
        self._pool_v = torch.zeros_like(self._pool_k)

    # -- public API --------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               priority: int = 0, rng: Optional[int] = None,
               deadline_s: Optional[float] = None,
               greedy: Optional[bool] = None,
               resume_tokens: Optional[List[int]] = None,
               adapter_id: Optional[str] = None) -> int:
        """Enqueue a request; returns its id.

        ``priority`` (lower = sooner) orders the priority policy. A full
        bounded queue raises EngineOverloaded (on_full="reject") or
        drives the engine until a slot frees (on_full="block"). ``rng``
        (an int seed) pins this request's sampling stream: its sampled
        tokens then equal solo ``generate(..., rng=rng)``. ``greedy``
        overrides the engine-wide decode mode for this request.
        ``deadline_s`` is the admission SLO: a request still queued when
        it passes is SHED (finished with zero tokens, listed in
        ``shed_ids``). ``resume_tokens`` (fleet failover) and
        ``adapter_id`` (multi-LoRA) are not ported yet."""
        if resume_tokens:
            raise _unported("fleet failover resume (resume_tokens=)", "A10")
        if adapter_id is not None:
            raise _unported("multi-LoRA serving (adapter_id=)", "A8")
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
                    else self._clock() + deadline_s)
        key = None if rng is None else key_words(int(rng))
        req = _Request(self._next_id, prompt, max_new_tokens,
                       priority=priority, seq=self._next_id, rng=key,
                       deadline=deadline)
        req.greedy = greedy
        if deadline is not None and self._clock() >= deadline:
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
            t_block = self._clock()
            while len(self.scheduler) >= self.max_queue:
                if self.block_timeout_s is not None and \
                        self._clock() - t_block >= self.block_timeout_s:
                    self.metrics.on_reject()
                    raise SubmitTimeout(
                        f"queue still full ({self.max_queue} queued "
                        f"requests) after blocking {self.block_timeout_s}s")
                self.step()
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
        budget = self.max_prefills_per_step or self.B
        admissions: List[Tuple[int, _Request]] = []
        deferred = False
        for row in range(self.B):
            if budget <= 0 or deferred:
                break
            if self.row_req[row] is not None:
                continue
            req = None
            while len(self.scheduler):
                cand = self.scheduler.pop()
                if cand.deadline is not None and \
                        self._clock() >= cand.deadline and \
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

        live = [b for b in range(self.B) if self.row_req[b] is not None]
        if not live:
            if self._ring:             # defensive: never strand blocks
                self._flush_pipeline(emitted)
            return emitted
        decodable = live
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
        fully replayed) at the adaptive horizon. Returns the possibly
        narrowed decodable set (paged reservation may preempt)."""
        H = horizon
        if H is None:
            H = self.scheduler.horizon_hint(
                free_slots=self.B - len(live),
                max_horizon=self.decode_horizon)
            H = min(H, int(self.row_budget[decodable].max()))
            H = 1 << max(0, H.bit_length() - 1)
        if self.paged:
            # Grow every decodable row's chain to cover the horizon,
            # preempting victims if the pool runs dry.
            decodable, H = self._reserve_decode_blocks(decodable, H)
        self._dispatch_decode(H, decodable, run_ahead=False)
        return decodable

    def _stage_inputs(self, run_ahead: bool) -> None:
        """Copy the host inputs of a decode dispatch into `_din` in one
        copy: the row state and keys for a primary dispatch, then the
        greedy lane and (paged) the block tables, snapshotted here, so
        host-side growth only reaches later dispatches. A run-ahead
        dispatch keeps the row state the previous loop left on the
        device. On the card the staging buffer is pinned and the copy
        does not block; the caching host allocator keeps the buffer
        from reuse until the copy has run."""
        B = self.B
        lo = 6 * B if run_ahead else 0
        buf = torch.empty((self._din.numel() - lo,), dtype=torch.int64,
                          pin_memory=self.device.type == "cuda")
        a = buf.numpy()
        if not run_ahead:
            a[0:B] = self.row_len
            a[B:2 * B] = [r is not None for r in self.row_req]
            a[2 * B:3 * B] = self.row_budget
            a[3 * B:4 * B] = self._tok_idx
            a[4 * B:6 * B] = self._row_keys.reshape(-1)
        a[6 * B - lo:7 * B - lo] = self._row_greedy
        if self.paged:
            a[7 * B - lo:] = self._bt.reshape(-1)
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
        if self.paged:
            out = _decode_multi_paged(self.params, self._pool_k,
                                      self._pool_v,
                                      self._d_bt.to(torch.int32), *args)
        else:
            out = _decode_multi(self.params, self.cache, *args,
                                max_len=self.max_len,
                                view_bt=self._view_bt)
        toks, last_logits, row_len, active, budget, tok_idx = out
        self._last_logits.copy_(last_logits)
        st.copy_(torch.stack([row_len, active.to(st.dtype), budget,
                              tok_idx]))
        return toks

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
            inflight = sum(e.H for e in self._ring)
            rem = int(self.row_budget[rows].max()) - inflight
            if rem <= 0:
                break              # every further iteration would overrun
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
        self._emit_block(block, entry, emitted)
        self.metrics.on_pipeline_drain(depth, len(self._ring))
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

    def dump_trace(self, path: Optional[str] = None) -> List[dict]:
        """chrome://tracing export of the request-lifecycle spans."""
        return self.trace.dump(path, pid=self.engine_id)

    def kv_free_blocks(self) -> int:
        """KV blocks an admission could claim right now; 0 for the
        dense engine (no pool)."""
        return self.kv_pool.free_blocks if self.paged else 0

    def kv_used_fraction(self) -> float:
        """KV pressure in [0, 1]. Paged: fraction of pool blocks in use.
        Dense: live slots / batch slots (each live slot pins a full
        max_len cache row)."""
        if self.paged:
            total = self.kv_pool.blocks_total
            return max(0.0, 1.0 - self.kv_free_blocks() / total)
        return sum(r is not None for r in self.row_req) / self.B

    def stats(self) -> Dict[str, float]:
        """Flat numeric telemetry snapshot (EngineMetrics.stats) plus
        the engine's plain-int accounting and queue/slot/pipeline/pool
        state. The pipeline plane: ``pipeline_depth_effective`` is the
        mean number of steps in flight at each drain (1.0 =
        synchronous), ``host_lag_steps`` the ring length now, overrun
        tokens the masked run-ahead iterations of finished rows."""
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
            "preemptions": float(self.preemptions),
            "swap_ins": float(self.swap_ins),
            "kv_used_fraction": self.kv_used_fraction(),
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
                "requests_swapped": float(len(self._preempted)),
            })
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

    def _admit_rows(self, admissions: List[Tuple[int, _Request]]) -> None:
        """Bind this step's admissions to their rows and queue their
        prefills (run by `_advance_prefills` this step). First tokens
        are NOT sampled here: each row's last-prompt logits stay on the
        device in `_last_logits` and the decode loop samples them. The
        paged engine admits through `_admit_rows_paged`."""
        if self.paged:
            self._admit_rows_paged(admissions)
            return
        for row, req in admissions:
            self.metrics.on_admit(req.req_id)
            if self.trace.enabled:
                self.trace.close("queue_wait", req.req_id)
                self.trace.instant("admit", req.req_id, {"row": row})
            self._bind_row(row, req, [], 0)
            self._row_prefill[row] = _PrefillState(req, 0)

    def _admit_rows_paged(
            self, admissions: List[Tuple[int, _Request]]) -> None:
        """Bind each admission to a fresh BLOCK CHAIN covering its prompt
        and queue its prefill (run by `_advance_prefills` this step). A
        preempted request re-binds through `_swap_in_row` instead."""
        T = self.kv_block_tokens
        for row, req in admissions:
            self.metrics.on_admit(req.req_id)
            if req.req_id in self._preempted:
                if not self._swap_in_row(row, req):
                    # The gate's estimate went stale: requeue.
                    self._requeue_front(req)
                continue
            if self.trace.enabled:
                self.trace.close("queue_wait", req.req_id)
                self.trace.instant("admit", req.req_id, {"row": row})
            ids = self._pool_alloc(-(-len(req.prompt) // T))
            if ids is None:
                if self.trace.enabled:
                    self.trace.open("queue_wait", req.req_id)
                self._requeue_front(req)
                continue
            self._bind_row(row, req, ids, 0)
            self._row_prefill[row] = _PrefillState(req, 0)

    def _bind_row(self, row: int, req: _Request, chain: List[int],
                  start: int) -> None:
        """Reset a slot row's decode state for `req` and, paged, point
        it at its block chain (budget/tok_idx are overridden by the
        recompute path)."""
        self.row_req[row] = req
        self.row_len[row] = start
        self.row_budget[row] = req.max_new_tokens
        self._tok_idx[row] = 0
        self._row_keys[row] = self._req_key(req)
        self._row_greedy[row] = (self.greedy if req.greedy is None
                                 else bool(req.greedy))
        if self.paged:
            self._row_blocks[row] = list(chain)
            self._bt[row, :] = 0
            self._bt[row, :len(chain)] = chain
            self._row_admit_seq[row] = self._admit_seq
            self._admit_seq += 1

    def _requeue_front(self, req: _Request) -> None:
        self.scheduler.push_front(req)
        self.metrics.observe_queue_depth(len(self.scheduler))

    def _pool_alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks, or None when the pool cannot cover them (the
        caller preempts a row or defers the admission)."""
        if n <= 0:
            return []
        return self.kv_pool.alloc(n)

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
        """Evict a live row mid-decode: drop its blocks and requeue it at
        the FRONT; re-admission replays prompt + emitted tokens. The
        token stream continues unchanged, because the sampling noise
        depends only on the request's key and token index."""
        req = self.row_req[row]
        n_blocks = len(self._row_blocks[row])
        self._preempted.add(req.req_id)
        self._release_row_blocks(row)
        self.row_req[row] = None
        self.row_len[row] = 0
        self.row_budget[row] = 0
        self._tok_idx[row] = 0
        self.preemptions += 1
        self.metrics.on_preempt()
        if self.trace.enabled:
            self.trace.span_since_mark(
                "preempt_swap_out", req.req_id,
                {"mode": "recompute", "blocks": n_blocks, "bytes": 0})
        req.resume = True
        self._requeue_front(req)

    def _swap_in_row(self, row: int, req: _Request) -> bool:
        """Re-admit a preempted request: allocate a chain for prompt +
        emitted tokens, re-prefill them, and continue the stream at the
        saved token index. False if the pool cannot cover it now."""
        replay = list(req.prompt) + list(req.tokens)
        ids = self._pool_alloc(-(-len(replay) // self.kv_block_tokens))
        if ids is None:
            return False
        self._preempted.discard(req.req_id)
        self._bind_row(row, req, ids, 0)
        self.row_budget[row] = req.max_new_tokens - len(req.tokens)
        self._tok_idx[row] = len(req.tokens)
        self._row_prefill[row] = _PrefillState(req, 0, prompt=replay)
        self.swap_ins += 1
        if self.trace.enabled:
            self.trace.span_since_mark(
                "swap_in", req.req_id,
                {"mode": "recompute", "replay_tokens": len(replay)})
        return True

    def _release_row_blocks(self, row: int) -> None:
        """Drop the row's reference on its chain and point the table
        back at the null block."""
        ids = self._row_blocks[row]
        if ids:
            self.kv_pool.decref(ids)
        self._row_blocks[row] = []
        self._bt[row, :] = 0

    def _fits_now(self, req: _Request) -> bool:
        """Admission gate: would this request's blocks fit right now?"""
        n = len(req.prompt)
        if req.req_id in self._preempted:
            n += len(req.tokens)
        return -(-n // self.kv_block_tokens) <= self.kv_free_blocks()

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card it goes
        through pinned memory with a non-blocking copy, so the host
        does not wait for the stream to reach it."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _advance_prefills(self) -> None:
        """Prefill every newly bound row, same-bucket prompts batched
        into ONE `_prefill_rows` / `_prefill_rows_paged` dispatch. Each
        row is decodable in this same step: its prefill scattered its
        true last-prompt logits."""
        if not self._row_prefill:
            return
        groups: Dict[int, List[Tuple[int, _PrefillState, int]]] = {}
        for row, st in self._row_prefill.items():
            C = len(st.prompt) - st.pos
            # Bucket the prompt, capped so the write never runs past
            # max_len.
            Cb = min(self._bucket(C), self.max_len - st.pos)
            groups.setdefault(Cb, []).append((row, st, C))
        for Cb in sorted(groups):
            grp = groups[Cb]
            n = len(grp)
            t0 = self.trace.now() if self.trace.enabled else 0.0
            prompts = np.zeros((n, Cb), np.int64)
            rows = np.zeros((n,), np.int64)
            starts = np.zeros((n,), np.int64)
            last_idx = np.zeros((n,), np.int64)
            real = 0
            for i, (row, st, C) in enumerate(grp):
                prompts[i, :C] = st.prompt[st.pos:st.pos + C]
                rows[i] = row
                starts[i] = st.pos
                last_idx[i] = C - 1
                real += C
            args = (self._dev(rows), self._dev(starts), self._dev(last_idx),
                    self.cfg)
            if self.paged:
                _prefill_rows_paged(
                    self.params, self._dev(prompts), self._pool_k,
                    self._pool_v, self._last_logits,
                    self._dev(self._bt[rows]), *args)
            else:
                _prefill_rows(self.params, self._dev(prompts), self.cache,
                              self._last_logits, *args)
            self.prefill_dispatches += 1
            padded = n * Cb - real
            self.prefill_real_tokens += real
            self.prefill_padded_tokens += padded
            self.metrics.on_prefill_batch(real, padded)
            if self.trace.enabled:
                self.trace.add("prefill_dispatch", t0,
                               self.trace.now() - t0, lane="dispatch",
                               args={"bucket": Cb, "rows": n,
                                     "real": real, "padded": padded})
            for row, st, C in grp:
                st.pos += C
                self.row_len[row] = st.pos
                if self.trace.enabled:
                    self.trace.span_since_mark(
                        "prefill_chunk", st.req.req_id,
                        {"pos": st.pos, "tokens": C,
                         "prompt_tokens": len(st.prompt)})
        self._row_prefill.clear()

    def _emit_block(self, block: np.ndarray, entry: _InflightStep,
                    emitted: Dict[int, List[int]]) -> None:
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
        `pipeline_overrun_tokens`."""
        tr = self.trace
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
                if self.paged:
                    # The blocks return to the pool NOW, so admission
                    # capacity tracks finished tokens, not live slots.
                    self._release_row_blocks(b)
            else:
                self.row_len[b] += count
