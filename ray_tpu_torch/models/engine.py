"""Continuous-batching decode engine over a paged KV block pool.

Port of the paged path of `ray_tpu/models/engine.py`. B fixed decode
slots advance together, every row at its OWN cache offset, with every
row's K/V in refcounted blocks of ONE pool ``[L, NB, T, KV, D]``
addressed through per-row block tables (`models/block_pool.py`):

- Admission binds a request to a block chain and prefills its prompt:
  same-length-bucket admissions share one batched prefill
  (`_prefill_rows_paged`), which gathers each row's block view, runs
  the shared `forward_cached_rows` math and scatters the view back —
  ONE LAYER AT A TIME, so at most one layer's row views exist at once.
  The last-prompt logits stay on the device in `_last_logits`; the
  decode loop samples the first token from them.
- Decode runs H iterations (`_decode_multi_paged`) as a Python loop
  that keeps tokens, logits and row state on the device: per-row
  sampling, per-row eos/budget/room freezing, the K/V write into each
  row's frontier block, and attention through the block table with the
  hand-written paged-attention kernel (`ops.attention.paged_attention`).
  The host gets the [H, B] token block in ONE device->host copy and
  replays it (`_emit_block`).
- When decode growth runs the pool dry, the newest row is PREEMPTED:
  its blocks are freed and it re-queues at the front; re-admission
  re-prefills prompt + emitted tokens (``preempt="recompute"``).

Consistency contract (tested on the CPU): greedy output equals the JAX
package's paged engine and solo `generate`; sampled output equals the
port's own solo `generate` under the same per-request seed.

Not ported yet, each raising NotImplementedError that names its
ROADMAP.md item: the dense engine (``paged=False``), the async pipeline
(``pipeline_depth > 1``), swap preemption, the prefix cache, chunked
prefill, quantized KV, speculative decoding, multi-LoRA, tensor
parallelism and the runtime sanitizer.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.models.block_pool import BlockPool
from ray_tpu_torch.models.engine_metrics import (EngineMetrics,
                                                 NullEngineMetrics)
from ray_tpu_torch.models.engine_trace import resolve_tracer
from ray_tpu_torch.models.generate import (_check_sampling_knobs, _layer,
                                           _layer_body, _logits,
                                           forward_cached_rows, key_words,
                                           sample_rows)
from ray_tpu_torch.models.llama import LlamaConfig, _rmsnorm
from ray_tpu_torch.models.prefix_cache import block_bytes
from ray_tpu_torch.models.scheduler import (EngineDraining,
                                            EngineOverloaded,
                                            SchedulerPolicy, SubmitTimeout,
                                            make_policy)
from ray_tpu_torch.ops.attention import paged_attention

Params = Dict[str, Any]


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP.md, Queue A "
        f"item {item})")


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

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


@torch.no_grad()
def _prefill_rows_paged(params: Params, prompts: torch.Tensor,
                        pool_k: torch.Tensor, pool_v: torch.Tensor,
                        last_logits: torch.Tensor, bt: torch.Tensor,
                        rows: torch.Tensor, starts: torch.Tensor,
                        last_idx: torch.Tensor, cfg: LlamaConfig) -> None:
    """Batched admission prefill into the pool, in place: N same-bucket
    prompts [N, Cb] run `forward_cached_rows` over their block views,
    and each row's last-real-token logits land in ``last_logits[rows]``.
    Filler tokens past a prompt's true length write K/V beyond its
    frontier, which every later mask excludes until decode overwrites
    them; only the logits at ``last_idx`` are read out."""
    cache = {"k": _PagedRows(pool_k, bt), "v": _PagedRows(pool_v, bt)}
    logits, _ = forward_cached_rows(params, prompts, cache, starts, cfg)
    n = prompts.shape[0]
    last_logits[rows.long()] = logits[torch.arange(n, device=logits.device),
                                      last_idx.long()]


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

    def write_kv(k_pages, v_pages, k, v):
        k_pages[blk, off] = k[:, 0].to(k_pages.dtype)
        v_pages[blk, off] = v[:, 0].to(v_pages.dtype)
        return k_pages, v_pages

    def attend(q, k_pages, v_pages):
        return paged_attention(q, k_pages, v_pages, bt,
                               write_slots[:, None], kv_valid_len=span,
                               impl=cfg.attn_impl)

    h, _, _ = _layer_body(h, layer, k_pages, v_pages, write_slots[:, None],
                          write_kv, write_slots[:, None], span, cfg,
                          attend=attend)
    return h


def _decode_core_paged(params: Params, toks: torch.Tensor,
                       pool_k: torch.Tensor, pool_v: torch.Tensor,
                       bt: torch.Tensor, row_len: torch.Tensor,
                       cfg: LlamaConfig) -> torch.Tensor:
    """One decode step for ALL slots: row b's token ``toks[b]`` is
    written at slot ``row_len[b]`` and attends slots [0, row_len[b]].
    Returns next-token logits [B, vocab] f32; the pool is updated in
    place."""
    h = params["tok_embed"][toks[:, None]]
    for i in range(cfg.n_layers):
        h = _decode_layer_rows_paged(h, _layer(params, i), pool_k[i],
                                     pool_v[i], bt, row_len, cfg)
    h = _rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params["lm_head"])[:, 0]


@torch.no_grad()
def _decode_multi_paged(params: Params, pool_k, pool_v, bt, last_logits,
                        row_len, active, budget, tok_idx, row_keys,
                        row_greedy, temperature: float, cfg: LlamaConfig,
                        horizon: int, greedy: bool, top_k: Optional[int],
                        top_p: Optional[float], eos_id: Optional[int]):
    """`horizon` decode iterations with every per-row decision on the
    device. Per iteration (mirrored by the host replay in
    `DecodeEngine._emit_block`):

        tok      = sample(last_logits)          # emit if active, else -1
        budget  -= active;  tok_idx += active
        done     = budget <= 0 | row_len+1 >= max_len | tok == eos
        feed tok at slot row_len (all rows; frozen rows write garbage
        one slot past their content, masked everywhere)
        row_len += active & ~done;  last_logits updates where continuing

    Returns (toks [horizon, B], last_logits, row_len, active, budget,
    tok_idx). ``row_greedy`` [B] bool lets a sampling batch argmax the
    rows that asked for greedy decoding."""
    max_len = bt.shape[1] * pool_k.shape[2]
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
        logits = _decode_core_paged(params, tok, pool_k, pool_v, bt,
                                    row_len, cfg)
        row_len = row_len + cont.to(row_len.dtype)
        last_logits = torch.where(cont[:, None], logits, last_logits)
        active = cont
    return (torch.stack(emits), last_logits, row_len, active, budget,
            tok_idx)


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


class DecodeEngine:
    """Slot-based continuous batching over a paged KV block pool.

    `submit()` enqueues a request; `step()` admits queued requests into
    free slots (same-bucket prefills batched), then advances every live
    slot up to `decode_horizon` tokens with ONE device->host transfer
    (the [H, B] token block); `run()` drains everything. The horizon
    adapts via the scheduler's `horizon_hint` (1 while a queued request
    could take a free slot, else `decode_horizon`) — `step(horizon=)`
    pins it.

    The device is the params' device: weights from
    `llama_init(..., device="cuda")` or `convert.params_from_numpy`
    serve on the card, weights on the CPU serve on the CPU through the
    plain attention path.

    Greedy by default; sampling (greedy=False) applies `generate`'s
    temperature/top_k/top_p semantics with a per-request key stream:
    ``submit(..., rng=seed)`` pins it, else one is mixed from the engine
    ``rng`` seed and the request id.

    Port defaults that differ from the JAX engine: ``paged=True``,
    ``preempt="recompute"`` and ``pipeline_depth=1``, because the dense
    engine, swap preemption and the async pipeline are not ported yet.
    The JAX engine's tokens are identical at every pipeline depth and
    under swap and recompute alike, so these defaults change no token.
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
                 pipeline_depth: int = 1,
                 prefix_cache: bool = False,
                 prefix_block: int = 32,
                 prefix_cache_bytes: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 paged: bool = True,
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
        if not paged:
            raise _unported("the dense engine (paged=False)", "A4")
        if pipeline_depth > 1:
            raise _unported("the async decode pipeline "
                            "(pipeline_depth > 1)", "A4")
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

        self.paged = True
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
        # Next-token logits per slot, device-resident: prefill scatters
        # into it, decode samples from it.
        self._last_logits = torch.zeros((self.B, cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
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
        self._start_t = clock()
        self.steps_total = 0

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
        # A request must fit the pool alone in the worst case (every
        # other row preempted) or it could never complete.
        T = self.kv_block_tokens
        need = -(-(len(prompt) + max_new_tokens) // T)
        if need > self.kv_pool.blocks_total:
            raise ValueError(
                f"request needs {need} KV blocks ({len(prompt)} prompt + "
                f"{max_new_tokens} new tokens at {T} tokens/block) but the "
                f"pool holds only {self.kv_pool.blocks_total}; raise "
                "kv_pool_bytes or shrink the request")
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
        rounded down to a power of two."""
        if horizon is not None and horizon < 1:
            raise ValueError("horizon must be >= 1")
        self.steps_total += 1
        emitted: Dict[int, List[int]] = {}
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
                if not self._fits_now(cand):
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
            self._admit_rows_paged(admissions)
        self._advance_prefills()

        decodable = [b for b in range(self.B) if self.row_req[b] is not None]
        if not decodable:
            return emitted
        H = horizon
        if H is None:
            H = self.scheduler.horizon_hint(
                free_slots=self.B - len(decodable),
                max_horizon=self.decode_horizon)
            H = min(H, int(self.row_budget[decodable].max()))
            H = 1 << max(0, H.bit_length() - 1)
        # Grow every decodable row's chain to cover the horizon,
        # preempting victims if the pool runs dry.
        decodable, H = self._reserve_decode_blocks(decodable, H)
        block = self._decode(H, decodable)
        self._emit_block(block, H, decodable, emitted)
        n_tokens = sum(len(t) for t in emitted.values())
        self.tokens_out += n_tokens
        self.metrics.on_step(sum(r is not None for r in self.row_req),
                             len(self.scheduler), n_tokens)
        self.metrics.on_kv_pool(self.kv_pool.blocks_total,
                                self.kv_pool.blocks_in_use,
                                self.kv_pool.free_blocks,
                                bytes_per_token=self.kv_bytes_per_token)
        return emitted

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
        """KV blocks an admission could claim right now."""
        return self.kv_pool.free_blocks

    def kv_used_fraction(self) -> float:
        """Fraction of pool blocks in use, in [0, 1]."""
        total = self.kv_pool.blocks_total
        return max(0.0, 1.0 - self.kv_free_blocks() / total)

    def stats(self) -> Dict[str, float]:
        """Flat numeric telemetry snapshot (EngineMetrics.stats) plus
        the engine's plain-int accounting and queue/slot/pool state."""
        def _ratio(num: float, den: float) -> float:
            return num / den if den else 0.0

        out = self.metrics.stats()
        live = float(sum(r is not None for r in self.row_req))
        pool = self.kv_pool
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
            "paged": 1.0,
            "preemptions": float(self.preemptions),
            "swap_ins": float(self.swap_ins),
            "kv_used_fraction": self.kv_used_fraction(),
            "kv_bytes_per_token": float(self.kv_bytes_per_token),
            "kv_bytes_per_block": float(self.kv_bytes_per_block),
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
        """Point a slot row at its block chain and reset its decode
        state (budget/tok_idx are overridden by the recompute path)."""
        self._row_blocks[row] = list(chain)
        self._bt[row, :] = 0
        self._bt[row, :len(chain)] = chain
        self.row_req[row] = req
        self.row_len[row] = start
        self.row_budget[row] = req.max_new_tokens
        self._tok_idx[row] = 0
        self._row_keys[row] = self._req_key(req)
        self._row_greedy[row] = (self.greedy if req.greedy is None
                                 else bool(req.greedy))
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

    def _ensure_decode_blocks(self, rows: List[int], H: int) -> bool:
        """Grow each row's chain to cover ``row_len + H`` slots (capped
        at the row's completion point and at max_len). False when the
        pool cannot cover it; rows already grown keep their blocks (no
        leak: the retry after preemption re-walks them as no-ops)."""
        T = self.kv_block_tokens
        for b in rows:
            req = self.row_req[b]
            lim = min(len(req.prompt) + req.max_new_tokens, self.max_len)
            need_slots = min(int(self.row_len[b]) + H, lim)
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
        first) until the survivors fit."""
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
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _advance_prefills(self) -> None:
        """Prefill every newly bound row, same-bucket prompts batched
        into ONE `_prefill_rows_paged` dispatch. Each row is decodable
        in this same step: its prefill scattered its true last-prompt
        logits."""
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
            _prefill_rows_paged(
                self.params, self._dev(prompts), self._pool_k,
                self._pool_v, self._last_logits, self._dev(self._bt[rows]),
                self._dev(rows), self._dev(starts), self._dev(last_idx),
                self.cfg)
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

    def _decode(self, H: int, rows: List[int]) -> np.ndarray:
        """Run H decode iterations for every slot and pull the [H, B]
        token block to the host: the loop's one device->host copy."""
        tr = self.trace
        t0 = tr.now() if tr.enabled else 0.0
        active = np.array([r is not None for r in self.row_req])
        toks, self._last_logits = _decode_multi_paged(
            self.params, self._pool_k, self._pool_v, self._dev(self._bt),
            self._last_logits, self._dev(self.row_len), self._dev(active),
            self._dev(self.row_budget), self._dev(self._tok_idx),
            self._dev(self._row_keys), self._dev(self._row_greedy),
            self.temperature, self.cfg, H, bool(self._row_greedy.all()),
            self.top_k, self.top_p, self.eos_id)[:2]
        self.decode_dispatches += 1
        self.decode_iterations += H
        self.metrics.on_dispatch(H)
        t1 = tr.now() if tr.enabled else 0.0
        if tr.enabled:
            tr.add("dispatch", t0, t1 - t0, lane="dispatch",
                   args={"horizon": H, "rows": len(rows)})
        block = toks.cpu().numpy()
        self.host_syncs += 1
        self.host_transfer_bytes += block.nbytes
        self.metrics.on_host_sync(block.nbytes)
        if tr.enabled:
            tr.add("host_drain", t1, tr.now() - t1, lane="drain",
                   args={"horizon": H, "bytes": block.nbytes})
        return block

    def _emit_block(self, block: np.ndarray, H: int, rows: List[int],
                    emitted: Dict[int, List[int]]) -> None:
        """Host replay of one [H, B] token block, mirroring
        `_decode_multi_paged`'s per-iteration transition. Each column is
        a prefix of real tokens followed by -1s (a row freezes once and
        stays frozen), so replaying the transition once with the count
        of real tokens equals replaying it token by token:
            budget  -= count;  tok_idx += count
            done     = budget <= 0 | row_len + count >= max_len
                       | last_tok == eos
            row_len += count if continuing"""
        tr = self.trace
        for b in rows:
            req = self.row_req[b]
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
                                   {"tokens": count, "horizon": H,
                                    "batch": len(rows)})
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
                # The blocks return to the pool NOW, so admission
                # capacity tracks finished tokens, not live slots.
                self._release_row_blocks(b)
            else:
                self.row_len[b] += count
