"""Request-lifecycle telemetry for the continuous-batching DecodeEngine.

Port of `ray_tpu/models/engine_metrics.py`, cut to the planes the
port's engine has today: the request lifecycle (queue wait, TTFT, TPOT,
tokens, steps, occupancy), decode dispatches and device->host syncs,
prefill padding and chunked-prefill stalls, the async decode pipeline
(flushes, overrun, effective depth, host lag), the prefix cache
(lookups, hits, reused tokens, evictions), the paged KV pool
(occupancy, zero-copy shares, copy-on-write, preemptions, swap bytes),
speculative decoding (rounds, proposed and accepted draft tokens,
acceptance rate), multi-LoRA serving (adapter lookups, hits,
prefetches, evictions, deferrals and slot residency) and the
disaggregated prefill->decode handoff (requests and bytes each way)
and the tensor-parallel degree.
Instruments go through the port's own `ray_tpu_torch.util.metrics`.

Every request moves queued → admitted (prefill) → decoding → finished;
the engine calls the ``on_*`` hooks at each transition and `stats()`
returns a flat numeric snapshot. All instruments carry an ``engine``
tag so several engines in one process stay separable.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

# Token-scale latency buckets: decode cadences live in 0.5 ms – 30 s.
LATENCY_BOUNDARIES_S = [
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0]

# Decode horizon buckets (tokens per dispatch).
HORIZON_BOUNDARIES = [1, 2, 4, 8, 16, 32, 64]

_engine_ids = itertools.count()


class _Agg:
    """Running aggregate (count/sum/max) plus a bounded ring of recent
    observations for p50/p95/p99 over the last ``WINDOW`` values (an
    SLO is judged on recent traffic, and the bound keeps a long-running
    engine's snapshot cost flat)."""

    WINDOW = 2048

    __slots__ = ("count", "sum", "max", "_ring", "_ring_i")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._ring: List[float] = []
        self._ring_i = 0

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v
        if len(self._ring) < self.WINDOW:
            self._ring.append(v)
        else:                       # overwrite oldest: O(1), no shift
            self._ring[self._ring_i] = v
            self._ring_i = (self._ring_i + 1) % self.WINDOW

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100) of the retained window, nearest
        rank on a sorted copy; 0.0 when empty."""
        if not self._ring:
            return 0.0
        vals = sorted(self._ring)
        rank = max(0, min(len(vals) - 1,
                          int(round(q / 100.0 * (len(vals) - 1)))))
        return vals[rank]

    def fields(self, prefix: str, out: Dict[str, float]) -> None:
        out[f"{prefix}_count"] = self.count
        out[f"{prefix}_mean"] = self.sum / self.count if self.count else 0.0
        out[f"{prefix}_max"] = self.max
        out[f"{prefix}_p50"] = self.percentile(50.0)
        out[f"{prefix}_p95"] = self.percentile(95.0)
        out[f"{prefix}_p99"] = self.percentile(99.0)


class _ReqTimes:
    __slots__ = ("submit_t", "admit_t", "first_token_t", "last_token_t",
                 "n_tokens")

    def __init__(self, submit_t: float):
        self.submit_t = submit_t
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.n_tokens = 0


class EngineMetrics:
    """One instance per DecodeEngine. ``clock`` is injectable for
    deterministic tests."""

    def __init__(self, *, engine_id: Optional[str] = None,
                 batch_slots: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.engine_id = engine_id or f"engine-{next(_engine_ids)}"
        self.batch_slots = max(1, batch_slots)
        self._clock = clock
        self._req: Dict[int, _ReqTimes] = {}

        self.requests_submitted = 0
        self.requests_admitted = 0
        self.requests_finished = 0
        self.requests_rejected = 0
        self.requests_shed = 0
        self.tokens_generated = 0
        self.steps = 0
        self.queue_depth = 0
        self.live_slots = 0
        self.batch_efficiency = 0.0
        self.queue_wait_s = _Agg()
        self.ttft_s = _Agg()
        self.tpot_s = _Agg()
        self.decode_dispatches = 0
        self.host_syncs = 0
        self.host_transfer_bytes = 0
        self.decode_horizon = _Agg()
        self.prefill_real_tokens = 0
        self.prefill_padded_tokens = 0
        self.prefill_stalls = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_reused_tokens = 0
        self.prefix_evictions = 0
        self.kv_blocks_shared = 0
        self.kv_block_cows = 0
        self.preemptions = 0
        self.swap_in_bytes = 0
        self.swap_out_bytes = 0
        self.handoffs_out = 0
        self.handoffs_in = 0
        self.handoff_out_bytes = 0
        self.handoff_in_bytes = 0
        self.kv_pool_blocks_total = 0
        self.kv_pool_blocks_in_use = 0
        self.kv_pool_blocks_free = 0
        self.kv_bytes_per_token = 0.0
        self.pipeline_flushes = 0
        self.pipeline_overrun_tokens = 0
        self.host_lag_steps = 0
        self.pipeline_depth = _Agg()
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # The multi-LoRA plane: a lookup is one admission-gate slot
        # acquisition attempt, a hit means the adapter was resident.
        self.adapter_lookups = 0
        self.adapter_hits = 0
        self.adapter_prefetches = 0
        self.adapter_evictions = 0
        self.adapter_deferrals = 0
        self.adapter_slots = 0
        self.adapter_slots_resident = 0
        self.adapter_slots_pinned = 0

        tag = {"engine": self.engine_id}
        keys = ("engine",)

        def counter(name, desc):
            return Counter(name, desc, tag_keys=keys).set_default_tags(tag)

        def gauge(name, desc):
            return Gauge(name, desc, tag_keys=keys).set_default_tags(tag)

        def hist(name, desc, boundaries=LATENCY_BOUNDARIES_S):
            return Histogram(name, desc, boundaries=boundaries,
                             tag_keys=keys).set_default_tags(tag)

        self._m_submitted = counter(
            "llm_engine_requests_submitted_total",
            "Requests accepted into the engine queue")
        self._m_finished = counter(
            "llm_engine_requests_finished_total",
            "Requests that completed (budget, eos, or max_len)")
        self._m_rejected = counter(
            "llm_engine_requests_rejected_total",
            "Requests shed by bounded-queue backpressure")
        self._m_shed = counter(
            "llm_engine_requests_shed_total",
            "Requests shed past their deadline before burning prefill")
        self._m_tokens = counter(
            "llm_engine_tokens_generated_total",
            "Tokens emitted across all requests")
        self._m_steps = counter(
            "llm_engine_steps_total", "Engine steps executed")
        self._m_queue_wait = hist(
            "llm_engine_queue_wait_s",
            "Seconds from submit to prefill admission")
        self._m_ttft = hist(
            "llm_engine_ttft_s",
            "Seconds from submit to first emitted token")
        self._m_tpot = hist(
            "llm_engine_tpot_s",
            "Seconds between consecutive tokens of one request")
        self._m_queue_depth = gauge(
            "llm_engine_queue_depth",
            "Requests queued awaiting a decode slot")
        self._m_occupancy = gauge(
            "llm_engine_slot_occupancy",
            "Live decode slots / total slots (0..1)")
        self._m_batch_eff = gauge(
            "llm_engine_batch_efficiency",
            "Tokens emitted this step / total slots")
        self._m_dispatches = counter(
            "llm_engine_decode_dispatches_total",
            "Decode dispatches (one per step horizon)")
        self._m_host_syncs = counter(
            "llm_engine_host_syncs_total",
            "Blocking device->host transfers in the serving loop")
        self._m_transfer_bytes = counter(
            "llm_engine_host_transfer_bytes_total",
            "Bytes moved device->host by the serving loop")
        self._m_horizon = hist(
            "llm_engine_decode_horizon",
            "Decode iterations per dispatch (adaptive horizon)",
            boundaries=HORIZON_BOUNDARIES)
        self._m_prefill_real = counter(
            "llm_engine_prefill_tokens_total",
            "True prompt tokens run through batched prefill")
        self._m_prefill_padded = counter(
            "llm_engine_prefill_padded_tokens_total",
            "Length-bucket filler tokens run through batched prefill")
        self._m_prefill_stalls = counter(
            "llm_engine_chunked_prefill_stalls_total",
            "Engine steps with >= 1 row frozen mid-chunked-prefill")
        self._m_prefix_lookups = counter(
            "llm_engine_prefix_lookups_total",
            "Admissions probed against the prefix-cache trie")
        self._m_prefix_hits = counter(
            "llm_engine_prefix_hits_total",
            "Admissions that matched >= 1 cached prefix block")
        self._m_prefix_reused = counter(
            "llm_engine_prefix_reused_tokens_total",
            "Prompt tokens copied or shared from the prefix cache, not "
            "prefilled")
        self._m_prefix_evictions = counter(
            "llm_engine_prefix_evictions_total",
            "Cold prefix blocks recycled by LRU eviction")
        self._m_kv_shared = counter(
            "llm_engine_kv_blocks_shared_total",
            "Prefix-cache blocks shared into warm admissions by refcount "
            "(zero bytes copied)")
        self._m_kv_cow = counter(
            "llm_engine_kv_block_cow_total",
            "Shared blocks duplicated copy-on-write (a full-prompt hit "
            "whose tail block the new row must extend)")
        self._m_preemptions = counter(
            "llm_engine_preemptions_total",
            "Live decode rows evicted to free KV pool blocks "
            "(preempt-and-swap or preempt-and-recompute)")
        self._m_swap_out = counter(
            "llm_engine_swap_out_bytes_total",
            "Bytes spilled device->host by preemption swap-outs")
        self._m_swap_in = counter(
            "llm_engine_swap_in_bytes_total",
            "Bytes restored host->device by preemption swap-ins")
        self._m_handoffs_out = counter(
            "llm_engine_handoffs_out_total",
            "Requests exported post-prefill to a decode-class replica "
            "(disaggregated fleet handoff)")
        self._m_handoffs_in = counter(
            "llm_engine_handoffs_in_total",
            "Requests imported from a prefill-class replica for decode "
            "(disaggregated fleet handoff)")
        self._m_handoff_out = counter(
            "llm_engine_handoff_out_bytes_total",
            "KV + logits bytes staged device->host by handoff exports")
        self._m_handoff_in = counter(
            "llm_engine_handoff_in_bytes_total",
            "KV + logits bytes accepted by handoff imports (swap "
            "pre-seed; 0 for a recompute import)")
        self._m_kv_pool_total = gauge(
            "llm_engine_kv_pool_blocks",
            "KV pool size in blocks (null block excluded)")
        self._m_kv_pool_in_use = gauge(
            "llm_engine_kv_pool_blocks_in_use",
            "KV pool blocks currently referenced by rows")
        self._m_kv_pool_free = gauge(
            "llm_engine_kv_pool_blocks_free",
            "KV pool blocks on the free list")
        self._m_kv_bytes_per_token = gauge(
            "llm_engine_kv_bytes_per_token",
            "Device bytes one cached token costs")
        self._m_pipe_flushes = counter(
            "llm_engine_pipeline_flushes_total",
            "Forced full drains of the in-flight decode ring "
            "(pending admission or end of stream)")
        self._m_pipe_overrun = counter(
            "llm_engine_pipeline_overrun_tokens_total",
            "Masked run-ahead decode iterations dispatched for rows "
            "that had already finished")
        self._m_host_lag = gauge(
            "llm_engine_host_lag_steps",
            "Fused decode steps dispatched but not yet replayed on "
            "the host (ring length after the last drain)")
        # The speculative plane: engine-tagged aggregates beside the
        # per-plane llm_spec_* series of `speculative.SpecMetrics`, which
        # carry the same engine id.
        self._m_spec_rounds = counter(
            "llm_engine_spec_rounds_total",
            "Draft-propose / target-verify rounds replayed at drain")
        self._m_spec_proposed = counter(
            "llm_engine_spec_proposed_total",
            "Draft tokens proposed inside speculative dispatches")
        self._m_spec_accepted = counter(
            "llm_engine_spec_accepted_total",
            "Proposed draft tokens the target accepted")
        self._m_spec_rate = gauge(
            "llm_engine_spec_acceptance_rate",
            "Cumulative accepted / proposed (0..1; 0 with spec off)")
        self._m_adapter_lookups = counter(
            "llm_engine_adapter_lookups_total",
            "Adapter-slot acquisition attempts at the admission gate")
        self._m_adapter_hits = counter(
            "llm_engine_adapter_hits_total",
            "Slot acquisitions that found the adapter already "
            "resident on the device")
        self._m_adapter_prefetches = counter(
            "llm_engine_adapter_prefetches_total",
            "Async host->device adapter weight transfers started for "
            "cold adapters")
        self._m_adapter_evictions = counter(
            "llm_engine_adapter_evictions_total",
            "Refcount-0 resident adapters evicted LRU-first to free "
            "a slot for a committing prefetch")
        self._m_adapter_deferrals = counter(
            "llm_engine_adapter_prefetch_deferrals_total",
            "Admissions requeued because their adapter was cold and "
            "its prefetch had not committed yet")
        self._m_adapter_slots = gauge(
            "llm_engine_adapter_slots",
            "Adapter slots in the device-resident stacks (null slot "
            "0 excluded)")
        self._m_adapter_resident = gauge(
            "llm_engine_adapter_slots_resident",
            "Slots currently holding a committed adapter")
        self._m_adapter_pinned = gauge(
            "llm_engine_adapter_slots_pinned",
            "Resident slots pinned by >= 1 live row (ineligible for "
            "eviction)")
        self.tp_degree = 1
        self._m_tp_degree = gauge(
            "llm_engine_tp_degree",
            "Tensor-parallel degree of the serving mesh (1 = "
            "unsharded single-card engine)")

    # -- lifecycle hooks (called by DecodeEngine) --------------------------

    def on_submit(self, req_id: int) -> None:
        self._req[req_id] = _ReqTimes(self._clock())
        self.requests_submitted += 1
        self._m_submitted.inc()

    def on_reject(self) -> None:
        self.requests_rejected += 1
        self._m_rejected.inc()

    def on_shed(self, req_id: int) -> None:
        self.requests_shed += 1
        self._m_shed.inc()
        self._req.pop(req_id, None)

    def on_admit(self, req_id: int) -> None:
        rt = self._req.get(req_id)
        if rt is None or rt.admit_t is not None:
            return
        rt.admit_t = self._clock()
        wait = rt.admit_t - rt.submit_t
        self.requests_admitted += 1
        self.queue_wait_s.add(wait)
        self._m_queue_wait.observe(wait)

    def on_tokens(self, req_id: int, n: int) -> None:
        """`n` tokens of one request landing together (one drained
        [H, B] block): TTFT once at the request's first token, then one
        TPOT observation per further token. The first gap of a block is
        the real inter-block gap; the rest are 0.0, since a block's
        tokens reach the host at the same instant."""
        if n <= 0:
            return
        rt = self._req.get(req_id)
        now = self._clock()
        self.tokens_generated += n
        self._m_tokens.inc(n)
        if rt is None:
            return
        if rt.first_token_t is None:
            rt.first_token_t = now
            ttft = now - rt.submit_t
            self.ttft_s.add(ttft)
            self._m_ttft.observe(ttft)
        else:
            tpot = now - rt.last_token_t
            self.tpot_s.add(tpot)
            self._m_tpot.observe(tpot)
        for _ in range(n - 1):
            self.tpot_s.add(0.0)
            self._m_tpot.observe(0.0)
        rt.last_token_t = now
        rt.n_tokens += n

    def on_finish(self, req_id: int) -> None:
        self.requests_finished += 1
        self._m_finished.inc()
        self._req.pop(req_id, None)

    def on_step(self, live_slots: int, queue_depth: int,
                tokens_emitted: int) -> None:
        self.steps += 1
        self.live_slots = live_slots
        self.queue_depth = queue_depth
        self.batch_efficiency = tokens_emitted / self.batch_slots
        self._m_steps.inc()
        self._m_queue_depth.set(queue_depth)
        self._m_occupancy.set(live_slots / self.batch_slots)
        self._m_batch_eff.set(self.batch_efficiency)

    def on_dispatch(self, horizon: int, host_syncs: int = 1) -> None:
        """One decode dispatch of `horizon` iterations, costing
        `host_syncs` blocking device->host transfers (the engine passes
        0 and reports its one pull per block at drain through
        `on_host_sync`)."""
        self.decode_dispatches += 1
        self.host_syncs += host_syncs
        self.decode_horizon.add(horizon)
        self._m_dispatches.inc()
        if host_syncs > 0:
            self._m_host_syncs.inc(host_syncs)
        self._m_horizon.observe(horizon)

    def on_host_sync(self, n: int = 1, nbytes: int = 0) -> None:
        """A blocking device->host pull completed (a drained token
        block of `nbytes` bytes). Under the async pipeline it comes up
        to `pipeline_depth` dispatches after its block's dispatch."""
        self.host_syncs += n
        self._m_host_syncs.inc(n)
        if nbytes > 0:
            self.host_transfer_bytes += nbytes
            self._m_transfer_bytes.inc(nbytes)

    def on_tp_degree(self, tp: int) -> None:
        """Record the engine's tensor-parallel degree (once, at
        construction)."""
        self.tp_degree = int(tp)
        self._m_tp_degree.set(float(tp))

    def on_pipeline_drain(self, depth: int, lag: int) -> None:
        """One in-flight block replayed: `depth` fused steps were in
        flight when the drain started (1 = synchronous), `lag` remain
        after it (the host_lag_steps gauge)."""
        self.pipeline_depth.add(depth)
        self.host_lag_steps = lag
        self._m_host_lag.set(lag)

    def on_pipeline_flush(self, n: int = 1) -> None:
        self.pipeline_flushes += n
        self._m_pipe_flushes.inc(n)

    def on_pipeline_overrun(self, n: int) -> None:
        if n > 0:
            self.pipeline_overrun_tokens += n
            self._m_pipe_overrun.inc(n)

    def on_prefix(self, *, hit: bool, reused_tokens: int = 0) -> None:
        """One admission probed the prefix-cache trie; on a hit,
        `reused_tokens` prompt tokens were copied or shared, not run."""
        self.prefix_lookups += 1
        self._m_prefix_lookups.inc()
        if hit:
            self.prefix_hits += 1
            self._m_prefix_hits.inc()
        if reused_tokens > 0:
            self.prefix_reused_tokens += reused_tokens
            self._m_prefix_reused.inc(reused_tokens)

    def on_prefix_evictions(self, n: int = 1) -> None:
        if n > 0:
            self.prefix_evictions += n
            self._m_prefix_evictions.inc(n)

    def on_kv_shared(self, n: int) -> None:
        """`n` pool blocks handed to an admission by incref: the warm
        part of the prompt cost zero copy bytes."""
        if n > 0:
            self.kv_blocks_shared += n
            self._m_kv_shared.inc(n)

    def on_kv_cow(self, n: int = 1) -> None:
        if n > 0:
            self.kv_block_cows += n
            self._m_kv_cow.inc(n)

    def on_preempt(self, n: int = 1) -> None:
        if n > 0:
            self.preemptions += n
            self._m_preemptions.inc(n)

    def on_swap_out(self, nbytes: int) -> None:
        if nbytes > 0:
            self.swap_out_bytes += nbytes
            self._m_swap_out.inc(nbytes)

    def on_swap_in(self, nbytes: int) -> None:
        if nbytes > 0:
            self.swap_in_bytes += nbytes
            self._m_swap_in.inc(nbytes)

    def on_handoff_out(self, req_id: int, nbytes: int) -> None:
        """A request left this engine mid-flight (prefill->decode
        handoff): its per-request timing record goes with it, since the
        importing engine owns TTFT/TPOT from here."""
        self.handoffs_out += 1
        self._m_handoffs_out.inc()
        if nbytes > 0:
            self.handoff_out_bytes += nbytes
            self._m_handoff_out.inc(nbytes)
        self._req.pop(req_id, None)

    def on_handoff_in(self, nbytes: int) -> None:
        self.handoffs_in += 1
        self._m_handoffs_in.inc()
        if nbytes > 0:
            self.handoff_in_bytes += nbytes
            self._m_handoff_in.inc(nbytes)

    def on_kv_pool(self, total: int, in_use: int, free: int,
                   bytes_per_token: float = 0.0) -> None:
        """Gauge update at step end: pool occupancy in blocks, plus the
        engine's per-token KV cost."""
        self.kv_pool_blocks_total = total
        self.kv_pool_blocks_in_use = in_use
        self.kv_pool_blocks_free = free
        self._m_kv_pool_total.set(total)
        self._m_kv_pool_in_use.set(in_use)
        self._m_kv_pool_free.set(free)
        if bytes_per_token > 0:
            self.kv_bytes_per_token = bytes_per_token
            self._m_kv_bytes_per_token.set(bytes_per_token)

    def on_prefill_batch(self, real_tokens: int,
                         padded_tokens: int) -> None:
        """One batched prefill: `real_tokens` true prompt tokens plus
        `padded_tokens` bucket filler riding along."""
        self.prefill_real_tokens += real_tokens
        self.prefill_padded_tokens += padded_tokens
        if real_tokens > 0:
            self._m_prefill_real.inc(real_tokens)
        if padded_tokens > 0:
            self._m_prefill_padded.inc(padded_tokens)

    def on_prefill_stall(self, n: int = 1) -> None:
        """One engine step ran with >= 1 row frozen mid-chunked-prefill
        (decode advanced without it, or was skipped entirely)."""
        if n > 0:
            self.prefill_stalls += n
            self._m_prefill_stalls.inc(n)

    def on_spec_round(self, rounds: int, proposed: int,
                      accepted: int) -> None:
        """One drained speculative block: `rounds` live greedy rows each
        verified their proposals, `proposed` draft tokens in all, of
        which `accepted` matched the target's argmax chain."""
        self.spec_rounds += rounds
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        if rounds > 0:
            self._m_spec_rounds.inc(rounds)
        if proposed > 0:
            self._m_spec_proposed.inc(proposed)
        if accepted > 0:
            self._m_spec_accepted.inc(accepted)
        if self.spec_proposed:
            self._m_spec_rate.set(self.spec_accepted / self.spec_proposed)

    def on_adapter_lookup(self, hit: bool) -> None:
        """One adapter-slot acquisition attempt at the admission gate
        (AdapterPool.alloc for a non-None adapter_id)."""
        self.adapter_lookups += 1
        self._m_adapter_lookups.inc()
        if hit:
            self.adapter_hits += 1
            self._m_adapter_hits.inc()

    def on_adapter_prefetch(self, n: int = 1) -> None:
        if n > 0:
            self.adapter_prefetches += n
            self._m_adapter_prefetches.inc(n)

    def on_adapter_evict(self, n: int = 1) -> None:
        if n > 0:
            self.adapter_evictions += n
            self._m_adapter_evictions.inc(n)

    def on_adapter_defer(self, n: int = 1) -> None:
        """An admission was requeued waiting on its adapter's prefetch
        instead of stalling the step."""
        if n > 0:
            self.adapter_deferrals += n
            self._m_adapter_deferrals.inc(n)

    def on_adapter_slots(self, total: int, resident: int,
                         pinned: int) -> None:
        """Gauge update after a pool state change (commit/evict)."""
        self.adapter_slots = total
        self.adapter_slots_resident = resident
        self.adapter_slots_pinned = pinned
        self._m_adapter_slots.set(total)
        self._m_adapter_resident.set(resident)
        self._m_adapter_pinned.set(pinned)

    def observe_queue_depth(self, depth: int) -> None:
        """Gauge update outside a step (e.g. right after submit)."""
        self.queue_depth = depth
        self._m_queue_depth.set(depth)

    # -- snapshot ----------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Flat numeric snapshot of everything above."""
        def _ratio(num: float, den: float) -> float:
            return num / den if den else 0.0

        prefill_total = self.prefill_real_tokens + self.prefill_padded_tokens
        out: Dict[str, float] = {
            "requests_submitted": self.requests_submitted,
            "requests_admitted": self.requests_admitted,
            "requests_finished": self.requests_finished,
            "requests_rejected": self.requests_rejected,
            "requests_shed": self.requests_shed,
            "tokens_generated": self.tokens_generated,
            "steps": self.steps,
            "queue_depth": self.queue_depth,
            "live_slots": self.live_slots,
            "slot_occupancy": self.live_slots / self.batch_slots,
            "batch_efficiency": self.batch_efficiency,
            "decode_dispatches": self.decode_dispatches,
            "host_syncs": self.host_syncs,
            "host_syncs_per_token": _ratio(self.host_syncs,
                                           self.tokens_generated),
            "host_transfer_bytes": self.host_transfer_bytes,
            "host_transfer_bytes_per_token": _ratio(
                self.host_transfer_bytes, self.tokens_generated),
            "dispatches_per_token": _ratio(self.decode_dispatches,
                                           self.tokens_generated),
            "prefill_real_tokens": self.prefill_real_tokens,
            "prefill_padded_tokens": self.prefill_padded_tokens,
            "prefill_padding_waste_frac": _ratio(
                self.prefill_padded_tokens, prefill_total),
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": _ratio(self.prefix_hits, self.prefix_lookups),
            "prefix_reused_tokens": self.prefix_reused_tokens,
            "prefix_evictions": self.prefix_evictions,
            "chunked_prefill_stalls": self.prefill_stalls,
            "kv_blocks_shared": self.kv_blocks_shared,
            "kv_block_cows": self.kv_block_cows,
            "preemptions": self.preemptions,
            "swap_in_bytes": self.swap_in_bytes,
            "swap_out_bytes": self.swap_out_bytes,
            "handoffs_out": self.handoffs_out,
            "handoffs_in": self.handoffs_in,
            "handoff_out_bytes": self.handoff_out_bytes,
            "handoff_in_bytes": self.handoff_in_bytes,
            "kv_pool_blocks_total": self.kv_pool_blocks_total,
            "kv_pool_blocks_in_use": self.kv_pool_blocks_in_use,
            "kv_pool_blocks_free": self.kv_pool_blocks_free,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "kv_pool_occupancy": _ratio(self.kv_pool_blocks_in_use,
                                        self.kv_pool_blocks_total),
            "pipeline_flushes": self.pipeline_flushes,
            "pipeline_overrun_tokens": self.pipeline_overrun_tokens,
            "host_lag_steps": self.host_lag_steps,
            "pipeline_depth_effective": _ratio(self.pipeline_depth.sum,
                                               self.pipeline_depth.count),
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance_rate": _ratio(self.spec_accepted,
                                           self.spec_proposed),
            "adapter_lookups": self.adapter_lookups,
            "adapter_hits": self.adapter_hits,
            "adapter_hit_rate": _ratio(self.adapter_hits,
                                       self.adapter_lookups),
            "adapter_prefetches": self.adapter_prefetches,
            "adapter_evictions": self.adapter_evictions,
            "adapter_prefetch_deferrals": self.adapter_deferrals,
            "adapter_slots": self.adapter_slots,
            "adapter_slots_resident": self.adapter_slots_resident,
            "adapter_slots_pinned": self.adapter_slots_pinned,
            "tp_degree": self.tp_degree,
        }
        self.queue_wait_s.fields("queue_wait_s", out)
        self.ttft_s.fields("ttft_s", out)
        self.tpot_s.fields("tpot_s", out)
        self.decode_horizon.fields("decode_horizon", out)
        return out


class NullEngineMetrics:
    """No-op twin for loops that must not pay even the timestamping
    cost (DecodeEngine(..., enable_metrics=False))."""

    engine_id = "disabled"

    def on_submit(self, req_id): pass

    def on_reject(self): pass

    def on_shed(self, req_id): pass

    def on_admit(self, req_id): pass

    def on_tokens(self, req_id, n): pass

    def on_finish(self, req_id): pass

    def on_step(self, live_slots, queue_depth, tokens_emitted): pass

    def on_dispatch(self, horizon, host_syncs=1): pass

    def on_host_sync(self, n=1, nbytes=0): pass

    def on_tp_degree(self, tp): pass

    def on_pipeline_drain(self, depth, lag): pass

    def on_pipeline_flush(self, n=1): pass

    def on_pipeline_overrun(self, n): pass

    def on_prefix(self, *, hit, reused_tokens=0): pass

    def on_prefix_evictions(self, n=1): pass

    def on_kv_shared(self, n): pass

    def on_kv_cow(self, n=1): pass

    def on_preempt(self, n=1): pass

    def on_swap_out(self, nbytes): pass

    def on_swap_in(self, nbytes): pass

    def on_handoff_out(self, req_id, nbytes): pass

    def on_handoff_in(self, nbytes): pass

    def on_kv_pool(self, total, in_use, free, bytes_per_token=0.0): pass

    def on_prefill_batch(self, real_tokens, padded_tokens): pass

    def on_prefill_stall(self, n=1): pass

    def on_spec_round(self, rounds, proposed, accepted): pass

    def on_adapter_lookup(self, hit): pass

    def on_adapter_prefetch(self, n=1): pass

    def on_adapter_evict(self, n=1): pass

    def on_adapter_defer(self, n=1): pass

    def on_adapter_slots(self, total, resident, pinned): pass

    def observe_queue_depth(self, depth): pass

    def stats(self):
        return {}
