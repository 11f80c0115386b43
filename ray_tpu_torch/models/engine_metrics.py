"""Request-lifecycle telemetry for the continuous-batching DecodeEngine.

Port of `ray_tpu/models/engine_metrics.py`, cut to the planes the
port's engine has today: the request lifecycle (queue wait, TTFT, TPOT,
tokens, steps, occupancy), decode dispatches and device->host syncs,
prefill padding, the async decode pipeline (flushes, overrun, effective
depth, host lag) and the paged KV pool (occupancy, preemptions). The
prefix-cache, tensor-parallel, handoff, speculative and multi-LoRA
planes come with those engine features (ROADMAP.md Queue A).
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
        self.preemptions = 0
        self.kv_pool_blocks_total = 0
        self.kv_pool_blocks_in_use = 0
        self.kv_pool_blocks_free = 0
        self.kv_bytes_per_token = 0.0
        self.pipeline_flushes = 0
        self.pipeline_overrun_tokens = 0
        self.host_lag_steps = 0
        self.pipeline_depth = _Agg()

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
        self._m_preemptions = counter(
            "llm_engine_preemptions_total",
            "Live decode rows evicted to free KV pool blocks")
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

    def on_preempt(self, n: int = 1) -> None:
        if n > 0:
            self.preemptions += n
            self._m_preemptions.inc(n)

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
            "preemptions": self.preemptions,
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

    def on_pipeline_drain(self, depth, lag): pass

    def on_pipeline_flush(self, n=1): pass

    def on_pipeline_overrun(self, n): pass

    def on_preempt(self, n=1): pass

    def on_kv_pool(self, total, in_use, free, bytes_per_token=0.0): pass

    def on_prefill_batch(self, real_tokens, padded_tokens): pass

    def observe_queue_depth(self, depth): pass

    def stats(self):
        return {}
