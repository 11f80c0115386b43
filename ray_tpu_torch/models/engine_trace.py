"""Request-lifecycle tracing for the serving engine.

Port of `ray_tpu/models/engine_trace.py`, with its own copy of
`chrome_complete_event` (from `ray_tpu/util/timeline.py`) so the port
imports nothing of the JAX package.

`EngineTracer` keeps individual spans — one bounded ring buffer of
(name, req_id, lane, t0, dur, args) records fed by `DecodeEngine` at
the seams where the metrics hooks fire. `dump()` emits
chrome://tracing complete events.

- Zero cost when off: the default is `NULL_TRACER` (``enabled =
  False``) and every engine call site guards on ``tr.enabled``.
- Bounded memory when on: the ring overwrites its OLDEST record when
  full and counts the overwrite in ``events_dropped``.
- Injectable ``clock=``.

Per-request spans are CONTIGUOUS: each request carries a frontier
timestamp advanced by every span emitted for it, so queue_wait +
prefill_chunk + decode_block spans sum to submit->finish wall time.

Env gate: ``RAY_TPU_TRACE=<prefix>`` turns tracing on for every engine
constructed with ``trace=None`` and dumps
``<prefix>.<engine_id>.<pid>.trace.json`` at process exit.

Span catalogue (name / lane / meaning):

- ``queue_wait`` (req): submit -> admission.
- ``prefill_chunk`` (req): one prompt-prefill dispatch.
- ``decode_block`` (req): the request's share of one decode dispatch.
- ``prefix_match`` (req, instant): an admission's trie probe (args:
  hit, matched_tokens; paged also shared_blocks and cow).
- ``preempt_swap_out`` / ``swap_in`` (req): a preemption round trip
  (args: mode "swap" with blocks and bytes, or "recompute").
- ``finish`` / ``shed`` (req): instant markers closing the lifecycle.
- ``dispatch`` / ``host_drain`` (engine lane): one decode dispatch
  (H iterations enqueued) / its blocking device->host token pull.
- ``spec_draft`` (engine ``dispatch`` lane): one speculative dispatch,
  draft proposals and target verify in one round (args: window,
  proposed, rows, run_ahead).
- ``spec_draft_prefill`` (engine ``dispatch`` lane): draft-plane prompt
  seeding at admission or swap-in (args: bucket, rows).
- ``spec_verify`` (engine ``drain`` lane): the host's acceptance
  accounting of one drained speculative block (args: window, rounds,
  proposed, accepted).
- ``adapter_prefetch`` / ``adapter_evict`` (engine ``events`` lane,
  instants): the adapter pool started a cold adapter's host-to-device
  copy / evicted a refcount-0 resident for a committing one (args:
  adapter_id).
- ``handoff_export`` / ``handoff_import`` (req): a request leaving a
  prefill-class engine (args: bytes, blocks, tokens) / entering a
  decode-class one (args: bytes, mode "swap" or "recompute").
- ``handoff_ready`` (engine ``events`` lane, instant): a prefill-only
  engine parked a row whose prefill completed (args: req,
  prompt_tokens).
- ``halt`` (engine ``events`` lane, instant): the fleet abandoned the
  engine (args: queued, live_rows, inflight_steps).

`models/fleet.py` records its own span ``route`` and instants
(``replica_*``, ``breaker_open``, ``failover_scheduled``, ``failover``,
``handoff``, ``handoff_placed``) through a tracer of this class, and its
`dump_trace` stitches the replicas' traces in.

Speculative spans ride the ENGINE lanes: one round serves the whole
batch, so a per-request span would break the per-request contiguity
that `tools/trace_report.py` sums; its `spec_summary` folds them
apart.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

ENV_TRACE = "RAY_TPU_TRACE"

# ~16k spans cover thousands of requests at a few spans each, < 2 MiB.
DEFAULT_CAPACITY = 16384


def chrome_complete_event(name: str, cat: str, start_s: float,
                          dur_s: float, pid: Any, tid: Any,
                          args: Optional[dict] = None) -> Dict[str, Any]:
    """One chrome://tracing complete ("X") event. Times are SECONDS in,
    microseconds out (the trace viewer's unit)."""
    return {
        "name": name,
        "cat": cat,
        "ph": "X",
        "ts": start_s * 1e6,
        "dur": max(0.0, dur_s) * 1e6,
        "pid": pid,
        "tid": tid,
        "args": args or {},
    }


class EngineTracer:
    """Bounded ring buffer of lifecycle spans. ``req_id=None`` marks an
    engine-level span, ``dur=0.0`` an instant marker."""

    enabled = True

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 clock: Callable[[], float] = time.monotonic,
                 engine_id: Optional[str] = None,
                 dump_path: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock
        self.engine_id = engine_id or "engine"
        self.dump_path = dump_path
        self.events_dropped = 0
        self._buf: List[Optional[tuple]] = [None] * capacity
        self._n = 0          # records ever written
        # Open spans awaiting their close and the per-request
        # contiguity frontier; both are pruned on finish/shed.
        self._open: Dict[Tuple[str, Any], float] = {}
        self._req_mark: Dict[Any, float] = {}

    # -- primitives --------------------------------------------------------

    def now(self) -> float:
        return self.clock()

    def add(self, name: str, t0: float, dur: float = 0.0,
            req_id: Any = None, lane: Optional[str] = None,
            args: Optional[dict] = None) -> None:
        """Append one record; overwrite the oldest (and count the drop)
        when the ring is full."""
        if self._n >= self.capacity:
            self.events_dropped += 1
        self._buf[self._n % self.capacity] = (
            name, req_id, lane, t0, dur, args)
        self._n += 1

    def instant(self, name: str, req_id: Any = None,
                args: Optional[dict] = None,
                lane: Optional[str] = None) -> None:
        self.add(name, self.clock(), 0.0, req_id, lane, args)

    def open(self, name: str, req_id: Any) -> None:
        """Mark the start of a span closed later by `close`."""
        self._open[(name, req_id)] = self.clock()

    def close(self, name: str, req_id: Any,
              args: Optional[dict] = None) -> float:
        """Emit the span opened by `open`; returns its end time (which
        also becomes the request's contiguity frontier)."""
        t1 = self.clock()
        t0 = self._open.pop((name, req_id), None)
        if t0 is not None:
            self.add(name, t0, t1 - t0, req_id, None, args)
        self._req_mark[req_id] = t1
        return t1

    def span_since_mark(self, name: str, req_id: Any,
                        args: Optional[dict] = None) -> None:
        """Emit a span from the request's frontier to now and advance
        the frontier (keeps each request's spans contiguous)."""
        t1 = self.clock()
        t0 = self._req_mark.get(req_id, t1)
        self.add(name, t0, t1 - t0, req_id, None, args)
        self._req_mark[req_id] = t1

    def finish(self, req_id: Any, args: Optional[dict] = None,
               name: str = "finish") -> None:
        """Instant `finish` (or `shed`) marker + drop the request's
        frontier/open state."""
        self.add(name, self.clock(), 0.0, req_id, None, args)
        self._req_mark.pop(req_id, None)
        for key in [k for k in self._open if k[1] == req_id]:
            del self._open[key]

    # -- introspection / export --------------------------------------------

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def events(self) -> List[tuple]:
        """Ring contents, oldest first."""
        if self._n <= self.capacity:
            return list(self._buf[:self._n])
        i = self._n % self.capacity
        return self._buf[i:] + self._buf[:i]

    def chrome_events(self, pid: Any = None) -> List[dict]:
        """Ring -> chrome://tracing complete events (plus still-open
        spans), in timestamp order."""
        pid = self.engine_id if pid is None else pid
        out = []
        for name, req_id, lane, t0, dur, args in self.events():
            tid = (f"req-{req_id}" if req_id is not None
                   else f"engine:{lane or 'events'}")
            out.append(chrome_complete_event(
                name, "request" if req_id is not None else "engine",
                t0, dur, pid, tid, args))
        now = self.clock()
        for (name, req_id), t0 in self._open.items():
            out.append(chrome_complete_event(
                name, "request", t0, now - t0, pid, f"req-{req_id}",
                {"open": True}))
        out.sort(key=lambda e: e["ts"])
        return out

    def dump(self, path: Optional[str] = None,
             pid: Any = None) -> List[dict]:
        """Write (and return) the chrome-trace JSON; with no path and no
        env-gate dump path, just return the events."""
        events = self.chrome_events(pid=pid)
        path = path or self.dump_path
        if path:
            with open(path, "w") as f:
                json.dump(events, f)
        return events


class NullEngineTracer:
    """No-op twin: the off path costs one attribute read per seam."""

    enabled = False
    engine_id = "disabled"
    events_dropped = 0
    dump_path = None

    def now(self) -> float:
        return 0.0

    def add(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def open(self, *a, **k) -> None:
        pass

    def close(self, *a, **k) -> float:
        return 0.0

    def span_since_mark(self, *a, **k) -> None:
        pass

    def finish(self, *a, **k) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def events(self) -> List[tuple]:
        return []

    def chrome_events(self, pid: Any = None) -> List[dict]:
        return []

    def dump(self, path: Optional[str] = None, pid: Any = None) -> List[dict]:
        return []


NULL_TRACER = NullEngineTracer()


def maybe_tracer_from_env(tag: str,
                          clock: Callable[[], float] = time.monotonic,
                          ) -> Optional[EngineTracer]:
    """`RAY_TPU_TRACE=<prefix>` -> an EngineTracer that dumps
    ``<prefix>.<tag>.<pid>.trace.json`` at process exit; None when the
    env gate is off."""
    prefix = os.environ.get(ENV_TRACE)
    if not prefix:
        return None
    import atexit

    tracer = EngineTracer(
        clock=clock, engine_id=tag,
        dump_path=f"{prefix}.{tag}.{os.getpid()}.trace.json")
    atexit.register(tracer.dump)
    return tracer


def resolve_tracer(spec: Union[None, bool, EngineTracer, NullEngineTracer],
                   *, engine_id: str,
                   clock: Callable[[], float] = time.monotonic):
    """The `trace=` knob: an instance is used as-is, ``True`` builds
    one, ``False`` forces off, ``None`` defers to the env gate."""
    if spec is None:
        # Explicit None check: an empty EngineTracer is falsy (__len__).
        env_tracer = maybe_tracer_from_env(engine_id, clock)
        return NULL_TRACER if env_tracer is None else env_tracer
    if spec is False:
        return NULL_TRACER
    if spec is True:
        return EngineTracer(clock=clock, engine_id=engine_id)
    return spec
