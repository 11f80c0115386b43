"""Request-scheduler policies for the continuous-batching DecodeEngine.

Own copy of `ray_tpu/models/scheduler.py` (the port imports nothing of
the JAX package): the base policy, FIFO, priority, the prefix-affinity
policy and the adapter-affinity policy of the multi-LoRA engine.

The policy picks which QUEUED request gets the next freed decode slot,
plus the two admission-control knobs every production LLM server grows:

- a BOUNDED queue with backpressure (`max_queue` + `on_full`): reject
  (raise `EngineOverloaded`) or block (drive the engine until a queue
  slot frees; `block_timeout_s` bounds the wait and raises
  `SubmitTimeout`);
- a per-step PREFILL ADMISSION BUDGET (`max_prefills_per_step`), so a
  burst of long prompts cannot stall every in-flight decode row.

Scheduling only changes WHICH request is admitted when a slot frees —
and, via `horizon_hint` and `spec_window_hint`, how many decode
iterations or draft tokens one dispatch holds — never what an admitted
request computes.
"""

from __future__ import annotations

import collections
import heapq
from typing import List, Optional


class EngineOverloaded(RuntimeError):
    """Raised by `DecodeEngine.submit()` when the bounded queue is full
    and the engine was configured with on_full="reject"."""


class EngineDraining(RuntimeError):
    """Raised by `DecodeEngine.submit()` after `begin_drain()`."""


class SubmitTimeout(EngineOverloaded):
    """Raised by `DecodeEngine.submit()` in on_full="block" mode when
    the queue stays full past ``block_timeout_s``. Subclasses
    EngineOverloaded so existing overload handlers keep catching it."""


class SchedulerPolicy:
    """Ordering policy for queued (not-yet-admitted) requests."""

    name = "base"

    def push(self, req) -> None:
        raise NotImplementedError

    def push_front(self, req) -> None:
        """Re-queue a request at the HEAD of the policy's order — a
        stale admission gate, or a PREEMPTED row that must be first in
        line to come back. Policies without a natural front may fall
        back to push."""
        self.push(req)

    def pop(self):
        """Remove and return the next request to admit."""
        raise NotImplementedError

    def choose_victim(self, rows: List[int], requests) -> int:
        """Pick which live row the paged engine preempts when the KV
        pool runs dry. `rows` is ordered oldest-admitted first. Default
        is LIFO: evict the newest admission (the oldest is closest to
        finishing and has absorbed the most compute)."""
        return rows[-1]

    def __len__(self) -> int:
        raise NotImplementedError

    def snapshot(self) -> List[int]:
        """Queued request ids, in no particular order (introspection)."""
        raise NotImplementedError

    def queued_requests(self) -> list:
        """The queued request OBJECTS, in no particular order: a
        read-only view for load probes (`pending_prefill_tokens`).
        Callers must not mutate the returned requests or the list."""
        raise NotImplementedError

    def queued_state(self) -> List[dict]:
        """Plain-dict view of the queue for the serving state API
        (`ray_tpu_torch.util.state.serving.list_requests`): one entry
        per queued request with the fields an operator reads, and the
        request object itself under ``"request"``. Falls back to id-only
        entries for a policy that implements `snapshot()` but not
        `queued_requests()`. Read-only."""
        try:
            reqs = self.queued_requests()
        except NotImplementedError:
            return [{"req_id": rid} for rid in self.snapshot()]
        return [{"req_id": r.req_id, "priority": r.priority,
                 "prompt_tokens": len(r.prompt),
                 "max_new_tokens": r.max_new_tokens,
                 "deadline": r.deadline, "resume": r.resume,
                 # imported from a prefill-class replica, waiting for
                 # decode admission (disaggregated fleets)
                 "handoff": bool(getattr(r, "handoff", False)),
                 "request": r} for r in reqs]

    def horizon_hint(self, *, free_slots: int,
                     max_horizon: int) -> int:
        """Suggested decode horizon for the NEXT engine step: 1 while a
        queued request could take a free slot next step (protect its
        TTFT), else `max_horizon` (amortize dispatch overhead). The
        engine caps the hint at the largest remaining row budget and
        rounds it down to a power of two."""
        if len(self) and free_slots > 0:
            return 1
        return max_horizon

    def spec_window_hint(self, *, rates: List[Optional[float]],
                         spec_window: int) -> List[int]:
        """Per-row draft width for the next speculative dispatch, one
        entry per candidate row, each in [1, spec_window]. ``rates``
        holds each row's recent acceptance rate (accepted / proposed
        over the engine's sliding window of rounds), or None for a row
        with no history yet. Default: a fresh row gets the full window;
        a measured row gets ``1 + rate * (spec_window - 1)`` rounded,
        so a row rejecting everything still proposes one token, which
        rides free on the verify pass. The engine dispatches at the
        largest hint (rounded up to a power of two, capped at
        spec_window) and applies each row's hint as its acceptance
        cap."""
        out = []
        for r in rates:
            if r is None:
                out.append(spec_window)
            else:
                out.append(max(1, min(spec_window,
                                      1 + int(r * (spec_window - 1)
                                              + 0.5))))
        return out

    def admissions_pending(self) -> bool:
        """Could an admission decision change the batch soon? The
        engine's async decode pipeline asks before running ahead: a
        pending admission means every freed slot must be re-examined
        with fully replayed host state, so the engine FLUSHES its
        in-flight ring and steps synchronously. Default: queue
        non-empty."""
        return len(self) > 0


class FIFOPolicy(SchedulerPolicy):
    """Admit in submission order."""

    name = "fifo"

    def __init__(self):
        self._q: collections.deque = collections.deque()

    def push(self, req) -> None:
        self._q.append(req)

    def push_front(self, req) -> None:
        self._q.appendleft(req)

    def pop(self):
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def snapshot(self) -> List[int]:
        return [r.req_id for r in self._q]

    def queued_requests(self) -> list:
        return list(self._q)


class PriorityPolicy(SchedulerPolicy):
    """Admit by priority class (LOWER number = admitted first), FIFO
    within a class. The submission sequence number breaks ties, so
    equal-priority requests never reorder (and the heap never compares
    request objects)."""

    name = "priority"

    def __init__(self):
        self._heap: list = []

    def push(self, req) -> None:
        heapq.heappush(self._heap, (req.priority, req.seq, req))

    def pop(self):
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)

    def snapshot(self) -> List[int]:
        return [r.req_id for _, _, r in self._heap]

    def queued_requests(self) -> list:
        return [r for _, _, r in self._heap]


class PrefixAffinityPolicy(FIFOPolicy):
    """FIFO order, made prefix-cache aware: never admit a request COLD
    when admitting it one round later would be WARM.

    The engine (built with prefix_cache=True) attaches a probe via
    `attach_prefix_probe`: ``probe(prompt) -> (matched_tokens,
    prefix_group_key, next_block_pending)``, a pure host walk of the
    prefix trie. `pop` scans the queue in FIFO order and SKIPS, for this
    admission round only, any request that is about to become warmer:

    - its next prefix block is PENDING: a live row is already
      prefilling exactly the blocks this request would recompute;
    - a same-prefix-group request (same first block) was already popped
      COLD this round: the first of a burst sharing one system prompt
      leads and computes the shared blocks once, the rest wait for it.

    `pop` returns None when every queued request is deferred (the
    engine stops admitting for the step). The leader IS admitted and
    its prefill always advances, so the blocks followers wait on commit
    after finitely many steps. Without a probe the policy is plain
    FIFO. Like every policy it reorders admission only."""

    name = "prefix"

    def __init__(self):
        super().__init__()
        self._probe = None
        self._round_cold: set = set()   # group keys popped cold this round
        self.deferrals = 0   # pops skipped to wait for a warmer admission

    def attach_prefix_probe(self, probe) -> None:
        self._probe = probe

    def begin_admission_round(self) -> None:
        self._round_cold = set()

    def pop(self):
        if self._probe is None:
            return super().pop()
        for i, req in enumerate(self._q):
            if getattr(req, "resume", False):
                # A preempted row coming back: its K/V is in the host
                # swap buffer (or replayed from its own history), not in
                # the trie, so deferring it only delays its restart.
                del self._q[i]
                return req
            matched, key, pending = self._probe(req.prompt)
            if pending or (key is not None and key in self._round_cold):
                self.deferrals += 1
                continue                 # warmer next round: defer
            if key is not None and matched == 0:
                self._round_cold.add(key)   # cold leader of its group
            del self._q[i]
            return req
        return None


class AdapterAffinityPolicy(FIFOPolicy):
    """FIFO order, made multi-LoRA aware: cold-adapter requests wait on
    their PREFETCH instead of stalling the admission round.

    The engine (built with `lora=`) attaches a probe via
    `attach_adapter_probe`: ``probe(adapter_id) -> (resident,
    fetching)``, a pure host lookup in the AdapterPool's ledger. `pop`
    scans the queue in FIFO order and SKIPS, for this admission round
    only, any request whose adapter is not resident yet:

    - its adapter's prefetch is IN FLIGHT: once `drain_prefetches`
      commits it (at most a few steps), the request admits warm;
    - a same-adapter request was already popped cold this round: the
      first leads (the engine's gate starts its prefetch and requeues
      it), the rest wait for that one transfer.

    `pop` returns None when every queued request is deferred. Base-model
    and resident-adapter requests always admit, and a deferred adapter's
    prefetch commits after finitely many steps. Without a probe the
    policy is plain FIFO. Like every policy it reorders admission
    only."""

    name = "adapter"

    def __init__(self):
        super().__init__()
        self._probe = None
        self._round_cold: set = set()   # adapter ids popped cold this round
        self.deferrals = 0   # pops skipped to wait for a warm slot

    def attach_adapter_probe(self, probe) -> None:
        self._probe = probe

    def begin_admission_round(self) -> None:
        self._round_cold = set()

    def pop(self):
        if self._probe is None:
            return super().pop()
        for i, req in enumerate(self._q):
            aid = getattr(req, "adapter_id", None)
            if aid is None or getattr(req, "resume", False):
                # Base-model rows gather the null slot; a preempted row
                # is owed its restart (its re-admission re-runs the
                # engine's adapter gate anyway).
                del self._q[i]
                return req
            resident, fetching = self._probe(aid)
            if resident:
                del self._q[i]
                return req
            if fetching or aid in self._round_cold:
                self.deferrals += 1
                continue                 # warm next round: defer
            self._round_cold.add(aid)    # cold leader for its adapter
            del self._q[i]
            return req
        return None


_POLICIES = {"fifo": FIFOPolicy, "priority": PriorityPolicy,
             "prefix": PrefixAffinityPolicy,
             "adapter": AdapterAffinityPolicy}


def make_policy(spec) -> SchedulerPolicy:
    """Resolve a policy spec: an instance passes through, a name
    ("fifo" | "priority" | "prefix" | "adapter") constructs the
    built-in."""
    if isinstance(spec, SchedulerPolicy):
        return spec
    try:
        return _POLICIES[spec]()
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown scheduler policy {spec!r}: expected a "
            f"SchedulerPolicy instance or one of {sorted(_POLICIES)}")


__all__ = ["EngineOverloaded", "EngineDraining", "SubmitTimeout",
           "SchedulerPolicy", "FIFOPolicy", "PriorityPolicy",
           "PrefixAffinityPolicy", "AdapterAffinityPolicy", "make_policy"]
