"""Request-scheduler policies for the continuous-batching DecodeEngine.

Own copy of `ray_tpu/models/scheduler.py` (the port imports nothing of
the JAX package): the base policy, FIFO and priority. The prefix- and
adapter-affinity policies wait for the engine features they serve
(prefix cache, multi-LoRA; see ROADMAP.md Queue A).

The policy picks which QUEUED request gets the next freed decode slot,
plus the two admission-control knobs every production LLM server grows:

- a BOUNDED queue with backpressure (`max_queue` + `on_full`): reject
  (raise `EngineOverloaded`) or block (drive the engine until a queue
  slot frees; `block_timeout_s` bounds the wait and raises
  `SubmitTimeout`);
- a per-step PREFILL ADMISSION BUDGET (`max_prefills_per_step`), so a
  burst of long prompts cannot stall every in-flight decode row.

Scheduling only changes WHICH request is admitted when a slot frees —
and, via `horizon_hint`, how many decode iterations the engine runs
before it re-consults the queue — never what an admitted request
computes.
"""

from __future__ import annotations

import collections
import heapq
from typing import List


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


_POLICIES = {"fifo": FIFOPolicy, "priority": PriorityPolicy}


def make_policy(spec) -> SchedulerPolicy:
    """Resolve a policy spec: an instance passes through, a name
    ("fifo" | "priority") constructs the built-in."""
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
           "make_policy"]
