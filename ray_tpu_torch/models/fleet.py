"""SLO-aware serving fleet: replica router + engine-stats autoscaler.

Own copy of `ray_tpu/models/fleet.py` over the port's engines (the port
imports nothing of the JAX package): the same routers, autoscaler,
health state machine, failover and disaggregated classes, with the
port's scheduler exceptions, metrics instruments, tracer and key
normaliser. Names and structure follow the original, so each piece has
its counterpart there.

The `DecodeEngine` is fast on its own (fused horizon, prefix cache,
async pipeline); this module makes N of them serve as a single system.
The fleet-scale literature (Ray Serve's pow-2-choice router, Orca/vLLM
continuous batching at scale) is unanimous about where tail latency is
won once the kernel is fast: in the ROUTER (which replica gets the
request) and the SCALING POLICY (when replicas appear and disappear) —
so those are the two first-class objects here.

Four planes, one `submit()`-shaped facade (`LLMFleet`):

- ROUTING. Each request is placed by scoring replicas on their live
  `engine.stats()`-plane signals — queue depth, slot occupancy,
  pending prefill tokens, and the prompt's prefix-cache hit potential
  probed directly against each replica's radix index (`peek=True`, so
  losing candidates' LRU recency is untouched). The default router is
  power-of-two-choices (two random candidates, pick the less loaded —
  O(1) with near-best-of-N tail behavior, the Serve router's design)
  with a PREFIX-AFFINITY OVERRIDE: a replica that already holds a
  request's prefix blocks wins outright unless it is overloaded
  relative to the fleet, because re-computing a cached prefix on a
  "less loaded" replica costs more than queueing behind the warm one.

- AUTOSCALING. `EngineStatsAutoscaler` consumes per-replica
  TTFT/TPOT-p95 and occupancy gauges — NOT request rate: QPS says
  nothing about cost when one request can be 10 or 10k tokens — and
  adds or drains replicas with hysteresis (sustained breach for
  `upscale_hold_s` before +1; sustained idle for `downscale_hold_s`
  before -1; the asymmetry is deliberate, scale-up cheap and fast,
  scale-down slow and safe). Scale-down NEVER kills work:
  the victim replica is put in DRAINING (its engine refuses new
  submits, the router stops offering it), runs to empty, and only then
  leaves the pool — flush-before-removal, zero in-flight tokens lost.

- OVERLOAD. Priority classes ride the engine's own priority scheduler
  (`submit(priority=...)` passes straight through) and deadline-based
  shedding rides `DecodeEngine.submit(deadline_s=...)`: a request that
  is past its admission deadline is retired WITHOUT burning prefill,
  at submit (dead on arrival) or at admission pop (expired mid-queue).
  Shed requests surface through the same finished/pop_result path with
  `shed_ids` membership, so one polling loop serves both outcomes.

- FAULT TOLERANCE. Every `engine.step()` runs under the fleet's
  supervision: a per-replica HEALTH STATE MACHINE (RUNNING -> SUSPECT
  -> UNHEALTHY -> RETIRED, `FleetHealthConfig`) driven by step
  exceptions, a step-deadline watchdog on the injected clock,
  consecutive-slow-step probes, and a no-progress (silent) detector —
  the blueprint's raylet-heartbeat / NodeManager failure-detection
  role, done in-process. The router only offers RUNNING replicas
  whose CIRCUIT BREAKER is closed (a replica that keeps flapping into
  SUSPECT stops receiving traffic for a cooldown before it fails
  again). When a replica goes UNHEALTHY the fleet performs
  DETERMINISTIC FAILOVER: every in-flight and queued request on it is
  reconstructed from host-side bookkeeping (prompt + tokens already
  emitted + the per-request rng key the fleet pinned at submit) and
  resubmitted to a healthy replica with resume semantics — the final
  token stream is bit-identical to a fault-free run, greedy AND
  sampled, because sampling streams depend only on (key, token index)
  and the fleet derives each request's key from its FLEET id, never
  from placement. Retries get exponential backoff with deterministic
  jitter from the request seed; a request that runs out of
  `max_retries` (or of replicas) surfaces as a typed
  `RetriesExhausted` / `ReplicaUnavailable` through `pop_result()` /
  `run()` instead of hanging. `tokens_lost_to_failure` stays 0 by
  construction and is counted, not assumed.

Every replica keeps the engine's token-identity invariant: routing,
scale-up, drain, shedding, and FAILOVER change WHICH engine runs a
request and WHEN it is admitted — never what it computes. Outputs stay
token-identical to solo `generate` (greedy, and sampled with a pinned
per-request rng), which `tests/test_torch_port_fleet.py`,
`test_torch_port_fleet_faults.py` and `test_torch_port_disagg.py` hold
against the JAX fleet.

Fleet health exports as `llm_fleet_*` gauges plus the
`llm_fleet_replica_failures_total` / `llm_fleet_requests_recovered_total`
/ `llm_fleet_retries_total` counters through the ordinary
`ray_tpu_torch.util.metrics` plane (tagged by fleet id, same pattern as the
engine's `llm_engine_*` series) and as a flat `stats()` snapshot.
"""

from __future__ import annotations

import heapq
import json
import random
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ray_tpu_torch.models.engine_metrics import _Agg
from ray_tpu_torch.models.engine_trace import resolve_tracer
from ray_tpu_torch.models.generate import key_data
from ray_tpu_torch.models.scheduler import EngineDraining, EngineOverloaded
from ray_tpu_torch.util.metrics import Counter, Gauge
from ray_tpu_torch.util.state.serving import register_fleet

__all__ = [
    "LLMFleet",
    "FleetRouter",
    "RoundRobinRouter",
    "PowerOfTwoAffinityRouter",
    "FleetAutoscalingConfig",
    "FleetHealthConfig",
    "EngineStatsAutoscaler",
    "FleetError",
    "ReplicaUnavailable",
    "RetriesExhausted",
    "make_router",
    "replica_score",
]


def _key_data(key) -> np.ndarray:
    """A request's sampling key in canonical host form, raw uint32[2]
    words (`generate.key_data`: an int seed or a raw key)."""
    return np.asarray(key_data(key), np.uint32)


# ---------------------------------------------------------------------------
# Typed errors
# ---------------------------------------------------------------------------

class FleetError(RuntimeError):
    """Base class for typed fleet serving failures (replaces the bare
    RuntimeErrors the fleet used to raise)."""


class ReplicaUnavailable(FleetError):
    """No replica can take the work: none RUNNING at submit, or every
    survivor retired with replacement disabled before a recovery could
    land."""


class RetriesExhausted(FleetError):
    """A request's replica died and its retry budget ran out.

    When raised by `run()` it aggregates: ``failed`` maps each lost
    fleet request id to its underlying error, ``partial`` carries the
    results of every request that DID finish (so a caller can keep
    them instead of re-running the world)."""

    def __init__(self, msg: str, *,
                 failed: Optional[Dict[int, Exception]] = None,
                 partial: Optional[Dict[int, List[int]]] = None):
        super().__init__(msg)
        self.failed = failed or {}
        self.partial = partial or {}


# ---------------------------------------------------------------------------
# Replica pool
# ---------------------------------------------------------------------------

RUNNING = "RUNNING"
DRAINING = "DRAINING"
SUSPECT = "SUSPECT"       # probation: router skips it, step() watches it
UNHEALTHY = "UNHEALTHY"   # condemned: failover in progress
RETIRED = "RETIRED"       # out of the pool (failed replicas only;
#                           drained replicas are simply removed)


class _Replica:
    """One DecodeEngine plus its fleet bookkeeping: the replica-local
    request-id -> fleet request-id map (each engine numbers its own
    requests from 0), the health/lifecycle state the router and scaler
    act on, and the health-probe streaks the state machine runs on."""

    __slots__ = ("name", "engine", "state", "rid_to_fid", "routed",
                 "slow_streak", "silent_streak", "good_streak",
                 "failures", "timeouts", "suspect_events",
                 "breaker_open_until", "breaker_trips",
                 "replica_class")

    def __init__(self, name: str, engine,
                 replica_class: Optional[str] = None):
        self.name = name
        self.engine = engine
        # Disaggregated fleets run two replica classes: "prefill"
        # (admission + chunked prefill only; finished KV is handed
        # off) and "decode" (imports handoffs, runs fused decode).
        # None = colocated (both workloads), the default.
        self.replica_class = replica_class
        self.state = RUNNING
        self.rid_to_fid: Dict[int, int] = {}
        self.routed = 0          # requests this replica has been given
        # Health-probe streaks (reset on a good step):
        self.slow_streak = 0     # consecutive steps over slow_step_s
        self.silent_streak = 0   # consecutive no-progress steps
        self.good_streak = 0     # consecutive clean steps (recovery)
        self.failures = 0        # step() exceptions seen
        self.timeouts = 0        # watchdog (step_deadline_s) breaches
        self.suspect_events: List[float] = []   # SUSPECT entry times
        self.breaker_open_until = 0.0           # clock time; 0 = closed
        self.breaker_trips = 0


class _FleetReq:
    """Host-side bookkeeping for one fleet request — everything
    deterministic failover needs to reconstruct it on another replica:
    the normalized prompt, the budget/priority/greedy knobs, and the
    PINNED sampling key (fleet-derived from the fleet id/seed and the
    FLEET request id, so the stream survives any re-placement)."""

    __slots__ = ("fid", "prompt", "max_new_tokens", "priority",
                 "greedy", "rng", "adapter_id", "attempts", "emitted",
                 "tokens", "recovering", "handoff", "submit_t")

    def __init__(self, fid: int, prompt: List[int],
                 max_new_tokens: int, priority: int, greedy,
                 rng: np.ndarray, adapter_id: Optional[str] = None):
        self.fid = fid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        self.greedy = greedy
        self.rng = rng
        self.adapter_id = adapter_id
        self.attempts = 1        # submissions so far (retries = n-1)
        self.emitted = 0         # tokens already streamed to the caller
        self.tokens: List[int] = []   # salvage buffer while recovering
        self.recovering = False  # in the retry queue right now
        self.handoff = None      # exported engine state while the
        #                          request is between replica classes
        self.submit_t: Optional[float] = None   # fleet-clock submit
        #                          time (fleet-side TTFT in disagg)


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------

def replica_score(replica: _Replica, prompt: List[int],
                  *, queue_cost: float = 64.0,
                  slot_cost: float = 8.0) -> float:
    """Estimated cost (in prompt-token equivalents) of placing `prompt`
    on `replica` RIGHT NOW — the scoring function both routers and the
    bench share.

    pending_prefill_tokens is the real backlog unit (prompt tokens owed
    before the newcomer's prefill can start); queue depth and KV
    occupancy are converted to the same unit with fixed exchange rates
    (`queue_cost` per queued request ~ a short prompt's prefill,
    `slot_cost` per occupied slot-equivalent ~ the decode interference
    it adds); the prompt's own cost counts only its COLD suffix —
    tokens the replica's prefix pool cannot copy (probed with
    peek=True: scoring must not touch any replica's LRU recency; only
    the winner's trie is touched, at admission).

    Occupancy reads through `kv_used_fraction()`: on a DENSE engine
    that is live_rows / batch_slots, so the term equals the historical
    `live * slot_cost` exactly; on a PAGED engine it is the fraction
    of KV pool blocks not free-or-evictable, so a replica whose pool
    is nearly dry — about to preempt — scores as loaded even when its
    row slots look empty, and the router steers toward free KV blocks.
    All host-side reads, zero device work per decision.

    Replica CLASSES score on what they actually do (disaggregated
    fleets): a "prefill" replica's cost is its prefill backlog —
    queue + pending prompt tokens + the newcomer's cold suffix; its
    decode-slot terms are meaningless (it never decodes). A "decode"
    replica's cost is decode interference — live slots plus KV-pool
    pressure (the preemption predictor) plus queue; the prompt's cold
    suffix is irrelevant because its KV arrives pre-computed through
    the handoff. Colocated replicas (class None) keep the historical
    blended score."""
    eng = replica.engine
    queued = float(len(eng.scheduler))
    if hasattr(eng, "kv_used_fraction"):
        occupied = eng.kv_used_fraction() * len(eng.row_req)
    else:
        occupied = float(sum(r is not None for r in eng.row_req))
    klass = getattr(replica, "replica_class", None)
    if klass == "prefill":
        pending = float(eng.pending_prefill_tokens())
        cold = float(max(len(prompt)
                         - eng.prefix_match_tokens(prompt), 1))
        return queued * queue_cost + pending + cold
    if klass == "decode":
        live = float(sum(r is not None for r in eng.row_req))
        kv_pressure = (eng.kv_used_fraction()
                       if hasattr(eng, "kv_used_fraction") else 0.0)
        return (queued * queue_cost + live * slot_cost
                + kv_pressure * len(eng.row_req) * slot_cost + 1.0)
    pending = float(eng.pending_prefill_tokens())
    cold = float(max(len(prompt) - eng.prefix_match_tokens(prompt), 1))
    return queued * queue_cost + occupied * slot_cost + pending + cold


class FleetRouter:
    """Chooses the replica a request is submitted to. Only RUNNING
    replicas with a closed circuit breaker are offered (the fleet
    filters the rest out before calling).

    Routers that score on multi-LoRA adapter residency set
    `supports_adapter_affinity = True` and accept an ``adapter_id``
    keyword in `choose`; the fleet only passes the keyword to routers
    that advertise it, so existing custom routers keep working."""

    name = "base"
    supports_adapter_affinity = False

    def choose(self, replicas: List[_Replica],
               prompt: List[int]) -> _Replica:
        raise NotImplementedError


class RoundRobinRouter(FleetRouter):
    """Stats-blind baseline: replicas in rotation. Exists to be beaten
    — the bench's control arm for the pow-2 + affinity router."""

    name = "round_robin"

    def __init__(self):
        self._i = 0

    def choose(self, replicas: List[_Replica],
               prompt: List[int]) -> _Replica:
        rep = replicas[self._i % len(replicas)]
        self._i += 1
        return rep


class PowerOfTwoAffinityRouter(FleetRouter):
    """Power-of-two-choices over `replica_score`, with a prefix-
    affinity override.

    Affinity first: the replica whose radix index holds the LONGEST
    committed prefix of this prompt wins outright — IF its score stays
    within `affinity_overload_factor` of the best score in the fleet.
    The cap is what keeps affinity from defeating itself: without it,
    every request of a hot shared-prefix group piles onto the one warm
    replica until its queue dwarfs the prefill it saves (the classic
    cache-affinity hotspot). Past the cap the request routes by load
    and becomes the group's cache seed on a second replica.

    Multi-LoRA requests get the same treatment one level up: when the
    fleet passes ``adapter_id``, a replica whose AdapterPool already
    holds that adapter RESIDENT in HBM wins (lowest-score resident
    candidate), under the same overload cap — routing to a cold
    replica costs a host->device adapter transfer plus an admission
    deferral, which is the adapter analog of recomputing a cached
    prefix. Adapter affinity outranks prefix affinity: adapter rows
    bypass the prefix trie entirely, so their prefix term is always
    cold anyway.

    Otherwise pow-2: sample two distinct candidates with a SEEDED
    stream (deterministic tests and benches), pick the lower score.
    Two random choices get within a constant factor of scanning all N
    — the Serve router's own rationale — and the score here folds in
    everything stats() knows, not just queue length."""

    name = "pow2_affinity"
    supports_adapter_affinity = True

    def __init__(self, *, seed: int = 0, affinity: bool = True,
                 affinity_overload_factor: float = 4.0,
                 queue_cost: float = 64.0, slot_cost: float = 8.0):
        if affinity_overload_factor < 1.0:
            raise ValueError("affinity_overload_factor must be >= 1.0")
        self._rng = random.Random(seed)
        self.affinity = affinity
        self.affinity_overload_factor = affinity_overload_factor
        self.queue_cost = queue_cost
        self.slot_cost = slot_cost
        self.affinity_wins = 0   # decisions the prefix override took
        self.adapter_wins = 0    # decisions the adapter override took
        self.pow2_wins = 0       # decisions left to power-of-two

    def _score(self, rep: _Replica, prompt: List[int]) -> float:
        return replica_score(rep, prompt, queue_cost=self.queue_cost,
                             slot_cost=self.slot_cost)

    def choose(self, replicas: List[_Replica], prompt: List[int],
               adapter_id: Optional[str] = None) -> _Replica:
        if len(replicas) == 1:
            return replicas[0]
        if self.affinity and adapter_id is not None:
            scores = [self._score(r, prompt) for r in replicas]
            best_score = min(scores)
            warm = [
                i for i, r in enumerate(replicas)
                if getattr(r.engine, "adapter_resident",
                           lambda _aid: False)(adapter_id)]
            if warm:
                i = min(warm, key=lambda k: scores[k])
                if scores[i] <= self.affinity_overload_factor * \
                        (best_score + 1.0):
                    self.adapter_wins += 1
                    return replicas[i]
        if self.affinity:
            scores = [self._score(r, prompt) for r in replicas]
            best_score = min(scores)
            warm_i, warm_tokens = -1, 0
            for i, r in enumerate(replicas):
                m = r.engine.prefix_match_tokens(prompt)
                if m > warm_tokens:
                    warm_i, warm_tokens = i, m
            if warm_i >= 0 and scores[warm_i] <= \
                    self.affinity_overload_factor * (best_score + 1.0):
                self.affinity_wins += 1
                return replicas[warm_i]
        i = self._rng.randrange(len(replicas))
        j = self._rng.randrange(len(replicas) - 1)
        if j >= i:
            j += 1
        a, b = replicas[i], replicas[j]
        self.pow2_wins += 1
        return a if self._score(a, prompt) <= self._score(b, prompt) \
            else b


_ROUTERS = {"round_robin": RoundRobinRouter,
            "pow2": PowerOfTwoAffinityRouter,
            "pow2_affinity": PowerOfTwoAffinityRouter}


def make_router(spec: Union[str, FleetRouter]) -> FleetRouter:
    """Resolve a router spec: an instance passes through, a name
    ("round_robin" | "pow2" | "pow2_affinity") constructs the
    built-in."""
    if isinstance(spec, FleetRouter):
        return spec
    try:
        return _ROUTERS[spec]()
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown fleet router {spec!r}: expected a FleetRouter "
            f"instance or one of {sorted(_ROUTERS)}")


# ---------------------------------------------------------------------------
# Autoscaler
# ---------------------------------------------------------------------------

class FleetAutoscalingConfig:
    """Scaling policy knobs for `EngineStatsAutoscaler`.

    The breach signals are the SERVING SLOs, not traffic: TTFT p95 over
    `ttft_p95_slo_s` (the tail of submit -> first token, the number a
    user feels) or mean slot occupancy over `occupancy_high` (the fleet
    is out of decode slots even if the tail has not blown up yet), or —
    when `target_custom_metric` is set — a caller-recorded scalar (read
    back through `custom_metric_source`) exceeding its target.
    Scale-down needs ALL clear: occupancy under `occupancy_low`, custom
    metric (if any) under target, TTFT inside SLO.

    `upscale_hold_s` / `downscale_hold_s` are the hysteresis: a breach
    (resp. idle spell) must be CONTINUOUS for that long before the
    scaler acts, and the timers reset whenever the condition breaks.
    Downscale defaults much slower than upscale — adding a replica
    wastes a little compute; removing one into a traffic return wastes
    user latency."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 ttft_p95_slo_s: Optional[float] = None,
                 tpot_p95_slo_s: Optional[float] = None,
                 occupancy_high: float = 0.85,
                 occupancy_low: float = 0.30,
                 upscale_hold_s: float = 3.0,
                 downscale_hold_s: float = 30.0,
                 target_custom_metric: Optional[float] = None,
                 custom_metric_source: Optional[
                     Callable[[], Optional[float]]] = None):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not 0.0 <= occupancy_low <= occupancy_high <= 1.0:
            raise ValueError(
                "need 0 <= occupancy_low <= occupancy_high <= 1")
        if upscale_hold_s < 0 or downscale_hold_s < 0:
            raise ValueError("hold times must be >= 0")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.ttft_p95_slo_s = ttft_p95_slo_s
        # TPOT tail SLO: the decode-side twin of ttft_p95_slo_s. In a
        # disaggregated fleet the decode class scales on this (TTFT
        # gates the prefill class); a colocated fleet may set both.
        self.tpot_p95_slo_s = tpot_p95_slo_s
        self.occupancy_high = occupancy_high
        self.occupancy_low = occupancy_low
        self.upscale_hold_s = upscale_hold_s
        self.downscale_hold_s = downscale_hold_s
        self.target_custom_metric = target_custom_metric
        self.custom_metric_source = custom_metric_source


class FleetHealthConfig:
    """Fault-tolerance knobs for the fleet's per-replica health state
    machine, retry policy, and circuit breaker.

    Health probes (all evaluated by the fleet around each
    `engine.step()`, on the fleet's injected clock):

    - ``step_deadline_s`` — the WATCHDOG: a step that takes at least
      this long is a timeout event; ``unhealthy_after_timeouts`` of
      them (cumulative) condemn the replica. None disables.
    - ``slow_step_s`` — softer probe: ``suspect_after_slow``
      CONSECUTIVE steps at least this slow put the replica on
      SUSPECT probation (routed around, still stepped). None disables.
    - ``suspect_after_silent`` / ``unhealthy_after_silent`` —
      no-progress detection: a step that returns without advancing the
      engine at all (its step counter frozen while work is pending —
      the failure mode of a wedged or hijacked step) is a silent
      event; consecutive silents escalate SUSPECT then UNHEALTHY.
    - ``max_step_failures`` — a step() EXCEPTION condemns the replica
      once this many have been seen (default 1: fail fast; raise it to
      tolerate transient errors via SUSPECT first).
    - ``recover_after`` — clean consecutive steps that promote a
      SUSPECT replica back to RUNNING.

    Retry/backoff (per request, on replica failure): the first
    failover resubmits immediately; retry n >= 2 waits
    ``backoff_base_s * backoff_factor**(n-2)`` capped at
    ``backoff_max_s``, stretched by up to 50% deterministic jitter
    derived from the REQUEST's rng key (reproducible chaos runs).
    After ``max_retries`` retries the request surfaces as
    `RetriesExhausted`.

    Circuit breaker (per replica): ``breaker_trips`` entries into
    SUSPECT within ``breaker_window_s`` open the breaker for
    ``breaker_cooldown_s`` — the router stops offering the replica
    even after it recovers to RUNNING, until the cooldown lapses
    (half-open). Failover RESUBMISSIONS ignore the breaker:
    a recovery must land somewhere, and the breaker's job is load
    placement, not correctness.

    ``replace_failed`` — a condemned replica is REPLACED (a fresh
    replica from the factory joins as it retires), not merely counted
    out, so capacity survives the failure; the autoscaler never sees
    the dead replica in its replica count."""

    def __init__(self, *, step_deadline_s: Optional[float] = None,
                 slow_step_s: Optional[float] = None,
                 suspect_after_slow: int = 3,
                 suspect_after_silent: int = 2,
                 unhealthy_after_silent: int = 4,
                 unhealthy_after_timeouts: int = 2,
                 max_step_failures: int = 1,
                 recover_after: int = 2,
                 max_retries: int = 3,
                 backoff_base_s: float = 0.02,
                 backoff_factor: float = 2.0,
                 backoff_max_s: float = 1.0,
                 breaker_trips: int = 3,
                 breaker_window_s: float = 30.0,
                 breaker_cooldown_s: float = 5.0,
                 replace_failed: bool = True):
        if step_deadline_s is not None and step_deadline_s <= 0:
            raise ValueError("step_deadline_s must be > 0")
        if slow_step_s is not None and slow_step_s <= 0:
            raise ValueError("slow_step_s must be > 0")
        if step_deadline_s is not None and slow_step_s is not None \
                and slow_step_s > step_deadline_s:
            raise ValueError("slow_step_s must be <= step_deadline_s")
        for nm, v in (("suspect_after_slow", suspect_after_slow),
                      ("suspect_after_silent", suspect_after_silent),
                      ("unhealthy_after_silent", unhealthy_after_silent),
                      ("unhealthy_after_timeouts",
                       unhealthy_after_timeouts),
                      ("max_step_failures", max_step_failures),
                      ("recover_after", recover_after),
                      ("breaker_trips", breaker_trips)):
            if v < 1:
                raise ValueError(f"{nm} must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if backoff_base_s < 0 or backoff_max_s < 0:
            raise ValueError("backoff times must be >= 0")
        if backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1.0")
        if breaker_window_s <= 0 or breaker_cooldown_s <= 0:
            raise ValueError("breaker window/cooldown must be > 0")
        self.step_deadline_s = step_deadline_s
        self.slow_step_s = slow_step_s
        self.suspect_after_slow = suspect_after_slow
        self.suspect_after_silent = suspect_after_silent
        self.unhealthy_after_silent = unhealthy_after_silent
        self.unhealthy_after_timeouts = unhealthy_after_timeouts
        self.max_step_failures = max_step_failures
        self.recover_after = recover_after
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_factor = backoff_factor
        self.backoff_max_s = backoff_max_s
        self.breaker_trips = breaker_trips
        self.breaker_window_s = breaker_window_s
        self.breaker_cooldown_s = breaker_cooldown_s
        self.replace_failed = replace_failed


class EngineStatsAutoscaler:
    """Hysteresis state machine over per-replica engine stats.

    `tick(stats_list, n_replicas)` returns the scale decision for this
    instant: +1 (add a replica), -1 (drain one), or 0. The caller (the
    fleet) applies it; the scaler only decides. Mirrors the serve
    controller's AutoscalingState decision-hold pattern
    (_private/autoscaling.py) but reads the LLM-native gauges: worst
    per-replica TTFT p95 (one hot replica IS an SLO breach — means
    would hide it), mean occupancy (fleet-level headroom), and the
    optional custom metric.

    All timing flows through the injected clock, so tests drive
    hysteresis with a fake clock instead of sleeping real time."""

    def __init__(self, config: FleetAutoscalingConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config
        self._clock = clock
        self._breach_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self.scale_ups = 0
        self.scale_downs = 0
        # Last tick's inputs/verdict, for stats() and the bench log.
        self.last_signals: Dict[str, float] = {}

    def _signals(self, stats_list: List[Dict[str, float]]
                 ) -> Tuple[float, float, float, float, Optional[float]]:
        ttft_p95 = max((s.get("ttft_s_p95", 0.0) for s in stats_list),
                       default=0.0)
        tpot_p95 = max((s.get("tpot_s_p95", 0.0) for s in stats_list),
                       default=0.0)
        occ = (sum(s.get("slot_occupancy", 0.0) for s in stats_list)
               / len(stats_list)) if stats_list else 0.0
        qdepth = sum(s.get("queue_depth", 0.0) for s in stats_list)
        custom = None
        if self.config.custom_metric_source is not None:
            custom = self.config.custom_metric_source()
        return ttft_p95, tpot_p95, occ, qdepth, custom

    def tick(self, stats_list: List[Dict[str, float]],
             n_replicas: int) -> int:
        """One scaling decision from the current per-replica snapshots.
        Call at the fleet's step cadence; returns +1 / 0 / -1."""
        cfg = self.config
        now = self._clock()
        ttft_p95, tpot_p95, occ, qdepth, custom = \
            self._signals(stats_list)

        # TTFT/TPOT p95 are sliding WINDOWS over past requests — once
        # traffic stops the window goes stale at its last (bad) value.
        # A latency breach therefore only counts while the fleet is
        # actually busy (work queued or slots occupied); an idle fleet
        # quoting an old p95 must scale DOWN, not up.
        busy = occ > 0.0 or qdepth > 0.0
        breach = occ > cfg.occupancy_high
        if busy and cfg.ttft_p95_slo_s is not None and \
                ttft_p95 > cfg.ttft_p95_slo_s:
            breach = True
        if busy and cfg.tpot_p95_slo_s is not None and \
                tpot_p95 > cfg.tpot_p95_slo_s:
            breach = True
        if cfg.target_custom_metric is not None and custom is not None \
                and custom > cfg.target_custom_metric:
            breach = True

        idle = (not breach) and occ < cfg.occupancy_low
        if cfg.target_custom_metric is not None and custom is not None \
                and custom >= cfg.target_custom_metric:
            idle = False

        self.last_signals = {
            "ttft_p95": ttft_p95, "tpot_p95": tpot_p95,
            "occupancy": occ,
            "queue_depth": qdepth,
            "custom": float("nan") if custom is None else custom,
            "breach": 1.0 if breach else 0.0,
            "idle": 1.0 if idle else 0.0,
        }

        if breach:
            self._idle_since = None
            if self._breach_since is None:
                self._breach_since = now
            if now - self._breach_since >= cfg.upscale_hold_s and \
                    n_replicas < cfg.max_replicas:
                self._breach_since = None   # re-arm: next +1 needs a
                self.scale_ups += 1         # fresh sustained breach
                return +1
            return 0
        self._breach_since = None

        if idle:
            if self._idle_since is None:
                self._idle_since = now
            if now - self._idle_since >= cfg.downscale_hold_s and \
                    n_replicas > cfg.min_replicas:
                self._idle_since = None
                self.scale_downs += 1
                return -1
            return 0
        self._idle_since = None
        return 0


# ---------------------------------------------------------------------------
# Fleet facade
# ---------------------------------------------------------------------------

_fleet_gauges: Dict[str, Gauge] = {}
_fleet_counters: Dict[str, Counter] = {}


class LLMFleet:
    """N `DecodeEngine` replicas behind one engine-shaped API.

    `engine_factory(name)` builds one replica's engine (the fleet
    passes a unique replica name — use it as `engine_id` so the
    per-engine `llm_engine_*` series stay separable). The fleet owns
    replica lifecycle: it starts with `initial_replicas` (or the
    autoscaler's min), the router places every `submit`, `step()`
    advances every replica one engine step — under the health state
    machine's supervision — and applies at most one scale decision;
    DRAINING replicas leave the pool only once empty, UNHEALTHY ones
    fail over their work and are replaced.

    The API mirrors DecodeEngine on purpose — submit / step / run /
    pending / pop_result / finished / shed_ids / stats — so a serving
    loop written against one engine drives a fleet unchanged. Request
    ids are FLEET-scoped (each engine numbers its own; the fleet maps
    engine ids back per replica). The fleet pins every request's
    sampling key at submit (derived from `rng_seed` and the FLEET id
    when the caller passes none), which is what makes failover
    deterministic: the stream depends on the request, never on the
    replica that happens to run it.

    ``fault_injector`` (a `models.fault_injection.FaultInjector`) is
    armed on every replica the factory builds — including autoscale
    and failure replacements — so chaos schedules keep biting
    mid-churn."""

    def __init__(self, engine_factory: Callable[[str], object], *,
                 initial_replicas: Optional[int] = None,
                 router: Union[str, FleetRouter] = "pow2_affinity",
                 autoscaling: Optional[FleetAutoscalingConfig] = None,
                 health: Optional[FleetHealthConfig] = None,
                 fleet_id: str = "fleet-0",
                 rng_seed: int = 0,
                 fault_injector=None,
                 trace=None,
                 clock: Callable[[], float] = time.monotonic,
                 disaggregated: bool = False,
                 prefill_replicas: Optional[int] = None,
                 decode_replicas: Optional[int] = None,
                 prefill_autoscaling: Optional[
                     FleetAutoscalingConfig] = None,
                 decode_autoscaling: Optional[
                     FleetAutoscalingConfig] = None):
        self._factory = engine_factory
        self.router = make_router(router)
        self.fleet_id = fleet_id
        self._clock = clock
        self.health = health if health is not None else \
            FleetHealthConfig()
        self._injector = fault_injector
        # Fleet-level tracer: holds the `route` spans (one per submit,
        # carrying the router's scoring decision) that stitch replica
        # traces into one request story. Same knob semantics as
        # DecodeEngine(trace=...): instance / True / False / None
        # (env gate). Replica ENGINE tracing stays the factory's call —
        # dump_trace() merges whatever replicas traced.
        self.trace = resolve_tracer(trace, engine_id=fleet_id,
                                    clock=clock)
        self._retired_trace: List[dict] = []   # removed replicas' spans
        # Disaggregated prefill/decode (DistServe/Splitwise shape):
        # the replica pool splits into a "prefill" class (admission +
        # chunked prefill only; finished KV is exported) and a
        # "decode" class (imports handoffs, runs fused decode), each
        # scaled by its OWN autoscaler — TTFT p95 gates prefill
        # capacity, TPOT p95 gates decode capacity. Colocated fleets
        # (the default) keep the single shared pool and scaler.
        self.disaggregated = bool(disaggregated)
        if not self.disaggregated and (
                prefill_replicas is not None
                or decode_replicas is not None
                or prefill_autoscaling is not None
                or decode_autoscaling is not None):
            raise ValueError(
                "prefill_*/decode_* fleet knobs require "
                "disaggregated=True")
        if self.disaggregated and (autoscaling is not None
                                   or initial_replicas is not None):
            raise ValueError(
                "disaggregated=True sizes and scales per class: use "
                "prefill_replicas/decode_replicas and "
                "prefill_autoscaling/decode_autoscaling instead of "
                "initial_replicas/autoscaling")
        self.autoscaler = (EngineStatsAutoscaler(autoscaling, clock)
                           if autoscaling is not None else None)
        self._prefill_scaler = (
            EngineStatsAutoscaler(prefill_autoscaling, clock)
            if prefill_autoscaling is not None else None)
        self._decode_scaler = (
            EngineStatsAutoscaler(decode_autoscaling, clock)
            if decode_autoscaling is not None else None)
        # Fleet-level adapter table: {adapter_id: lora_init-shaped
        # host tree}. register_adapter fans out to every replica and
        # REPLAYS onto replicas that join later (autoscale, failure
        # replacement), so routing never depends on when a replica was
        # born relative to a registration.
        self._adapters: Dict[str, object] = {}
        self.replicas: List[_Replica] = []
        self._next_replica = 0
        if self.disaggregated:
            n_pre = prefill_replicas
            if n_pre is None:
                n_pre = (prefill_autoscaling.min_replicas
                         if prefill_autoscaling else 1)
            n_dec = decode_replicas
            if n_dec is None:
                n_dec = (decode_autoscaling.min_replicas
                         if decode_autoscaling else 1)
            for klass, n_k, cfg_k in (
                    ("prefill", n_pre, prefill_autoscaling),
                    ("decode", n_dec, decode_autoscaling)):
                if n_k < 1:
                    raise ValueError(
                        f"{klass}_replicas must be >= 1")
                if cfg_k is not None and not \
                        cfg_k.min_replicas <= n_k \
                        <= cfg_k.max_replicas:
                    raise ValueError(
                        f"{klass}_replicas {n_k} outside autoscaling "
                        f"bounds [{cfg_k.min_replicas}, "
                        f"{cfg_k.max_replicas}]")
            for _ in range(n_pre):
                self.add_replica(replica_class="prefill")
            for _ in range(n_dec):
                self.add_replica(replica_class="decode")
        else:
            n = initial_replicas
            if n is None:
                n = autoscaling.min_replicas if autoscaling else 2
            if n < 1:
                raise ValueError("initial_replicas must be >= 1")
            if autoscaling is not None and \
                    not autoscaling.min_replicas <= n \
                    <= autoscaling.max_replicas:
                raise ValueError(
                    f"initial_replicas {n} outside autoscaling bounds "
                    f"[{autoscaling.min_replicas}, "
                    f"{autoscaling.max_replicas}]")
            for _ in range(n):
                self.add_replica()
        # Handoff plane: fids whose exported engine state is parked on
        # the host (no decode replica could import right now), plus
        # the fleet's own submit->first-token latency window — prefill
        # engines never emit tokens, so the fleet measures the
        # user-visible TTFT itself and feeds it to the prefill scaler.
        self._handoff_parked: List[int] = []
        self.handoffs = 0
        self._ttft_agg = _Agg()
        self._next_fid = 0
        self._placement: Dict[int, Tuple[_Replica, int]] = {}
        self._requests: Dict[int, _FleetReq] = {}
        self._done: Dict[int, List[int]] = {}
        self.finished: set = set()
        self.shed_ids: set = set()
        self.failed: Dict[int, FleetError] = {}
        self.failed_ids: set = set()
        # Retry queue: (ready_at, seq, fid) min-heap; seq keeps pops
        # FIFO among retries due at the same instant.
        self._retry: List[Tuple[float, int, int]] = []
        self._retry_seq = 0
        # Tokens salvaged from a dead replica that were never streamed
        # through step()'s emissions — surfaced in the NEXT step's
        # merged dict so streaming callers see a gapless sequence.
        self._pending_emit: Dict[int, List[int]] = {}
        self.requests_routed = 0
        self.requests_shed = 0
        self.requests_failed = 0
        self.requests_recovered = 0
        self.retries = 0
        self.replicas_removed = 0
        self.replicas_failed = 0
        self.tokens_lost_to_drain = 0   # stays 0 by construction;
        #                                 asserted in tests AND here
        self.tokens_lost_to_failure = 0  # ditto, for the failover path
        # Per-request sampling-key root: two 32-bit halves mixed from
        # rng_seed (splitmix-style), XOR-folded with the fleet request
        # id in `_fid_key`.
        s = (rng_seed * 0x9E3779B97F4A7C15 + 0xD1B54A32D192ED03) \
            & 0xFFFFFFFFFFFFFFFF
        self._seed0 = (s >> 32) & 0xFFFFFFFF
        self._seed1 = s & 0xFFFFFFFF
        # Weak registration in the serving state API: summarize_fleet /
        # the status CLI find this fleet (and attribute its replicas'
        # engines) without the fleet holding any extra lifecycle.
        register_fleet(self)

    # -- replica lifecycle -------------------------------------------------

    def add_replica(self,
                    replica_class: Optional[str] = None) -> str:
        """Build a fresh replica via the factory and put it in the
        routing rotation; returns its name. Arms the fleet's fault
        injector (when one is configured) so chaos schedules cover
        replacements too.

        ``replica_class`` ("prefill" | "decode" | None) is a FLEET
        placement attribute stamped onto the engine after construction
        — any engine_factory works unchanged. A "prefill" engine gets
        `prefill_only = True`: its step() parks completed prefills for
        export instead of decoding them."""
        if replica_class not in (None, "prefill", "decode"):
            raise ValueError(
                f"replica_class must be 'prefill', 'decode' or None, "
                f"got {replica_class!r}")
        name = f"{self.fleet_id}-r{self._next_replica}"
        self._next_replica += 1
        engine = self._factory(name)
        if replica_class is not None:
            engine.replica_class = replica_class
            if replica_class == "prefill":
                engine.prefill_only = True
        if self._injector is not None:
            self._injector.arm(engine, name)
        if self._adapters and \
                getattr(engine, "adapter_pool", None) is not None:
            for aid, params in self._adapters.items():
                engine.register_adapter(aid, params)
        self.replicas.append(_Replica(name, engine, replica_class))
        return name

    def register_adapter(self, adapter_id: str, lora_params) -> None:
        """Admit a LoRA adapter fleet-wide: register its weights on
        every pooled replica that carries an AdapterPool (and on every
        future replica, via the fleet table). Raises if NO replica can
        serve adapters — a silent no-op would route adapter traffic
        into per-engine submit errors later."""
        pools = [r for r in self.replicas
                 if getattr(r.engine, "adapter_pool", None) is not None]
        if not pools:
            raise ValueError(
                "register_adapter: no replica was built with lora= "
                "(engine_factory must enable the adapter pool)")
        for rep in pools:
            rep.engine.register_adapter(adapter_id, lora_params)
        self._adapters[adapter_id] = lora_params

    def unregister_adapter(self, adapter_id: str) -> None:
        """Drop an adapter fleet-wide (per-replica removal defers
        until that replica's last live row using it retires)."""
        self._adapters.pop(adapter_id, None)
        for rep in self.replicas:
            if getattr(rep.engine, "adapter_pool", None) is not None:
                rep.engine.unregister_adapter(adapter_id)

    def adapter_ids(self) -> List[str]:
        return sorted(self._adapters)

    def drain_replica(self, name: str) -> None:
        """Move a replica to DRAINING: its engine refuses new submits
        (EngineDraining), the router no longer offers it, and `step()`
        keeps advancing it until empty, then removes it. In-flight and
        queued work all complete — flush-before-removal."""
        rep = self._replica(name)
        rep.state = DRAINING
        rep.engine.begin_drain()

    def _replica(self, name: str) -> _Replica:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        raise KeyError(f"no replica named {name!r}")

    def _running(self) -> List[_Replica]:
        return [r for r in self.replicas if r.state == RUNNING]

    def _routable(self) -> List[_Replica]:
        """RUNNING replicas whose circuit breaker is closed. Falls back
        to ALL RUNNING replicas when every breaker is open — serving
        somewhere beats serving nowhere."""
        running = self._running()
        now = self._clock()
        closed = [r for r in running if now >= r.breaker_open_until]
        return closed or running

    # -- request path ------------------------------------------------------

    def _fid_key(self, fid: int) -> np.ndarray:
        """The pinned per-request sampling key: a distinct uint32[2]
        stream mixed host-side from the fleet seed and the FLEET
        request id. Deriving from the fleet id — never the replica or
        its engine-local request numbering — is the failover
        determinism guarantee for sampled requests: any replica that
        (re)runs request `fid` samples the identical stream."""
        mix0 = (fid * 0x9E3779B9 + 0x7F4A7C15) & 0xFFFFFFFF
        mix1 = (fid * 0x85EBCA6B + 0xC2B2AE35) & 0xFFFFFFFF
        return np.array([self._seed0 ^ mix0, self._seed1 ^ mix1],
                        np.uint32)

    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               priority: int = 0, rng=None,
               deadline_s: Optional[float] = None,
               greedy: Optional[bool] = None,
               adapter_id: Optional[str] = None) -> int:
        """Route and enqueue one request; returns its FLEET id.

        priority / deadline_s / greedy pass straight through to the
        chosen engine's submit. The sampling key does NOT pass through
        untouched: when ``rng`` is None the fleet derives a per-request
        key from its own seed and the fleet request id and pins it, so
        the request's sampled stream is a function of the REQUEST, not
        of whichever replica runs (or re-runs, after a failure) it. A
        dead-on-arrival deadline still routes (the engine sheds it
        before it can occupy a queue slot) and is visible in
        `finished` + `shed_ids` immediately. Raises
        `ReplicaUnavailable` when no RUNNING replica exists.

        ``adapter_id`` selects a registered LoRA adapter (None = base
        model): the router scores on HBM residency when it advertises
        adapter affinity, and the id passes through to the engine's
        adapter-gated admission."""
        routable = self._routable()
        if self.disaggregated:
            # New requests land on the prefill class — that is the
            # whole point of the split. Fall back to whatever runs
            # (decode replicas are full colocated engines) only when
            # the prefill class is momentarily empty mid-churn.
            pre = [r for r in routable
                   if r.replica_class == "prefill"]
            routable = pre or routable
        if not routable:
            raise ReplicaUnavailable(
                "fleet has no RUNNING replicas to route to")
        if adapter_id is not None and adapter_id not in self._adapters:
            raise KeyError(
                f"unknown adapter_id {adapter_id!r}: call "
                "register_adapter first")
        prompt = [int(t) for t in prompt]
        fid = self._next_fid
        key = self._fid_key(fid) if rng is None else rng
        tr = self.trace
        if tr.enabled:
            # Snapshot what the router is about to see (pure peek
            # probes, no LRU perturbation) so the route span carries
            # the scoring decision, not a post-hoc reconstruction.
            t0 = tr.now()
            scores = {r.name: round(replica_score(r, prompt), 2)
                      for r in routable}
            warm = {r.name: r.engine.prefix_match_tokens(prompt)
                    for r in routable}
        rep = self._choose(routable, prompt, adapter_id)
        # adapter_id rides as a kwarg only when set: stub/legacy
        # engines without the multi-LoRA plane keep working.
        ad_kw = {} if adapter_id is None else {"adapter_id": adapter_id}
        rid = rep.engine.submit(prompt, max_new_tokens,
                                priority=priority, rng=key,
                                deadline_s=deadline_s, greedy=greedy,
                                **ad_kw)
        self._next_fid += 1
        if tr.enabled:
            tr.add("route", t0, tr.now() - t0, req_id=fid,
                   args={"replica": rep.name, "rid": rid,
                         "router": getattr(self.router, "name",
                                           type(self.router).__name__),
                         "scores": scores, "warm_tokens": warm,
                         "warm": warm.get(rep.name, 0) > 0})
        # Pin the key in canonical host form (raw uint32[2] bits):
        # failover resubmission must replay the SAME stream whether the
        # caller passed a legacy key array, a typed key, or nothing.
        self._requests[fid] = _FleetReq(
            fid, prompt, max_new_tokens, priority, greedy,
            _key_data(key), adapter_id)
        if self.disaggregated:
            self._requests[fid].submit_t = self._clock()
        rep.rid_to_fid[rid] = fid
        self._placement[fid] = (rep, rid)
        rep.routed += 1
        self.requests_routed += 1
        self._sweep_finished(rep)    # DOA sheds surface immediately
        return fid

    def step(self) -> Dict[int, List[int]]:
        """Advance every replica one engine step; returns the merged
        {fleet_id: new tokens} emissions. Also applies at most one
        autoscaler decision, runs the health state machine over every
        step (exceptions, watchdog, slow/silent probes — failing
        replicas fail over their work here), resubmits due retries,
        and retires DRAINING replicas that have run empty.

        The scale decision is taken on the PRE-step snapshots: submits
        land between steps, so the backlog visible now — before this
        step consumes any of it — is the demand the fleet is actually
        facing. (Post-step stats systematically under-read: a fast
        engine may clear its whole queue within the step and report an
        idle instant while sustained traffic is breaching the SLO.)"""
        if self.autoscaler is not None:
            self._apply_scale(self.autoscaler.tick(
                [r.engine.stats() for r in self.replicas],
                len(self._running())))
        if self.disaggregated:
            self._tick_class_scalers()
        emitted: Dict[int, List[int]] = {}
        if self._pending_emit:
            # Tokens salvaged from a failed replica that step() never
            # streamed: surface them now so the caller's stream is
            # gapless across the failover.
            emitted.update(self._pending_emit)
            self._pending_emit = {}
        self._drain_retries()
        for rep in list(self.replicas):
            if rep.state in (UNHEALTHY, RETIRED):
                continue
            if not rep.engine.pending():
                self._sweep_finished(rep)
                # No step ran: streaks can't accumulate on idleness,
                # and an idle SUSPECT replica (routed around, so it
                # can never earn good steps) recovers on clean sweeps.
                rep.slow_streak = 0
                rep.silent_streak = 0
                self._note_good(rep)
                continue
            steps_before = getattr(rep.engine, "steps_total", 0)
            t0 = self._clock()
            try:
                em = rep.engine.step()
            except Exception as exc:   # noqa: BLE001 — any step error
                #                        is a replica health event
                self._on_step_error(rep, exc)
                continue
            dt = self._clock() - t0
            for rid, toks in em.items():
                fid = rep.rid_to_fid.get(rid)
                if fid is not None and toks:
                    emitted.setdefault(fid, []).extend(toks)
                    meta = self._requests.get(fid)
                    if meta is not None:
                        if meta.emitted == 0 and \
                                meta.submit_t is not None:
                            # Fleet-side TTFT: submit -> first token,
                            # SPANNING the handoff (the number a user
                            # feels; prefill engines never emit, so no
                            # engine window covers it).
                            self._ttft_agg.add(
                                self._clock() - meta.submit_t)
                        meta.emitted += len(toks)
            self._sweep_finished(rep)
            progressed = getattr(rep.engine, "steps_total",
                                 steps_before + 1) != steps_before
            self._health_after_step(rep, dt, progressed)
        if self.disaggregated:
            self._process_handoffs()
        self._retire_drained()
        return emitted

    def pending(self) -> bool:
        return bool(self._retry) or bool(self._handoff_parked) or any(
            r.engine.pending() for r in self.replicas
            if r.state != RETIRED)

    def run(self) -> Dict[int, List[int]]:
        """Drain every replica; returns {fleet_id: tokens} for every
        finished request and pops them (like DecodeEngine.run). If any
        request was LOST — its replica died and retries ran out, or no
        replica remained to recover onto — raises `RetriesExhausted`
        (or `ReplicaUnavailable` when no retry budget was even
        consumed) carrying the per-request errors in ``.failed`` and
        every successful result in ``.partial``, instead of hanging on
        tokens that will never arrive."""
        while self.pending():
            self.step()
        for rep in list(self.replicas):
            self._sweep_finished(rep)
        self._retire_drained()
        results: Dict[int, List[int]] = {}
        errors: Dict[int, FleetError] = {}
        for fid in list(self.finished):
            if fid in self.failed:
                self.finished.discard(fid)
                self.failed_ids.discard(fid)
                errors[fid] = self.failed.pop(fid)
            else:
                results[fid] = self.pop_result(fid)
        if errors:
            kind = (RetriesExhausted
                    if any(isinstance(e, RetriesExhausted)
                           for e in errors.values())
                    else ReplicaUnavailable)
            err = kind(
                f"{len(errors)} request(s) lost to replica failure: "
                f"{sorted(errors)}", failed=errors, partial=results) \
                if kind is RetriesExhausted else kind(
                f"{len(errors)} request(s) lost to replica failure: "
                f"{sorted(errors)}")
            if kind is ReplicaUnavailable:
                err.failed = errors          # same introspection shape
                err.partial = results
            raise err
        return results

    def pop_result(self, fid: int) -> List[int]:
        """Tokens of a FINISHED fleet request (empty for a shed one —
        check `shed_ids` before popping, same contract as the engine).
        For a request whose replica died with retries exhausted,
        raises its typed `RetriesExhausted` / `ReplicaUnavailable`
        (check `failed_ids` first to branch without try/except)."""
        if fid in self.failed:
            self.finished.discard(fid)
            self.failed_ids.discard(fid)
            raise self.failed.pop(fid)
        if fid not in self.finished:
            raise KeyError(f"fleet request {fid} unknown or "
                           f"not finished")
        self.finished.discard(fid)
        self.shed_ids.discard(fid)
        return self._done.pop(fid)

    # -- health state machine + failover -----------------------------------

    def _note_good(self, rep: _Replica) -> None:
        rep.good_streak += 1
        if rep.state == SUSPECT and \
                rep.good_streak >= self.health.recover_after:
            rep.state = RUNNING
            if self.trace.enabled:
                self.trace.instant("replica_recovered", lane="events",
                                   args={"replica": rep.name})

    def _suspect(self, rep: _Replica, why: str) -> None:
        """Put a replica on probation (RUNNING -> SUSPECT): the router
        skips it, step() keeps watching it. Entering SUSPECT counts
        toward the circuit breaker — `breaker_trips` entries within
        `breaker_window_s` open it for `breaker_cooldown_s`, so a
        flapping replica stops taking traffic BEFORE its next failure.
        DRAINING replicas stay DRAINING (already unrouted)."""
        rep.good_streak = 0
        if rep.state != RUNNING:
            return
        rep.state = SUSPECT
        if self.trace.enabled:
            self.trace.instant("replica_suspect", lane="events",
                               args={"replica": rep.name, "why": why})
        now = self._clock()
        cfg = self.health
        rep.suspect_events.append(now)
        rep.suspect_events = [
            t for t in rep.suspect_events
            if now - t <= cfg.breaker_window_s]
        if len(rep.suspect_events) >= cfg.breaker_trips:
            rep.breaker_open_until = now + cfg.breaker_cooldown_s
            rep.breaker_trips += 1
            rep.suspect_events.clear()
            if self.trace.enabled:
                self.trace.instant(
                    "breaker_open", lane="events",
                    args={"replica": rep.name,
                          "until": rep.breaker_open_until})

    def _on_step_error(self, rep: _Replica, exc: Exception) -> None:
        rep.failures += 1
        if self.trace.enabled:
            self.trace.instant(
                "replica_step_error", lane="events",
                args={"replica": rep.name, "failures": rep.failures,
                      "error": f"{type(exc).__name__}: {exc}"})
        if rep.failures >= self.health.max_step_failures:
            self._fail_replica(rep, exc)
        else:
            self._suspect(rep, "step_error")

    def _health_after_step(self, rep: _Replica, dt: float,
                           progressed: bool) -> None:
        """Classify one completed (non-raising) step: watchdog timeout,
        silent (no engine progress while work is pending), slow, or
        good — and advance the replica's health state accordingly."""
        cfg = self.health
        if cfg.step_deadline_s is not None and \
                dt >= cfg.step_deadline_s:
            rep.timeouts += 1
            if self.trace.enabled:
                self.trace.instant(
                    "replica_watchdog_timeout", lane="events",
                    args={"replica": rep.name, "step_s": dt,
                          "timeouts": rep.timeouts})
            if rep.timeouts >= cfg.unhealthy_after_timeouts:
                self._fail_replica(rep, FleetError(
                    f"replica {rep.name}: {rep.timeouts} watchdog "
                    f"timeouts (step >= {cfg.step_deadline_s}s)"))
                return
            self._suspect(rep, "watchdog_timeout")
            return
        if not progressed:
            rep.silent_streak += 1
            if rep.silent_streak >= cfg.unhealthy_after_silent:
                self._fail_replica(rep, FleetError(
                    f"replica {rep.name}: silent for "
                    f"{rep.silent_streak} steps (no engine progress "
                    "with work pending)"))
                return
            if rep.silent_streak >= cfg.suspect_after_silent:
                self._suspect(rep, "silent")
            return
        if cfg.slow_step_s is not None and dt >= cfg.slow_step_s:
            rep.silent_streak = 0
            rep.slow_streak += 1
            if rep.slow_streak >= cfg.suspect_after_slow:
                self._suspect(rep, "slow_steps")
            return
        rep.slow_streak = 0
        rep.silent_streak = 0
        self._note_good(rep)

    def _fail_replica(self, rep: _Replica, cause: Exception) -> None:
        """Condemn a replica and fail its work over: harvest results
        it already finished, reconstruct every in-flight and queued
        request from host bookkeeping (prompt + emitted tokens + the
        pinned key), halt the engine (pipeline discarded, paged-KV
        refcounts released), retire the replica, schedule the
        reconstructed requests for resubmission with backoff, and —
        by default — add a replacement replica."""
        if rep.state == RETIRED:
            return
        rep.state = UNHEALTHY
        self.replicas_failed += 1
        self._count("replica_failures", 1)
        if self.trace.enabled:
            self.trace.instant(
                "replica_failed", lane="events",
                args={"replica": rep.name,
                      "error": f"{type(cause).__name__}: {cause}",
                      "inflight": len(rep.rid_to_fid)})
        # Results the replica finished before dying are ordinary
        # completions: sweep them first (host-side state survives any
        # step() exception — nothing below touches the device).
        try:
            self._sweep_finished(rep)
        except Exception:
            pass
        salvaged: List[Tuple[int, List[int]]] = []
        results = getattr(rep.engine, "results", {})
        for rid, fid in list(rep.rid_to_fid.items()):
            req = results.get(rid)
            toks = list(req.tokens) if req is not None else []
            meta = self._requests.get(fid)
            if meta is not None:
                # Tokens already streamed to the caller must all be in
                # the salvage (req.tokens accrues at drain, BEFORE the
                # fleet ever sees an emission) — counted, not trusted.
                self.tokens_lost_to_failure += max(
                    0, meta.emitted - len(toks))
                gap = toks[meta.emitted:]
                if gap:
                    self._pending_emit.setdefault(fid, []).extend(gap)
                    meta.emitted = len(toks)
            salvaged.append((fid, toks))
            self._placement.pop(fid, None)
        rep.rid_to_fid.clear()
        try:
            rep.engine.halt()
        except Exception:
            pass               # the engine may be arbitrarily broken
        self._harvest_trace(rep)
        rep.state = RETIRED
        if rep in self.replicas:
            self.replicas.remove(rep)
        self.replicas_removed += 1
        for fid, toks in salvaged:
            self._schedule_retry(fid, toks, cause)
        if self.health.replace_failed:
            # Replacement inherits the dead replica's class: losing a
            # decode replica must not quietly shrink decode capacity
            # into a colocated pool.
            name = self.add_replica(replica_class=rep.replica_class)
            if self.trace.enabled:
                self.trace.instant(
                    "replica_replaced", lane="events",
                    args={"failed": rep.name, "replacement": name})

    def _schedule_retry(self, fid: int, toks: List[int],
                        cause: Exception) -> None:
        meta = self._requests.get(fid)
        if meta is None:
            return
        if len(toks) >= meta.max_new_tokens:
            # The salvage IS the complete answer (the replica died
            # between finishing and being swept): finish directly.
            self._done[fid] = toks
            self.finished.add(fid)
            self._requests.pop(fid, None)
            return
        n = meta.attempts           # next submission = retry #n
        if n > self.health.max_retries:
            self._fail_request(fid, RetriesExhausted(
                f"fleet request {fid}: replica failed "
                f"({type(cause).__name__}: {cause}) and all "
                f"{self.health.max_retries} retries are spent"))
            return
        meta.tokens = toks
        meta.recovering = True
        delay = self._backoff_delay(meta, n)
        heapq.heappush(self._retry,
                       (self._clock() + delay, self._retry_seq, fid))
        self._retry_seq += 1
        if self.trace.enabled:
            self.trace.instant(
                "failover_scheduled", fid,
                args={"retry": n, "delay_s": round(delay, 4),
                      "resume_tokens": len(toks)})

    def _backoff_delay(self, meta: _FleetReq, n: int) -> float:
        """Retry n's wait. The first failover is immediate (the
        failure is already detected — waiting buys nothing); later
        retries back off exponentially, stretched by up to 50%
        deterministic jitter mixed from the request's own key — so a
        herd of failed-over requests de-synchronizes the same way
        every run (reproducible chaos)."""
        if n <= 1:
            return 0.0
        cfg = self.health
        base = min(cfg.backoff_max_s,
                   cfg.backoff_base_s * cfg.backoff_factor ** (n - 2))
        seed0 = int(meta.rng[0]) if meta.rng is not None else meta.fid
        frac = (((seed0 & 0xFFFFFFFF) * 0x9E3779B9
                 + n * 0x85EBCA6B) & 0xFFFF) / 65535.0
        return base * (1.0 + 0.5 * frac)

    def _fail_request(self, fid: int, err: FleetError) -> None:
        meta = self._requests.pop(fid, None)
        if meta is not None and meta.tokens:
            err.partial = {fid: list(meta.tokens)}
        self.failed[fid] = err
        self.failed_ids.add(fid)
        self.finished.add(fid)    # wakes pollers; pop_result raises
        self.requests_failed += 1

    def _drain_retries(self) -> None:
        """Resubmit every retry whose backoff has lapsed. Retries
        route over ALL RUNNING replicas — the circuit breaker is
        ignored here (a recovery must land somewhere; the breaker
        shapes new-traffic placement, not correctness). With zero
        RUNNING replicas: wait while any survivor could still recover
        or drain out (SUSPECT/DRAINING), else fail the request with
        `ReplicaUnavailable` — never hang `run()`."""
        now = self._clock()
        while self._retry and self._retry[0][0] <= now:
            ready, seq, fid = heapq.heappop(self._retry)
            meta = self._requests.get(fid)
            if meta is None:
                continue
            running = self._running()
            if not running:
                if any(r.state in (SUSPECT, DRAINING)
                       for r in self.replicas):
                    # A survivor may yet recover (or a drain finish):
                    # park the retry and re-check next step.
                    heapq.heappush(self._retry, (ready, seq, fid))
                    return
                self._fail_request(fid, ReplicaUnavailable(
                    f"fleet request {fid}: no RUNNING replica left to "
                    "recover onto (replacement disabled or exhausted)"))
                continue
            if self.disaggregated:
                # Recoveries re-enter through the prefill class: the
                # recompute replay IS a prefill, and the finished
                # frontier rides the ordinary handoff to decode. Only
                # when no prefill replica runs does a recovery land on
                # decode (a decode engine is a full colocated engine).
                pre = [r for r in running
                       if r.replica_class == "prefill"]
                running = pre or running
            self._resubmit(meta, running, ready, seq)

    def _choose(self, cands: List[_Replica], prompt: List[int],
                adapter_id: Optional[str]) -> _Replica:
        """Route, passing adapter_id only to routers that advertise
        adapter affinity (back-compat with custom routers)."""
        if adapter_id is not None and \
                getattr(self.router, "supports_adapter_affinity",
                        False):
            return self.router.choose(cands, prompt,
                                      adapter_id=adapter_id)
        return self.router.choose(cands, prompt)

    def _resubmit(self, meta: _FleetReq, cands: List[_Replica],
                  ready: float, seq: int) -> None:
        rep = self._choose(cands, meta.prompt, meta.adapter_id)
        ad_kw = ({} if meta.adapter_id is None
                 else {"adapter_id": meta.adapter_id})
        try:
            rid = rep.engine.submit(
                meta.prompt, meta.max_new_tokens,
                priority=meta.priority, rng=meta.rng,
                greedy=meta.greedy,
                resume_tokens=meta.tokens or None,
                **ad_kw)
        except (EngineDraining, EngineOverloaded):
            # Raced a drain/overload on the chosen replica: park the
            # retry one backoff-base further out, attempt unconsumed.
            heapq.heappush(self._retry,
                           (self._clock() + self.health.backoff_base_s,
                            seq, meta.fid))
            return
        meta.attempts += 1
        meta.recovering = False
        rep.rid_to_fid[rid] = meta.fid
        self._placement[meta.fid] = (rep, rid)
        rep.routed += 1
        self.retries += 1
        self._count("retries", 1)
        if self.trace.enabled:
            self.trace.instant(
                "failover", meta.fid,
                args={"replica": rep.name, "rid": rid,
                      "attempt": meta.attempts,
                      "resume_tokens": len(meta.tokens)})
        self._sweep_finished(rep)

    def _harvest_trace(self, rep: _Replica) -> None:
        """Keep a leaving replica's spans so dump_trace() still tells
        the whole story — bounded like the rings it collects from
        (oldest spans trimmed first)."""
        etr = getattr(rep.engine, "trace", None)
        if etr is None or not etr.enabled:
            return
        self._retired_trace.extend(etr.chrome_events(pid=rep.name))
        cap = 4 * getattr(etr, "capacity", 16384)
        if len(self._retired_trace) > cap:
            self._retired_trace = self._retired_trace[-cap:]

    # -- internals ---------------------------------------------------------

    def _sweep_finished(self, rep: _Replica) -> None:
        """Move the replica's finished engine requests into the fleet's
        finished set (popping them from the engine, so a drained
        replica ends truly empty)."""
        for rid in list(rep.engine.finished):
            fid = rep.rid_to_fid.pop(rid, None)
            if fid is None:
                continue
            shed = rid in rep.engine.shed_ids
            toks = rep.engine.pop_result(rid)
            meta = self._requests.pop(fid, None)
            if meta is not None and meta.attempts > 1:
                self.requests_recovered += 1
                self._count("requests_recovered", 1)
            self._done[fid] = toks
            self.finished.add(fid)
            self._placement.pop(fid, None)
            if shed:
                self.shed_ids.add(fid)
                self.requests_shed += 1

    def _retire_drained(self) -> None:
        """Remove DRAINING replicas that have fully flushed. The
        zero-loss invariant is checked here, not trusted: a replica
        may only leave with no queued work, no live rows, and no
        unswept results."""
        for rep in list(self.replicas):
            if rep.state != DRAINING:
                continue
            if rep.engine.pending() or rep.engine.finished or \
                    rep.rid_to_fid:
                continue    # still owes work or unswept results: kept
            self._harvest_trace(rep)
            self.replicas.remove(rep)
            self.replicas_removed += 1

    def _apply_scale(self, decision: int,
                     replica_class: Optional[str] = None) -> None:
        if decision > 0:
            self.add_replica(replica_class=replica_class)
        elif decision < 0:
            pool = self._running()
            if replica_class is not None:
                pool = [r for r in pool
                        if r.replica_class == replica_class]
            if len(pool) <= 1:
                return    # never drain the last live replica
            #             # (of its class, in a disaggregated fleet)
            # Drain the replica with the least outstanding work — the
            # cheapest flush, so capacity leaves the pool fastest.
            victim = min(
                pool,
                key=lambda r: (r.engine.pending_prefill_tokens()
                               + sum(x is not None
                                     for x in r.engine.row_req)))
            self.drain_replica(victim.name)

    # -- disaggregated prefill/decode handoff ------------------------------

    def _class_replicas(self, klass: str) -> List[_Replica]:
        return [r for r in self.replicas
                if r.replica_class == klass and r.state != RETIRED]

    def _tick_class_scalers(self) -> None:
        """One scale decision PER CLASS: the prefill scaler gates on
        TTFT p95 (admission latency — add prefill replicas when the
        first token lags), the decode scaler on TPOT p95 (steady-state
        decode latency — add decode replicas when streams stutter).
        Which signal each class uses is the config's choice
        (ttft_p95_slo_s / tpot_p95_slo_s); the split is what makes the
        two SLOs independently tunable."""
        for klass, scaler in (("prefill", self._prefill_scaler),
                              ("decode", self._decode_scaler)):
            if scaler is None:
                continue
            reps = self._class_replicas(klass)
            stats_list = [r.engine.stats() for r in reps]
            if klass == "prefill":
                # Prefill engines never emit tokens, so their engine
                # TTFT windows are empty forever: inject the fleet's
                # own submit->first-token tail (measured ACROSS the
                # handoff) so the scaler sees what users feel.
                t = self._ttft_agg.percentile(95.0)
                for s in stats_list:
                    s["ttft_s_p95"] = t
            n_running = sum(1 for r in reps if r.state == RUNNING)
            self._apply_scale(scaler.tick(stats_list, n_running),
                              replica_class=klass)

    def _process_handoffs(self) -> None:
        """Drain the handoff pipeline once per fleet step: re-place
        parked exports first (a decode replica may have appeared),
        then export every prefill-complete request and import it on a
        decode replica. DRAINING prefill replicas still export — the
        handoff IS their flush path; only condemned replicas are
        skipped (their work goes through ordinary failover)."""
        if self._handoff_parked:
            parked, self._handoff_parked = self._handoff_parked, []
            for fid in parked:
                self._place_handoff(fid)
        for rep in list(self.replicas):
            if rep.replica_class != "prefill" or \
                    rep.state in (UNHEALTHY, RETIRED):
                continue
            eng = rep.engine
            for rid in list(eng.handoff_ready()):
                fid = rep.rid_to_fid.get(rid)
                meta = self._requests.get(fid) \
                    if fid is not None else None
                if meta is None:
                    continue
                h = eng.export_request(rid)
                rep.rid_to_fid.pop(rid, None)
                self._placement.pop(fid, None)
                meta.handoff = h
                self.handoffs += 1
                self._count("handoffs", 1)
                if self.trace.enabled:
                    self.trace.instant(
                        "handoff", fid,
                        args={"from": rep.name,
                              "prompt_tokens": len(meta.prompt),
                              "resume_tokens": len(h["tokens"])})
                self._place_handoff(fid)

    def _place_handoff(self, fid: int) -> None:
        """Import one exported request on a decode-class replica. No
        importable replica right now -> the payload parks on the host
        (the KV lives in host tensors inside `meta.handoff`, safe
        across any replica's death) and is retried every step; the
        request only fails when the decode class is GONE."""
        meta = self._requests.get(fid)
        if meta is None or meta.handoff is None:
            return
        cands = [r for r in self._routable()
                 if r.replica_class == "decode"]
        if not cands:
            if any(r.replica_class == "decode"
                   and r.state in (RUNNING, SUSPECT, DRAINING)
                   for r in self.replicas):
                self._handoff_parked.append(fid)
                return
            self._fail_request(fid, ReplicaUnavailable(
                f"fleet request {fid}: no decode-class replica left "
                "to import the handoff onto"))
            return
        rep = self._choose(cands, meta.prompt, meta.adapter_id)
        try:
            rid = rep.engine.import_request(meta.handoff)
        except (EngineDraining, EngineOverloaded):
            self._handoff_parked.append(fid)
            return
        meta.handoff = None
        rep.rid_to_fid[rid] = fid
        self._placement[fid] = (rep, rid)
        rep.routed += 1
        if self.trace.enabled:
            self.trace.instant(
                "handoff_placed", fid,
                args={"replica": rep.name, "rid": rid})
        self._sweep_finished(rep)

    def handoff_requests(self) -> List[Dict[str, object]]:
        """One dict per request whose export is parked between replica
        classes — the state API's fleet-side `status="handoff"`
        source. Host-only."""
        out = []
        for fid in self._handoff_parked:
            meta = self._requests.get(fid)
            if meta is None or meta.handoff is None:
                continue
            out.append({
                "req_id": fid,
                "prompt_tokens": len(meta.prompt),
                "max_new_tokens": meta.max_new_tokens,
                "tokens_out": len(meta.handoff["tokens"]),
                "priority": meta.priority,
                "attempts": meta.attempts,
            })
        return out

    def adapter_miss_rate(self) -> float:
        """Fleet-wide adapter HBM-residency miss rate over the live
        pool counters (1 - hits/lookups; 0.0 before any lookup).
        Exposed as the `llm_fleet_adapter_miss_rate` gauge and usable
        directly as an autoscaling `custom_metric_source` — a decode
        class thrashing adapter slots wants MORE replicas (each added
        replica's pool spreads the working set), which plain occupancy
        and latency signals under-read."""
        lk = hit = 0.0
        for r in self.replicas:
            pool = getattr(r.engine, "adapter_pool", None)
            if pool is None:
                continue
            s = pool.stats()
            lk += s.get("adapter_lookups", 0.0)
            hit += s.get("adapter_hits", 0.0)
        return (1.0 - hit / lk) if lk else 0.0

    # -- telemetry ---------------------------------------------------------

    def recovering_requests(self) -> List[Dict[str, object]]:
        """One dict per request currently parked in the retry queue —
        the state API's `status="recovering"` source. Host-only."""
        out = []
        for ready, _seq, fid in sorted(self._retry):
            meta = self._requests.get(fid)
            if meta is None or not meta.recovering:
                continue
            out.append({
                "req_id": fid,
                "prompt_tokens": len(meta.prompt),
                "max_new_tokens": meta.max_new_tokens,
                "tokens_out": len(meta.tokens),
                "priority": meta.priority,
                "attempts": meta.attempts,
                "retry_ready_at": ready,
            })
        return out

    def replica_health(self) -> Dict[str, str]:
        """{replica name -> health/lifecycle state} for every pooled
        replica (the state API / status CLI health column)."""
        return {r.name: r.state for r in self.replicas}

    def dump_trace(self, path: Optional[str] = None) -> List[dict]:
        """One chrome://tracing JSON for the whole fleet: the fleet
        tracer's `route` spans (pid = fleet id, tid = fleet request
        lane) merged with every replica engine's lifecycle spans
        (pid = replica name, tid = replica-local request lane) plus
        spans harvested from replicas already drained or failed out of
        the pool. A route span's args carry the chosen replica and its
        replica-local rid, which is the join key between the two pid
        groups. Writes JSON to `path` when given; returns the event
        list (empty when nothing traced)."""
        events = list(self._retired_trace)
        for rep in self.replicas:
            etr = getattr(rep.engine, "trace", None)
            if etr is not None and etr.enabled:
                events.extend(etr.chrome_events(pid=rep.name))
        events.extend(self.trace.chrome_events(pid=self.fleet_id))
        events.sort(key=lambda e: e["ts"])
        if path:
            with open(path, "w") as f:
                json.dump(events, f)
        return events

    def stats(self) -> Dict[str, float]:
        """Flat fleet snapshot (gauge-friendly, like engine.stats()).
        Every field is also published as an `llm_fleet_<field>` gauge
        tagged with the fleet id through util.metrics."""
        running = self._running()
        draining = [r for r in self.replicas if r.state == DRAINING]
        suspect = [r for r in self.replicas if r.state == SUSPECT]
        now = self._clock()
        per = [r.engine.stats() for r in self.replicas]
        out: Dict[str, float] = {
            "replicas": float(len(self.replicas)),
            "replicas_running": float(len(running)),
            "replicas_draining": float(len(draining)),
            "replicas_suspect": float(len(suspect)),
            "replicas_removed": float(self.replicas_removed),
            "replicas_failed": float(self.replicas_failed),
            "breakers_open": float(sum(
                1 for r in self.replicas
                if now < r.breaker_open_until)),
            "requests_routed": float(self.requests_routed),
            "requests_shed": float(self.requests_shed),
            "requests_failed": float(self.requests_failed),
            "requests_recovered": float(self.requests_recovered),
            "retries": float(self.retries),
            "retry_queue_depth": float(len(self._retry)),
            "tokens_lost_to_drain": float(self.tokens_lost_to_drain),
            "tokens_lost_to_failure": float(
                self.tokens_lost_to_failure),
            "queue_depth": sum(s.get("queue_depth", 0.0) for s in per),
            "pending_prefill_tokens": sum(
                s.get("pending_prefill_tokens", 0.0) for s in per),
            "slot_occupancy_mean": (
                sum(s.get("slot_occupancy", 0.0) for s in per)
                / len(per)) if per else 0.0,
            "ttft_s_p95_max": max(
                (s.get("ttft_s_p95", 0.0) for s in per), default=0.0),
            "tpot_s_p95_max": max(
                (s.get("tpot_s_p95", 0.0) for s in per), default=0.0),
            # Tensor-parallel plane: a replica may itself be tp-sharded
            # (`DecodeEngine(tp=)`), and the fleet then scales in units
            # of whole meshes. Replicas are homogeneous in practice, so max ==
            # the fleet's tp; the per-replica view flows through each
            # engine's own llm_engine_* series.
            "tp_degree_max": max(
                (s.get("tp_degree", 1.0) for s in per), default=1.0),
            "host_transfer_bytes": sum(
                s.get("host_transfer_bytes", 0.0) for s in per),
            # Paged-KV plane: zero-copy sharing / preempt-and-swap
            # rollup (all-zero when replicas run the dense cache).
            "kv_blocks_shared": sum(
                s.get("kv_blocks_shared", 0.0) for s in per),
            "kv_block_cows": sum(
                s.get("kv_block_cows", 0.0) for s in per),
            "preemptions": sum(
                s.get("preemptions", 0.0) for s in per),
            "swap_in_bytes": sum(
                s.get("swap_in_bytes", 0.0) for s in per),
            "swap_out_bytes": sum(
                s.get("swap_out_bytes", 0.0) for s in per),
            "kv_free_blocks": sum(
                s.get("kv_free_blocks", 0.0) for s in per),
            "kv_used_fraction_mean": (
                sum(s.get("kv_used_fraction", 0.0) for s in per)
                / len(per)) if per else 0.0,
            # Quantized-KV plane: replicas are homogeneous in
            # practice, so the mean bytes/token IS the fleet's KV cost
            # per cached token; quant_replicas counts how many run a
            # low-bit pool (0 = dense fleet).
            "kv_quant_replicas": sum(
                s.get("kv_quant_enabled", 0.0) for s in per),
            "kv_bytes_per_token_mean": (
                sum(s.get("kv_bytes_per_token", 0.0) for s in per)
                / len(per)) if per else 0.0,
        }
        # Speculative plane (all-zero when no replica carries a draft
        # model). Rates are re-derived from the summed raw counters —
        # a proposal-weighted mean — so a busy replica's acceptance
        # dominates an idle one's instead of averaging per-replica
        # ratios.
        sp_prop = sum(s.get("spec_proposed", 0.0) for s in per)
        sp_acc = sum(s.get("spec_accepted", 0.0) for s in per)
        sp_rounds = sum(s.get("spec_rounds", 0.0) for s in per)
        out["spec_replicas"] = sum(
            s.get("spec_enabled", 0.0) for s in per)
        out["spec_dispatches"] = sum(
            s.get("spec_dispatches", 0.0) for s in per)
        out["spec_rounds"] = sp_rounds
        out["spec_proposed"] = sp_prop
        out["spec_accepted"] = sp_acc
        out["spec_acceptance_rate"] = (
            sp_acc / sp_prop if sp_prop else 0.0)
        out["spec_window_effective"] = (
            sp_prop / sp_rounds if sp_rounds else 0.0)
        out["spec_draft_tokens_wasted"] = sum(
            s.get("spec_draft_tokens_wasted", 0.0) for s in per)
        # Multi-LoRA plane (all-zero when no replica carries an
        # adapter pool). Hit rate re-derived from summed counters, like
        # the spec plane.
        ad_lk = sum(s.get("adapter_lookups", 0.0) for s in per)
        ad_hit = sum(s.get("adapter_hits", 0.0) for s in per)
        out["adapter_replicas"] = sum(
            s.get("adapter_enabled", 0.0) for s in per)
        out["adapters_registered"] = float(len(self._adapters))
        out["adapter_lookups"] = ad_lk
        out["adapter_hits"] = ad_hit
        out["adapter_hit_rate"] = ad_hit / ad_lk if ad_lk else 0.0
        out["adapter_prefetches"] = sum(
            s.get("adapter_prefetches", 0.0) for s in per)
        out["adapter_evictions"] = sum(
            s.get("adapter_evictions", 0.0) for s in per)
        out["adapter_prefetch_deferrals"] = sum(
            s.get("adapter_prefetch_deferrals", 0.0) for s in per)
        # Disaggregated prefill/decode plane (all-zero for colocated
        # fleets). `handoffs` counts fleet-level export->import moves;
        # the per-engine out/in counters and byte totals roll up so a
        # leak (out != in + parked) is visible from one snapshot.
        out["disaggregated"] = 1.0 if self.disaggregated else 0.0
        out["replicas_prefill"] = float(
            len(self._class_replicas("prefill")))
        out["replicas_decode"] = float(
            len(self._class_replicas("decode")))
        out["handoffs"] = float(self.handoffs)
        out["handoff_parked"] = float(len(self._handoff_parked))
        out["handoffs_out"] = sum(
            s.get("handoffs_out", 0.0) for s in per)
        out["handoffs_in"] = sum(
            s.get("handoffs_in", 0.0) for s in per)
        out["handoff_out_bytes"] = sum(
            s.get("handoff_out_bytes", 0.0) for s in per)
        out["handoff_in_bytes"] = sum(
            s.get("handoff_in_bytes", 0.0) for s in per)
        out["adapter_miss_rate"] = self.adapter_miss_rate()
        out["ttft_s_p95_fleet"] = self._ttft_agg.percentile(95.0)
        if self._prefill_scaler is not None:
            out["prefill_scale_ups"] = float(
                self._prefill_scaler.scale_ups)
            out["prefill_scale_downs"] = float(
                self._prefill_scaler.scale_downs)
        if self._decode_scaler is not None:
            out["decode_scale_ups"] = float(
                self._decode_scaler.scale_ups)
            out["decode_scale_downs"] = float(
                self._decode_scaler.scale_downs)
        out["router_affinity_wins"] = float(
            getattr(self.router, "affinity_wins", 0))
        out["router_adapter_wins"] = float(
            getattr(self.router, "adapter_wins", 0))
        out["router_pow2_wins"] = float(
            getattr(self.router, "pow2_wins", 0))
        if self.autoscaler is not None:
            out["scale_ups"] = float(self.autoscaler.scale_ups)
            out["scale_downs"] = float(self.autoscaler.scale_downs)
        self._publish(out)
        return out

    def _publish(self, stats: Dict[str, float]) -> None:
        for field, value in stats.items():
            name = f"llm_fleet_{field}"
            g = _fleet_gauges.get(name)
            if g is None:
                g = _fleet_gauges[name] = Gauge(
                    name, f"LLMFleet stats field {field!r}",
                    tag_keys=("fleet",))
            g.set(float(value), tags={"fleet": self.fleet_id})

    def _count(self, event: str, value: float) -> None:
        """Monotonic fault-plane counters (`llm_fleet_<event>_total`),
        incremented at event time — unlike the gauges, which republish
        whole snapshots on stats()."""
        name = f"llm_fleet_{event}_total"
        c = _fleet_counters.get(name)
        if c is None:
            c = _fleet_counters[name] = Counter(
                name, f"LLMFleet fault-tolerance event {event!r}",
                tag_keys=("fleet",))
        c.inc(float(value), tags={"fleet": self.fleet_id})
