"""Serving state API: live introspection over the port's engines and
fleets.

Own copy of `ray_tpu/util/state/serving.py` (the port imports nothing of
the JAX package). `DecodeEngine` and `LLMFleet` (and a server, once
`serve/llm.py` is ported) register themselves WEAKLY at construction,
and the query functions snapshot plain dicts from their live host-side
bookkeeping: scheduler queue, slot table, chunked-prefill frontiers,
swap ledger, block-pool refcounts, prefix-trie occupancy.

Snapshots are read-only by construction: nothing here calls `step()`,
touches a trie's LRU recency, publishes a gauge, or launches a device
operation. Registration is a `WeakValueDictionary`, so an engine that
goes out of scope disappears from the listings without an unregister
call.

Request phases (`list_requests(status=...)`):

- ``queued``      in the scheduler, no slot yet
- ``prefilling``  bound to a row whose prompt suffix is still being
                  written (chunked prefill frontier mid-prompt)
- ``decoding``    bound to a live row with final logits (emitting)
- ``swapped``     preempted out of the pool, spilled state waiting to
                  swap back in (the request is also re-queued; the
                  swap ledger takes precedence here)
- ``handoff``     moving between replica classes in a disaggregated
                  fleet: parked on a prefill-class engine for export,
                  parked host-side on the fleet (no decode replica
                  could import yet: ``engine_id`` is None), or imported
                  on a decode-class engine and awaiting its decode
                  admission. Handoff WINS over ``swapped``: an imported
                  request also sits in the importer's swap ledger, and
                  counting it twice would double the in-flight census
- ``recovering``  parked in a fleet's retry queue after its replica
                  failed, waiting out its backoff before resubmission
                  (these rows live on the FLEET: ``engine_id`` is None)
- ``draining``    not a phase but a FILTER: any request, in any phase,
                  living on an engine that has begun draining
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "register_engine", "register_fleet", "register_server",
    "engines", "fleets", "servers", "reset_serving_state",
    "engine_state", "engine_requests",
    "list_engines", "list_requests", "list_kv_pools",
    "summarize_fleet",
]

_lock = threading.Lock()
_seq = itertools.count()
_engines: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()
_fleets: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()
_servers: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()


def _register(table, obj) -> None:
    with _lock:
        table[next(_seq)] = obj


def register_engine(engine) -> None:
    """Called by DecodeEngine.__init__; weak, so the engine needs no
    lifecycle hook."""
    _register(_engines, engine)


def register_fleet(fleet) -> None:
    _register(_fleets, fleet)


def register_server(server) -> None:
    _register(_servers, server)


def _live(table) -> List[Any]:
    with _lock:
        return [obj for _, obj in sorted(table.items())]


def engines() -> List[Any]:
    """Live registered DecodeEngines, registration order."""
    return _live(_engines)


def fleets() -> List[Any]:
    return _live(_fleets)


def servers() -> List[Any]:
    return _live(_servers)


def reset_serving_state() -> None:
    """Drop every registration (test isolation helper — live objects
    keep working, they just stop being listed)."""
    with _lock:
        _engines.clear()
        _fleets.clear()
        _servers.clear()


# ---------------------------------------------------------------------------
# Per-engine snapshots
# ---------------------------------------------------------------------------

def _fleet_of(engine) -> Dict[str, Optional[str]]:
    """(fleet_id, replica name, health state) owning `engine`, by
    identity walk over registered fleets — engines carry no
    back-pointer on purpose (the models layer stays fleet-blind).
    `health` is the fleet's replica lifecycle state (RUNNING /
    SUSPECT / DRAINING / ...); a loose engine reports None."""
    for fleet in fleets():
        for rep in getattr(fleet, "replicas", []):
            if rep.engine is engine:
                return {"fleet": fleet.fleet_id, "replica": rep.name,
                        "health": rep.state,
                        "replica_class": getattr(
                            rep, "replica_class", None)}
    return {"fleet": None, "replica": None, "health": None,
            "replica_class": None}


def engine_state(engine) -> Dict[str, Any]:
    """One engine's row: identity, topology, and the instantaneous
    occupancy/queue/KV numbers the status CLI draws bars from. Pure
    host reads — no step, no device sync, no gauge writes."""
    live = sum(r is not None for r in engine.row_req)
    row = {
        "engine_id": engine.engine_id,
        "batch_slots": engine.B,
        "max_len": engine.max_len,
        "tp_degree": engine.tp_degree,
        "paged": bool(engine.paged),
        "draining": bool(engine.draining),
        "scheduler": type(engine.scheduler).__name__,
        "queue_depth": len(engine.scheduler),
        "live_slots": live,
        "slot_occupancy": live / engine.B,
        "prefilling_rows": len(engine._row_prefill),
        "kv_used_fraction": engine.kv_used_fraction(),
        "kv_free_blocks": engine.kv_free_blocks(),
        "pending_prefill_tokens": engine.pending_prefill_tokens(),
        "requests_swapped": len(engine._swapped) if engine.paged else 0,
        "pipeline_inflight": len(engine._ring),
        "tokens_out": engine.tokens_out,
        "uptime_s": max(0.0, engine._clock() - engine._start_t),
        "steps_total": engine.steps_total,
        # Speculative plane (host counters; all-zero without a draft).
        "spec_enabled": bool(engine.spec_enabled),
        "spec_window": engine.spec_window if engine.spec_enabled else 0,
        "spec_dispatches": engine.spec_dispatches,
        "spec_acceptance_rate": (
            engine.spec_accepted / engine.spec_proposed
            if engine.spec_proposed else 0.0),
    }
    row.update(_fleet_of(engine))
    return row


def _req_row(engine, req, status: str, *, row: Optional[int] = None,
             prefill_pos: Optional[int] = None,
             now: Optional[float] = None) -> Dict[str, Any]:
    entry = {
        "req_id": req.req_id,
        "engine_id": engine.engine_id,
        "status": status,
        "row": row,
        "prompt_tokens": len(req.prompt),
        "max_new_tokens": req.max_new_tokens,
        "tokens_out": len(req.tokens),
        "priority": req.priority,
        "deadline": req.deadline,
        "resume": bool(req.resume),
        "engine_draining": bool(engine.draining),
    }
    if prefill_pos is not None:
        entry["prefill_pos"] = prefill_pos
    # Age rides on EngineMetrics' per-request submit timestamp when the
    # engine keeps one (enable_metrics=False engines report None).
    times = getattr(engine.metrics, "_req", {}).get(req.req_id)
    if times is not None and now is not None:
        entry["age_s"] = max(0.0, now - times.submit_t)
    else:
        entry["age_s"] = None
    return entry


def engine_requests(engine) -> List[Dict[str, Any]]:
    """Every in-flight request on one engine, classified exactly the
    way the engine's own bookkeeping classifies it: the swap ledger
    first (a preempted request is also re-queued — `swapped` wins),
    then prefill frontiers, live decode rows, and the scheduler queue.
    Finished/popped requests are not state; read `results`/`finished`
    for those."""
    now = engine._clock()
    rows: List[Dict[str, Any]] = []
    swapped_ids = set(engine._swapped) if engine.paged else set()
    prefill_only = bool(getattr(engine, "prefill_only", False))
    for b, st in engine._row_prefill.items():
        rows.append(_req_row(engine, st.req, "prefilling", row=b,
                             prefill_pos=st.pos, now=now))
    for b, req in enumerate(engine.row_req):
        if req is not None and b not in engine._row_prefill:
            # A prefill-class engine never decodes: a bound row past
            # its prefill frontier is PARKED for export, not emitting.
            status = "handoff" if prefill_only else "decoding"
            rows.append(_req_row(engine, req, status, row=b,
                                 now=now))
    for entry in engine.scheduler.queued_state():
        req = entry.get("request")
        if req is None:
            # Custom policy exposing ids only: a thin queued row.
            rows.append({"req_id": entry["req_id"],
                         "engine_id": engine.engine_id,
                         "status": "queued", "row": None,
                         "age_s": None,
                         "engine_draining": bool(engine.draining)})
            continue
        # An imported handoff waiting for decode admission also sits
        # in the swap ledger (its KV pre-seed) — "handoff" wins so the
        # request is counted exactly once, in its true phase.
        if getattr(req, "handoff", False):
            status = "handoff"
        elif req.req_id in swapped_ids:
            status = "swapped"
        else:
            status = "queued"
        row = _req_row(engine, req, status, now=now)
        if req.req_id in swapped_ids:
            swap = engine._swapped[req.req_id]
            row["swap_blocks"] = swap.n_blocks
            row["swap_resident"] = swap.host is not None
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Query functions
# ---------------------------------------------------------------------------

REQUEST_STATUSES = ("queued", "prefilling", "decoding", "swapped",
                    "handoff", "recovering", "draining")


def list_engines(limit: int = 1000) -> List[Dict[str, Any]]:
    """One row per live registered engine (see `engine_state`)."""
    return [engine_state(e) for e in engines()[:limit]]


def list_requests(status: Optional[str] = None,
                  engine_id: Optional[str] = None,
                  limit: int = 1000) -> List[Dict[str, Any]]:
    """Every in-flight request across registered engines.

    ``status`` filters to one phase (queued / prefilling / decoding /
    swapped / handoff / recovering) or to ``draining`` — all requests,
    any phase, on engines that have begun draining. ``engine_id``
    restricts to one engine (``recovering`` rows and host-parked
    ``handoff`` rows belong to a FLEET, not an engine, so an engine_id
    filter excludes them)."""
    if status is not None and status not in REQUEST_STATUSES:
        raise ValueError(
            f"unknown status {status!r} "
            f"(expected one of {'|'.join(REQUEST_STATUSES)})")
    rows: List[Dict[str, Any]] = []
    for eng in engines():
        if engine_id is not None and eng.engine_id != engine_id:
            continue
        rows.extend(engine_requests(eng))
    if engine_id is None:
        # Failed-over requests waiting out their retry backoff are
        # fleet-side state (no engine holds them yet).
        for fleet in fleets():
            for r in fleet.recovering_requests():
                rows.append({**r, "engine_id": None,
                             "status": "recovering", "row": None,
                             "fleet": fleet.fleet_id,
                             "age_s": None,
                             "engine_draining": False})
            # Exports parked between replica classes (disaggregated
            # fleets only): host-side payloads no engine holds yet.
            for r in getattr(fleet, "handoff_requests", list)():
                rows.append({**r, "engine_id": None,
                             "status": "handoff", "row": None,
                             "fleet": fleet.fleet_id,
                             "age_s": None,
                             "engine_draining": False})
    if status == "draining":
        rows = [r for r in rows if r["engine_draining"]]
    elif status is not None:
        rows = [r for r in rows if r["status"] == status]
    return rows[:limit]


def list_kv_pools(limit: int = 1000) -> List[Dict[str, Any]]:
    """One row per engine that owns KV block storage: the paged
    engine's unified pool (refcount ledger included) or the dense
    engine's prefix-cache pool. Engines with neither are omitted."""
    rows: List[Dict[str, Any]] = []
    for eng in engines():
        pool = eng.kv_pool
        prefix = eng._prefix
        if pool is None and prefix is None:
            continue
        row: Dict[str, Any] = {
            "engine_id": eng.engine_id,
            "kind": "paged" if pool is not None else "prefix",
            "block_tokens": eng.prefix_block,
            # Quantized-KV plane: storage dtype (None = dense kv_dtype)
            # and the byte cost one block/token actually pays, scale
            # slab included. getattr defaults keep pre-quant engine
            # objects (or test doubles) listable.
            "quant": getattr(eng, "kv_quant", None),
            "bytes_per_block": float(
                getattr(eng, "kv_bytes_per_block", 0.0)),
            "bytes_per_token": float(
                getattr(eng, "kv_bytes_per_token", 0.0)),
        }
        if pool is not None:
            row.update(pool.snapshot())
            row["occupancy"] = (pool.blocks_in_use / pool.blocks_total
                                if pool.blocks_total else 0.0)
        if prefix is not None:
            row["prefix_blocks_in_use"] = prefix.blocks_in_use
            row["prefix_blocks_total"] = prefix.blocks_total
            row["evictable_blocks"] = prefix.evictable_blocks()
            if pool is None:
                row["blocks_total"] = prefix.blocks_total
                row["blocks_in_use"] = prefix.blocks_in_use
                row["occupancy"] = (
                    prefix.blocks_in_use / prefix.blocks_total
                    if prefix.blocks_total else 0.0)
        rows.append(row)
    return rows[:limit]


def _phase_counts(rows: List[Dict[str, Any]]) -> Dict[str, int]:
    counts = {s: 0 for s in REQUEST_STATUSES if s != "draining"}
    for r in rows:
        counts[r["status"]] = counts.get(r["status"], 0) + 1
    return counts


def _health_counts(fleet) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for state in fleet.replica_health().values():
        counts[state] = counts.get(state, 0) + 1
    return counts


def summarize_fleet() -> Dict[str, Any]:
    """`ray status`-shaped rollup: one block per registered fleet plus
    totals over every registered engine (fleet members and loose
    engines alike). Built from the same read-only snapshots as the
    list_* calls — unlike `LLMFleet.stats()` it publishes NO gauges,
    so polling it cannot perturb the metric plane."""
    engine_rows = list_engines()
    request_rows = list_requests()
    by_engine: Dict[str, List[Dict[str, Any]]] = {}
    for r in request_rows:
        by_engine.setdefault(r["engine_id"], []).append(r)

    fleet_blocks: List[Dict[str, Any]] = []
    for fleet in fleets():
        members = [r for r in engine_rows
                   if r["fleet"] == fleet.fleet_id]
        member_reqs = [rr for r in members
                       for rr in by_engine.get(r["engine_id"], [])]
        running = sum(1 for r in members if not r["draining"])
        fleet_blocks.append({
            "fleet_id": fleet.fleet_id,
            "router": type(fleet.router).__name__,
            "replicas": len(members),
            "replicas_running": running,
            "replicas_draining": len(members) - running,
            "autoscaling": fleet.autoscaler is not None,
            "tp_degree_max": max(
                (r["tp_degree"] for r in members), default=1),
            "queue_depth": sum(r["queue_depth"] for r in members),
            "slot_occupancy_mean": (
                sum(r["slot_occupancy"] for r in members) / len(members)
                if members else 0.0),
            "kv_used_fraction_mean": (
                sum(r["kv_used_fraction"] for r in members)
                / len(members) if members else 0.0),
            "requests_routed": fleet.requests_routed,
            "requests_shed": fleet.requests_shed,
            "requests": _phase_counts(member_reqs),
            # Fault-tolerance plane: replica health census + recovery
            # counters (all host-side reads, like everything here).
            "health": _health_counts(fleet),
            "replicas_failed": fleet.replicas_failed,
            "requests_recovering": len(fleet.recovering_requests()),
            "requests_recovered": fleet.requests_recovered,
            "requests_failed": fleet.requests_failed,
            "retries": fleet.retries,
            "tokens_lost_to_failure": fleet.tokens_lost_to_failure,
            # Disaggregated plane (zeros for colocated fleets).
            "disaggregated": bool(
                getattr(fleet, "disaggregated", False)),
            "replicas_prefill": sum(
                1 for r in members
                if r.get("replica_class") == "prefill"),
            "replicas_decode": sum(
                1 for r in members
                if r.get("replica_class") == "decode"),
            "handoffs": int(getattr(fleet, "handoffs", 0)),
        })

    attached = {r["engine_id"] for r in engine_rows
                if r["fleet"] is not None}
    return {
        "fleets": fleet_blocks,
        "engines_total": len(engine_rows),
        "engines_unattached": len(engine_rows) - len(attached),
        "requests": _phase_counts(request_rows),
        "requests_inflight": len(request_rows),
    }
