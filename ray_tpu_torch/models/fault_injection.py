"""Seeded, deterministic fault injection for fleet replicas.

Own copy of `ray_tpu/models/fault_injection.py` (the port imports
nothing of the JAX package); it is host code over any engine with a
``step(horizon=None)`` method, so the same schedules drive the JAX and
the port fleets.

The fault-tolerance plane (`models/fleet.py`) is only as trustworthy as
the failures it was tested against, so failures are a first-class,
reproducible input here. `FaultInjector` wraps a replica engine's
`step()` (instance-attribute shadowing, nothing subclassed) and makes
it misbehave on cue:

- ``raise``   — one step raises `InjectedFault` (transient error);
- ``kill``    — every step from now on raises (a dead replica);
- ``stall``   — the step sleeps `stall_s` (or the action's own
  duration) then runs normally: the fleet watchdog sees a
  deadline/slow-step breach but no error. `sleep=` is injectable —
  tests pass a fake clock's ``advance`` so the stall is visible to the
  fleet's injected clock without real waiting;
- ``silent``  — the step returns ``{}`` WITHOUT running the engine at
  all for the next N calls: no error, no progress, the failure mode a
  heartbeat/progress probe exists to catch.

Faults come from a SCRIPT (``schedule={replica_name: [(step_idx,
action), ...]}`` — exact, for unit tests) or from a SEEDED random
process (``p_raise``/``p_stall``/``p_silent``/``p_kill`` per step,
with a per-replica stream derived from ``seed`` and the replica name
via crc32, so the fault sequence is independent of arming order and
reproducible across runs).

Zero cost when idle: an armed injector whose replica has no scripted
faults, no random rates and no sticky state takes a guarded fast path
that calls the original step and allocates nothing in this module, and
an engine that was never armed is untouched entirely.
"""

from __future__ import annotations

import random
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple, Union

__all__ = ["FaultInjector", "InjectedFault"]

Action = Union[str, Tuple[str, float], Tuple[str, int]]


class InjectedFault(RuntimeError):
    """The exception an injected ``raise``/``kill`` fault throws from a
    replica's `step()`. A distinct type so tests and the fleet's
    failure sweep can tell scripted chaos from organic bugs."""


class _ReplicaFaults:
    """Per-armed-replica injector state."""

    __slots__ = ("name", "step", "plan", "killed", "silent", "rng",
                 "active")

    def __init__(self, name: str, plan: List[Tuple[int, Action]],
                 rng: Optional[random.Random]):
        self.name = name
        self.step = 0               # calls seen (scripted step index)
        self.plan = sorted(plan)    # [(step_idx, action)], ascending
        self.killed = False         # sticky: every later step raises
        self.silent = 0             # remaining do-nothing steps
        self.rng = rng              # per-replica seeded stream, or None
        # Fast-path gate: False while nothing can ever fire for this
        # replica — the wrapped step() then runs the original with no
        # bookkeeping (and no allocations) at all.
        self.active = bool(plan) or rng is not None


class FaultInjector:
    """Deterministic `step()` saboteur for `DecodeEngine` replicas.

    Scripted: ``schedule`` maps replica name -> list of
    ``(step_idx, action)`` where action is ``"raise"``, ``"kill"``,
    ``"stall"`` / ``("stall", seconds)``, or ``"silent"`` /
    ``("silent", n_steps)``. Step indices count that replica's
    `step()` CALLS since arming, from 0.

    Seeded-random: pass ``seed`` and per-step probabilities; each
    armed replica draws from its own `random.Random` stream keyed by
    ``(seed, crc32(name))``. Both modes may be combined; the script
    fires first on its exact steps.

    ``arm(engine, name)`` wraps the engine in place and also accepts
    repeated calls for new replicas (the fleet arms every replica its
    factory builds, including mid-churn replacements). ``fired`` keeps
    the audit log: ``(replica, step_idx, action)`` per fault, in
    order — the chaos bench's ground truth for when the kill landed.
    """

    def __init__(self, *, seed: Optional[int] = None,
                 schedule: Optional[Dict[str, List[Tuple[int, Action]]]]
                 = None,
                 p_raise: float = 0.0, p_stall: float = 0.0,
                 p_silent: float = 0.0, p_kill: float = 0.0,
                 stall_s: float = 0.05, silent_steps: int = 2,
                 sleep: Callable[[float], None] = time.sleep):
        for nm, p in (("p_raise", p_raise), ("p_stall", p_stall),
                      ("p_silent", p_silent), ("p_kill", p_kill)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{nm} must be in [0, 1], got {p}")
        if stall_s < 0:
            raise ValueError("stall_s must be >= 0")
        if silent_steps < 1:
            raise ValueError("silent_steps must be >= 1")
        self.seed = seed
        self.schedule = dict(schedule or {})
        self.p_raise = p_raise
        self.p_stall = p_stall
        self.p_silent = p_silent
        self.p_kill = p_kill
        self.stall_s = stall_s
        self.silent_steps = silent_steps
        self._sleep = sleep
        self._random_on = (seed is not None and
                           (p_raise or p_stall or p_silent or p_kill))
        self.fired: List[Tuple[str, int, str]] = []
        self._states: Dict[str, _ReplicaFaults] = {}

    # -- arming ------------------------------------------------------------

    def arm(self, engine, name: Optional[str] = None) -> str:
        """Wrap ``engine.step`` with this injector's fault process for
        replica ``name`` (default: the engine's own id). Returns the
        name armed under. Re-arming the same name resumes its existing
        fault state (a replacement replica gets a FRESH name from the
        fleet, hence a fresh stream)."""
        name = name or getattr(engine, "engine_id", "engine")
        st = self._states.get(name)
        if st is None:
            rng = None
            if self._random_on:
                rng = random.Random(
                    (self.seed << 32) ^ zlib.crc32(name.encode()))
            st = _ReplicaFaults(name, list(self.schedule.get(name, [])),
                                rng)
            self._states[name] = st
        orig = engine.step

        def step(horizon=None):
            if not st.active:
                return orig(horizon)
            return self._faulty_step(st, orig, horizon)

        engine.step = step
        return name

    # -- the fault process -------------------------------------------------

    def _decide(self, st: _ReplicaFaults) -> Optional[Action]:
        """The action for this step of this replica, or None. Consumes
        one script entry / one rng draw per call — the source of the
        determinism guarantee."""
        idx = st.step
        st.step = idx + 1
        if st.killed:
            return "kill"
        if st.silent > 0:
            return "silent_cont"
        while st.plan and st.plan[0][0] < idx:
            st.plan.pop(0)       # missed entries (engine idled) lapse
        if st.plan and st.plan[0][0] == idx:
            return st.plan.pop(0)[1]
        if st.rng is not None:
            r = st.rng.random()
            if r < self.p_kill:
                return "kill"
            r -= self.p_kill
            if r < self.p_raise:
                return "raise"
            r -= self.p_raise
            if r < self.p_stall:
                return "stall"
            r -= self.p_stall
            if r < self.p_silent:
                return "silent"
        return None

    def _faulty_step(self, st: _ReplicaFaults, orig, horizon):
        act = self._decide(st)
        if act is None:
            return orig(horizon)
        kind = act if isinstance(act, str) else act[0]
        if kind == "silent_cont":
            st.silent -= 1
            return {}
        self.fired.append((st.name, st.step - 1, kind))
        if kind == "kill":
            st.killed = True
            raise InjectedFault(
                f"replica {st.name} killed at step {st.step - 1}")
        if kind == "raise":
            raise InjectedFault(
                f"replica {st.name} injected error at step "
                f"{st.step - 1}")
        if kind == "stall":
            dur = act[1] if isinstance(act, tuple) else self.stall_s
            self._sleep(dur)
            return orig(horizon)
        if kind == "silent":
            n = act[1] if isinstance(act, tuple) else self.silent_steps
            st.silent = n - 1    # this call is the first silent step
            return {}
        raise ValueError(f"unknown fault action {act!r}")
