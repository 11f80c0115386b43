"""PyTorch port, fleet fault tolerance: the health state machine, the
fault injector and deterministic failover.

Mirrors tests/test_fleet_faults.py. The health machine (watchdog, slow
and silent probes, the step-error threshold, the circuit breaker) runs on
duck-typed stub engines over a fake clock, once under the JAX package's
`LLMFleet` and once under the port's, with the same script: the replica
health after every step, the replicas condemned, halted and replaced,
and the routing are equal. A replica killed mid-churn by `FaultInjector`
fails its work over: on real nano engines (dense and paged) the port
fleet's tokens, errors, retries and recovery counters equal the JAX
fleet's, greedy tokens equal the fault-free run, and sampled requests
with pinned keys equal the port's own solo `generate`. The injector copy
fires the same faults as the original on the same schedules.
"""

import faulthandler

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_port_helpers import (FakeClock, drive_fleet, fleet_factory,
                                numpy_params)

from ray_tpu.models import engine as jengine
from ray_tpu.models import fault_injection as jfault
from ray_tpu.models import fleet as jfleet
from ray_tpu.models import llama as jllama
from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import fault_injection as tfault
from ray_tpu_torch.models import fleet as tfleet
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.util.state import serving as tserving

TCFG = tllama.LlamaConfig.nano()
PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2], [3, 1, 4, 1, 5, 9]]
CHURN = PROMPTS + [[11, 13], [2, 7, 1, 8], [8, 3], [6, 6, 6]]
KEYS = [np.array([40 + i, 0], np.uint32) for i in range(len(PROMPTS))]
TOP_K = {"greedy": False, "temperature": 0.9, "top_k": 8}
COMBOS = {"dense": {}, "paged": {"paged": True, "kv_block_tokens": 4}}
PKGS = {"jax": (jfleet, jfault), "port": (tfleet, tfault)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.LlamaConfig.nano()
    tree = numpy_params(jcfg, seed=0)
    return {"jax": (jengine.DecodeEngine,
                    jax.tree_util.tree_map(jnp.asarray, tree), jcfg),
            "port": (DecodeEngine,
                     params_from_numpy(tree, TCFG, device="cpu"), TCFG)}


# ---------------------------------------------------------------------------
# Health state machine on stub engines + a fake clock
# ---------------------------------------------------------------------------

class StubEngine:
    """Duck-typed replica: `step()` advances the shared clock by
    ``step_time`` (what the watchdog and slow probes measure) and counts
    a step unless wedged (what the silent probe measures)."""

    def __init__(self, name, clock, fault_cls, step_time=0.0):
        self.engine_id = name
        self.clock = clock
        self.fault_cls = fault_cls
        self.step_time = step_time
        self.wedged = False
        self.fail_steps = 0
        self.steps_total = 0
        self.halted = False
        self.draining = False
        self.finished = set()
        self.shed_ids = set()
        self.results = {}
        self.scheduler = []
        self.row_req = [None, None]
        self._next_rid = 0

    def pending(self):
        return not self.halted

    def step(self, horizon=None):
        if self.fail_steps > 0:
            self.fail_steps -= 1
            raise self.fault_cls(f"{self.engine_id}: scripted step error")
        self.clock.advance(self.step_time)
        if not self.wedged:
            self.steps_total += 1
        return {}

    def submit(self, prompt, max_new_tokens=32, priority=0, rng=None,
               deadline_s=None, greedy=None, resume_tokens=None):
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def pop_result(self, rid):
        raise KeyError(rid)

    def stats(self):
        return {}

    def pending_prefill_tokens(self):
        return 0

    def prefix_match_tokens(self, prompt, peek=True):
        return 0

    def halt(self):
        self.halted = True

    def begin_drain(self):
        self.draining = True


HEALTH = {
    "watchdog": dict(step_deadline_s=1.0, unhealthy_after_timeouts=2),
    "slow": dict(slow_step_s=0.5, suspect_after_slow=2, recover_after=2),
    "silent": dict(suspect_after_silent=2, unhealthy_after_silent=4),
    "error_fast": {},
    "error_threshold": dict(max_step_failures=2, recover_after=1),
    "breaker": dict(slow_step_s=0.5, suspect_after_slow=1, recover_after=1,
                    breaker_trips=2, breaker_window_s=100.0,
                    breaker_cooldown_s=5.0),
}


def _health_script(pkg, case):
    """tests/test_fleet_faults.py's stub scenario ``case`` under
    ``pkg``'s fleet: what the fleet and its stubs did, step by step."""
    fmod, fault = PKGS[pkg]
    clock = FakeClock()
    built = []
    step_time = {"watchdog": 2.0, "slow": 0.6}.get(case, 0.0)

    def factory(name):
        eng = StubEngine(name, clock, fault.InjectedFault, step_time)
        built.append(eng)
        return eng

    fleet = fmod.LLMFleet(factory, router="round_robin", clock=clock,
                          health=fmod.FleetHealthConfig(**HEALTH[case]),
                          initial_replicas=2 if case == "breaker" else 1,
                          fleet_id=f"h-{case}")
    log = []

    def step(n=1):
        for _ in range(n):
            fleet.step()
            log.append((fleet.replica_health(), fleet.replicas_failed,
                        [e.halted for e in built]))

    if case == "watchdog":
        step(2)
    elif case == "slow":
        step(2)
        built[0].step_time = 0.0
        step(2)
    elif case == "silent":
        built[0].wedged = True
        step(4)
    elif case == "error_fast":
        built[0].fail_steps = 1
        step(1)
    elif case == "error_threshold":
        built[0].fail_steps = 1
        step(2)
        built[0].fail_steps = 1
        step(1)
    else:
        flapper, steady = built
        for _ in range(2):
            flapper.step_time = 0.6
            step(1)
            flapper.step_time = 0.0
            step(1)
        log.append(fleet.stats()["breakers_open"])
        for _ in range(3):
            fleet.submit([1, 2, 3], 4)
        log.append((flapper._next_rid, steady._next_rid))
        clock.advance(5.1)
        log.append(fleet.stats()["breakers_open"])
        fleet.submit([1, 2, 3], 4)
        fleet.submit([1, 2, 3], 4)
        log.append((flapper._next_rid, steady._next_rid))
    return log, fleet.stats()


@pytest.mark.parametrize("case", ["watchdog", "slow", "silent", "error_fast",
                                  "error_threshold", "breaker"])
def test_health_machine_matches_jax(case):
    """The same stub script walks both fleets through the same health
    states, condemnations, halts, replacements and routing."""
    j_log, j_stats = _health_script("jax", case)
    t_log, t_stats = _health_script("port", case)
    assert t_log == j_log
    assert t_stats == j_stats
    states = {s for entry in t_log if isinstance(entry, tuple)
              and isinstance(entry[0], dict) for s in entry[0].values()}
    if case in ("watchdog", "silent", "error_fast", "error_threshold"):
        assert t_stats["replicas_failed"] == 1.0
    else:
        assert tfleet.SUSPECT in states or case == "breaker"
        assert t_stats["replicas_failed"] == 0.0


def test_retry_backoff_matches_jax():
    """Retry n's backoff (immediate first failover, exponential after,
    capped, jittered from the request's own key) is the same number in
    both packages."""
    out = []
    for pkg in ("jax", "port"):
        fmod, fault = PKGS[pkg]
        clock = FakeClock()
        fleet = fmod.LLMFleet(
            lambda n: StubEngine(n, clock, fault.InjectedFault),
            initial_replicas=1, clock=clock, fleet_id="bk",
            health=fmod.FleetHealthConfig(backoff_base_s=0.02,
                                          backoff_factor=2.0,
                                          backoff_max_s=0.1))
        meta = fleet._requests[fleet.submit([1, 2, 3], 4)]
        out.append([fleet._backoff_delay(meta, n) for n in range(1, 10)])
    assert out[1] == out[0]
    assert out[1][0] == 0.0 and max(out[1]) <= 0.15


# ---------------------------------------------------------------------------
# The injector copy
# ---------------------------------------------------------------------------

class _Counter:
    def __init__(self):
        self.calls = 0

    def step(self, horizon=None):
        self.calls += 1
        return {"ok": self.calls}


@pytest.mark.parametrize("mode", ["scripted", "seeded"])
def test_fault_injector_copy_matches_original(mode):
    """Both injectors fire the same faults, at the same steps, with the
    same outcomes, on the same schedule or seed."""
    kw = ({"schedule": {"a": [(1, "raise"), (3, ("silent", 2)),
                              (6, ("stall", 0.5)), (8, "kill")],
                        "b": [(0, "stall")]}}
          if mode == "scripted" else
          {"seed": 11, "p_raise": 0.2, "p_stall": 0.2, "p_silent": 0.1,
           "p_kill": 0.02})
    logs = []
    for fault in (jfault, tfault):
        slept = []
        inj = fault.FaultInjector(sleep=slept.append, **kw)
        engines = {n: _Counter() for n in ("a", "b")}
        for n, e in engines.items():
            inj.arm(e, n)
        log = []
        for _ in range(12):
            for n, e in engines.items():
                try:
                    log.append((n, e.step()))
                except fault.InjectedFault as exc:
                    log.append((n, str(exc)))
        logs.append((log, inj.fired, slept))
    assert logs[1] == logs[0]
    assert logs[1][1]


def test_fault_injector_idle_is_the_original_step():
    """An armed replica with nothing scheduled runs its original step
    (the fast path), and an unarmed engine is untouched."""
    inj = tfault.FaultInjector(schedule={"other": [(0, "kill")]})
    e, plain = _Counter(), _Counter()
    orig = plain.step
    inj.arm(e, "idle")
    assert [e.step() for _ in range(3)] == [{"ok": 1}, {"ok": 2},
                                            {"ok": 3}]
    assert plain.step == orig and not inj.fired


# ---------------------------------------------------------------------------
# Failover on real engines, against the JAX fleet
# ---------------------------------------------------------------------------

def _failover(weights, pkg, case, mode="greedy"):
    eng_cls, params, cfg = weights[pkg]
    fmod, fault = PKGS[pkg]
    kw = dict(TOP_K if mode == "top_k" else {}, decode_horizon=4)
    prompts, budget, n_rep = CHURN, 12, 2
    health = fmod.FleetHealthConfig()
    if case in COMBOS:
        kw.update(COMBOS[case])
    elif case == "exhausted":
        prompts, budget = PROMPTS, 8
        health = fmod.FleetHealthConfig(max_retries=0, replace_failed=False)
    else:                                   # no survivors
        prompts, budget, n_rep = PROMPTS[:1], 8, 1
        health = fmod.FleetHealthConfig(replace_failed=False)
    fid_ = f"ff-{case}-{mode}"
    inj = fault.FaultInjector(schedule={f"{fid_}-r0": [(1, "kill")]})
    fleet = fmod.LLMFleet(fleet_factory(eng_cls, params, cfg, **kw),
                          initial_replicas=n_rep, router="round_robin",
                          fleet_id=fid_, fault_injector=inj, health=health)
    keys = KEYS if mode == "top_k" else [None] * len(prompts)
    fids = [fleet.submit(p, budget, rng=k) for p, k in zip(prompts, keys)]
    steps, health_log = drive_fleet(fleet)
    try:
        out, err = fleet.run(), None
    except fmod.FleetError as exc:
        out, err = exc.partial, (type(exc).__name__, sorted(exc.failed),
                                 sorted(type(e).__name__
                                        for e in exc.failed.values()))
    st = fleet.stats()
    return {"fids": fids, "fired": inj.fired, "steps": steps,
            "health": health_log, "err": err,
            "tokens": {f: out[f] for f in sorted(out)},
            "stats": {k: st[k] for k in (
                "replicas_failed", "replicas_running", "requests_recovered",
                "requests_failed", "retries", "tokens_lost_to_failure")},
            "budget": budget, "prompts": prompts, "keys": keys}


@pytest.fixture(scope="module")
def failovers(weights):
    cache = {}

    def get(pkg, case, mode="greedy"):
        key = (pkg, case, mode)
        if key not in cache:
            cache[key] = _failover(weights, pkg, case, mode)
        return cache[key]
    return get


@pytest.mark.parametrize("case", ["dense", "paged", "exhausted",
                                  "no_survivors"])
def test_failover_matches_jax(failovers, case):
    """Kill one replica at its second step: the port fleet's emissions,
    health, final tokens, typed errors and recovery counters equal the
    JAX fleet's, nothing is lost, and the dead replica is replaced (or,
    with replacement off, its requests fail with a typed error)."""
    j = failovers("jax", case)
    t = failovers("port", case)
    for key in ("fids", "fired", "steps", "health", "err", "tokens",
                "stats"):
        assert t[key] == j[key], key
    assert t["fired"] == [(f"ff-{case}-greedy-r0", 1, "kill")]
    assert t["stats"]["tokens_lost_to_failure"] == 0.0
    if case in COMBOS:
        assert t["err"] is None
        assert t["stats"]["requests_recovered"] >= 1.0
        assert t["stats"]["replicas_running"] == 2.0
        assert all(len(v) == t["budget"] for v in t["tokens"].values())
    elif case == "exhausted":
        # round-robin placement: fids 0 and 2 were on the killed replica
        assert t["err"] == ("RetriesExhausted", [0, 2],
                            ["RetriesExhausted"] * 2)
        assert sorted(t["tokens"]) == [1, 3]
    else:
        assert t["err"] == ("ReplicaUnavailable", [0],
                            ["ReplicaUnavailable"])


@pytest.mark.parametrize("combo", ["dense", "paged"])
def test_failover_greedy_equals_fault_free(weights, failovers, combo):
    """The failed-over greedy streams equal a fault-free port fleet's
    and solo `generate`'s."""
    eng_cls, params, cfg = weights["port"]
    fleet = tfleet.LLMFleet(
        fleet_factory(eng_cls, params, cfg, decode_horizon=4,
                      **COMBOS[combo]),
        initial_replicas=2, router="round_robin", fleet_id="base")
    fids = [fleet.submit(p, 12) for p in CHURN]
    base = fleet.run()
    chaos = failovers("port", combo)["tokens"]
    assert [chaos[f] for f in fids] == [base[f] for f in fids]
    for f, p in zip(fids, CHURN):
        solo = tgen.generate(params, torch.tensor([p]), TCFG,
                             max_new_tokens=12)[0, len(p):].tolist()
        assert chaos[f] == solo


@pytest.mark.parametrize("combo", ["dense", "paged"])
def test_failover_sampled_matches_port_solo(weights, failovers, combo):
    """Sampled requests with caller-pinned keys, failed over mid-stream,
    still equal the port's solo `generate` under those keys."""
    t = failovers("port", combo, "top_k")
    assert t["fired"] and t["stats"]["requests_recovered"] >= 1.0
    params = weights["port"][1]
    for f, p, k in zip(t["fids"], t["prompts"], t["keys"]):
        solo = tgen.generate(params, torch.tensor([p]), TCFG,
                             max_new_tokens=t["budget"], rng=k,
                             **TOP_K)[0, len(p):].tolist()
        assert t["tokens"][f] == solo


def test_streaming_is_gapless_across_failover(weights):
    """Tokens streamed by step() before the kill plus everything after
    concatenate to exactly each final result."""
    eng_cls, params, cfg = weights["port"]
    inj = tfault.FaultInjector(schedule={"fg-r0": [(2, "kill")]})
    fleet = tfleet.LLMFleet(
        fleet_factory(eng_cls, params, cfg, decode_horizon=2),
        initial_replicas=2, router="round_robin", fleet_id="fg",
        fault_injector=inj)
    fids = [fleet.submit(p, 10) for p in PROMPTS]
    streamed = {f: [] for f in fids}
    for emitted in drive_fleet(fleet)[0]:
        for f, toks in emitted.items():
            streamed[f].extend(toks)
    out = fleet.run()
    assert inj.fired
    assert all(streamed[f] == out[f] and len(out[f]) == 10 for f in fids)


def _recovering(weights, pkg, serving):
    eng_cls, params, cfg = weights[pkg]
    fmod, fault = PKGS[pkg]
    serving.reset_serving_state()
    inj = fault.FaultInjector(schedule={"sapi-r0": [(1, "kill")]})
    fleet = fmod.LLMFleet(
        fleet_factory(eng_cls, params, cfg, decode_horizon=4),
        initial_replicas=2, router="round_robin", fleet_id="sapi",
        fault_injector=inj)
    fids = [fleet.submit(p, 8) for p in PROMPTS]
    for _ in range(10):
        fleet.step()
        if fleet.replicas_failed:
            break
    # between the failing step and the next, the killed replica's
    # requests sit in the retry queue
    rec = sorted((r["req_id"], r["engine_id"], r["attempts"])
                 for r in serving.list_requests(status="recovering"))
    engs = sorted((e["engine_id"], e["fleet"], e["health"])
                  for e in serving.list_engines())
    before = serving.summarize_fleet()["fleets"][0]
    out = fleet.run()
    after = serving.summarize_fleet()["fleets"][0]
    return rec, engs, before, after, [len(out[f]) for f in fids]


def test_state_api_reports_recovering_like_jax(weights):
    """Right after a replica fails, its requests are ``recovering`` on
    the fleet (no engine) in both packages' state APIs, with the same
    engine rows and the same fleet summary before and after recovery."""
    from ray_tpu.util.state import serving as jserving

    j = _recovering(weights, "jax", jserving)
    t = _recovering(weights, "port", tserving)
    assert t == j
    rec, _, before, after, lens = t
    assert [r[0] for r in rec] == [0, 2] and all(r[1] is None for r in rec)
    assert before["requests_recovering"] == 2
    assert after["requests_recovered"] == 2
    assert after["tokens_lost_to_failure"] == 0 and lens == [8] * 4
