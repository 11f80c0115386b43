"""PyTorch port, serving fleet: routing, scale-up, drain, shedding, the
autoscaler and the serving state API.

Mirrors tests/test_fleet.py. The same scenarios (a burst, a replica
added mid-stream, a replica drained mid-stream, dead-on-arrival traffic
shed between live requests) run on the JAX package's `LLMFleet` over JAX
engines and on the port's over port engines, with the same seeded numpy
weights: fleet request ids, every step's greedy emissions, shed ids, the
replica names and health after every step, and the fleet's counters are
equal across packages, and greedy tokens equal solo `generate`. Sampled
fleets pin a key per request and equal the port's own solo `generate`
under that key (the port's sampling hash does not reproduce threefry).
`EngineStatsAutoscaler`, pure host code, takes the same decisions on the
same stats under a fake clock. The state API lists the same requests in
the same phases. Each scenario runs once per package in a module cache
that the parametrised cases read.
"""

import faulthandler
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_port_helpers import (FakeClock, drive_fleet, fleet_factory,
                                numpy_params)

from ray_tpu.models import engine as jengine
from ray_tpu.models import fleet as jfleet
from ray_tpu.models import llama as jllama
from ray_tpu.util.state import serving as jserving
from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import fleet as tfleet
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.scheduler import EngineDraining
from ray_tpu_torch.util.state import serving as tserving

TCFG = tllama.LlamaConfig.nano()
PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2], [3, 1, 4, 1, 5, 9],
           [11, 13], [2, 7, 1, 8]]
BUDGETS = [4, 6, 3, 5, 2, 4]
# Raw uint32[2] keys: the form both fleets pin and both engines accept.
KEYS = [np.array([40 + i, 0], np.uint32) for i in range(len(PROMPTS))]
TOP_K = {"greedy": False, "temperature": 0.9, "top_k": 8}
# Fleet stats read off the clock; everything else is a count.
TIMED = ("ttft_s_p95_fleet", "ttft_s_p95_max", "tpot_s_p95_max")


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
    return {"jax": (jengine.DecodeEngine, jfleet,
                    jax.tree_util.tree_map(jnp.asarray, tree), jcfg),
            "port": (DecodeEngine, tfleet,
                     params_from_numpy(tree, TCFG, device="cpu"), TCFG)}


def _port_solo(tp, prompt, n, **kw):
    out = tgen.generate(tp, torch.tensor([prompt]), TCFG, max_new_tokens=n,
                        **kw)
    return out[0, len(prompt):].tolist()


def _scenario(weights, pkg, router, scenario, mode):
    """tests/test_fleet.py's identity matrix, one cell, on ``pkg``."""
    eng_cls, fmod, params, cfg = weights[pkg]
    kw = TOP_K if mode == "top_k" else {}
    fleet = fmod.LLMFleet(
        fleet_factory(eng_cls, params, cfg, prefix_cache=True,
                      prefix_block=4, **kw),
        initial_replicas=2, router=router,
        fleet_id=f"{router}-{scenario}-{mode}")
    first = [fleet.submit(p, n, rng=k) for p, n, k
             in zip(PROMPTS[:3], BUDGETS[:3], KEYS[:3])]
    steps = [fleet.step() for _ in range(2)]
    shed = []
    if scenario == "scale_up":
        fleet.add_replica()
    elif scenario == "drain":
        victim = fleet.replicas[0]
        fleet.drain_replica(victim.name)
        with pytest.raises(
                jengine.EngineDraining if pkg == "jax" else EngineDraining):
            victim.engine.submit([1, 2], 2)
    elif scenario == "shed":
        shed = [fleet.submit([4, 4, 4], 4, deadline_s=0.0)
                for _ in range(2)]
    shed_ids = sorted(fleet.shed_ids)
    rest = [fleet.submit(p, n, rng=k) for p, n, k
            in zip(PROMPTS[3:], BUDGETS[3:], KEYS[3:])]
    more, health = drive_fleet(fleet)
    out = fleet.run()
    stats = fleet.stats()
    return {"fids": first + rest, "shed": shed, "shed_ids": shed_ids,
            "steps": steps + more, "health": health,
            "tokens": [out[f] for f in first + rest],
            "shed_tokens": [out[f] for f in shed],
            "replicas": [r.name for r in fleet.replicas],
            "stats": {k: v for k, v in stats.items() if k not in TIMED},
            "stat_keys": set(stats)}


@pytest.fixture(scope="module")
def runs(weights):
    cache = {}

    def get(pkg, router, scenario, mode="greedy"):
        key = (pkg, router, scenario, mode)
        if key not in cache:
            cache[key] = _scenario(weights, pkg, router, scenario, mode)
        return cache[key]
    return get


# ---------------------------------------------------------------------------
# Routing x scale-up x drain x shedding, against the JAX fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["route", "scale_up", "drain", "shed"])
@pytest.mark.parametrize("router", ["round_robin", "pow2_affinity"])
def test_fleet_matches_jax_fleet(runs, weights, router, scenario):
    """Greedy: the port fleet's ids, step-by-step emissions, shed ids,
    replica lifecycle, health and counters equal the JAX fleet's, and
    every request's tokens equal solo `generate`."""
    j = runs("jax", router, scenario)
    t = runs("port", router, scenario)
    for key in ("fids", "shed", "shed_ids", "steps", "health", "tokens",
                "shed_tokens", "replicas", "stats"):
        assert t[key] == j[key], key
    tp = weights["port"][2]
    assert t["tokens"] == [_port_solo(tp, p, n)
                           for p, n in zip(PROMPTS, BUDGETS)]
    assert t["shed_tokens"] == [[]] * len(t["shed"])
    if scenario == "drain":
        assert len(t["replicas"]) == 1     # flushed, then removed
        assert t["stats"]["tokens_lost_to_drain"] == 0.0
        assert t["stats"]["replicas_removed"] == 1.0
    if scenario == "scale_up":
        assert len(t["replicas"]) == 3


@pytest.mark.parametrize("scenario", ["route", "scale_up", "drain", "shed"])
@pytest.mark.parametrize("router", ["round_robin", "pow2_affinity"])
def test_fleet_sampled_matches_port_solo(runs, weights, router, scenario):
    """Sampled (top-k): each request's pinned key makes its stream
    independent of the replica: it equals the port's solo `generate`
    under the same key, whatever the scenario did to the pool."""
    t = runs("port", router, scenario, "top_k")
    tp = weights["port"][2]
    assert t["tokens"] == [_port_solo(tp, p, n, rng=k, **TOP_K)
                           for p, n, k in zip(PROMPTS, BUDGETS, KEYS)]


def test_fleet_stats_keys_match_jax(runs):
    """The port fleet publishes exactly the JAX fleet's stats keys."""
    assert runs("port", "round_robin", "route")["stat_keys"] == \
        runs("jax", "round_robin", "route")["stat_keys"]


def test_fleet_derives_the_same_keys_as_jax():
    """With no caller key, both fleets pin the same uint32[2] key per
    fleet request id and seed, so a request's stream depends only on
    the request."""
    for seed in (0, 7):
        j = jfleet.LLMFleet(lambda n: types.SimpleNamespace(),
                            initial_replicas=1, rng_seed=seed)
        t = tfleet.LLMFleet(lambda n: types.SimpleNamespace(),
                            initial_replicas=1, rng_seed=seed)
        for fid in (0, 1, 5, 1 << 20):
            np.testing.assert_array_equal(t._fid_key(fid), j._fid_key(fid))


# ---------------------------------------------------------------------------
# Autoscaler: pure host decisions under a fake clock
# ---------------------------------------------------------------------------

def _stats_seq(case):
    """(config kwargs, [(dt, n_replicas, [per-replica stats])])."""
    busy = {"slot_occupancy": 1.0, "queue_depth": 3.0, "ttft_s_p95": 0.1}
    idle = {"slot_occupancy": 0.0, "queue_depth": 0.0, "ttft_s_p95": 9.0}
    if case == "occupancy":
        return ({"upscale_hold_s": 2.0, "max_replicas": 3},
                [(1.0, 1, [busy])] * 3 + [(1.0, 2, [busy, busy])] * 4)
    if case == "ttft":
        slow = dict(busy, slot_occupancy=0.5, ttft_s_p95=2.0)
        return ({"ttft_p95_slo_s": 1.0, "upscale_hold_s": 1.0},
                [(0.5, 1, [slow])] * 4 + [(0.5, 2, [slow, idle])] * 3)
    if case == "idle":
        return ({"downscale_hold_s": 3.0, "min_replicas": 1},
                [(1.0, 3, [idle] * 3)] * 5 + [(1.0, 2, [idle] * 2)] * 5)
    return ({"tpot_p95_slo_s": 0.05, "upscale_hold_s": 0.0},
            [(0.1, 1, [dict(busy, slot_occupancy=0.5, tpot_s_p95=0.2)])] * 3
            + [(0.1, 2, [idle, idle])] * 2)


@pytest.mark.parametrize("case", ["occupancy", "ttft", "idle", "tpot"])
def test_autoscaler_decisions_match_jax(case):
    """The same stats sequence gives the same +1/0/-1 decisions and
    signals from both packages' `EngineStatsAutoscaler`."""
    cfg_kw, seq = _stats_seq(case)
    got = []
    for mod in (jfleet, tfleet):
        clock = FakeClock()
        sc = mod.EngineStatsAutoscaler(
            mod.FleetAutoscalingConfig(**cfg_kw), clock=clock)
        out = []
        for dt, n, stats in seq:
            clock.advance(dt)
            out.append((sc.tick(stats, n), sc.last_signals["breach"],
                        sc.last_signals["idle"]))
        got.append((out, sc.scale_ups, sc.scale_downs))
    assert got[0] == got[1]
    assert any(d != 0 for d, _, _ in got[1][0])


def test_autoscaled_fleet_matches_jax(weights):
    """A fleet under occupancy-driven autoscaling on a fake clock adds
    replicas at the same steps in both packages, with the same tokens."""
    got = []
    for pkg in ("jax", "port"):
        eng_cls, fmod, params, cfg = weights[pkg]
        clock = FakeClock()
        fleet = fmod.LLMFleet(
            fleet_factory(eng_cls, params, cfg, clock=clock,
                          decode_horizon=2),
            initial_replicas=1, clock=clock, fleet_id="as",
            autoscaling=fmod.FleetAutoscalingConfig(
                max_replicas=3, upscale_hold_s=1.0,
                downscale_hold_s=100.0))
        fids = [fleet.submit(p, 12) for p in PROMPTS]
        sizes = []
        while fleet.pending():
            clock.advance(0.5)
            fleet.step()
            sizes.append(len(fleet.replicas))
        out = fleet.run()
        got.append((sizes, [out[f] for f in fids],
                    fleet.stats()["replicas"]))
    assert got[1] == got[0]
    assert max(got[1][0]) > 1


# ---------------------------------------------------------------------------
# Serving state API
# ---------------------------------------------------------------------------

def _state_rows(weights, pkg, serving):
    eng_cls, fmod, params, cfg = weights[pkg]
    serving.reset_serving_state()
    fleet = fmod.LLMFleet(
        fleet_factory(eng_cls, params, cfg, paged=True, kv_block_tokens=4,
                      prefill_chunk=2),
        initial_replicas=2, router="round_robin", fleet_id="state")
    for p, n in zip(PROMPTS, BUDGETS):
        fleet.submit(p, n)
    fleet.step()
    rows = sorted((r["engine_id"], r["req_id"], r["status"],
                   r.get("prefill_pos"), r["tokens_out"])
                  for r in serving.list_requests())
    summary = serving.summarize_fleet()
    pools = [(p["engine_id"], p["blocks_in_use"])
             for p in serving.list_kv_pools()]
    fleet.run()
    return rows, summary, pools


def test_state_api_matches_jax(weights):
    """Mid-run, the port's state API lists each request on the same
    engine in the same phase at the same frontier as the JAX package's,
    and the fleet summary has the same keys and counts."""
    (jr, js, jp), (tr, ts, tp) = (_state_rows(weights, "jax", jserving),
                                  _state_rows(weights, "port", tserving))
    assert tr == jr
    assert {"queued", "prefilling"} <= {r[2] for r in tr}
    assert tp == jp
    assert ts["requests"] == js["requests"]
    assert set(ts["fleets"][0]) == set(js["fleets"][0])
    assert ts["fleets"][0]["health"] == js["fleets"][0]["health"]
    assert ts["engines_total"] == js["engines_total"] == 2
