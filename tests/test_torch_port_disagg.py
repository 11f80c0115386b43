"""PyTorch port, disaggregated prefill/decode and the engine's fleet
surface: `halt`, ``resume_tokens``, ``prefill_only``, `handoff_ready`,
`export_request` / `import_request` and the handoff stats.

Mirrors tests/test_fleet_disagg.py. A fleet with one prefill-class and
two decode-class replicas serves the same traffic on the JAX package
(JAX engines) and on the port (port engines), with the same seeded numpy
weights, on a dense, a paged f32 and a paged int8 pool: greedy tokens,
every step's emissions, handoff counts and bytes are equal across
packages, a paged handoff moves its KV by swap (bytes out == bytes in >
0) and every pool returns to empty. The split is invisible in the
tokens: a disaggregated port fleet equals a colocated one, greedy and
sampled. A JAX export imports into a port engine and decodes the JAX
fleet's tokens. The engine surface is held to the JAX engine's: the
payload's fields and pages, resumed streams and their refusals, the
stats keys, and what `halt` releases.

The `gpu` case builds an engine with no device argument and checks it
serves on the card; it skips without one:

    python -m pytest --noconftest -m gpu tests/test_torch_port_disagg.py -q
"""

import faulthandler

import numpy as np
import pytest
import torch

try:        # the card's machine has no JAX; only the gpu case runs there
    import jax
    import jax.numpy as jnp
    from torch_port_helpers import drive_fleet, fleet_factory, numpy_params

    from ray_tpu.models import engine as jengine
    from ray_tpu.models import fault_injection as jfault
    from ray_tpu.models import fleet as jfleet
    from ray_tpu.models import llama as jllama
    from ray_tpu.util.state import serving as jserving
except ImportError:
    jax = None

from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import fault_injection as tfault
from ray_tpu_torch.models import fleet as tfleet
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import lora as tlora
from ray_tpu_torch.models.scheduler import EngineDraining, EngineOverloaded
from ray_tpu_torch.util.state import serving as tserving

TCFG = tllama.LlamaConfig.nano()
PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2], [3, 1, 4, 1, 5, 9],
           [11, 13], [2, 7, 1, 8]]
BUDGETS = [4, 6, 3, 5, 2, 4]
TOP_K = {"greedy": False, "temperature": 0.9, "top_k": 8}
COMBOS = {"dense": {}, "paged": {"paged": True, "kv_block_tokens": 4},
          "paged_int8": {"paged": True, "kv_block_tokens": 4,
                         "kv_quant": "int8"}}
PAYLOAD_SCALARS = ("req_id", "prompt", "max_new_tokens", "priority",
                   "greedy", "adapter_id", "tokens")
KV_SCALARS = ("n_blocks", "row_len", "tok_idx", "budget", "block_tokens",
              "quant", "pool_shape")


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


def _pools_empty(fleet):
    """Every paged replica's pool back to no block in use."""
    for rep in fleet.replicas:
        if rep.engine.kv_pool is not None:
            assert rep.engine.kv_pool.blocks_in_use == 0, rep.name


# ---------------------------------------------------------------------------
# The disaggregated fleet, against the JAX fleet
# ---------------------------------------------------------------------------

def _disagg(weights, pkg, combo, mode, split=True):
    eng_cls, fmod, params, cfg = weights[pkg]
    kw = dict(COMBOS[combo], **(TOP_K if mode == "top_k" else {}))
    fac = fleet_factory(eng_cls, params, cfg, **kw)
    if split:
        fleet = fmod.LLMFleet(fac, rng_seed=7, disaggregated=True,
                              fleet_id="dis", prefill_replicas=1,
                              decode_replicas=2)
    else:
        fleet = fmod.LLMFleet(fac, rng_seed=7, initial_replicas=2,
                              fleet_id="co")
    fids = [fleet.submit(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    steps, health = drive_fleet(fleet)
    out = fleet.run()
    st = fleet.stats()
    if pkg == "port":
        _pools_empty(fleet)
    return {"fids": fids, "steps": steps, "health": health,
            "tokens": [out[f] for f in fids],
            "keys": [fleet._fid_key(f) for f in fids],
            "stats": {k: st[k] for k in (
                "disaggregated", "handoffs", "handoffs_out", "handoffs_in",
                "handoff_out_bytes", "handoff_in_bytes", "handoff_parked",
                "replicas_prefill", "replicas_decode",
                "tokens_lost_to_failure")}}


@pytest.fixture(scope="module")
def runs(weights):
    cache = {}

    def get(pkg, combo, mode="greedy", split=True):
        key = (pkg, combo, mode, split)
        if key not in cache:
            cache[key] = _disagg(weights, pkg, combo, mode, split)
        return cache[key]
    return get


@pytest.mark.parametrize("combo", ["dense", "paged", "paged_int8"])
def test_disagg_matches_jax_fleet(runs, weights, combo):
    """Greedy: the port's split fleet emits the JAX split fleet's tokens
    step by step, with the same handoff counts and bytes; a paged
    handoff goes by swap and every request is handed off once."""
    j = runs("jax", combo)
    t = runs("port", combo)
    for key in ("fids", "steps", "health", "tokens", "stats"):
        assert t[key] == j[key], key
    st = t["stats"]
    assert st["disaggregated"] == 1.0
    assert st["handoffs"] == st["handoffs_out"] == st["handoffs_in"] \
        == len(PROMPTS)
    assert st["handoff_parked"] == 0.0 and st["tokens_lost_to_failure"] == 0
    if combo == "dense":
        assert st["handoff_out_bytes"] == st["handoff_in_bytes"] == 0.0
    else:
        assert st["handoff_in_bytes"] == st["handoff_out_bytes"] > 0
    if combo != "paged_int8":
        assert t["tokens"] == [_port_solo(weights["port"][2], p, n)
                               for p, n in zip(PROMPTS, BUDGETS)]


@pytest.mark.parametrize("mode", ["greedy", "top_k"])
@pytest.mark.parametrize("combo", ["dense", "paged", "paged_int8"])
def test_disagg_equals_colocated(runs, weights, combo, mode):
    """The class split changes where a request decodes, never what it
    computes: a split port fleet equals a colocated one (same seed, so
    the same pinned per-request keys), greedy and sampled; on f32 pools
    each request equals the port's solo `generate` under the key the
    fleet pinned for it."""
    split = runs("port", combo, mode)
    assert split["tokens"] == runs("port", combo, mode, split=False)["tokens"]
    if combo != "paged_int8":
        kw = TOP_K if mode == "top_k" else {}
        assert split["tokens"] == [
            _port_solo(weights["port"][2], p, n, rng=k, **kw)
            for p, n, k in zip(PROMPTS, BUDGETS, split["keys"])]


def _mid_handoff_death(weights, pkg, kill_step):
    eng_cls, fmod, params, cfg = weights[pkg]
    fault = tfault if pkg == "port" else jfault
    inj = fault.FaultInjector(schedule={"chaos-r1": [(kill_step, "kill")]})
    fleet = fmod.LLMFleet(
        fleet_factory(eng_cls, params, cfg, paged=True, kv_block_tokens=4),
        rng_seed=11, disaggregated=True, fleet_id="chaos",
        prefill_replicas=1, decode_replicas=1, fault_injector=inj,
        health=fmod.FleetHealthConfig(max_retries=3))
    fids = [fleet.submit(p, n) for p, n in zip(PROMPTS[:4], BUDGETS[:4])]
    steps, health = drive_fleet(fleet)
    out = fleet.run()
    st = fleet.stats()
    if pkg == "port":
        _pools_empty(fleet)
    return (inj.fired, steps, health, [out[f] for f in fids],
            {k: st[k] for k in ("replicas_failed", "tokens_lost_to_failure",
                                "replicas_decode", "replicas_prefill",
                                "handoffs", "handoff_parked")})


@pytest.mark.parametrize("kill_step", [0, 2])
def test_mid_handoff_decode_death_matches_jax(weights, runs, kill_step):
    """The decode replica dies right after an import (step 0) or
    mid-decode (step 2): the request fails over through the prefill
    class again, the class-keeping replacement imports it, and the port
    fleet does exactly what the JAX fleet does, with no token lost and
    the streams of the fault-free run."""
    j = _mid_handoff_death(weights, "jax", kill_step)
    t = _mid_handoff_death(weights, "port", kill_step)
    assert t == j
    fired, _, _, tokens, st = t
    assert fired and st["replicas_failed"] == 1.0
    assert st["tokens_lost_to_failure"] == 0.0
    assert st["replicas_decode"] == st["replicas_prefill"] == 1.0
    tp = weights["port"][2]
    assert tokens == [_port_solo(tp, p, n)
                      for p, n in zip(PROMPTS[:4], BUDGETS[:4])]


def test_handoff_parks_when_decode_wont_import(weights):
    """An import refused with EngineOverloaded parks the export on the
    host (``handoff`` on the fleet in the state API, engine_id None) and
    is placed again next step, with the tokens unchanged."""
    eng_cls, fmod, params, cfg = weights["port"]
    tserving.reset_serving_state()
    dis = fmod.LLMFleet(
        fleet_factory(eng_cls, params, cfg, paged=True, kv_block_tokens=4),
        rng_seed=5, disaggregated=True, fleet_id="dis-park",
        prefill_replicas=1, decode_replicas=1)
    dec = next(r for r in dis.replicas if r.replica_class == "decode")
    real_import = dec.engine.import_request
    refusals = []

    def flaky_import(h):
        if not refusals:
            refusals.append(h["req_id"])
            raise EngineOverloaded("scripted refusal")
        return real_import(h)

    dec.engine.import_request = flaky_import
    fids = [dis.submit(p, n) for p, n in zip(PROMPTS[:3], BUDGETS[:3])]
    parked = None
    while dis.pending() and parked is None:
        dis.step()
        if dis._handoff_parked:
            parked = [r for r in tserving.list_requests(status="handoff")
                      if r["engine_id"] is None]
            assert dis.stats()["handoff_parked"] >= 1.0
    assert parked and parked[0]["fleet"] == "dis-park"
    out = dis.run()
    tp = weights["port"][2]
    assert [out[f] for f in fids] == [_port_solo(tp, p, n) for p, n
                                      in zip(PROMPTS[:3], BUDGETS[:3])]
    assert len(refusals) == 1 and dis.stats()["handoff_parked"] == 0.0
    _pools_empty(dis)


def test_state_api_handoff_status_like_jax(weights):
    """Mid-run, both packages' state APIs show each request in the same
    phase on the same engine (``handoff`` for parked exports and
    imported rows awaiting decode) with the replica classes."""
    got = []
    for pkg, serving in (("jax", jserving), ("port", tserving)):
        eng_cls, fmod, params, cfg = weights[pkg]
        serving.reset_serving_state()
        dis = fmod.LLMFleet(
            fleet_factory(eng_cls, params, cfg, paged=True,
                          kv_block_tokens=4),
            rng_seed=5, disaggregated=True, fleet_id="st",
            prefill_replicas=1, decode_replicas=1)
        for p, n in zip(PROMPTS, BUDGETS):
            dis.submit(p, n)
        seen = []
        for _ in range(3):
            dis.step()
            seen.append(sorted((r["engine_id"], r["req_id"], r["status"])
                               for r in serving.list_requests()))
        classes = sorted((e["engine_id"], e["replica_class"])
                         for e in serving.list_engines())
        dis.run()
        got.append((seen, classes))
    assert got[1] == got[0]
    assert any(s == "handoff" for rows in got[1][0] for _, _, s in rows)


# ---------------------------------------------------------------------------
# Cross-package handoff: a JAX export imported by a port engine
# ---------------------------------------------------------------------------

def test_jax_export_imports_into_port_engine():
    """A paged bf16 payload exported by the JAX engine (numpy; bf16 moved
    through a uint16 view) imports into a port decode engine BY SWAP (no
    re-prefill) and decodes the greedy tokens of the JAX fleet's own
    disaggregated run."""
    jcfg = jllama.LlamaConfig.nano(dtype=jnp.bfloat16)
    tcfg = tllama.LlamaConfig.nano(dtype=torch.bfloat16)
    tree = numpy_params(jcfg, seed=0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    kw = dict(paged=True, kv_block_tokens=4, batch_slots=2, max_len=32)
    prompts, budgets = PROMPTS[:3], BUDGETS[:3]

    ref = jfleet.LLMFleet(fleet_factory(jengine.DecodeEngine, jp, jcfg,
                                        **kw),
                          rng_seed=3, disaggregated=True, fleet_id="x",
                          prefill_replicas=1, decode_replicas=1)
    rf = [ref.submit(p, n) for p, n in zip(prompts, budgets)]
    ref_out = ref.run()

    pre = jengine.DecodeEngine(jp, jcfg, engine_id="jp", **kw)
    pre.prefill_only = True
    dec = DecodeEngine(tp, tcfg, engine_id="tp", **kw)
    for p, n in zip(prompts, budgets):
        pre.submit(p, n)
    rids = {}
    while pre.pending():
        pre.step()
        for rid in pre.handoff_ready():
            h = pre.export_request(rid)
            kv = dict(h["kv"])
            for name in ("k", "v"):
                kv[name] = torch.from_numpy(
                    np.asarray(kv[name]).view(np.uint16).copy()).view(
                        torch.bfloat16)
            kv["logits"] = torch.from_numpy(np.array(kv["logits"]))
            rids[rid] = dec.import_request(dict(h, kv=kv))
    out = dec.run()
    assert [out[rids[i]] for i in range(len(prompts))] == \
        [ref_out[f] for f in rf]
    st = dec.stats()
    assert st["handoffs_in"] == len(prompts)
    assert st["handoff_in_bytes"] == pre.stats()["handoff_out_bytes"] > 0
    assert st["prefill_real_tokens"] == 0       # nothing re-prefilled
    assert dec.kv_pool.blocks_in_use == 0


# ---------------------------------------------------------------------------
# The engine surface, against the JAX engine
# ---------------------------------------------------------------------------

def _both_engines(weights, **kw):
    kw = {"max_len": 32, "batch_slots": 2, **kw}
    return (jengine.DecodeEngine(weights["jax"][2], weights["jax"][3], **kw),
            DecodeEngine(weights["port"][2], TCFG, **kw))


def _prefill_and_export(eng, prompt, n):
    eng.prefill_only = True
    rid = eng.submit(prompt, n, rng=np.array([5, 9], np.uint32))
    while not eng.handoff_ready():
        eng.step()
    assert eng.handoff_ready() == [rid]
    assert eng.stats()["requests_handoff_ready"] == 1.0
    return eng.export_request(rid)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_export_payload_matches_jax(weights, quant):
    """The payload has the JAX engine's fields and meaning: equal
    scalars, equal shapes, pages within C4's tolerance (f32 values to
    1e-5; int8 scales to 2e-6 relative and values within one step) and
    equal logits; the row leaves the engine and its blocks go back."""
    kw = {"paged": True, "kv_block_tokens": 4}
    if quant == "int8":
        kw["kv_quant"] = "int8"
    jeng, teng = _both_engines(weights, **kw)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    jh, th = (_prefill_and_export(e, prompt, 6) for e in (jeng, teng))
    assert set(th) == set(jh) and set(th["kv"]) == set(jh["kv"])
    for k in PAYLOAD_SCALARS:
        assert th[k] == jh[k], k
    assert [int(x) for x in th["rng"]] == [int(x) for x in jh["rng"]]
    for k in KV_SCALARS:
        assert tuple(np.atleast_1d(th["kv"][k])) == \
            tuple(np.atleast_1d(jh["kv"][k])), k
    for k in ("k", "v", "sk", "sv", "logits"):
        jx, tx = jh["kv"][k], th["kv"][k]
        if jx is None:
            assert tx is None, k
            continue
        assert tuple(tx.shape) == np.asarray(jx).shape, k
        n = jh["kv"]["n_blocks"]
        jx = np.asarray(jx, np.float32)
        tx = tx.float().numpy()
        if k in ("k", "v", "sk", "sv"):      # padding blocks are garbage
            jx, tx = jx[:, :n], tx[:, :n]
        if quant == "int8" and k in ("k", "v"):
            assert np.abs(tx - jx).max() <= 1.0, k
        elif k in ("sk", "sv"):
            np.testing.assert_allclose(tx, jx, rtol=2e-6, err_msg=k)
        else:
            np.testing.assert_allclose(tx, jx, atol=1e-5, err_msg=k)
    for eng in (jeng, teng):
        assert eng.kv_pool.blocks_in_use == 0
        assert not eng.results and not eng.handoff_ready()
        assert eng.stats()["handoffs_out"] == 1.0
    assert teng.stats()["handoff_out_bytes"] == \
        jeng.stats()["handoff_out_bytes"]


def test_export_of_dense_engine_carries_no_bytes(weights):
    """A dense engine exports no KV: the importer re-prefills, and the
    imported request decodes solo `generate`'s tokens."""
    _, teng = _both_engines(weights)
    h = _prefill_and_export(teng, [5, 6, 7], 5)
    assert h["kv"] is None and teng.stats()["handoff_out_bytes"] == 0.0
    dec = DecodeEngine(weights["port"][2], TCFG, max_len=32, paged=True,
                       kv_block_tokens=4)
    rid = dec.import_request(h)
    assert dec.run()[rid] == _port_solo(weights["port"][2], [5, 6, 7], 5)
    assert dec.stats()["handoff_in_bytes"] == 0.0


@pytest.mark.parametrize("case", ["mid_chunk", "ring", "unknown"])
def test_export_refuses_like_jax(weights, case):
    """Export raises, in both packages, for a row still mid-chunked-
    prefill, while the ring holds a dispatch, and for an unbound id."""
    kw = {"prefill_chunk": 2} if case == "mid_chunk" else {}
    for eng in _both_engines(weights, paged=True, kv_block_tokens=4, **kw):
        rid = eng.submit([3, 1, 4, 1, 5, 9, 2, 6], 20)
        eng.prefill_only = case == "mid_chunk"
        eng.step()
        if case == "ring":
            assert eng._ring, "depth 2 keeps a dispatch in flight"
        with pytest.raises(RuntimeError):
            eng.export_request(rid if case != "unknown" else 99)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_resume_tokens_match_jax(weights, layout):
    """A request resumed with the first k tokens of its stream
    continues it exactly: the port engine's tokens equal the JAX
    engine's and the uninterrupted stream."""
    kw = COMBOS[layout]
    full = _port_solo(weights["port"][2], [9, 8, 7, 6, 5], 10)
    outs = []
    for eng in _both_engines(weights, **kw):
        ids = [eng.submit([9, 8, 7, 6, 5], 10, resume_tokens=full[:k])
               for k in (1, 4, 9)]
        res = eng.run()
        outs.append([res[i] for i in ids])
    assert outs[1] == outs[0] == [full] * 3


@pytest.mark.parametrize("case", ["complete", "deadline"])
def test_resume_tokens_rejected_like_jax(weights, case):
    """Both engines refuse a resume as long as the budget (nothing left
    to do) and a resume with a deadline (resumed requests are exempt
    from shedding)."""
    kw = ({"resume_tokens": [1, 2, 3]} if case == "complete"
          else {"resume_tokens": [1], "deadline_s": 5.0})
    for eng in _both_engines(weights):
        with pytest.raises(ValueError):
            eng.submit([5, 6, 7], 3, **kw)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_stats_keys_cover_jax(weights, layout):
    """`stats()` carries every key of the JAX engine's (the port adds
    its decode_graph* keys), the handoff plane and tp_degree included."""
    jeng, teng = _both_engines(weights, **COMBOS[layout])
    for eng in (jeng, teng):
        eng.submit([5, 6, 7], 3)
        eng.run()
    missing = set(jeng.stats()) - set(teng.stats())
    assert not missing, missing
    assert teng.stats()["tp_degree"] == 1.0


def test_prefill_only_parks_and_never_decodes(weights):
    """A prefill-only engine parks every completed prefill in
    `handoff_ready` (oldest first) and dispatches no decode."""
    _, teng = _both_engines(weights, paged=True, kv_block_tokens=4)
    teng.prefill_only = True
    ids = [teng.submit(p, n) for p, n in zip(PROMPTS[:2], BUDGETS[:2])]
    for _ in range(4):
        assert teng.step() == {}
    assert teng.handoff_ready() == ids
    st = teng.stats()
    assert st["prefill_only"] == 1.0 and st["requests_handoff_ready"] == 2.0
    assert st["decode_dispatches"] == 0.0 and not teng._ring


@pytest.mark.parametrize("layout", ["dense", "paged_prefix", "lora"])
def test_halt_releases_everything(weights, layout):
    """`halt` mid-run frees every pool block the prefix trie does not
    hold and every adapter slot's reference, keeps ``results`` (with
    the tokens emitted so far), is idempotent, and refuses new submits
    with EngineDraining."""
    kw = {"max_len": 32, "batch_slots": 2, "decode_horizon": 2}
    if layout == "paged_prefix":
        kw.update(paged=True, kv_block_tokens=4, prefix_cache=True)
    lcfg = None
    if layout == "lora":
        lcfg = tlora.LoraConfig(rank=4, alpha=8.0)
        kw.update(paged=True, kv_block_tokens=4, lora=lcfg,
                  max_live_adapters=2)
    eng = DecodeEngine(weights["port"][2], TCFG, **kw)
    aids = [None] * 4
    if lcfg is not None:
        for i, aid in enumerate(("a0", "a1")):
            g = torch.Generator().manual_seed(i)
            eng.register_adapter(aid, tlora.lora_init(
                TCFG, lcfg, generator=g, device="cpu"))
        aids = ["a0", "a1", None, "a0"]
    ids = [eng.submit(p, 16, adapter_id=a)
           for p, a in zip(PROMPTS[:4], aids)]
    for _ in range(3):
        eng.step()
    assert any(r is not None for r in eng.row_req)
    eng.halt()
    eng.halt()
    assert eng.halted and not eng.pending() and eng.step() == {}
    assert sorted(eng.results) == ids
    assert any(eng.results[i].tokens for i in ids)
    if eng.kv_pool is not None:
        held = eng._prefix.blocks_in_use if eng._prefix is not None else 0
        assert eng.kv_pool.blocks_in_use == held
        assert layout != "paged_prefix" or held > 0
    if eng.adapter_pool is not None:
        assert eng.adapter_pool.pinned_slots() == 0
        assert not eng._pending_slots
    with pytest.raises(EngineDraining):
        eng.submit([1, 2], 2)


def test_engine_registers_with_the_state_api(weights):
    """Every engine registers weakly; a paged engine's pool is listed."""
    tserving.reset_serving_state()
    eng = DecodeEngine(weights["port"][2], TCFG, max_len=32, paged=True,
                       kv_block_tokens=4, engine_id="reg")
    assert [e["engine_id"] for e in tserving.list_engines()] == ["reg"]
    assert tserving.list_kv_pools()[0]["kind"] == "paged"
    del eng
    assert tserving.list_engines() == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's default device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_engine_without_device_runs_on_cuda(cuda):
    """Weights from `llama_init` with no device argument, and so the
    engine built on them, live on the card; a prefill-only engine there
    exports a payload whose pages are pinned host tensors, and a decode
    engine on the card imports and finishes it."""
    cfg = tllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, ffn_dim=512,
                             max_seq_len=256)
    params = tllama.llama_init(cfg, seed=2, dtype=cfg.dtype)
    kw = dict(paged=True, kv_block_tokens=32, max_len=256, batch_slots=2)
    pre = DecodeEngine(params, cfg, **kw)
    dec = DecodeEngine(params, cfg, **kw)
    assert pre.device.type == "cuda" and dec.device.type == "cuda"
    pre.prefill_only = True
    rid = pre.submit(list(range(1, 40)), 8)
    while not pre.handoff_ready():
        pre.step()
    h = pre.export_request(rid)
    assert h["kv"]["k"].is_pinned() and h["kv"]["k"].device.type == "cpu"
    new = dec.import_request(h)
    out = dec.run()
    assert len(out[new]) == 8
    assert dec.stats()["handoff_in_bytes"] == pre.stats()[
        "handoff_out_bytes"] > 0
