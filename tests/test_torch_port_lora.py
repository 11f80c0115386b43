"""PyTorch port, multi-LoRA: `LoraConfig`, `lora_init`, `lora_merge`,
the adapter-only train step, the adapter pool, the adapter-affinity
policy and the DecodeEngine's LoRA plane against the JAX package.

Mirrors tests/test_engine_lora.py. The same seeded numpy weights and
adapters (both factors random: `lora_init`'s b = 0 would make every
adapter the base model) go to both packages, the port's through
`convert.params_from_numpy` / `lora_from_numpy`. On the nano f32 model:

- `lora_merge` equals the JAX merge to 1e-6 (f32; summation order);
  `forward_cached_rows` with the pool's stacks and a mixed slot lane
  equals JAX's to 1e-5 for every target (f32 sums in another order),
  and a slot-0 row is bit-identical to the run without adapters;
- the pools' stacks are byte-identical after every commit;
- the engine's greedy tokens equal the JAX engine's and the port's solo
  `generate` on `lora_merge`d weights, sampled tokens (top-k, a seed per
  request) equal the port's solo run (the port's sampling stream is its
  own), and the `adapter_*` stats equal the JAX engine's, on the dense
  and paged layouts (prefix cache, pipeline depths 1 and 2, int8 pages),
  through eviction, swap and recompute preemption and chunked prefill;
  every slot reference drains to 0;
- three adapter-only AdamW steps match JAX's losses and grad norms to
  1e-4 and its adapters to 1e-5 (as tests/test_torch_port_train.py),
  with the base bit-unchanged.

The `gpu` cases replay a decode graph after an eviction and a re-commit
into the same slot against the eager loop, hold base rows to the plain
engine on the card, and run the LoRA train step on the flash kernels
against the plain attention; they skip without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_lora.py -q
"""

import dataclasses
import faulthandler

import numpy as np
import pytest
import torch

try:        # the card's machine has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp
    import optax
    from torch_port_helpers import byte_view, numpy_params

    from ray_tpu.models import adapter_pool as jpool
    from ray_tpu.models import engine as jengine
    from ray_tpu.models import generate as jgen
    from ray_tpu.models import llama as jllama
    from ray_tpu.models import lora as jlora
    from ray_tpu.models import scheduler as jsched
    from ray_tpu.parallel import create_mesh
except ImportError:
    jax = None

from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import lora_from_numpy, params_from_numpy
from ray_tpu_torch.models import adapter_pool as tpool
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import lora as tlora
from ray_tpu_torch.models import scheduler as tsched
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models.engine_trace import EngineTracer
from ray_tpu_torch.models.prefix_cache import block_bytes
from ray_tpu_torch.ops import paged_attention_kernel as pak

TCFG = tllama.LlamaConfig.nano()
T = 4
MAX_LEN = 40
RANK, ALPHA = 4, 8.0
ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
SHARED = list(range(3, 11))
PROMPTS = [SHARED + [1, 2, 3, 4], SHARED + [5, 6, 7], [9, 10, 11, 12, 13],
           [3, 1, 4], SHARED + [2, 2]]
AIDS = ["ad0", "ad1", None, "ad2", "ad0"]
BUDGETS = [7, 4, 9, 5, 6]
# every adapter_* key both engines publish
ADAPTER_KEYS = ("adapter_enabled", "adapter_prefetch_deferrals",
                "adapters_registered", "adapter_slots",
                "adapter_slots_resident", "adapter_slots_pinned",
                "adapter_lookups", "adapter_hits", "adapter_hit_rate",
                "adapter_prefetches", "adapter_evictions")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(60, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _lcfgs(targets=("wq", "wk", "wv", "wo")):
    """(JAX LoraConfig, port LoraConfig) with the same fields."""
    return (jlora.LoraConfig(rank=RANK, alpha=ALPHA, targets=targets),
            tlora.LoraConfig(rank=RANK, alpha=ALPHA, targets=targets))


def _rand_lora(targets, seed, scale=0.05):
    """A numpy adapter tree with BOTH factors random."""
    rng = np.random.RandomState(seed)
    dims = tlora.lora_dims(TCFG, tlora.LoraConfig(rank=RANK,
                                                  targets=targets))
    L = TCFG.n_layers
    return {"layers": {name: {
        "a": (rng.standard_normal((L, n_in, RANK)) * scale
              ).astype(np.float32),
        "b": (rng.standard_normal((L, RANK, n_out)) * scale
              ).astype(np.float32)} for name, (n_in, n_out) in dims.items()}}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port params, numpy tree)."""
    jcfg = jllama.LlamaConfig.nano()
    tree = numpy_params(jcfg, seed=0)
    return (jcfg, _to_jax(tree), params_from_numpy(tree, TCFG, device="cpu"),
            tree)


@pytest.fixture(scope="module")
def adapters(model):
    """{aid: numpy tree}, the port's trees and the port's merged params
    of the three default-target adapters."""
    tp = model[2]
    jl, tl = _lcfgs()
    loras = {f"ad{i}": _rand_lora(tl.targets, 10 + i) for i in range(3)}
    tloras = {a: lora_from_numpy(lp, TCFG, tl, device="cpu")
              for a, lp in loras.items()}
    merged = {a: tlora.lora_merge(tp, lp, TCFG, tl)
              for a, lp in tloras.items()}
    return loras, tloras, merged


def _port_solo(params, prompt, n, **kw):
    out = tgen.generate(params, torch.tensor([prompt]), TCFG,
                        max_new_tokens=n, **kw)
    return out[0, len(prompt):].tolist()


def _pool_bytes(n_blocks, quant=False):
    if not quant:
        return n_blocks * block_bytes(TCFG.n_layers, T, TCFG.n_kv_heads,
                                      TCFG.head_dim, 4)
    return n_blocks * (block_bytes(TCFG.n_layers, T, TCFG.n_kv_heads,
                                   TCFG.head_dim, 1)
                       + 2 * TCFG.n_layers * TCFG.n_kv_heads * 4)


def _serve(eng, loras, prompts=PROMPTS, aids=AIDS, budgets=BUDGETS,
           rngs=None):
    """Register the adapters, submit the traffic and run to empty:
    the tokens per request."""
    for a, lp in loras.items():
        eng.register_adapter(a, lp)
    ids = [eng.submit(p, n, adapter_id=a,
                      rng=None if rngs is None else rngs[i])
           for i, (p, n, a) in enumerate(zip(prompts, budgets, aids))]
    out = eng.run()
    assert not eng.pending()
    return [out[i] for i in ids]


def _both(model, adapters, kw, **traffic):
    """The JAX and the port LoRA engine, constructed alike, on the same
    traffic: (JAX tokens, port tokens, JAX engine, port engine)."""
    jcfg, jp, tp, _ = model
    loras, tloras, _ = adapters
    jl, tl = _lcfgs()
    kw = dict(dict(batch_slots=2, max_len=MAX_LEN, max_live_adapters=2),
              **kw)
    jeng = jengine.DecodeEngine(jp, jcfg, lora=jl, **kw)
    teng = DecodeEngine(tp, TCFG, lora=tl, **kw)
    jtok = _serve(jeng, {a: _to_jax(lp) for a, lp in loras.items()},
                  **traffic)
    return jtok, _serve(teng, tloras, **traffic), jeng, teng


def _drained(eng):
    """Every adapter-slot reference returned, nothing pending."""
    assert not any(eng.adapter_pool._refs), eng.adapter_pool._refs
    assert not eng._pending_slots
    assert not eng._row_slot.any()


def _same_adapter_stats(jeng, teng):
    js, ts = jeng.stats(), teng.stats()
    bad = {k: (js[k], ts[k]) for k in ADAPTER_KEYS if js[k] != ts[k]}
    assert not bad, bad


# ---------------------------------------------------------------------------
# lora.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(rank=0), dict(targets=("wq", "nope")),
                                dict(targets=())],
                         ids=["rank", "unknown", "empty"])
def test_lora_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jlora.LoraConfig(**kw)
    with pytest.raises(ValueError):
        tlora.LoraConfig(**kw)
    assert tlora._ADAPTABLE == jlora._ADAPTABLE
    assert tlora.LoraConfig(rank=4, alpha=8.0).scale == \
        jlora.LoraConfig(rank=4, alpha=8.0).scale == 2.0


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"), ALL_TARGETS],
                         ids=["default", "all"])
def test_lora_init_shapes_and_num_params(model, targets):
    """Shapes, dtype and B = 0 as JAX's lora_init; A's spread is
    N(0, 1/in); lora_num_params equal; the merged init is the base."""
    jcfg, _, tp, _ = model
    jl, tl = _lcfgs(targets)
    want = jlora.lora_init(jax.random.PRNGKey(0), jcfg, jl)["layers"]
    got = tlora.lora_init(TCFG, tl, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert set(got["layers"]) == set(want)
    for name, ab in got["layers"].items():
        for k in ("a", "b"):
            assert tuple(ab[k].shape) == want[name][k].shape
            assert ab[k].dtype == torch.float32
        assert not ab["b"].any()
        std = ab["a"].std().item() * ab["a"].shape[1] ** 0.5
        assert 0.8 < std < 1.2, (name, std)
    assert tlora.lora_num_params(TCFG, tl) == \
        jlora.lora_num_params(jcfg, jl)
    merged = tlora.lora_merge(tp, got, TCFG, tl)
    for name in targets:
        assert torch.equal(merged["layers"][name], tp["layers"][name])


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"),
                                     ("wq", "wv", "w_gate", "w_down")],
                         ids=["default", "mlp"])
def test_lora_merge_matches_jax(model, targets):
    jcfg, jp, tp, _ = model
    jl, tl = _lcfgs(targets)
    lp = _rand_lora(targets, 3)
    want = jlora.lora_merge(jp, _to_jax(lp), jcfg, jl)
    got = tlora.lora_merge(tp, lora_from_numpy(lp, TCFG, tl, device="cpu"),
                           TCFG, tl)
    for name, w in got["layers"].items():
        np.testing.assert_allclose(w.numpy(), np.asarray(
            want["layers"][name]), rtol=1e-6, atol=1e-6)
    assert got["tok_embed"] is tp["tok_embed"]


def test_lora_from_numpy_copies_and_checks():
    _, tl = _lcfgs()
    lp = _rand_lora(tl.targets, 4)
    got = lora_from_numpy(lp, TCFG, tl, device="cpu")
    before = got["layers"]["wq"]["a"].clone()
    lp["layers"]["wq"]["a"][...] = 7.0
    assert torch.equal(got["layers"]["wq"]["a"], before)
    del lp["layers"]["wo"]
    with pytest.raises(ValueError, match="wo"):
        lora_from_numpy(lp, TCFG, tl, device="cpu")


# ---------------------------------------------------------------------------
# generate.py: the per-row deltas
# ---------------------------------------------------------------------------

def _pools(targets, max_live=3):
    """A JAX and a port AdapterPool with the same three adapters
    committed (slots 1..3)."""
    jl, tl = _lcfgs(targets)
    jp_ = jpool.AdapterPool(jllama.LlamaConfig.nano(), jl,
                            max_live_adapters=max_live)
    tp_ = tpool.AdapterPool(TCFG, tl, max_live_adapters=max_live,
                            device="cpu")
    for i in range(3):
        lp = _rand_lora(targets, 20 + i)
        jp_.register(f"ad{i}", _to_jax(lp))
        tp_.register(f"ad{i}", lp)
        jp_.prefetch(f"ad{i}")
        tp_.prefetch(f"ad{i}")
        jp_.drain_prefetches()
        tp_.drain_prefetches()
    return jp_, tp_


@pytest.mark.parametrize("target", list(ALL_TARGETS))
def test_forward_cached_rows_lora_matches_jax(model, target):
    """`forward_cached_rows` with one adapted target, the pool's stacks
    and the slot lane [2, 0, 3, 1] against JAX's: logits and K/V to
    1e-5. The slot-0 row equals the run without adapters bit for bit
    (its delta is x @ 0 = 0)."""
    jcfg, jp, tp, _ = model
    jpl, tpl = _pools((target,))
    rng = np.random.RandomState(5)
    B, S = 4, 6
    toks = rng.randint(0, 256, size=(B, S)).astype(np.int32)
    starts = np.array([0, 3, 1, 5], np.int32)
    slots = np.array([2, 0, 3, 1], np.int32)
    shape = (TCFG.n_layers, B, 16, TCFG.n_kv_heads, TCFG.head_dim)
    cache0 = rng.standard_normal(shape).astype(np.float32)
    jl, jc = jgen.forward_cached_rows(
        jp, jnp.asarray(toks), {"k": jnp.asarray(cache0),
                                "v": jnp.asarray(cache0)},
        jnp.asarray(starts), jcfg, adapters=jpl.stacks,
        row_slot=jnp.asarray(slots))
    tc = {"k": torch.from_numpy(cache0.copy()),
          "v": torch.from_numpy(cache0.copy())}
    tl, _ = tgen.forward_cached_rows(
        tp, torch.from_numpy(toks).long(), tc, torch.from_numpy(starts),
        TCFG, adapters=tpl.stacks, row_slot=torch.from_numpy(slots).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-5)
    plain = {"k": torch.from_numpy(cache0.copy()),
             "v": torch.from_numpy(cache0.copy())}
    pl, _ = tgen.forward_cached_rows(tp, torch.from_numpy(toks).long(),
                                     plain, torch.from_numpy(starts), TCFG)
    assert torch.equal(tl[1], pl[1])
    assert not torch.equal(tl[0], pl[0]), "the adapter took no effect"
    x = torch.randn(B, S, tpl._dims[target][0])
    delta = tgen._lora_delta(x, {k: v[0] for k, v in
                                 tpl.stacks[target].items()},
                             torch.from_numpy(slots).long(), torch.float32)
    assert not delta[1].any()


# ---------------------------------------------------------------------------
# adapter_pool.py
# ---------------------------------------------------------------------------

def _stacks_equal(jp_, tp_):
    for name, ab in tp_.stacks.items():
        for k, x in ab.items():
            assert np.array_equal(byte_view(x),
                                  byte_view(np.asarray(jp_.stacks[name][k])))


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"), ALL_TARGETS],
                         ids=["default", "all"])
def test_pool_stacks_match_jax_bytes(targets):
    """Register, prefetch and drain through two slots with churn (so
    commits land on evicted slots): after every drain the stacks, the
    residency ledger and the stats equal the JAX pool's."""
    jl, tl = _lcfgs(targets)
    jp_ = jpool.AdapterPool(jllama.LlamaConfig.nano(), jl,
                            max_live_adapters=2)
    tp_ = tpool.AdapterPool(TCFG, tl, max_live_adapters=2, device="cpu")
    for i in range(3):
        lp = _rand_lora(targets, 30 + i)
        jp_.register(f"ad{i}", _to_jax(lp))
        tp_.register(f"ad{i}", lp)
    for aid in ("ad0", "ad1", "ad2", "ad0", "ad1"):
        for p in (jp_, tp_):
            if not p.resident(aid):
                p.prefetch(aid)
                p.drain_prefetches()
            p.decref(p.alloc(aid))
        _stacks_equal(jp_, tp_)
        assert tp_._slot_of == jp_._slot_of
        assert tp_.stats() == jp_.stats()
    assert tp_.evictions == 3


def test_pool_pinned_adapter_never_evicted():
    """tests/test_engine_lora.py's pool contract: a slot held by alloc
    survives any churn, unregistering it defers to the last decref, and
    the slot is reclaimable after."""
    _, tl = _lcfgs()
    pool = tpool.AdapterPool(TCFG, tl, max_live_adapters=2, device="cpu")
    for i in range(3):
        pool.register(f"ad{i}", _rand_lora(tl.targets, 40 + i))
    pool.prefetch("ad0")
    pool.drain_prefetches()
    slot = pool.alloc("ad0")
    assert slot is not None and pool._refs[slot] == 1
    for aid in ("ad1", "ad2", "ad1", "ad2"):
        if not pool.resident(aid):
            pool.prefetch(aid)
            pool.drain_prefetches()
        assert pool.resident("ad0"), "pinned adapter evicted"
    assert pool.evictions >= 3
    assert pool.unregister("ad0") is False
    assert pool.registered("ad0")
    pool.decref(slot)
    assert not pool.registered("ad0") and not pool.resident("ad0")
    pool.prefetch("ad1")
    pool.drain_prefetches()
    assert pool.resident("ad1")


@pytest.mark.parametrize("case", ["alloc", "prefetch", "missing_target",
                                  "bad_shape", "empty_id", "zero_slots"])
def test_pool_rejects(case):
    """Unknown ids raise KeyError; malformed adapters and pools raise
    ValueError; the null slot is never refcounted."""
    _, tl = _lcfgs()
    pool = tpool.AdapterPool(TCFG, tl, max_live_adapters=2, device="cpu")
    lp = _rand_lora(tl.targets, 50)
    if case in ("alloc", "prefetch"):
        with pytest.raises(KeyError):
            getattr(pool, case)("never-registered")
        assert pool.alloc(None) == 0
        pool.decref(0)
        return
    with pytest.raises(ValueError):
        if case == "missing_target":
            del lp["layers"]["wk"]
            pool.register("x", lp)
        elif case == "bad_shape":
            lp["layers"]["wq"]["a"] = lp["layers"]["wq"]["a"][:, :-1]
            pool.register("x", lp)
        elif case == "empty_id":
            pool.register("", lp)
        else:
            tpool.AdapterPool(TCFG, tl, max_live_adapters=0, device="cpu")


def test_pool_defaults_to_the_card():
    """Like every entry point of the port, a pool built without device=
    puts its stacks on CUDA, and refuses where there is none."""
    _, tl = _lcfgs()
    if torch.cuda.is_available():
        pool = tpool.AdapterPool(TCFG, tl, max_live_adapters=1)
        assert pool.stacks["wq"]["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpool.AdapterPool(TCFG, tl, max_live_adapters=1)


def test_pool_register_copies_input():
    """The registry holds its own pre-scaled copy: a caller mutating its
    arrays or tensors afterwards changes nothing committed."""
    _, tl = _lcfgs()
    pool = tpool.AdapterPool(TCFG, tl, max_live_adapters=1, device="cpu")
    lp = lora_from_numpy(_rand_lora(tl.targets, 51), TCFG, tl, device="cpu")
    want = lp["layers"]["wv"]["b"] * tl.scale
    pool.register("ad0", lp)
    lp["layers"]["wv"]["b"].zero_()
    pool.prefetch("ad0")
    pool.drain_prefetches()
    assert torch.equal(pool.stacks["wv"]["b"][:, 1], want)


# ---------------------------------------------------------------------------
# scheduler.py: the adapter-affinity policy
# ---------------------------------------------------------------------------

class _Req:
    def __init__(self, i, aid, resume=False):
        self.req_id, self.seq, self.priority = i, i, 0
        self.adapter_id, self.resume, self.prompt = aid, resume, [i]


@pytest.mark.parametrize("probe", ["cold", "fetching", "warm"])
def test_adapter_policy_pops_like_jax(probe):
    """The same queue and probe give the same pops, None (all deferred)
    included, over two admission rounds."""
    state = {"cold": {}, "fetching": {"a": (False, True)},
             "warm": {"a": (True, False), "b": (True, False)}}[probe]
    aids = ["a", "b", None, "a", "c", "b"]
    orders = []
    for mod in (tsched, jsched):
        p = mod.make_policy("adapter")
        p.attach_adapter_probe(lambda aid: state.get(aid, (False, False)))
        for i, aid in enumerate(aids):
            p.push(_Req(i, aid, resume=(i == 4)))
        pops = []
        for _ in range(2):
            p.begin_admission_round()
            while True:
                r = p.pop()
                pops.append(None if r is None else r.req_id)
                if r is None:
                    break
        orders.append((pops, p.deferrals, len(p)))
    assert orders[0] == orders[1]
    assert isinstance(tsched.make_policy("adapter"),
                      tsched.AdapterAffinityPolicy)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

FEATURES = {
    "dense": {},
    "paged_prefix": {"paged": True, "kv_block_tokens": T,
                     "prefix_cache": True, "pipeline_depth": 1},
    "paged_prefix_depth2": {"paged": True, "kv_block_tokens": T,
                            "prefix_cache": True, "pipeline_depth": 2},
    "paged_int8": {"paged": True, "kv_block_tokens": T,
                   "kv_quant": "int8"},
}
_JAX_RUNS: dict = {}


def _jax_greedy(model, adapters, feature):
    """The JAX engine's greedy run of a feature (memoized): tokens and
    adapter stats. The schedule (admissions, evictions, prefetches)
    does not depend on the tokens (no eos), so sampled runs share it."""
    if feature not in _JAX_RUNS:
        jcfg, jp, _, _ = model
        loras = adapters[0]
        jl, _ = _lcfgs()
        eng = jengine.DecodeEngine(jp, jcfg, batch_slots=2, max_len=MAX_LEN,
                                   lora=jl, max_live_adapters=2,
                                   **FEATURES[feature])
        toks = _serve(eng, {a: _to_jax(lp) for a, lp in loras.items()})
        _JAX_RUNS[feature] = (toks, {k: eng.stats()[k]
                                     for k in ADAPTER_KEYS})
    return _JAX_RUNS[feature]


@pytest.mark.parametrize("mode", ["greedy", "top_k"])
@pytest.mark.parametrize("feature", list(FEATURES))
def test_mixed_adapter_matrix(model, adapters, feature, mode):
    """Three adapters and base rows through one engine with room for
    two (eviction and prefetch round trips), shared-prefix prompts on
    the prefix variants: greedy tokens equal the JAX engine's and solo
    `generate` on merged weights; sampled tokens (top-k, a seed per
    request) equal the port's solo run; the adapter stats equal the JAX
    engine's; every slot reference drains."""
    tp = model[2]
    _, tloras, merged = adapters
    _, tl = _lcfgs()
    sample = {} if mode == "greedy" else dict(greedy=False, temperature=0.9,
                                              top_k=5)
    rngs = None if mode == "greedy" else [100 + i for i in range(5)]
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN, lora=tl,
                       max_live_adapters=2, **sample, **FEATURES[feature])
    got = _serve(eng, tloras, rngs=rngs)
    jtok, jstats = _jax_greedy(model, adapters, feature)
    for i, (p, n, a) in enumerate(zip(PROMPTS, BUDGETS, AIDS)):
        kw = {} if rngs is None else dict(sample, rng=rngs[i])
        want = _port_solo(tp if a is None else merged[a], p, n, **kw)
        assert got[i] == want, (i, a)
    if mode == "greedy":
        assert got == jtok
    s = eng.stats()
    assert {k: s[k] for k in ADAPTER_KEYS} == jstats
    assert s["adapter_evictions"] >= 1 and s["adapter_prefetches"] >= 3
    assert s["adapter_hits"] >= 1
    _drained(eng)
    if eng.paged:
        held = eng._prefix.blocks_in_use if eng._prefix is not None else 0
        assert eng.kv_pool.blocks_in_use == held


@pytest.mark.parametrize("preempt", ["swap", "recompute"])
def test_preempt_with_adapters_matches_jax(model, adapters, preempt):
    """A 10-block pool for four adapter rows: rows are preempted (and
    drop their slot pins) and come back; tokens, preemptions and adapter
    stats equal the JAX engine's, and every pin drains."""
    prompts = [[7, 8, 9, 10, 11], [3, 1, 4, 1, 5], [2, 7, 1, 8, 2],
               [9, 9, 8, 8, 7]]
    kw = dict(batch_slots=4, paged=True, kv_block_tokens=T,
              kv_pool_bytes=_pool_bytes(10), preempt=preempt)
    traffic = dict(prompts=prompts, aids=["ad0", "ad1", None, "ad2"],
                   budgets=[12] * 4)
    jtok, ttok, jeng, teng = _both(model, adapters, kw, **traffic)
    assert ttok == jtok
    assert teng.stats()["preemptions"] == jeng.stats()["preemptions"] >= 1
    _same_adapter_stats(jeng, teng)
    _drained(teng)
    assert teng.kv_pool.blocks_in_use == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_with_adapters_matches_jax(model, adapters, paged):
    """3-token prefill chunks (filler rows repeat the last real row's
    slot) with the prefix cache on: tokens and adapter stats equal the
    JAX engine's, and the merged solo runs."""
    kw = dict(prefill_chunk=3, prefix_cache=True)
    if paged:
        kw.update(paged=True, kv_block_tokens=T)
    jtok, ttok, jeng, teng = _both(model, adapters, kw)
    assert ttok == jtok
    tp, merged = model[2], adapters[2]
    for i, (p, n, a) in enumerate(zip(PROMPTS, BUDGETS, AIDS)):
        assert ttok[i] == _port_solo(tp if a is None else merged[a], p, n)
    assert teng.stats()["chunked_prefill_stalls"] >= 1
    _same_adapter_stats(jeng, teng)
    _drained(teng)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_base_rows_equal_plain_engine(model, paged):
    """A LoRA engine serving only base rows emits the plain engine's
    tokens (slot-0 deltas are exact zeros) and looks nothing up."""
    tp = model[2]
    _, tl = _lcfgs(ALL_TARGETS)
    kw = dict(batch_slots=2, max_len=MAX_LEN)
    if paged:
        kw.update(paged=True, kv_block_tokens=T)
    prompts, n = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2]], [5, 6, 4]
    plain = _serve(DecodeEngine(tp, TCFG, **kw), {}, prompts=prompts,
                   aids=[None] * 3, budgets=n)
    eng = DecodeEngine(tp, TCFG, lora=tl, max_live_adapters=2, **kw)
    eng.register_adapter("ad0", _rand_lora(ALL_TARGETS, 60))
    assert _serve(eng, {}, prompts=prompts, aids=[None] * 3,
                  budgets=n) == plain
    s = eng.stats()
    assert s["adapter_enabled"] == 1.0
    assert s["adapter_lookups"] == 0.0 and s["adapter_prefetches"] == 0.0


def test_zero_b_adapter_is_base(model):
    """A `lora_init` adapter (b = 0) on every target gives exactly the
    base tokens."""
    tp = model[2]
    _, tl = _lcfgs(ALL_TARGETS)
    prompts, n = [[5, 6, 7], [9, 8, 7, 6, 5]], [6, 6]
    plain = _serve(DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN),
                   {}, prompts=prompts, aids=[None] * 2, budgets=n)
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN, lora=tl)
    got = _serve(eng, {"z": tlora.lora_init(TCFG, tl, device="cpu")},
                 prompts=prompts, aids=["z", None], budgets=n)
    assert got == plain
    _drained(eng)


def test_cold_adapter_defers_then_decodes_like_jax(model, adapters):
    """scheduler="adapter": a cold adapter's request starts a prefetch,
    is deferred (counted) while the base request admits, then decodes
    the merged model's tokens; stats equal the JAX engine's."""
    kw = dict(scheduler="adapter", pipeline_depth=1)
    traffic = dict(prompts=[[1, 2, 3], [4, 5]], aids=["ad0", None],
                   budgets=[4, 4])
    jtok, ttok, jeng, teng = _both(model, adapters, kw, **traffic)
    assert ttok == jtok
    assert ttok[0] == _port_solo(adapters[2]["ad0"], [1, 2, 3], 4)
    s = teng.stats()
    assert s["adapter_prefetch_deferrals"] >= 1.0
    assert s["adapter_prefetches"] == 1.0
    _same_adapter_stats(jeng, teng)
    assert teng.scheduler.deferrals == jeng.scheduler.deferrals


def test_unregister_deferred_while_pinned(model, adapters):
    """An adapter pinned by a live row unregisters only when its row
    retires; an unpinned one leaves at once."""
    tp = model[2]
    _, tloras, _ = adapters
    _, tl = _lcfgs()
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN, lora=tl,
                       pipeline_depth=1)
    for a in ("ad0", "ad1"):
        eng.register_adapter(a, tloras[a])
    rid = eng.submit([1, 2, 3], 6, adapter_id="ad0")
    while not eng.adapter_resident("ad0") or \
            eng.row_req[0] is None:
        eng.step()
    assert eng.unregister_adapter("ad0") is False
    assert eng.unregister_adapter("ad1") is True
    eng.run()
    assert eng.adapter_pool.adapter_ids() == []
    assert rid not in eng.results
    _drained(eng)


def test_lora_with_draft_raises(model):
    tp = model[2]
    with pytest.raises(ValueError, match="mutually exclusive"):
        DecodeEngine(tp, TCFG, max_len=MAX_LEN, lora=_lcfgs()[1],
                     draft_params=tp, draft_cfg=TCFG)
    with pytest.raises(ValueError, match="max_live_adapters"):
        DecodeEngine(tp, TCFG, max_len=MAX_LEN, lora=_lcfgs()[1],
                     max_live_adapters=0)


def test_submit_adapter_checks(model):
    """adapter_id= raises ValueError without lora= and KeyError for an
    unregistered id (JAX's exceptions); register_adapter needs lora=."""
    tp = model[2]
    plain = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="lora="):
        plain.submit([1, 2], 2, adapter_id="any")
    with pytest.raises(ValueError, match="lora="):
        plain.register_adapter("any", {})
    assert not plain.adapter_resident("any")
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       lora=_lcfgs()[1])
    with pytest.raises(KeyError):
        eng.submit([1, 2], 2, adapter_id="nope")


def test_plain_engine_adapter_stats_zero(model):
    """Every adapter key is published, 0.0 without lora=, as in JAX."""
    jcfg, jp, tp, _ = model
    js = jengine.DecodeEngine(jp, jcfg, batch_slots=2,
                              max_len=MAX_LEN).stats()
    ts = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN).stats()
    for k in ADAPTER_KEYS:
        assert ts[k] == js[k] == 0.0, k


def test_adapter_trace_instants(model, adapters):
    """The pool's prefetch and eviction land in the engine trace as
    adapter_prefetch / adapter_evict instants on the events lane."""
    tp = model[2]
    _, tloras, _ = adapters
    _, tl = _lcfgs()
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN, lora=tl,
                       max_live_adapters=1, trace=EngineTracer())
    _serve(eng, tloras, prompts=[[1, 2], [3, 4], [5, 6]],
           aids=["ad0", "ad1", "ad2"], budgets=[3, 3, 3])
    names = [e[0] for e in eng.trace.events()]
    assert names.count("adapter_prefetch") == 3
    assert names.count("adapter_evict") == 2


# ---------------------------------------------------------------------------
# The adapter-only train step
# ---------------------------------------------------------------------------

def test_lora_train_steps_match_jax(model):
    """Three steps of make_lora_train_step + adamw(1e-2) against JAX's on
    a one-device mesh, from the same base and random adapters: loss and
    grad norm per step to 1e-4, the adapters after the last to 1e-5;
    the base bit-unchanged and never requires_grad."""
    jcfg, jparams, _, tree = model
    targets = ("wq", "wv", "w_gate")
    jl, tl = _lcfgs(targets)
    lp = _rand_lora(targets, 70)
    rng = np.random.RandomState(3)
    batch = {"tokens": rng.randint(0, 256, size=(2, 17)).astype(np.int32)}
    mesh = create_mesh({"dp": 1}, jax.devices()[:1])
    jinit, jstep = jlora.make_lora_train_step(
        lambda p, b: jllama.llama_loss(p, b, jcfg), optax.adamw(1e-2),
        mesh, jcfg, jl, jllama.llama_param_specs(jcfg))
    tinit, tstep = tlora.make_lora_train_step(
        lambda p, b: tllama.llama_loss(p, b, TCFG), ttrain.adamw(1e-2),
        TCFG, tl, device="cpu")
    jbase, jlp, jopt = jinit(jparams, _to_jax(lp))
    tbase, tlp, topt = tinit(params_from_numpy(tree, TCFG, device="cpu"),
                             lora_from_numpy(lp, TCFG, tl, device="cpu"))
    before = {k: v.clone() for k, v in tbase["layers"].items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        jlp, jopt, jm = jstep(jlp, jopt, jbase, jb)
        tlp2, topt, tm = tstep(tlp, topt, tbase, tb)
        assert tlp2 is tlp
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        losses.append(tm["loss"].item())
    assert losses[2] < losses[0], losses
    for g, w in zip(ttrain._leaves(tlp), jax.tree_util.tree_leaves(jlp)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    for k, v in tbase["layers"].items():
        assert torch.equal(v, before[k]) and not v.requires_grad


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graphs, B2 and the "
                    "flash kernels run only there")
    return torch.device("cuda")


def _card_model(cuda, **kw):
    cfg = tllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, ffn_dim=512,
                             max_seq_len=256, **kw)
    return cfg, tllama.llama_init(cfg, seed=3, device=cuda, dtype=cfg.dtype)


def _card_adapter(cfg, lcfg, seed, cuda):
    """A random adapter on the card: lora_init's A and a random B."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    lp = tlora.lora_init(cfg, lcfg, generator=g, device=cuda)
    for ab in lp["layers"].values():
        ab["b"].normal_(0.0, 0.05, generator=g)
    return lp


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graph_replay_after_recommit_matches_eager(cuda, paged):
    """One slot for three adapters on the card: every adapter request
    evicts the previous one and commits into the SAME slot, while the
    decode graphs captured for the first adapter keep replaying. The
    graphed engine and the same engine run eagerly (`_graphs = None`)
    emit the same tokens and adapter stats, B2 launches n_layers x
    decode iterations on both, and graphs were replayed after the
    re-commits."""
    cfg, params = _card_model(cuda)
    lcfg = tlora.LoraConfig(rank=8)
    loras = {f"ad{i}": _card_adapter(cfg, lcfg, 10 + i, cuda)
             for i in range(3)}
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 512, size=n).tolist()
               for n in (9, 30, 17, 5, 12)]
    aids = ["ad0", None, "ad1", "ad2", "ad0"]
    runs = []
    for graphed in (True, False):
        kw = dict(paged=True, kv_block_tokens=16) if paged else {}
        eng = DecodeEngine(params, cfg, batch_slots=2, max_len=128,
                           lora=lcfg, max_live_adapters=1, **kw)
        if not graphed:
            eng._graphs = None
        pak.launches = 0
        got = _serve(eng, loras, prompts=prompts, aids=aids,
                     budgets=[20, 12, 25, 16, 9])
        assert pak.launches == cfg.n_layers * eng.decode_iterations
        _drained(eng)
        runs.append((got, {k: eng.stats()[k] for k in ADAPTER_KEYS},
                     eng.stats()["decode_graph_replays"]))
    (g_toks, g_stats, replays), (e_toks, e_stats, _) = runs
    assert g_toks == e_toks
    assert g_stats == e_stats and g_stats["adapter_evictions"] >= 3
    assert replays > 0


@pytest.mark.gpu
def test_base_rows_equal_plain_engine_on_card(cuda):
    """bf16 on the card: the base rows of a mixed batch equal those rows
    of a plain engine serving the same prompts, token for token (a
    slot-0 delta is exactly 0 in bf16 too)."""
    cfg, params = _card_model(cuda)
    lcfg = tlora.LoraConfig(rank=8, targets=ALL_TARGETS)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 512, size=n).tolist() for n in (9, 30, 17, 5)]
    plain = _serve(DecodeEngine(params, cfg, batch_slots=4, max_len=128),
                   {}, prompts=prompts, aids=[None] * 4, budgets=[16] * 4)
    eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128, lora=lcfg)
    got = _serve(eng, {"ad0": _card_adapter(cfg, lcfg, 5, cuda)},
                 prompts=prompts, aids=["ad0", None, "ad0", None],
                 budgets=[16] * 4)
    assert got[1] == plain[1] and got[3] == plain[3]
    assert got[0] != plain[0] or got[2] != plain[2]


@pytest.mark.gpu
def test_lora_train_step_kernels_match_plain(cuda):
    """Two adapter-only steps on the card with the flash kernels (bf16)
    and with the plain attention, from the same base, adapters and
    batch: losses and grad norms within bf16 rounding (2e-2 relative).
    The kernel run launches the forward 2 x layers x steps (forward and
    its remat recompute) and dq, dk/dv layers x steps, as a full step
    does; the plain run launches none; the base stays unchanged."""
    from ray_tpu_torch.ops import flash_attention_kernel as fak

    lcfg = tlora.LoraConfig(rank=8, targets=("wq", "wv", "w_gate"))
    results = []
    for impl in ("kernel", "reference"):
        cfg, _ = _card_model(cuda, attn_impl=impl)
        base = tllama.llama_init(cfg, seed=3, device=cuda,
                                 dtype=torch.float32)
        init, step = tlora.make_lora_train_step(
            lambda p, b, c=cfg: tllama.llama_loss(p, b, c),
            ttrain.adamw(1e-2), cfg, lcfg, device=cuda)
        base, lp, opt = init(base, _card_adapter(cfg, lcfg, 7, cuda))
        before = base["layers"]["wq"].clone()
        tokens = torch.randint(0, 512, (2, 129), device=cuda,
                               generator=torch.Generator(
                                   device=cuda).manual_seed(1))
        fak.fwd_launches = fak.dq_launches = fak.dkv_launches = 0
        ms = []
        for _ in range(2):
            lp, opt, m = step(lp, opt, base, {"tokens": tokens})
            ms.append((m["loss"].item(), m["grad_norm"].item()))
        assert torch.equal(base["layers"]["wq"], before)
        results.append((ms, (fak.fwd_launches, fak.dq_launches,
                             fak.dkv_launches)))
    (k_ms, k_n), (r_ms, r_n) = results
    L = 2
    assert k_n == (2 * L * 2, L * 2, L * 2) and r_n == (0, 0, 0)
    np.testing.assert_allclose(np.array(k_ms), np.array(r_ms), rtol=2e-2)
