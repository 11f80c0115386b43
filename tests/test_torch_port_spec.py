"""PyTorch port, serving: speculative decoding (draft-propose /
target-verify) in the DecodeEngine and without it.

Mirrors tests/test_engine_spec.py. With the same seeded numpy weights
(target seed 0, an independent draft seed 1, or the target itself as a
perfect draft), the port's speculative engine emits the JAX speculative
engine's greedy tokens and solo `generate`'s on every layout and plane
(dense and paged, pipeline depths, chunked prefill, the prefix cache,
int8/fp8 pools, swap and recompute preemption), and its count stats
(dispatches, rounds, proposed, accepted, wasted, draft seedings) equal
the JAX engine's on the same run; a quantized draft plane holds the JAX
engine's bytes to ROADMAP Queue C4's tolerance. `_spec_accept`, one
dense or paged round and `speculative_generate` are held to their JAX
originals on the same inputs. Sampled rows equal the port's own solo
`generate` (the port's sampling stream is its own).

The `gpu` cases hold B2 at the round's shapes (S = 2, 3, 5 at head dim
128 and S = 1, 2 at 64, with overshoot slots past a row's chain) to its
plain version, a round's replayed graph to the engine run eagerly, and
the dense round on B2's block-table view to the plain round; they skip
without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_spec.py -q
"""

import faulthandler

import numpy as np
import pytest
import torch

try:        # the card's machine has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp
    from torch_port_helpers import numpy_params, to_torch

    from ray_tpu.models import engine as jengine
    from ray_tpu.models import generate as jgen
    from ray_tpu.models import llama as jllama
    from ray_tpu.models import scheduler as jsched
    from ray_tpu.models import speculative as jspec
    from ray_tpu.ops import kv_quant as jq
except ImportError:
    jax = None

from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import engine as tengine
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import scheduler as tsched
from ray_tpu_torch.models import speculative as tspec
from ray_tpu_torch.models.engine_trace import EngineTracer
from ray_tpu_torch.models.prefix_cache import block_bytes
from ray_tpu_torch.ops import kv_quant as tq
from ray_tpu_torch.ops import paged_attention_kernel as pak
from ray_tpu_torch.ops.attention import paged_attention
from ray_tpu_torch.util import metrics as tmetrics

TCFG = tllama.LlamaConfig.nano()
T = 4
MAX_LEN = 32
W = 4
PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2], [3, 1, 4, 1, 5, 9]]
BUDGETS = [4, 6, 3, 5]
# Shared-prefix traffic for the quantized pools: 2 blocks of 4 in common.
SHARED = [[7, 3, 9, 1, 4, 4, 2, 8] + s
          for s in ([11, 12], [13], [15, 16, 17], [19, 20])]
SHARED_BUDGETS = [6, 5, 7, 4]
PREEMPT_PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2, 3, 4]]
MODES = ["int8", "fp8_e4m3"]
# The count stats the JAX engine's stats() has for this plane; equal on
# a run.
SPEC_KEYS = ("spec_enabled", "spec_window", "spec_dispatches",
             "spec_rounds", "spec_proposed", "spec_accepted",
             "spec_acceptance_rate", "spec_window_effective",
             "spec_draft_tokens_wasted", "spec_prefill_dispatches",
             "decode_dispatches", "prefill_dispatches", "preemptions")
# ROADMAP Queue C4: the port's f32 K/V differ from the JAX engine's by a
# few ulps (torch's and XLA's cos/sin and rsqrt), so recomputed scales
# agree to a few ulps and a value at a rounding boundary may sit one
# step away.
SCALE_RTOL = 2e-6
MAX_STEP_FLIPS = 1e-3
# f32 nano K/V and logits, port against JAX: a few ulps (C4).
F32_RTOL, F32_ATOL = 1e-5, 1e-5


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
    """(JAX cfg, JAX target, JAX draft, port target, port draft): the
    draft's tree is converted apart from the target's."""
    jcfg = jllama.LlamaConfig.nano()
    tree, dtree = numpy_params(jcfg, seed=0), numpy_params(jcfg, seed=1)
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return (jcfg, to_jax(tree), to_jax(dtree),
            params_from_numpy(tree, TCFG, device="cpu"),
            params_from_numpy(dtree, TCFG, device="cpu"))


_SOLO: dict = {}


def _jax_solo(weights, prompt, n):
    """JAX solo greedy `generate` of the target (memoized per module)."""
    key = (tuple(prompt), n)
    if key not in _SOLO:
        jcfg, jp = weights[0], weights[1]
        out = jgen.generate(jp, jnp.asarray([prompt], jnp.int32), jcfg,
                            max_new_tokens=n)
        _SOLO[key] = np.asarray(out)[0, len(prompt):].tolist()
    return _SOLO[key]


def _port_solo(tp, prompt, n, **kw):
    out = tgen.generate(tp, torch.tensor([prompt]), TCFG, max_new_tokens=n,
                        **kw)
    return out[0, len(prompt):].tolist()


def _drive(eng, prompts, budgets, submit_kw=None, max_steps=300):
    ids = [eng.submit(p, n, **(submit_kw[i] if submit_kw else {}))
           for i, (p, n) in enumerate(zip(prompts, budgets))]
    for _ in range(max_steps):
        if not eng.pending():
            break
        eng.step()
    assert not eng.pending(), f"engine did not drain in {max_steps} steps"
    return [eng.pop_result(r) for r in ids]


def _pool_bytes(n_blocks, quant=None):
    if quant is None:
        return n_blocks * block_bytes(TCFG.n_layers, T, TCFG.n_kv_heads,
                                      TCFG.head_dim, 4)
    return n_blocks * (block_bytes(TCFG.n_layers, T, TCFG.n_kv_heads,
                                   TCFG.head_dim, 1)
                       + 2 * TCFG.n_layers * TCFG.n_kv_heads * 4)


def _both(weights, prompts, budgets, draft="independent", **kw):
    """The JAX and the port speculative engine on the same traffic:
    (JAX tokens, port tokens, JAX engine, port engine)."""
    jcfg, jp, jd, tp, td = weights
    if draft == "self":
        jd, td = jp, tp
    kw = dict(dict(batch_slots=2, max_len=MAX_LEN, spec_window=W), **kw)
    jeng = jengine.DecodeEngine(jp, jcfg, draft_params=jd, draft_cfg=jcfg,
                                **kw)
    teng = DecodeEngine(tp, TCFG, draft_params=td, draft_cfg=TCFG, **kw)
    return (_drive(jeng, prompts, budgets), _drive(teng, prompts, budgets),
            jeng, teng)


def _same_spec_stats(jeng, teng):
    js, ts = jeng.stats(), teng.stats()
    bad = {k: (js[k], ts[k]) for k in SPEC_KEYS if js[k] != ts[k]}
    assert not bad, bad


def _one_step(a, b, mode):
    """Quantized values a and b (as f32) equal or one step apart."""
    if mode == "int8":
        return np.abs(a - b) <= 1
    return np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) / 8 + 2 ** -9


def _assert_quant_close(pairs, mode):
    """[(jax values, port values, jax scales, port scales)]: scales to
    SCALE_RTOL, values within one step, at most MAX_STEP_FLIPS away."""
    flips = total = 0
    for jv, tv, js, ts in pairs:
        np.testing.assert_allclose(ts, js, rtol=SCALE_RTOL, atol=0)
        assert bool(_one_step(jv, tv, mode).all()), \
            "a stored value moved more than one quantization step"
        flips += int((jv != tv).sum())
        total += jv.size
    assert flips <= MAX_STEP_FLIPS * total, f"{flips} of {total} moved"


def _draft_planes(jeng, teng):
    """Both engines' quantized draft planes as f32 numpy, blocks
    1..NB-1 (block 0 takes overshoot garbage in no set order)."""
    out = []
    for pages, slab in (("_pool_dk", "_scale_dk"), ("_pool_dv", "_scale_dv")):
        out.append((
            np.asarray(jnp.asarray(getattr(jeng, pages)).astype(
                jnp.float32))[:, 1:],
            getattr(teng, pages).float().numpy()[:, 1:],
            np.asarray(getattr(jeng, slab))[:, 1:],
            getattr(teng, slab).numpy()[:, 1:].copy()))
    return out


# ---------------------------------------------------------------------------
# Token identity across the feature matrix
# ---------------------------------------------------------------------------

def _features():
    pb = _pool_bytes(40)
    return {
        "dense": {},
        "pipeline": dict(pipeline_depth=2),
        "chunked": dict(prefill_chunk=2),
        "prefix-dense": dict(prefix_cache=True, prefix_block=4),
        "paged": dict(paged=True, kv_block_tokens=T, kv_pool_bytes=pb),
        "paged+prefix": dict(paged=True, kv_block_tokens=T,
                             kv_pool_bytes=pb, prefix_cache=True),
        "paged+pipeline": dict(paged=True, kv_block_tokens=T,
                               kv_pool_bytes=pb, pipeline_depth=2),
    }


@pytest.mark.parametrize("feature", ["dense", "pipeline", "chunked",
                                     "prefix-dense", "paged",
                                     "paged+prefix", "paged+pipeline"])
def test_spec_identity_feature_matrix(weights, feature):
    """Independent draft (acceptance near 0, the hard case for cache
    alignment): tokens equal JAX solo greedy `generate` and the JAX
    speculative engine's, and the spec counts equal the JAX engine's."""
    jtoks, ttoks, jeng, teng = _both(weights, PROMPTS, BUDGETS,
                                     **_features()[feature])
    solo = [_jax_solo(weights, p, n) for p, n in zip(PROMPTS, BUDGETS)]
    assert ttoks == jtoks == solo
    _same_spec_stats(jeng, teng)
    s = teng.stats()
    assert s["spec_enabled"] == 1.0 and s["spec_dispatches"] >= 1
    assert s["spec_proposed"] >= s["spec_accepted"] >= 0
    if teng.paged:
        assert teng.kv_pool_d.blocks_in_use == 0
        assert s["spec_kv_pool_blocks_in_use"] == 0.0


# ---------------------------------------------------------------------------
# Quantized pools: both planes int8 / fp8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("plane", ["paged", "prefix", "chunked"])
def test_spec_quant_pool_matches_jax(weights, mode, plane):
    """int8/fp8 pools (the draft plane quantized too), plain, with the
    prefix cache and with chunked prefill, on shared-prefix traffic:
    tokens and spec counts equal the JAX engine's, and the draft plane's
    bytes equal JAX's to C4's tolerance."""
    kw = dict(paged=True, kv_block_tokens=T, kv_quant=mode,
              kv_pool_bytes=_pool_bytes(40, quant=mode))
    if plane == "prefix":
        kw.update(prefix_cache=True, scheduler="prefix")
    elif plane == "chunked":
        kw.update(prefill_chunk=4)
    jtoks, ttoks, jeng, teng = _both(weights, SHARED, SHARED_BUDGETS, **kw)
    assert ttoks == jtoks
    assert [len(t) for t in ttoks] == SHARED_BUDGETS
    _same_spec_stats(jeng, teng)
    if plane == "prefix":
        assert teng.stats()["prefix_hits"] >= 1
    _assert_quant_close(_draft_planes(jeng, teng), mode)


# ---------------------------------------------------------------------------
# Perfect draft, mixed lanes, eos
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_perfect_draft_full_acceptance(weights, paged):
    """Draft == target: every proposal verifies. Budgets of 20 (a
    multiple of W+1) truncate no round, so acceptance is exactly 1.0,
    nothing is wasted and the effective window is 4.0."""
    kw = dict(paged=True, kv_block_tokens=T, kv_pool_bytes=_pool_bytes(40)
              ) if paged else {}
    jtoks, ttoks, jeng, teng = _both(weights, PROMPTS[:2], [20, 20],
                                     draft="self", **kw)
    assert ttoks == jtoks == [_jax_solo(weights, p, 20)
                              for p in PROMPTS[:2]]
    s = teng.stats()
    assert s["spec_acceptance_rate"] == 1.0
    assert s["spec_draft_tokens_wasted"] == 0.0
    assert s["spec_window_effective"] == 4.0
    _same_spec_stats(jeng, teng)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_mixed_greedy_sampled(weights, paged):
    """A sampling engine with per-request greedy overrides: greedy rows
    ride speculation and equal JAX solo greedy; sampled rows take one
    sampled token per round and equal the port's solo sampled
    `generate` under the same seed."""
    _, _, _, tp, td = weights
    mode = dict(greedy=False, temperature=0.9, top_k=8)
    kw = dict(paged=True, kv_block_tokens=T, kv_pool_bytes=_pool_bytes(40)
              ) if paged else {}
    eng = DecodeEngine(tp, TCFG, batch_slots=4, max_len=MAX_LEN,
                       draft_params=td, draft_cfg=TCFG, spec_window=W,
                       **mode, **kw)
    sub = [dict(rng=100 + i, greedy=i % 2 == 0) for i in range(4)]
    got = _drive(eng, PROMPTS, BUDGETS, sub)
    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        want = (_jax_solo(weights, p, n) if i % 2 == 0
                else _port_solo(tp, p, n, rng=100 + i, **mode))
        assert got[i] == want, i
    assert eng.stats()["spec_dispatches"] >= 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_mid_window_eos(weights, paged):
    """An eos verified mid-window cuts the row exactly where solo stops;
    the freed slot serves the other request."""
    jcfg, jp, jd, _, _ = weights
    solo0 = _jax_solo(weights, [5, 6, 7], 8)
    eos = solo0[2]
    kw = dict(paged=True, kv_block_tokens=T, kv_pool_bytes=_pool_bytes(40)
              ) if paged else {}
    jtoks, ttoks, jeng, teng = _both(weights, [[5, 6, 7], [9, 8, 7, 6]],
                                     [8, 6], eos_id=eos, **kw)
    assert ttoks[0] == solo0[:solo0.index(eos) + 1]
    s1 = _jax_solo(weights, [9, 8, 7, 6], 6)
    if eos in s1:
        s1 = s1[:s1.index(eos) + 1]
    assert ttoks[1] == s1
    assert ttoks == jtoks
    _same_spec_stats(jeng, teng)


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preempt", ["swap", "recompute"])
@pytest.mark.parametrize("quant", ["float", "int8"])
def test_spec_preempt(weights, preempt, quant):
    """A 10-block pool forces preemption mid-decode (self-draft, 3
    slots): the victim's draft plane goes with its blocks and is seeded
    again from prompt + emitted at re-admission; tokens equal JAX solo
    greedy (float pool) and the JAX engine's, and preemptions
    happened."""
    mode = None if quant == "float" else quant
    kw = dict(batch_slots=3, paged=True, kv_block_tokens=T, kv_quant=mode,
              kv_pool_bytes=_pool_bytes(10, quant=mode), preempt=preempt)
    jtoks, ttoks, jeng, teng = _both(weights, PREEMPT_PROMPTS, [10] * 3,
                                     draft="self", **kw)
    assert ttoks == jtoks
    if mode is None:
        assert ttoks == [_jax_solo(weights, p, 10) for p in PREEMPT_PROMPTS]
    assert teng.stats()["preemptions"] >= 1
    _same_spec_stats(jeng, teng)
    assert teng.kv_pool_d.blocks_in_use == 0


# ---------------------------------------------------------------------------
# Guards, stats, policy, trace, metrics
# ---------------------------------------------------------------------------

def test_spec_submit_margin(weights):
    """A speculative engine needs spec_window slots above prompt +
    budget: 3 + 29 + 4 > 32 is refused at submit, 3 + 25 + 4 runs and
    equals solo greedy."""
    _, _, _, tp, td = weights
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       draft_params=td, draft_cfg=TCFG, spec_window=W)
    with pytest.raises(ValueError, match="spec_window"):
        eng.submit([1, 2, 3], 29)
    assert _drive(eng, [[1, 2, 3]], [25]) == \
        [_jax_solo(weights, [1, 2, 3], 25)]


def test_spec_off_stats_all_zero(weights):
    """An engine without a draft publishes every spec_* key, all 0.0,
    so rollups sum them blindly."""
    _, _, _, tp, _ = weights
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN)
    _drive(eng, [[5, 6, 7]], [4])
    s = eng.stats()
    for k in ("spec_enabled", "spec_window", "spec_dispatches",
              "spec_rounds", "spec_proposed", "spec_accepted",
              "spec_acceptance_rate", "spec_window_effective",
              "spec_draft_tokens_wasted", "spec_prefill_dispatches"):
        assert s[k] == 0.0, k


def test_spec_window_hint_matches_jax():
    """The default policy's per-row widths equal the JAX policy's on the
    same rates: a fresh row the full window, measured rows linear down
    to 1."""
    rates = [None, 1.0, 0.0, 0.5, 0.25, 0.74, 0.76, 0.1]
    for window in (1, 2, 4, 8):
        got = tsched.SchedulerPolicy().spec_window_hint(
            rates=rates, spec_window=window)
        assert got == jsched.SchedulerPolicy().spec_window_hint(
            rates=rates, spec_window=window)
    assert tsched.SchedulerPolicy().spec_window_hint(
        rates=[None, 1.0, 0.0, 0.5], spec_window=4) == [4, 4, 1, 3]


def test_spec_trace_spans_and_report(weights):
    """A traced speculative run emits the engine-lane spans, which
    `tools/trace_report.spec_summary` folds, apart from the per-request
    rows."""
    from tools.trace_report import request_breakdowns, spec_summary

    _, _, _, tp, td = weights
    tr = EngineTracer(engine_id="spec-tr")
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       draft_params=td, draft_cfg=TCFG, spec_window=W,
                       trace=tr)
    _drive(eng, [[5, 6, 7]], [5])
    events = tr.chrome_events()
    assert {"spec_draft", "spec_verify", "spec_draft_prefill"} <= \
        {e["name"] for e in events}
    s = spec_summary(events)
    st = eng.stats()
    assert s["spec_dispatches"] == st["spec_dispatches"] >= 1
    assert s["spec_rounds"] == st["spec_rounds"] >= 1
    assert s["spec_proposed"] == st["spec_proposed"] >= s["spec_accepted"]
    assert s["spec_prefills"] == st["spec_prefill_dispatches"] == 1
    rows = request_breakdowns(events)
    assert rows and all(r["e2e_s"] >= 0 for r in rows)


def test_spec_stats_reach_metrics_registry(weights):
    """The engine's spec counts reach the port's metrics registry (the
    engine-tagged llm_engine_spec_* series and the llm_spec_* series of
    its SpecMetrics), as do `speculative_generate`'s through a
    SpecMetrics."""
    _, _, _, tp, td = weights
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       draft_params=td, draft_cfg=TCFG, spec_window=W,
                       engine_id="spec-metrics-engine")
    _drive(eng, PROMPTS[:2], BUDGETS[:2])
    s = eng.stats()
    eng_rows = {r["name"]: r for r in tmetrics.snapshots()
                if r["tags"].get("engine") == "spec-metrics-engine"}
    assert eng_rows["llm_engine_spec_rounds_total"]["value"] == \
        s["spec_rounds"]
    assert eng_rows["llm_engine_spec_proposed_total"]["value"] == \
        s["spec_proposed"]
    assert eng_rows["llm_engine_spec_acceptance_rate"]["value"] == \
        pytest.approx(s["spec_acceptance_rate"])
    plane = {r["name"]: r for r in tmetrics.snapshots()
             if r["tags"].get("spec") == "spec-metrics-engine"}
    assert plane["llm_spec_rounds_total"]["value"] == s["spec_rounds"]
    # a counter's series appears at its first increment
    assert plane.get("llm_spec_accepted_total", {"value": 0.0})["value"] \
        == s["spec_accepted"]

    sm = tspec.SpecMetrics(spec_id="spec-plane-test")
    assert sm.stats()["acceptance_rate"] == 0.0
    _, stats = tspec.speculative_generate(
        tp, TCFG, td, TCFG, [[5, 6, 7]], max_new_tokens=8, window=2,
        metrics=sm)
    snap = sm.stats()
    assert (snap["calls"], snap["rounds"], snap["proposed"],
            snap["accepted"]) == (1.0, stats.rounds, stats.proposed,
                                  stats.accepted)
    rows = {r["name"]: r for r in tmetrics.snapshots()
            if r["tags"].get("spec") == "spec-plane-test"}
    assert rows["llm_spec_calls_total"]["value"] == 1
    assert rows["llm_spec_rounds_total"]["value"] == stats.rounds
    assert rows["llm_spec_proposed_total"]["value"] == stats.proposed
    assert rows["llm_spec_acceptance_rate"]["value"] == \
        pytest.approx(stats.acceptance_rate)


# ---------------------------------------------------------------------------
# _spec_accept on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 2, 4])
@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
def test_spec_accept_matches_jax(window, eos):
    """Seeded chunks where proposals match the verdict over random
    prefixes, an eos inside some windows, budgets that cut rounds, rows
    at the room limit, sampled and inactive rows, per-row width caps:
    every output of the port's `_spec_accept` equals JAX's."""
    rng = np.random.RandomState(10 * window + eos)
    B, V, max_len = 8, 6, 32
    eos_id = 3 if eos else None
    prop = rng.randint(0, V, size=(B, window))
    ver = rng.randint(0, V, size=(B, window + 1))
    for b in range(B):                 # matching prefixes of every length
        k = rng.randint(0, window + 1)
        ver[b, :k] = prop[b, :k]
    t0 = rng.randint(0, V, size=(B, 1))
    chunk = np.concatenate([t0, prop], axis=1)
    v_logits = rng.randn(B, window + 1, V).astype(np.float32)
    last_logits = rng.randn(B, V).astype(np.float32)
    row_len = rng.randint(3, max_len - window - 1, size=B)
    row_len[0] = max_len - 2                       # out of room mid-round
    active = rng.rand(B) > 0.15
    budget = rng.randint(1, 2 * window + 2, size=B)
    tok_idx = rng.randint(0, 9, size=B)
    d_tok = rng.randint(0, V, size=B)
    row_greedy = rng.rand(B) > 0.25
    w_row = rng.randint(1, window + 1, size=B)
    args = (chunk, prop, ver, v_logits, last_logits, row_len, active,
            budget, tok_idx, d_tok, row_greedy, w_row)
    jout = jengine._spec_accept(
        *[jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
          for a in args], window, eos_id, max_len)
    tout = tengine._spec_accept(*[torch.from_numpy(np.asarray(a))
                                  for a in args], window, eos_id, max_len)
    names = ("emits", "last_logits", "row_len", "active", "budget",
             "tok_idx", "d_lag", "d_tok")
    for name, j, t in zip(names, jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    assert tout[0].dtype == torch.int32 and tout[0].shape == (window + 1, B)


# ---------------------------------------------------------------------------
# One round on its own: dense, paged, int8
# ---------------------------------------------------------------------------

def _round_state(seed, paged, mode=None):
    """Seeded inputs of one round at B=3, W=4: random (quantized) cache
    or pool contents, live rows at ragged frontiers (one fully accepted
    last round, d_lag 1), one inactive row."""
    rng = np.random.RandomState(seed)
    B, L, KV, D = 3, TCFG.n_layers, TCFG.n_kv_heads, TCFG.head_dim
    st = dict(
        last_logits=rng.randn(B, TCFG.vocab_size).astype(np.float32),
        row_len=np.array([5, 11, 7]), active=np.array([True, True, False]),
        budget=np.array([9, 3, 4]), tok_idx=np.array([1, 4, 0]),
        d_lag=np.array([0, 1, 0]), d_tok=np.array([0, 17, 0]),
        row_keys=np.zeros((B, 2), np.int64),
        row_greedy=np.ones(B, bool), w_row=np.array([4, 4, 2]))
    if not paged:
        st["cache"] = [rng.randn(L, B, MAX_LEN, KV, D).astype(np.float32)
                       for _ in range(4)]          # k, v, draft k, draft v
        return st
    NB, MB = 16, MAX_LEN // T
    bt = np.zeros((B, MB), np.int32)
    bt[0, :4] = [1, 2, 3, 4]
    bt[1, :3] = [5, 6, 7]       # the live row's slots 12..15 (verify) and
    bt[2, :4] = [9, 10, 11, 12]  # 12..14 (draft) overshoot into block 0
    st["bt"], st["bt_d"] = bt, np.where(bt > 0, bt + 3, 0).astype(np.int32)
    pools = [rng.randn(L, NB, T, KV, D).astype(np.float32)
             for _ in range(4)]
    if mode is None:
        st["pools"] = pools
    else:
        qspec = jq.resolve_kv_quant(mode)
        st["pools"], st["scales"] = [], []
        for x in pools:
            s = jq.block_scale(jnp.max(jnp.abs(jnp.asarray(x)),
                                       axis=(2, 4)), qspec)
            st["pools"].append(np.asarray(jq.quantize(
                jnp.asarray(x), s[:, :, None, :, None], qspec)))
            st["scales"].append(np.asarray(s))
    return st


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_spec_round_matches_jax(weights, layout):
    """One `_spec_round` / `_spec_round_paged` from the same state: the
    emit block, the carry and every written cache slot (pages and
    scales for int8, held to C4's tolerance) equal JAX's."""
    jcfg, jp, jd, tp, td = weights
    paged = layout != "dense"
    mode = "int8" if layout == "int8" else None
    st = _round_state(3, paged, mode)
    lanes = ("last_logits", "row_len", "active", "budget", "tok_idx",
             "d_lag", "d_tok", "row_keys", "row_greedy", "w_row")
    jl = [jnp.asarray(st[k].astype(np.int32) if st[k].dtype == np.int64
                      else st[k]) for k in lanes]
    jl[7] = jnp.zeros((3, 2), jnp.uint32)
    tl = [torch.from_numpy(st[k].copy()) for k in lanes]
    tail = (1.0, )
    if not paged:
        jc = [jnp.asarray(x) for x in st["cache"]]
        tc = [torch.from_numpy(x.copy()) for x in st["cache"]]
        jout = jengine._spec_round(
            jp, jd, {"k": jc[0], "v": jc[1]}, {"k": jc[2], "v": jc[3]},
            *jl, *tail, jcfg, jcfg, W, True, None, None, None)
        (je, jcache, jdcache), jcarry = jout[:3], jout[3:]
        jbufs = [jcache["k"], jcache["v"], jdcache["k"], jdcache["v"]]
        tout = tengine._spec_round(
            tp, td, {"k": tc[0], "v": tc[1]}, {"k": tc[2], "v": tc[3]},
            *tl, *tail, TCFG, TCFG, W, True, None, None, None,
            max_len=MAX_LEN)
        tbufs = tc
    else:
        qspec = None if mode is None else jq.resolve_kv_quant(mode)
        jpools = [jnp.asarray(x) for x in st["pools"]]
        tpools = [to_torch(x) for x in st["pools"]]
        kw_j, kw_t = {}, {}
        if mode is not None:
            js = [jnp.asarray(x) for x in st["scales"]]
            ts = [torch.from_numpy(x.copy()) for x in st["scales"]]
            kw_j = dict(scale_k=js[0], scale_v=js[1], scale_dk=js[2],
                        scale_dv=js[3], qspec=qspec)
            kw_t = dict(scale_k=ts[0], scale_v=ts[1], scale_dk=ts[2],
                        scale_dv=ts[3], qspec=tq.resolve_kv_quant(mode))
        jout = jengine._spec_round_paged(
            jp, jd, *jpools, jnp.asarray(st["bt"]), jnp.asarray(st["bt_d"]),
            *jl, *tail, jcfg, jcfg, W, True, None, None, None, **kw_j)
        je, jbufs, jcarry = jout[0], list(jout[1:9]), jout[9:]
        tout = tengine._spec_round_paged(
            tp, td, *tpools, torch.from_numpy(st["bt"]),
            torch.from_numpy(st["bt_d"]), *tl, *tail, TCFG, TCFG, W, True,
            None, None, None, **kw_t)
        tbufs = tpools + ([ts[0], ts[1], ts[2], ts[3]] if mode else [])
        # pools: (k, v, dk, dv), then scales (k, v, dk, dv); block 0 takes
        # the overshoot of several rows in no set order
        jbufs = [jbufs[i] for i in (0, 1, 2, 3, 4, 5, 6, 7)
                 if jbufs[i] is not None]
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(je))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jcarry[0]),
                               rtol=F32_RTOL, atol=F32_ATOL)
    for j, t in zip(jcarry[1:], tout[2:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if mode is None:
        for j, t in zip(jbufs, tbufs):
            j, t = np.asarray(j), t.numpy()
            if paged:
                j, t = j[:, 1:], t[:, 1:]
            np.testing.assert_allclose(t, j, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        pairs = []
        for i in range(4):
            pairs.append((np.asarray(jbufs[i].astype(jnp.float32))[:, 1:],
                          tbufs[i].float().numpy()[:, 1:],
                          np.asarray(jbufs[4 + i])[:, 1:],
                          tbufs[4 + i].numpy()[:, 1:]))
        _assert_quant_close(pairs, mode)
    assert bool((tout[0][:, 2] == -1).all())      # the inactive row


# ---------------------------------------------------------------------------
# speculative_generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2], ids=["b1", "b2"])
@pytest.mark.parametrize("window", [1, 4], ids=["w1", "w4"])
def test_speculative_generate_matches_jax(weights, batch, window):
    """Solo speculative decoding with an eos taken from the solo stream:
    tokens and SpecStats equal JAX's, and greedy tokens equal solo
    greedy up to the eos."""
    jcfg, jp, jd, tp, td = weights
    prompts = [[5, 6, 7, 8], [9, 8, 7, 6]][:batch]
    solo = _jax_solo(weights, prompts[0], 12)
    eos = solo[5]
    jout, jstats = jspec.speculative_generate(
        jp, jcfg, jd, jcfg, jnp.asarray(prompts, jnp.int32),
        max_new_tokens=12, window=window, eos_id=eos)
    tout, tstats = tspec.speculative_generate(
        tp, TCFG, td, TCFG, prompts, max_new_tokens=12, window=window,
        eos_id=eos)
    assert tout.tolist() == np.asarray(jout).tolist()
    assert (tstats.rounds, tstats.proposed, tstats.accepted) == \
        (jstats.rounds, jstats.proposed, jstats.accepted)
    assert tout[0, 4:].tolist()[:solo.index(eos) + 1] == \
        solo[:solo.index(eos) + 1]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B2 and the round's graphs run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_b2_spec_shapes_against_plain(cuda):
    """B2 at a round's shapes — the verify pass's S = 2, 3, 5 at head dim
    128 and the draft's S = 1, 2 at 64 (32/8 heads) — with every row's
    last query slots running past its chain into the null block (which
    holds finite garbage), bf16, int8 and fp8 pages: held to the plain
    version within bf16 rounding (atol = rtol = 2e-2)."""
    B, H, KV, Tk, MB = 4, 32, 8, 32, 16
    for D, S in ((128, 2), (128, 3), (128, 5), (64, 1), (64, 2)):
        for pool in ("bf16", "int8", "fp8_e4m3"):
            g = torch.Generator(device=cuda).manual_seed(D + S)
            NB = 1 + B * MB
            q = torch.randn(B, S, H, D, generator=g, device=cuda).bfloat16()
            kf = torch.randn(NB, Tk, KV, D, generator=g, device=cuda)
            vf = torch.randn(NB, Tk, KV, D, generator=g, device=cuda)
            bt = torch.zeros(B, MB, dtype=torch.int32)
            q_slots = torch.zeros(B, S, dtype=torch.int32)
            for b in range(B):
                n_blk = 2 + 3 * b
                bt[b, :n_blk] = 1 + b * MB + torch.arange(n_blk)
                # the first query is the last slot of the chain
                q_slots[b] = n_blk * Tk - 1 + torch.arange(S)
            bt, q_slots = bt.to(cuda), q_slots.to(cuda)
            if pool == "bf16":
                kp, vp, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
                plain = (kp.float(), vp.float())
            else:
                spec = tq.resolve_kv_quant(pool)
                ks = tq.block_scale(kf.abs().amax(dim=(1, 3)), spec)
                vs = tq.block_scale(vf.abs().amax(dim=(1, 3)), spec)
                kp = tq.quantize(kf, ks[:, None, :, None], spec)
                vp = tq.quantize(vf, vs[:, None, :, None], spec)
                plain = (kp, vp)
            kw = dict(kv_valid_len=MB * Tk, k_scale=ks, v_scale=vs)
            before = pak.launches
            out = paged_attention(q, kp, vp, bt, q_slots, impl="kernel",
                                  **kw)
            assert pak.launches == before + 1
            ref = paged_attention(q.float(), *plain, bt, q_slots,
                                  impl="reference", **kw)
            torch.cuda.synchronize()
            out = out.float()
            assert torch.isfinite(out).all(), (D, S, pool)
            err = (out - ref).abs()
            assert bool((err <= 2e-2 + 2e-2 * ref.abs()).all()), \
                (D, S, pool, err.max().item())


def _card_model(cuda, seed, **kw):
    cfg = tllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, ffn_dim=512,
                             max_seq_len=256, **kw)
    return cfg, tllama.llama_init(cfg, seed=seed, device=cuda,
                                  dtype=cfg.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_graph_replay_matches_eager(cuda, paged):
    """A bf16 target and a 1-layer draft (head dim 64) on the card: the
    engine with its rounds replayed from CUDA graphs and the same engine
    run eagerly emit the same tokens and the same spec counts, B2
    launched n_layers x decode iterations + (L_target + L_draft x W)
    per round on both, and rounds were replayed."""
    cfg, params = _card_model(cuda, 3)
    dcfg = tllama.LlamaConfig(vocab_size=512, dim=256, n_layers=1,
                              n_heads=4, n_kv_heads=2, ffn_dim=512,
                              max_seq_len=256)
    dparams = tllama.llama_init(dcfg, seed=4, device=cuda, dtype=dcfg.dtype)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 512, size=n).tolist() for n in (9, 30, 17, 5)]
    budgets = [20, 12, 25, 16]
    runs = []
    for graphed in (True, False):
        kw = dict(paged=True, kv_block_tokens=16) if paged else {}
        eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128,
                           draft_params=dparams, draft_cfg=dcfg,
                           spec_window=W, **kw)
        if not graphed:
            eng._graphs = None
        pak.launches = 0
        got = _drive(eng, prompts, budgets)
        want = cfg.n_layers * eng.decode_iterations + sum(
            n * (cfg.n_layers + dcfg.n_layers * w)
            for w, n in eng.spec_dispatches_by_window.items())
        assert pak.launches == want
        runs.append((got, eng.stats()))
    (g_toks, g_stats), (e_toks, e_stats) = runs
    assert g_toks == e_toks
    for k in SPEC_KEYS:
        assert g_stats[k] == e_stats[k], k
    assert g_stats["decode_graph_replays"] > 0


@pytest.mark.gpu
def test_dense_round_b2_view_matches_plain(cuda):
    """The dense round on the card through B2's block-table view of
    both caches against the same round through the plain
    `_cached_attention`, from the same state, in f32 (B2's exact-FMA
    path, so near-ties cannot flip a token): equal emits and carry,
    caches and logits within f32 summation order."""
    cfg, params = _card_model(cuda, 5, dtype=torch.float32)
    B, span = 4, 128
    view_bt = torch.arange(B * span // 32, dtype=torch.int32,
                           device=cuda).view(B, span // 32)
    g = torch.Generator(device=cuda).manual_seed(5)
    shape = (cfg.n_layers, B, span, cfg.n_kv_heads, cfg.head_dim)
    caches = [torch.randn(shape, generator=g, device=cuda)
              for _ in range(4)]
    lanes = dict(
        last_logits=torch.randn(B, cfg.vocab_size, generator=g,
                                device=cuda),
        row_len=torch.tensor([5, 40, 77, 100], device=cuda),
        active=torch.ones(B, dtype=torch.bool, device=cuda),
        budget=torch.full((B,), 9, device=cuda),
        tok_idx=torch.zeros(B, dtype=torch.long, device=cuda),
        d_lag=torch.tensor([0, 1, 0, 1], device=cuda),
        d_tok=torch.tensor([0, 7, 0, 9], device=cuda),
        row_keys=torch.zeros(B, 2, dtype=torch.long, device=cuda),
        row_greedy=torch.ones(B, dtype=torch.bool, device=cuda),
        w_row=torch.full((B,), W, device=cuda))
    outs = []
    for view in (view_bt, None):
        c = [x.clone() for x in caches]
        lane_vals = [v.clone() for v in lanes.values()]
        out = tengine._spec_round(
            params, params, {"k": c[0], "v": c[1]}, {"k": c[2], "v": c[3]},
            *lane_vals, 1.0, cfg, cfg, W, True, None, None, None,
            max_len=span, view_bt=view)
        outs.append((out, c))
    (ko, kc), (po, pc) = outs
    for i in (0, 2, 3, 4, 5, 6, 7):
        assert torch.equal(ko[i], po[i]), i
    torch.testing.assert_close(ko[1], po[1], atol=1e-4, rtol=1e-4)
    for a, b in zip(kc, pc):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
