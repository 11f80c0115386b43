"""PyTorch port, serving: the dense DecodeEngine (the default), its async
run-ahead pipeline and the rest of `generate` on the CPU.

Token identity is the contract: with the same weights (seeded numpy
through `ray_tpu_torch.convert`), the port's dense engine emits the
greedy tokens of the JAX dense engine (``paged=False``) at pipeline
depths 1 and 2 and at pinned horizons 1, 2, 8 and the adaptive one;
sampled tokens equal the port's own solo `generate` (the port's noise is
not JAX's threefry stream). The pipeline gates mirror
tests/test_engine_horizon.py and tests/test_engine_pipeline.py: at most
two `_device_get` pulls per step, the next dispatch issued before the
previous block's pull, a flush before admission, overrun accounting and
an end-of-stream flush that strands nothing. `generate(prompt_live=)`,
`pad_prompts` and `generate_stream` equal the JAX functions.

The `gpu` cases hold the engine's replayed CUDA graphs to the same loop
run eagerly on the card, on both cache layouts; they skip without a
card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_dense.py -q
"""

import faulthandler

import numpy as np
import pytest
import torch

try:        # the card's machine has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp
    from torch_port_helpers import numpy_params

    from ray_tpu.models import engine as jengine
    from ray_tpu.models import generate as jgen
    from ray_tpu.models import llama as jllama
except ImportError:
    jax = None

from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import engine as tengine
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import paged_attention_kernel as pak

TCFG = tllama.LlamaConfig.nano()
MAX_LEN = 32
BUDGETS = [7, 4, 9, 5, 6]


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
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, params_from_numpy(tree, TCFG, device="cpu")


def _prompts(n=5, seed=7, lo=3, hi=9):
    """tests/test_engine_pipeline.py's mix: two prompts sharing an
    8-token prefix, then short ones."""
    rng = np.random.RandomState(seed)
    base = [rng.randint(1, TCFG.vocab_size, size=rng.randint(lo, hi))
            .tolist() for _ in range(n)]
    if n < 5:
        return base
    shared = list(range(3, 11))
    return [shared + p for p in base[:2]] + base[2:]


def _drive(eng, prompts, budgets, horizon=None, seeds=None):
    """Submit everything, step to empty; returns (tokens per request,
    the emitted dict of every step)."""
    ids = [eng.submit(p, n, **({} if seeds is None else {"rng": seeds[i]}))
           for i, (p, n) in enumerate(zip(prompts, budgets))]
    steps = []
    for _ in range(200):
        if not eng.pending():
            break
        steps.append(eng.step(horizon=horizon))
    assert not eng.pending(), "engine did not drain within 200 steps"
    return [eng.pop_result(r) for r in ids], steps


def _engine(tp, **kw):
    return DecodeEngine(tp, TCFG, **{"batch_slots": 2, "max_len": MAX_LEN,
                                     **kw})


# ---------------------------------------------------------------------------
# Token identity against the JAX dense engine
# ---------------------------------------------------------------------------

def test_defaults_are_the_jax_defaults(weights):
    _, _, tp = weights
    eng = DecodeEngine(tp, TCFG, max_len=MAX_LEN)
    assert not eng.paged and eng.pipeline_depth == 2
    assert eng.preempt_mode == "swap"
    assert eng.cache["k"].shape == (TCFG.n_layers, 8, MAX_LEN,
                                    TCFG.n_kv_heads, TCFG.head_dim)
    s = eng.stats()
    assert s["paged"] == 0.0 and s["pipeline_depth"] == 2.0
    assert s["host_lag_steps"] == 0.0 and eng.kv_free_blocks() == 0


@pytest.mark.parametrize("horizon", [1, 2, 8, None],
                         ids=["h1", "h2", "h8", "adaptive"])
@pytest.mark.parametrize("depth", [1, 2])
def test_greedy_tokens_identical_to_jax_dense_engine(weights, depth,
                                                     horizon):
    """Five requests through two slots churn admissions between
    pure-decode stretches; every step's emissions equal the JAX dense
    engine's at the same depth and horizon."""
    jcfg, jp, tp = weights
    jeng = jengine.DecodeEngine(jp, jcfg, batch_slots=2, max_len=MAX_LEN,
                                paged=False, pipeline_depth=depth)
    want, want_steps = _drive(jeng, _prompts(), BUDGETS, horizon)
    eng = _engine(tp, pipeline_depth=depth)
    got, got_steps = _drive(eng, _prompts(), BUDGETS, horizon)
    assert got == want
    assert got_steps == want_steps
    s = eng.stats()
    assert s["host_lag_steps"] == 0.0
    assert s["decode_dispatches"] == s["host_syncs"]
    assert s["tokens_generated"] == sum(BUDGETS)


@pytest.mark.parametrize("mode", [
    {"temperature": 0.9, "top_k": 5},
    {"temperature": 1.1, "top_p": 0.9}], ids=["top_k", "top_p"])
def test_sampled_tokens_identical_to_port_generate(weights, mode):
    _, _, tp = weights
    prompts = _prompts()
    seeds = [1000 + i for i in range(len(prompts))]
    eng = _engine(tp, greedy=False, **mode)
    got, _ = _drive(eng, prompts, BUDGETS, seeds=seeds)
    want = [tgen.generate(tp, torch.tensor([p]), TCFG, max_new_tokens=n,
                          greedy=False, rng=s, **mode)[0, len(p):].tolist()
            for p, n, s in zip(prompts, BUDGETS, seeds)]
    assert got == want


def test_mid_horizon_eos_retires_row_and_frees_slot(weights):
    """A row hitting eos inside a horizon freezes on the device, is
    retired by the host replay, and its slot serves the next request,
    which still decodes exactly."""
    _, _, tp = weights
    p0, p1 = [5, 6, 7], [9, 8, 7, 6]

    def solo(p, n):
        return tgen.generate(tp, torch.tensor([p]), TCFG,
                             max_new_tokens=n)[0, len(p):].tolist()

    solo0 = solo(p0, 8)
    eos = solo0[2]
    eng = _engine(tp, batch_slots=1, eos_id=eos, decode_horizon=8)
    r0 = eng.submit(p0, 8)
    r1 = eng.submit(p1, 6)
    ev0 = eng.step(horizon=8)
    assert ev0[r0] == solo0[:solo0.index(eos) + 1]
    assert r0 in eng.finished and eng.row_req[0] is None
    out = eng.run()
    solo1 = solo(p1, 6)
    assert out[r1] == (solo1[:solo1.index(eos) + 1] if eos in solo1
                       else solo1)


# ---------------------------------------------------------------------------
# Transfer and pipeline gates
# ---------------------------------------------------------------------------

def test_at_most_two_device_gets_per_step(weights, monkeypatch):
    _, _, tp = weights
    pulls = []
    real = tengine._device_get
    monkeypatch.setattr(tengine, "_device_get",
                        lambda x: pulls.append(1) or real(x))
    eng = _engine(tp, decode_horizon=8)
    for p, n in zip(_prompts(4, seed=3), [4, 6, 3, 5]):
        eng.submit(p, n)
    steps = 0
    while eng.pending():
        before = len(pulls)
        eng.step()
        steps += 1
        assert len(pulls) - before <= 2, \
            f"step {steps} pulled {len(pulls) - before} times"
    assert steps >= 2 and len(pulls) == eng.decode_dispatches


@pytest.mark.parametrize("depth", [1, 2])
def test_next_dispatch_issued_before_the_fetch(weights, monkeypatch, depth):
    """At depth 2 in a pure-decode stretch the second dispatch comes
    before the first block's pull; at depth 1 every pull comes before
    the next dispatch."""
    _, _, tp = weights
    events = []
    real_get, real_multi = tengine._device_get, tengine._decode_multi
    monkeypatch.setattr(tengine, "_device_get",
                        lambda x: events.append("get") or real_get(x))
    monkeypatch.setattr(
        tengine, "_decode_multi",
        lambda *a, **k: events.append("dispatch") or real_multi(*a, **k))
    eng = _engine(tp, pipeline_depth=depth, decode_horizon=4)
    for p in _prompts(2, seed=23):
        eng.submit(p, 12)
    eng.run()
    tail = events[events.index("dispatch") + 1:]
    if depth == 2:
        assert tail.index("dispatch") < tail.index("get"), events
    else:
        assert tail.index("get") < tail.index("dispatch"), events


def test_flush_before_admission(weights):
    _, _, tp = weights
    prompts = _prompts(3, seed=13)
    eng = _engine(tp, max_len=64, pipeline_depth=2, decode_horizon=4)
    a = eng.submit(prompts[0], 16)
    b = eng.submit(prompts[1], 16)
    eng.step()                 # admit both, then run ahead one block
    assert eng.stats()["host_lag_steps"] >= 1.0
    flushes = eng.stats()["pipeline_flushes"]
    c = eng.submit(prompts[2], 6)     # pending admission -> flush
    eng.step()
    assert eng.stats()["pipeline_flushes"] == flushes + 1
    out = eng.run()
    ref, _ = _drive(_engine(tp, max_len=64, pipeline_depth=1),
                    [prompts[2]], [6])
    assert out[c] == ref[0]
    assert len(out[a]) == 16 and len(out[b]) == 16


def test_end_of_stream_flush_strands_nothing(weights):
    _, _, tp = weights
    eng = _engine(tp, max_len=64, pipeline_depth=4, decode_horizon=2)
    got, _ = _drive(eng, _prompts(2, seed=17), [8, 8])
    assert all(len(t) == 8 for t in got)
    assert not eng.pending()
    s = eng.stats()
    assert s["host_lag_steps"] == 0.0
    assert s["decode_dispatches"] == s["host_syncs"]


def test_overrun_tokens_accounted(weights):
    """Uneven budgets in a pure-decode stretch: a row finishes while a
    chained block is in flight, and its masked iterations show up as
    overrun; the effective depth exceeds 1."""
    _, _, tp = weights
    eng = _engine(tp, max_len=64, pipeline_depth=2, decode_horizon=2)
    _drive(eng, _prompts(2, seed=19), [3, 17])
    s = eng.stats()
    assert s["pipeline_overrun_tokens"] > 0
    assert s["pipeline_depth_effective"] > 1.0


# ---------------------------------------------------------------------------
# The rest of generate: ragged batches, pad_prompts, streaming
# ---------------------------------------------------------------------------

_RAGGED = [[5, 6, 7], [9, 8, 7, 6, 5, 4, 3], [1, 2], [3, 1, 4, 1, 5]]


@pytest.mark.parametrize("kw", [{}, {"bucket_len": True},
                                {"pad_id": 3, "pad_batch_to": 6}],
                         ids=["plain", "bucket", "pad_batch"])
def test_pad_prompts_equal_jax(kw):
    got = tgen.pad_prompts(_RAGGED, **kw)
    want = jgen.pad_prompts(_RAGGED, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_ragged_generate_equals_jax(weights):
    jcfg, jp, tp = weights
    toks, live = tgen.pad_prompts(_RAGGED)
    want = np.asarray(jgen.generate(jp, jnp.asarray(toks), jcfg,
                                    max_new_tokens=6,
                                    prompt_live=jnp.asarray(live)))
    got = tgen.generate(tp, torch.from_numpy(toks).long(), TCFG,
                        max_new_tokens=6,
                        prompt_live=torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "ragged"])
def test_generate_stream_equals_jax(weights, ragged):
    jcfg, jp, tp = weights
    if ragged:
        toks, live = tgen.pad_prompts(_RAGGED)
    else:
        toks = np.random.RandomState(4).randint(
            1, TCFG.vocab_size, size=(3, 6)).astype(np.int32)
        live = None
    first = np.asarray(jgen.generate(jp, jnp.asarray(toks), jcfg,
                                     max_new_tokens=7))[:, toks.shape[1]:]
    eos = int(first[0, 3])          # row 0 stops early, the rest run on
    jlive = None if live is None else jnp.asarray(live)
    want = list(jgen.generate_stream(jp, jnp.asarray(toks), jcfg,
                                     max_new_tokens=7, eos_id=eos,
                                     prompt_live=jlive))
    tlive = None if live is None else torch.from_numpy(live)
    got = list(tgen.generate_stream(tp, torch.from_numpy(toks).long(), TCFG,
                                    max_new_tokens=7, eos_id=eos,
                                    prompt_live=tlive))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# On the card: replayed CUDA graphs against the same loop run eagerly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graphs and B2 run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graph_replay_tokens_equal_eager_on_card(cuda, paged):
    """A bf16 model with head dim 64 (B2's smallest): the engine's
    replayed graphs and the same engine with its graphs removed (every
    dispatch eager) emit the same tokens, with B2 launched n_layers
    times per decode iteration on both."""
    cfg = tllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, ffn_dim=512,
                             max_seq_len=256)
    params = tllama.llama_init(cfg, seed=2, device=cuda, dtype=cfg.dtype)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (5, 17, 40, 9, 23, 31)]
    budgets = [12, 20, 7, 16, 9, 24]
    runs = []
    for graphed in (True, False):
        eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128,
                           paged=paged, kv_block_tokens=16)
        if not graphed:
            eng._graphs = None
        pak.launches = 0
        got, _ = _drive(eng, prompts, budgets)
        assert pak.launches == cfg.n_layers * eng.decode_iterations
        runs.append((got, eng.stats()))
    (g_toks, g_stats), (e_toks, e_stats) = runs
    assert g_toks == e_toks
    assert [len(t) for t in g_toks] == budgets
    assert g_stats["decode_graph_replays"] > 0
    assert e_stats["decode_graph_replays"] == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_release_graphs_keeps_the_engine_serving(paged):
    """On the CPU the loop runs eagerly and holds no graph:
    `release_graphs` frees nothing, and the engine serves the same
    prompts again with the same tokens."""
    params = tllama.llama_init(TCFG, seed=3, device="cpu")
    eng = DecodeEngine(params, TCFG, batch_slots=2, max_len=MAX_LEN,
                       paged=paged, kv_block_tokens=4)
    prompts = [[5, 6, 7], [9, 8, 7, 6], [1, 2]]
    first, _ = _drive(eng, prompts, [5, 6, 4])
    eng.release_graphs()
    again, _ = _drive(eng, prompts, [5, 6, 4])
    assert first == again
    assert eng.stats()["decode_graphs"] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_release_graphs_then_recapture_on_card(cuda, paged):
    """`release_graphs` waits for the card and frees every captured
    decode graph (what a tp rank does before its NCCL group is
    destroyed); the engine's next dispatches capture again and emit the
    tokens of the first run."""
    cfg = tllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, ffn_dim=512,
                             max_seq_len=256)
    params = tllama.llama_init(cfg, seed=2, device=cuda, dtype=cfg.dtype)
    eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128,
                       paged=paged, kv_block_tokens=16)
    prompts = [[5, 6, 7, 8], list(range(1, 30)), [9] * 12]
    budgets = [10, 14, 6]
    first, _ = _drive(eng, prompts, budgets)
    assert eng.stats()["decode_graphs"] > 0
    eng.release_graphs()
    assert eng.stats()["decode_graphs"] == 0.0
    again, _ = _drive(eng, prompts, budgets)
    assert again == first
    assert eng.stats()["decode_graphs"] > 0
