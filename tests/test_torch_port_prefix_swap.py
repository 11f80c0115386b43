"""PyTorch port, serving: swap preemption, copy-on-write, the prefix cache
and chunked prefill.

Mirrors tests/test_engine_prefix.py and tests/test_engine_paged.py. With
the same seeded numpy weights, the port's engine (dense and paged,
chunked and not, prefix cache on) emits the JAX engine's greedy tokens
and solo `generate`'s, and its counters (prefix lookups and hits,
reused tokens, shares, copies, stalls, padding, swap bytes) equal the
JAX engine's on the same run; sampled streams equal the port's own solo
`generate`. Preempt-and-swap moves a row's blocks to the host and back
with tokens unchanged. The `PrefixCacheIndex` copy and the prefix
policy behave as the JAX originals.

The `gpu` case runs swap preemption under run-ahead at pipeline depth 2
on the card, against the unpreempted engine; it skips without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_prefix_swap.py -q
"""

import faulthandler

import numpy as np
import pytest
import torch

try:        # the card's machine has no JAX; only the gpu case runs there
    import jax
    import jax.numpy as jnp
    from torch_port_helpers import numpy_params

    from ray_tpu.models import engine as jengine
    from ray_tpu.models import generate as jgen
    from ray_tpu.models import llama as jllama
    from ray_tpu.models import prefix_cache as jprefix
except ImportError:
    jax = None

from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import scheduler as tsched
from ray_tpu_torch.models.block_pool import BlockPool
from ray_tpu_torch.models.prefix_cache import PrefixCacheIndex, block_bytes
from ray_tpu_torch.ops import paged_attention_kernel as pak

TCFG = tllama.LlamaConfig.nano()
T = 4
MAX_LEN = 32
PREFIX = [7, 3, 9, 1, 4, 4, 2, 8, 5, 6, 1, 2]        # 3 blocks of 4
SUFFIXES = [[11, 12], [13, 14], [15, 16], [17, 18], [19, 20]]
BUDGETS = [4, 6, 3, 5, 4]
TIGHT = [[7, 8, 9, 10, 11], [3, 1, 4, 1, 5], [2, 7, 1, 8, 2],
         [9, 9, 8, 8, 7]]
# Counters the JAX engine's stats() has for this plane; equal on a run.
PLANE_KEYS = ("prefix_lookups", "prefix_hits", "prefix_hit_rate",
              "prefix_reused_tokens", "prefix_reused_frac",
              "prefix_evictions", "prefix_copy_dispatches",
              "chunked_prefill_stalls", "kv_blocks_shared", "kv_block_cows",
              "preemptions", "swap_ins", "swap_outs", "swap_in_bytes",
              "swap_out_bytes", "prefill_real_tokens",
              "prefill_padded_tokens", "prefill_padding_waste_frac",
              "prefill_dispatches", "decode_dispatches",
              "pending_prefill_tokens", "kv_used_fraction",
              "kv_quant_enabled", "kv_bytes_per_token", "kv_bytes_per_block")


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
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, TCFG, device="cpu"))


def _drive(eng, prompts, budgets, seeds=None, max_steps=300):
    ids = [eng.submit(p, n, **({} if seeds is None else {"rng": seeds[i]}))
           for i, (p, n) in enumerate(zip(prompts, budgets))]
    for _ in range(max_steps):
        if not eng.pending():
            break
        eng.step()
    assert not eng.pending(), f"engine did not drain in {max_steps} steps"
    return [eng.pop_result(r) for r in ids]


def _pool_bytes(n_blocks):
    return n_blocks * block_bytes(TCFG.n_layers, T, TCFG.n_kv_heads,
                                  TCFG.head_dim, 4)


def _jax_solo(jp, jcfg, prompt, n):
    out = jgen.generate(jp, jnp.asarray([prompt], jnp.int32), jcfg,
                        max_new_tokens=n)
    return np.asarray(out)[0, len(prompt):].tolist()


def _port_solo(tp, prompt, n, **kw):
    out = tgen.generate(tp, torch.tensor([prompt]), TCFG, max_new_tokens=n,
                        **kw)
    return out[0, len(prompt):].tolist()


def _both(weights, prompts, budgets, **kw):
    """The JAX and the port engine on the same traffic: (JAX tokens,
    port tokens, JAX engine, port engine)."""
    jcfg, jp, tp = weights
    kw = {"max_len": MAX_LEN, **kw}
    jeng = jengine.DecodeEngine(jp, jcfg, **kw)
    teng = DecodeEngine(tp, TCFG, **kw)
    return (_drive(jeng, prompts, budgets), _drive(teng, prompts, budgets),
            jeng, teng)


def _same_plane_stats(jeng, teng):
    js, ts = jeng.stats(), teng.stats()
    bad = {k: (js[k], ts[k]) for k in PLANE_KEYS if js[k] != ts[k]}
    assert not bad, bad


# ---------------------------------------------------------------------------
# Token identity: dense/paged x chunked, prefix cache on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def matrix(weights):
    """The prefix identity matrix's JAX and port runs, by (layout,
    chunked), and JAX solo generate's tokens."""
    jcfg, jp, _ = weights
    prompts = [PREFIX + s for s in SUFFIXES]
    runs = {}
    for paged in (False, True):
        for chunked in (False, True):
            kw = dict(batch_slots=2, prefix_cache=True, scheduler="prefix",
                      prefill_chunk=4 if chunked else None)
            kw.update(dict(paged=True, kv_block_tokens=T) if paged
                      else dict(prefix_block=T))
            runs[(paged, chunked)] = _both(weights, prompts, BUDGETS, **kw)
    solo = [_jax_solo(jp, jcfg, p, n) for p, n in zip(prompts, BUDGETS)]
    return prompts, runs, solo


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("chunked", [False, True],
                         ids=["unchunked", "chunked"])
def test_prefix_identity_matrix(matrix, paged, chunked):
    """Five requests sharing a 3-block system prompt through two slots,
    prefix-affinity scheduling, cache on (+ chunked prefill): tokens
    equal the JAX engine's and solo generate's; warm admissions reused
    the prefix; the plane's counters equal JAX's."""
    _, runs, solo = matrix
    jtoks, ttoks, jeng, teng = runs[(paged, chunked)]
    assert ttoks == jtoks == solo
    s = teng.stats()
    assert s["prefix_hits"] >= 1 and s["prefix_reused_tokens"] >= 12
    if chunked:
        assert s["chunked_prefill_stalls"] >= 1
    _same_plane_stats(jeng, teng)
    if paged:
        # every retired row returned its blocks: only the trie holds any
        assert teng.kv_pool.blocks_in_use == teng._prefix.blocks_in_use
        assert s["prefix_copy_dispatches"] == 0
    else:
        assert s["prefix_copy_dispatches"] >= 2


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefix_identity_sampled(weights, paged):
    """Sampled (top-k) streams under the prefix cache and chunking equal
    the port's own solo generate under the same per-request seeds."""
    _, _, tp = weights
    prompts = [PREFIX + s for s in SUFFIXES]
    mode = dict(greedy=False, temperature=0.9, top_k=8)
    seeds = [300 + i for i in range(len(prompts))]
    kw = dict(paged=True, kv_block_tokens=T) if paged else {}
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       prefix_cache=True, prefix_block=T, scheduler="prefix",
                       prefill_chunk=4, **mode, **kw)
    got = _drive(eng, prompts, BUDGETS, seeds)
    assert got == [_port_solo(tp, p, n, rng=s, **mode)
                   for p, n, s in zip(prompts, BUDGETS, seeds)]


def test_chunked_identity_without_prefix_cache(weights):
    """prefill_chunk alone (cache off) keeps the tokens."""
    prompts = [PREFIX + s for s in SUFFIXES[:3]]
    jtoks, ttoks, jeng, teng = _both(weights, prompts, [4] * 3,
                                     batch_slots=2, prefill_chunk=4)
    assert ttoks == jtoks
    assert teng.stats()["chunked_prefill_stalls"] >= 1
    _same_plane_stats(jeng, teng)


def test_prefix_identity_under_eviction_pressure(weights):
    """Dense: a prefix pool of 6 blocks for 4 prefixes x 2 blocks; LRU
    eviction recycles blocks and the tokens stay the JAX engine's."""
    rng = np.random.RandomState(3)
    prompts = []
    for i in range(4):
        pref = rng.randint(1, TCFG.vocab_size, size=8).tolist()
        prompts += [pref + [30 + i], pref + [40 + i]]
    jtoks, ttoks, jeng, teng = _both(
        weights, prompts, [3] * len(prompts), batch_slots=1,
        prefix_cache=True, prefix_block=T, prefix_cache_bytes=_pool_bytes(6))
    assert ttoks == jtoks
    s = teng.stats()
    assert s["prefix_evictions"] > 0
    assert s["prefix_blocks_total"] == 6.0 and s["prefix_blocks_in_use"] <= 6
    _same_plane_stats(jeng, teng)


# ---------------------------------------------------------------------------
# Efficiency gates
# ---------------------------------------------------------------------------

def test_warm_admission_runs_zero_full_prompt_prefill(weights):
    """Dense: after a cold request seeds the trie, a same-prefix request
    (every full block cached) prefills only its 1-token suffix and
    copies the 16-token prefix in."""
    jcfg, jp, tp = weights
    prefix = list(range(1, 17))
    eng = DecodeEngine(tp, TCFG, batch_slots=1, max_len=MAX_LEN,
                       prefix_cache=True, prefix_block=T)
    assert _drive(eng, [prefix + [21]], [3]) == \
        [_jax_solo(jp, jcfg, prefix + [21], 3)]
    real0, reused0 = eng.prefill_real_tokens, eng.prefix_reused_tokens
    assert _drive(eng, [prefix + [22]], [3]) == \
        [_jax_solo(jp, jcfg, prefix + [22], 3)]
    assert eng.prefill_real_tokens - real0 == 1
    assert eng.prefix_reused_tokens - reused0 == 16
    s = eng.stats()
    assert s["prefix_hit_rate"] == 0.5
    assert s["prefix_copy_dispatches"] >= 2       # out (cold) + in


def test_warm_admission_is_zero_copy(weights):
    """Paged: a warm admission shares the 3 committed blocks by incref,
    with no copy and no copy-on-write (its suffix is not aligned)."""
    jcfg, jp, tp = weights
    sys_p = list(range(1, 13))
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN, paged=True,
                       kv_block_tokens=T, prefix_cache=True)
    _drive(eng, [sys_p + [50, 51]], [4])
    s0 = eng.stats()
    assert _drive(eng, [sys_p + [60, 61, 62]], [4]) == \
        [_jax_solo(jp, jcfg, sys_p + [60, 61, 62], 4)]
    s1 = eng.stats()
    assert s1["prefix_hits"] - s0["prefix_hits"] == 1
    assert s1["kv_blocks_shared"] - s0["kv_blocks_shared"] == 3
    assert s1["prefix_copy_dispatches"] == s0["prefix_copy_dispatches"] == 0
    assert s1["kv_block_cows"] == s0["kv_block_cows"] == 0
    assert s1["prefix_reused_tokens"] - s0["prefix_reused_tokens"] == 12


def test_full_prompt_hit_pays_one_cow_block(weights):
    """Paged: a prompt that IS a committed chain shares all but its tail
    block, which is copied once; the prefill recomputes one token."""
    jcfg, jp, tp = weights
    sys_p = list(range(1, 13))
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN, paged=True,
                       kv_block_tokens=T, prefix_cache=True)
    cold = _drive(eng, [sys_p], [4])
    s0 = eng.stats()
    assert _drive(eng, [sys_p], [4]) == cold == \
        [_jax_solo(jp, jcfg, sys_p, 4)]
    s1 = eng.stats()
    assert s1["kv_block_cows"] - s0["kv_block_cows"] == 1
    assert s1["kv_blocks_shared"] - s0["kv_blocks_shared"] == 2
    assert s1["prefill_real_tokens"] - s0["prefill_real_tokens"] == 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_interleaves_with_decode(weights, paged):
    """While a 13-token prompt advances in 4-token chunks, the live row
    keeps emitting every step, and the stall counter records it."""
    jcfg, jp, tp = weights
    kw = dict(paged=True, kv_block_tokens=T) if paged else {}
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       prefill_chunk=4, **kw)
    ra = eng.submit([5, 6, 7], 12)
    eng.step()
    long_prompt = list(range(1, 14))
    rb = eng.submit(long_prompt, 3)
    during = 0
    while rb not in eng.finished and ra not in eng.finished:
        during += len(eng.step().get(ra, []))
    out = eng.run()
    assert out[ra] == _jax_solo(jp, jcfg, [5, 6, 7], 12)
    assert out[rb] == _jax_solo(jp, jcfg, long_prompt, 3)
    assert during >= 2
    assert eng.chunked_prefill_stalls >= 2


def test_prefill_padding_waste_metric(weights):
    """A 3-wide same-bucket group pads to 4 rows (the last repeated):
    real 9, padded 4*4-9 = 7, as in the JAX engine."""
    _, ttoks, jeng, teng = _both(weights, [[5, 6, 7], [9, 8, 7], [1, 2, 3]],
                                 [3] * 3, batch_slots=4)
    s = teng.stats()
    assert s["prefill_real_tokens"] == 9.0
    assert s["prefill_padded_tokens"] == 7.0
    assert s["prefill_padding_waste_frac"] == pytest.approx(7 / 16)
    _same_plane_stats(jeng, teng)


def test_pending_prefill_tokens(weights):
    """Queued prompts plus the uncovered suffix of a mid-chunk row."""
    _, _, tp = weights
    eng = DecodeEngine(tp, TCFG, batch_slots=1, max_len=MAX_LEN,
                       prefill_chunk=4)
    eng.submit(list(range(1, 14)), 3)
    eng.submit([5, 6, 7], 3)
    assert eng.pending_prefill_tokens() == 16
    eng.step()                                  # first chunk of 4
    assert eng.pending_prefill_tokens() == 9 + 3
    assert eng.stats()["pending_prefill_tokens"] == 12.0
    eng.run()
    assert eng.pending_prefill_tokens() == 0


# ---------------------------------------------------------------------------
# Prefix-affinity scheduling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefix_policy_defers_followers_then_admits_warm(weights, paged):
    """A burst of 3 same-prefix requests into 3 free slots: one cold
    leader the first step, both followers warm the next."""
    jcfg, jp, tp = weights
    prompts = [PREFIX[:8] + [s] for s in (31, 32, 33)]
    kw = dict(paged=True, kv_block_tokens=T) if paged else {}
    eng = DecodeEngine(tp, TCFG, batch_slots=3, max_len=MAX_LEN,
                       prefix_cache=True, prefix_block=T, scheduler="prefix",
                       **kw)
    ids = [eng.submit(p, 4) for p in prompts]
    eng.step()
    assert sum(r is not None for r in eng.row_req) == 1
    assert len(eng.scheduler) == 2
    eng.step()
    assert len(eng.scheduler) == 0
    assert eng.prefix_hits == 2 and eng.prefix_reused_tokens == 16
    out = eng.run()
    for rid, p in zip(ids, prompts):
        assert out[rid] == _jax_solo(jp, jcfg, p, 4)


def test_prefix_policy_without_probe_is_fifo():
    pol = tsched.make_policy("prefix")
    assert isinstance(pol, tsched.PrefixAffinityPolicy)
    reqs = [type("R", (), {"req_id": i, "prompt": [i]})() for i in range(3)]
    for r in reqs:
        pol.push(r)
    assert [pol.pop().req_id for _ in range(3)] == [0, 1, 2]


def test_prefix_policy_pop_returns_none_when_all_deferred():
    pol = tsched.PrefixAffinityPolicy()
    pol.attach_prefix_probe(lambda prompt: (0, ("g",), False))
    for i in range(3):
        pol.push(type("R", (), {"req_id": i, "prompt": [1, 2]})())
    pol.begin_admission_round()
    assert pol.pop().req_id == 0          # cold leader
    assert pol.pop() is None              # followers defer
    assert len(pol) == 2 and pol.deferrals == 2
    pol.begin_admission_round()
    assert pol.pop().req_id == 1


# ---------------------------------------------------------------------------
# PrefixCacheIndex: the port's copy against the JAX original
# ---------------------------------------------------------------------------

def _index_trace(mod_index, mod_pool):
    """One operation sequence on an index: match, extend, commit,
    eviction by extend, then the paged register/evict cycle. Returns
    every observable result."""
    idx = mod_index(block_tokens=4, n_blocks=4)          # 3 usable
    p = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    log = [idx.match(p)]
    created = idx.extend(p)
    log.append([(j, n.block_id, n.committed) for j, n in created])
    log.append(idx.match(p))
    for _, n in created:
        idx.commit(n)
    log += [idx.match(p), idx.match([1, 2, 3, 4, 5, 6, 7, 8]),
            idx.match([1, 2, 3, 4, 5, 6, 7, 8], allow_full=True)]
    for _, n in idx.extend([1, 2, 3, 4, 9, 9, 9, 9]):
        idx.commit(n)
    log.append(idx.blocks_in_use)
    log.append([(j, n.block_id) for j, n in idx.extend([9, 8, 7, 6, 5])])
    log += [idx.evictions, idx.blocks_in_use, idx.blocks_total]
    pool = mod_pool(8)
    pidx = mod_index(block_tokens=4, n_blocks=8, pool=pool)
    chain = pool.alloc(3)
    nodes = pidx.register(list(range(12)), chain)
    log.append([(j, n.block_id) for j, n in nodes])
    for _, n in nodes:
        pidx.commit(n)
    log.append(pidx.evictable_blocks())
    pool.decref(chain)
    log += [pidx.evictable_blocks(), pidx.evict_one(), pool.free_blocks,
            pidx.match(list(range(12)), allow_full=True, peek=True)]
    return log


def test_prefix_index_match_extend_commit_evict():
    from ray_tpu.models import block_pool as jbp

    got = _index_trace(PrefixCacheIndex, BlockPool)
    assert got == _index_trace(jprefix.PrefixCacheIndex, jbp.BlockPool)
    assert got[0] == ([], False) and got[2] == ([], True)
    assert len(got[3][0]) == 2 and 0 not in got[3][0]
    assert len(got[4][0]) == 1            # one suffix token always left
    assert got[8] == 1                    # eviction made room


def test_prefix_index_validation():
    with pytest.raises(ValueError, match="n_blocks"):
        PrefixCacheIndex(block_tokens=4, n_blocks=1)
    with pytest.raises(ValueError, match="block_tokens"):
        PrefixCacheIndex(block_tokens=0, n_blocks=4)
    with pytest.raises(ValueError, match="pool"):
        PrefixCacheIndex(block_tokens=4, n_blocks=4).register([1] * 4, [1])


def test_referenced_blocks_never_evicted_property():
    """Random register/match/incref/decref/evict traffic on the port's
    pool + trie: a block a live row holds is never freed, and teardown
    returns every block."""
    rng = np.random.RandomState(0)
    pool = BlockPool(24)
    idx = PrefixCacheIndex(block_tokens=4, n_blocks=24, pool=pool)
    live = []
    for _ in range(300):
        op = rng.randint(4)
        if op == 0 and pool.free_blocks >= 3:
            prompt = rng.randint(1, 50, size=4 * rng.randint(1, 4)).tolist()
            need = len(prompt) // 4
            ids, _ = idx.match(prompt, allow_full=True)
            shared = ids[:need]
            pool.incref(shared)
            fresh = pool.alloc(need - len(shared))
            if fresh is None:
                pool.decref(shared)
                continue
            chain = shared + fresh
            for _, node in idx.register(prompt, chain):
                idx.commit(node)
            live.append(chain)
        elif op == 1 and live:
            pool.decref(live.pop(rng.randint(len(live))))
        elif op == 2:
            idx.evict_one()
        else:
            for b in set(b for row in live for b in row):
                assert pool.ref(b) >= 1, f"block {b} held but free"
    for row in live:
        pool.decref(row)
    while idx.evict_one():
        pass
    assert pool.blocks_in_use == 0
    assert pool.free_blocks == pool.blocks_total


# ---------------------------------------------------------------------------
# Preemption: swap and recompute, tight pools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tight_runs(weights):
    """The four-row tight workload (each row grows to 5 blocks of a
    10-block pool): JAX swap, port swap, port recompute, port
    unpreempted; and JAX solo generate."""
    jcfg, jp, tp = weights
    kw = dict(batch_slots=4, max_len=MAX_LEN, paged=True, kv_block_tokens=T)
    tight = dict(kw, kv_pool_bytes=_pool_bytes(10))
    jeng = jengine.DecodeEngine(jp, jcfg, **tight)
    swap = DecodeEngine(tp, TCFG, **tight)
    rec = DecodeEngine(tp, TCFG, preempt="recompute", **tight)
    ample = DecodeEngine(tp, TCFG, **kw)
    toks = {name: _drive(e, TIGHT, [12] * 4)
            for name, e in (("jax", jeng), ("swap", swap),
                            ("recompute", rec), ("ample", ample))}
    solo = [_jax_solo(jp, jcfg, p, 12) for p in TIGHT]
    return toks, solo, jeng, swap, rec


def test_preempt_and_swap_round_trip_identity(tight_runs):
    """Greedy tokens under swap equal those under recompute, the
    unpreempted run's, the JAX engine's and solo generate's; the swap
    ledger drains and every block returns."""
    toks, solo, jeng, swap, _ = tight_runs
    assert toks["swap"] == toks["recompute"] == toks["ample"] == \
        toks["jax"] == solo
    s = swap.stats()
    assert s["preemptions"] >= 1 and s["swap_outs"] == s["preemptions"]
    assert s["swap_ins"] == s["swap_outs"]
    assert s["swap_out_bytes"] == s["swap_in_bytes"] > 0
    assert s["requests_swapped"] == 0.0
    assert swap.kv_pool.blocks_in_use == 0
    _same_plane_stats(jeng, swap)


def test_preempt_recompute_identity(tight_runs):
    toks, solo, _, _, rec = tight_runs
    assert toks["recompute"] == solo
    s = rec.stats()
    assert s["preemptions"] >= 1
    assert s["swap_out_bytes"] == 0.0 and s["swap_in_bytes"] == 0.0


def test_preempt_and_swap_sampled_identity(weights):
    """Sampled rows resume their streams across a swap: tokens equal the
    port's own solo generate under the same seeds."""
    _, _, tp = weights
    mode = dict(greedy=False, temperature=0.9, top_k=5)
    seeds = [2300 + i for i in range(4)]
    eng = DecodeEngine(tp, TCFG, batch_slots=4, max_len=MAX_LEN, paged=True,
                       kv_block_tokens=T, kv_pool_bytes=_pool_bytes(10),
                       **mode)
    got = _drive(eng, TIGHT, [12] * 4, seeds)
    assert got == [_port_solo(tp, p, 12, rng=s, **mode)
                   for p, s in zip(TIGHT, seeds)]
    assert eng.stats()["swap_outs"] >= 1


def test_tight_pool_with_shared_prefix_trie_terminates(weights):
    """A 7-block pool, rows needing 6 blocks of which 3 a shared trie
    chain: the admission gate counts cascade-evictable trie chains, so
    the engine evicts, swaps and finishes in bounded steps with the JAX
    engine's tokens."""
    jcfg, jp, tp = weights
    shared = list(range(1, 13))
    rng = np.random.RandomState(5)
    prompts = [shared + rng.randint(1, TCFG.vocab_size, size=3).tolist()
               for _ in range(6)]
    kw = dict(batch_slots=3, max_len=MAX_LEN, paged=True, kv_block_tokens=T,
              kv_pool_bytes=_pool_bytes(7), prefix_cache=True)
    eng = DecodeEngine(tp, TCFG, **kw)
    got = _drive(eng, prompts, [6] * 6, max_steps=500)
    assert got == [_jax_solo(jp, jcfg, p, 6) for p in prompts]
    assert eng.stats()["preemptions"] >= 1


def test_submit_rejects_request_larger_than_pool(weights):
    _, _, tp = weights
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN, paged=True,
                       kv_block_tokens=T, kv_pool_bytes=_pool_bytes(3))
    with pytest.raises(ValueError, match="pool"):
        eng.submit(list(range(1, 9)), 12)
    with pytest.raises(ValueError, match="prefill_chunk"):
        DecodeEngine(tp, TCFG, max_len=MAX_LEN, prefill_chunk=0)


# ---------------------------------------------------------------------------
# On the card: swap preemption under run-ahead
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graphs and B2 run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_swap_under_run_ahead_on_card(cuda, kv_quant):
    """A bf16 model (head dim 64) on a pool too small for its rows at
    pipeline depth 2: the engine preempts with the ring drained, swaps
    rows to pinned host memory and back, and emits the tokens of the
    same engine on an ample pool, with B2 launched n_layers times per
    decode iteration."""
    cfg = tllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, ffn_dim=512,
                             max_seq_len=256)
    params = tllama.llama_init(cfg, seed=3, device=cuda, dtype=cfg.dtype)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (20, 33, 17, 40)]
    budgets = [40, 36, 44, 30]
    kw = dict(batch_slots=4, max_len=128, paged=True, kv_block_tokens=16,
              pipeline_depth=2, kv_quant=kv_quant)
    ample = _drive(DecodeEngine(params, cfg, **kw), prompts, budgets)
    tight = DecodeEngine(params, cfg, **kw).kv_bytes_per_block * 9
    eng = DecodeEngine(params, cfg, kv_pool_bytes=int(tight), **kw)
    assert eng.kv_pool.blocks_total == 9      # rows need 18 blocks
    pak.launches = 0
    got = _drive(eng, prompts, budgets)
    assert pak.launches == cfg.n_layers * eng.decode_iterations
    s = eng.stats()
    assert got == ample
    assert s["swap_outs"] >= 1 and s["swap_ins"] == s["swap_outs"]
    assert s["pipeline_depth_effective"] > 1.0
    assert s["decode_graph_replays"] > 0
    assert eng.kv_pool.blocks_in_use == 0
