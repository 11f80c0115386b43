"""PyTorch port, serving: the quantized paged KV pool (``kv_quant=``).

Mirrors tests/test_engine_kv_quant.py without its Pallas cases. The
write sites are held to the JAX package's bytes on identical f32
inputs: `paged_quant_write` (one token, a window straddling two blocks,
stale slots zeroed, rows off the table going to the null block) and the
paged prefill's whole-view requantization. Requantization is
byte-stable. The engines run side by side on seeded numpy weights: the
port's int8/fp8 engine emits the JAX quantized engine's greedy tokens,
and its pool matches the JAX pool after prefill and after decode (bytes
and scales; the f32 K/V that feed them differ by a few ulps, ROADMAP
Queue C4). Swap and recompute preemption and a copy-on-write tail are
exact. The layout facts of `bench.py:_bench_kv_quant`'s CPU config
(bytes per token 512 -> 132, concurrency 4 -> 15) are reproduced.

The `gpu` case holds the card's replayed decode graphs to the same
engine run eagerly, on an int8 pool with the prefix cache and chunked
prefill; it skips without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_kvquant.py -q
"""

import faulthandler

import numpy as np
import pytest
import torch

try:        # the card's machine has no JAX; only the gpu case runs there
    import jax
    import jax.numpy as jnp
    from torch_port_helpers import byte_view, numpy_params, to_torch

    from ray_tpu.models import engine as jengine
    from ray_tpu.models import llama as jllama
    from ray_tpu.ops import kv_quant as jq
except ImportError:
    jax = None

from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import engine as tengine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.prefix_cache import block_bytes
from ray_tpu_torch.ops import kv_quant as tq
from ray_tpu_torch.ops import paged_attention_kernel as pak

TCFG = tllama.LlamaConfig.nano()
T = 4
MAX_LEN = 32
MODES = ["int8", "fp8_e4m3"]
TIGHT = [[7, 8, 9, 10, 11], [3, 1, 4, 1, 5], [2, 7, 1, 8, 2],
         [9, 9, 8, 8, 7]]
# ROADMAP Queue C4: the port's f32 K/V differ from the JAX engine's by a
# few ulps (torch's and XLA's cos/sin and rsqrt), so the recomputed
# scales agree to a few ulps and an element whose f32 value sits within
# an ulp of a rounding boundary may land one step away.
SCALE_RTOL = 2e-6
MAX_STEP_FLIPS = 1e-3      # share of elements allowed one step away


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


def _prompts(n, seed, lo=3, hi=9):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, TCFG.vocab_size, size=rng.randint(lo, hi))
            .tolist() for _ in range(n)]


def _drive(eng, prompts, budgets, seeds=None):
    ids = [eng.submit(p, n, **({} if seeds is None else {"rng": seeds[i]}))
           for i, (p, n) in enumerate(zip(prompts, budgets))]
    for _ in range(300):
        if not eng.pending():
            break
        eng.step()
    assert not eng.pending(), "engine did not drain within 300 steps"
    return [eng.pop_result(r) for r in ids]


def _quant_pool_bytes(n_blocks):
    """Bytes buying exactly `n_blocks` quantized blocks at T: 1-byte
    values plus the two [KV] f32 scale rows per layer."""
    return n_blocks * (block_bytes(TCFG.n_layers, T, TCFG.n_kv_heads,
                                   TCFG.head_dim, 1)
                       + 2 * TCFG.n_layers * TCFG.n_kv_heads * 4)


def _stored(x, mode):
    """numpy f32 -> (quantized values, scales [.., KV]) via the JAX code,
    one scale per leading index and kv head."""
    qspec = jq.resolve_kv_quant(mode)
    xj = jnp.asarray(x)
    s = jq.block_scale(jnp.max(jnp.abs(xj), axis=(-3, -1)), qspec)
    return (np.asarray(jq.quantize(xj, s[..., None, :, None], qspec)),
            np.asarray(s))


# ---------------------------------------------------------------------------
# Write sites on identical inputs: bytes and scales equal JAX's
# ---------------------------------------------------------------------------

# (S, starts, block table): S=1 with one row off its table; a 6-token
# window straddling two blocks from mid-block, one row running off the
# table into the null block.
_WRITE_CASES = {
    "s1": (1, [1, 7, 8], [[1, 2, 0], [3, 4, 0], [5, 6, 0]]),
    "straddle": (6, [1, 3, 8], [[1, 2, 3], [4, 5, 0], [6, 7, 8]]),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["s1", "straddle"])
def test_paged_quant_write_matches_jax(mode, case):
    """Stale pages (random blocks, also past every write frontier) take
    the write: the written tokens, the zeroed stale slots, the
    recomputed scales and the untouched blocks equal JAX's bytes; the
    null block 0 takes the single off-table row's write as in JAX."""
    S, starts, bt = _WRITE_CASES[case]
    rng = np.random.RandomState(len(starts) + S)
    NB, KV, D = 9, 2, 8
    pages, scales = _stored(rng.randn(NB, T, KV, D).astype(np.float32),
                            mode)
    vals = rng.randn(len(starts), S, KV, D).astype(np.float32)
    bt = np.asarray(bt, np.int32)
    start = np.asarray(starts, np.int32)
    jp, js = jq.paged_quant_write(jnp.asarray(pages), jnp.asarray(scales),
                                  jnp.asarray(bt), jnp.asarray(start),
                                  jnp.asarray(vals),
                                  jq.resolve_kv_quant(mode))
    tp, ts = to_torch(pages), torch.from_numpy(scales.copy())
    out = tq.paged_quant_write(tp, ts, torch.from_numpy(bt),
                               torch.from_numpy(start),
                               torch.from_numpy(vals),
                               tq.resolve_kv_quant(mode))
    assert out[0] is tp and out[1] is ts          # written in place
    np.testing.assert_array_equal(byte_view(tp), byte_view(np.asarray(jp)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # stale slots at and past each row's frontier are zero in its last
    # written block
    for b, s0 in enumerate(starts):
        end = s0 + S
        if (end - 1) // T < bt.shape[1] and end % T:
            blk = bt[b, (end - 1) // T]
            assert not byte_view(tp[blk, end % T:]).any()


def test_paged_quant_write_matches_dense_write():
    """Through the table, each written token dequantizes to its value
    within half a step of its block's scale, and a zero pool's null
    block stays zero when no row runs off the table."""
    spec = tq.resolve_kv_quant("int8")
    rng = np.random.RandomState(2)
    NB, KV, D, B, S = 7, 2, 8, 2, 6
    pages = torch.zeros((NB, T, KV, D), dtype=spec.dtype)
    scales = torch.zeros((NB, KV))
    bt = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]], dtype=torch.int32)
    vals = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32))
    start = torch.tensor([1, 3], dtype=torch.int32)
    tq.paged_quant_write(pages, scales, bt, start, vals, spec)
    for b in range(B):
        for s in range(S):
            pos = int(start[b]) + s
            blk, off = int(bt[b, pos // T]), pos % T
            got = tq.dequantize(pages[blk, off], scales[blk][:, None])
            step = scales[blk][:, None]
            assert bool(((got - vals[b, s]).abs() <= step / 2 + 1e-7).all())
    assert not pages[0].any() and not scales[0].any()


@pytest.mark.parametrize("mode", MODES)
def test_requantize_is_byte_stable(mode):
    """dequantize -> recompute scale -> requantize gives the same bytes,
    and they equal JAX's."""
    spec = tq.resolve_kv_quant(mode)
    rng = np.random.RandomState(1)
    x = rng.randn(5, 8, 2, 16).astype(np.float32)
    jbytes, _ = _stored(x, mode)
    xt = torch.from_numpy(x)
    s = tq.block_scale(xt.abs().amax(dim=(1, 3)), spec)
    q1 = tq.quantize(xt, s[:, None, :, None], spec)
    deq = tq.dequantize(q1, s[:, None, :, None])
    s2 = tq.block_scale(deq.abs().amax(dim=(1, 3)), spec)
    q2 = tq.quantize(deq, s2[:, None, :, None], spec)
    np.testing.assert_array_equal(byte_view(q1), byte_view(q2))
    np.testing.assert_array_equal(byte_view(q1), byte_view(jbytes))


@pytest.mark.parametrize("mode", MODES)
def test_prefill_writeback_matches_jax(mode):
    """The paged prefill's quantized view: gathering dequantizes to f32;
    writing back zeroes every slot at or past each row's valid length
    and requantizes each block with a fresh scale, as JAX's
    `_prefill_rows_paged` write-back does (its op sequence, run here
    with the JAX kv_quant functions). A shared block that the rows do
    not modify comes back byte-identical, once per row holding it."""
    qspec = jq.resolve_kv_quant(mode)
    rng = np.random.RandomState(3)
    L, NB, KV, D, MB = 2, 9, 2, 8, 3
    pages, scales = _stored(rng.randn(L, NB, T, KV, D).astype(np.float32),
                            mode)
    bt = np.asarray([[1, 2, 3], [1, 4, 0]], np.int32)   # block 1 shared
    valid = np.asarray([10, 6], np.int64)
    new = rng.randn(L, 2, MB * T, KV, D).astype(np.float32)
    keep = np.arange(MB * T) < T                # slots of the shared block
    pool = to_torch(pages)
    slab = torch.from_numpy(scales.copy())
    view = tengine._QuantPagedRows(pool, slab, torch.from_numpy(bt),
                                   torch.from_numpy(valid), tq.resolve_kv_quant(mode))
    want_p, want_s = jnp.asarray(pages), jnp.asarray(scales)
    for i in range(L):
        got = view[i]                           # [N, MB*T, KV, D] f32
        assert got.dtype == torch.float32
        ref = jq.dequantize(want_p[i][bt], want_s[i][bt][:, :, None, :, None])
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref).reshape(2, MB * T, KV, D))
        x = np.where(keep[None, :, None, None], got.numpy(), new[i])
        view[i] = torch.from_numpy(x)
        xb = jnp.asarray(x).reshape(2, MB, T, KV, D)
        live = (np.arange(MB * T)[None, :] < valid[:, None]) \
            .reshape(2, MB, T, 1, 1)
        xb = jnp.where(live, xb, 0.0)
        s = jq.block_scale(jnp.max(jnp.abs(xb), axis=(2, 4)), qspec)
        want_p = want_p.at[i, bt].set(
            jq.quantize(xb, s[:, :, None, :, None], qspec))
        want_s = want_s.at[i, bt].set(s)
    np.testing.assert_array_equal(byte_view(pool)[:, 1:],
                                  byte_view(np.asarray(want_p))[:, 1:])
    np.testing.assert_array_equal(slab.numpy()[:, 1:],
                                  np.asarray(want_s)[:, 1:])
    np.testing.assert_array_equal(byte_view(pool)[:, 1],
                                  byte_view(pages)[:, 1])


def test_resolve_kv_quant_names():
    assert tq.resolve_kv_quant(None) is None
    assert tq.resolve_kv_quant("int8").name == "int8"
    assert tq.resolve_kv_quant("fp8_e4m3").name == "fp8_e4m3"
    with pytest.raises(ValueError, match="kv_quant"):
        tq.resolve_kv_quant("int4")


def test_engine_rejects_quant_without_paged(weights):
    _, _, tp = weights
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                     kv_quant="int8")


# ---------------------------------------------------------------------------
# The engine against the JAX quantized engine
# ---------------------------------------------------------------------------

def _one_step(a, b, mode):
    """Whether quantized values a and b (as f32) are equal or adjacent:
    one int8 step, or one fp8-e4m3 step (3 mantissa bits: a relative
    spacing of 2**-3, 2**-9 among the subnormals)."""
    if mode == "int8":
        return np.abs(a - b) <= 1
    return np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) / 8 + 2 ** -9


def _pools(jeng, teng):
    """Both engines' pools as f32 numpy: [(jax values, port values, jax
    scales, port scales)] for K and V, blocks 1..NB-1 (block 0 takes
    garbage in no set order)."""
    out = []
    for pages, slab in (("_pool_k", "_scale_k"), ("_pool_v", "_scale_v")):
        out.append((
            np.asarray(jnp.asarray(getattr(jeng, pages)).astype(
                jnp.float32))[:, 1:],
            getattr(teng, pages).float().numpy()[:, 1:],
            np.asarray(getattr(jeng, slab))[:, 1:],
            getattr(teng, slab).numpy()[:, 1:].copy()))
    return out


@pytest.fixture(scope="module")
def quant_runs(weights):
    """The JAX and port int8/fp8 engines on the same traffic: both
    pools after prefill + one decode iteration and after the drain, the
    engines and their tokens."""
    jcfg, jp, tp = weights
    prompts = _prompts(4, seed=5)
    budgets = [8, 8, 8, 8]
    out = {}
    for mode in MODES:
        kw = dict(batch_slots=4, max_len=MAX_LEN, paged=True,
                  kv_block_tokens=T, kv_quant=mode)
        engs = (jengine.DecodeEngine(jp, jcfg, **kw),
                DecodeEngine(tp, TCFG, **kw))
        ids = [[e.submit(p, n) for p, n in zip(prompts, budgets)]
               for e in engs]
        for e in engs:
            e.step(horizon=1)
        after_prefill = _pools(*engs)
        for e in engs:
            while e.pending():
                e.step()
        toks = [[e.pop_result(r) for r in rid] for e, rid in zip(engs,
                                                                 ids)]
        out[mode] = dict(engines=engs, toks=toks,
                         pools={"prefill": after_prefill,
                                "decode": _pools(*engs)})
    return prompts, budgets, out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("when", ["prefill", "decode"])
def test_quant_pool_matches_jax_engine(quant_runs, mode, when):
    """After prefill (+ one decode iteration) and after the drain, the
    port's pool holds the JAX engine's: scales to SCALE_RTOL, every
    stored value equal or one quantization step away, at most
    MAX_STEP_FLIPS of them away (Queue C4: the f32 K/V feeding them
    differ by a few ulps; on identical inputs the write sites are
    byte-exact, above)."""
    _, _, runs = quant_runs
    flips = total = 0
    for jv, tv, js, ts in runs[mode]["pools"][when]:
        np.testing.assert_allclose(ts, js, rtol=SCALE_RTOL, atol=0)
        assert bool(_one_step(jv, tv, mode).all()), \
            "a stored value moved more than one quantization step"
        flips += int((jv != tv).sum())
        total += jv.size
    assert flips <= MAX_STEP_FLIPS * total, f"{flips} of {total} moved"


@pytest.mark.parametrize("mode", MODES)
def test_quant_greedy_tokens_identical_to_jax_engine(quant_runs, mode):
    _, budgets, runs = quant_runs
    jtoks, ttoks = runs[mode]["toks"]
    assert ttoks == jtoks
    assert [len(t) for t in ttoks] == budgets


@pytest.mark.parametrize("mode", MODES)
def test_quant_stats_match_jax(quant_runs, mode):
    """The quantized engine's byte accounting and counters equal the
    JAX engine's on the same run."""
    _, _, runs = quant_runs
    js, ts = (e.stats() for e in runs[mode]["engines"])
    for key in ("kv_quant_enabled", "kv_bytes_per_token",
                "kv_bytes_per_block", "kv_pool_blocks_total",
                "kv_pool_blocks_in_use", "prefill_real_tokens",
                "prefill_padded_tokens", "decode_dispatches",
                "tokens_generated", "preemptions", "swap_out_bytes",
                "requests_swapped"):
        assert ts[key] == js[key], key
    assert ts["kv_quant_enabled"] == 1.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sampling", ["greedy", "top_k"])
def test_quant_on_token_tolerance_gate(weights, mode, sampling):
    """Quantized decode tracks the unquantized engine: the elementwise
    token-match share clears 0.5 (the JAX gate; it catches garbage
    scales or stale-slot bleed, not rounding). Sampled streams use the
    port's own per-request seeds."""
    _, _, tp = weights
    prompts = _prompts(4, seed=5)
    budgets = [8, 8, 8, 8]
    kw = {} if sampling == "greedy" else dict(greedy=False,
                                              temperature=0.9, top_k=5)
    seeds = None if sampling == "greedy" else [3000 + i for i in range(4)]
    base = dict(batch_slots=2, max_len=MAX_LEN, paged=True,
                kv_block_tokens=T, **kw)
    dense = _drive(DecodeEngine(tp, TCFG, **base), prompts, budgets, seeds)
    eng = DecodeEngine(tp, TCFG, kv_quant=mode, **base)
    quant = _drive(eng, prompts, budgets, seeds)
    match = sum(a == b for d, q in zip(dense, quant) for a, b in zip(d, q))
    assert all(len(t) == n for t, n in zip(quant, budgets))
    assert match / sum(budgets) >= 0.5, f"{mode}: {match}/{sum(budgets)}"
    assert eng.stats()["kv_quant_enabled"] == 1.0


def test_quant_layout_facts_match_bench_r13(weights):
    """bench.py:_bench_kv_quant's CPU config (nano, max_seq_len 256,
    8-token blocks, 65,536 pool bytes, max_len 32): 512 -> 132 bytes per
    token and 4 -> 15 concurrent max_len rows, as BENCH_r13.json records
    and as the JAX engine computes."""
    jcfg, jp, tp = weights
    jcfg = jllama.LlamaConfig.nano(max_seq_len=256)
    tcfg = tllama.LlamaConfig.nano(max_seq_len=256)
    got = {}
    for mode in (None, "int8", "fp8_e4m3"):
        kw = dict(batch_slots=4, max_len=32, paged=True, kv_block_tokens=8,
                  kv_pool_bytes=65536, kv_quant=mode)
        teng = DecodeEngine(tp, tcfg, **kw)
        jeng = jengine.DecodeEngine(jp, jcfg, **kw)
        assert teng.kv_bytes_per_token == jeng.kv_bytes_per_token
        assert teng.kv_pool.blocks_total == jeng.kv_pool.blocks_total
        got[mode] = (teng.kv_bytes_per_token,
                     teng.kv_pool.blocks_total // (32 // 8))
    assert got == {None: (512.0, 4), "int8": (132.0, 15),
                   "fp8_e4m3": (132.0, 15)}


# ---------------------------------------------------------------------------
# Exact paths: swap, recompute, copy-on-write
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ample_int8(weights):
    """The unpreempted int8 run of the four-row tight workload."""
    _, _, tp = weights
    eng = DecodeEngine(tp, TCFG, batch_slots=4, max_len=MAX_LEN,
                       paged=True, kv_block_tokens=T, kv_quant="int8")
    return _drive(eng, TIGHT, [12] * 4)


@pytest.mark.parametrize("mode", ["int8", None], ids=["int8", "f32"])
def test_quant_swap_round_trip_exact(weights, ample_int8, mode):
    """Preempt-and-swap on a 10-block pool: the pages (and an int8
    pool's scale rows) go to the host and back verbatim (every
    swapped-in block equals the one swapped out), so the tokens equal
    the unpreempted run's and the JAX engine's; the swap bytes equal
    JAX's. The unquantized case is the nano model's f32 pool."""
    jcfg, jp, tp = weights
    kw = dict(batch_slots=4, max_len=MAX_LEN, paged=True, kv_block_tokens=T,
              kv_quant=mode)
    ample = (ample_int8 if mode else
             _drive(DecodeEngine(tp, TCFG, **kw), TIGHT, [12] * 4))
    kw["kv_pool_bytes"] = (_quant_pool_bytes(10) if mode else
                           10 * block_bytes(TCFG.n_layers, T, TCFG.n_kv_heads,
                                            TCFG.head_dim, 4))
    eng = DecodeEngine(tp, TCFG, **kw)
    assert eng.kv_pool.blocks_total == 10 and eng.preempt_mode == "swap"
    sent, checked, held = {}, [], []
    real_gather, real_scatter = tengine._swap_out_gather, \
        tengine._swap_in_scatter

    def gather(*args):
        parts = real_gather(*args)   # on the CPU these ARE the host copies
        sent[id(parts[0])] = [p.clone() for p in parts]
        held.append(parts)   # keeps each id unique: no reuse after a free
        return parts

    def scatter(tensors, host, ids):
        real_scatter(tensors, host, ids)
        real = ids != 0
        checked.append(all(
            torch.equal(a[:, real], tengine.raw(t)[:, ids.long()][:, real])
            for a, t in zip(sent[id(host[0])], tensors)))

    tengine._swap_out_gather, tengine._swap_in_scatter = gather, scatter
    try:
        got = _drive(eng, TIGHT, [12] * 4)
    finally:
        tengine._swap_out_gather = real_gather
        tengine._swap_in_scatter = real_scatter
    assert got == ample
    jeng = jengine.DecodeEngine(jp, jcfg, **kw)
    assert _drive(jeng, TIGHT, [12] * 4) == got
    s, js = eng.stats(), jeng.stats()
    assert s["preemptions"] >= 1 and s["swap_outs"] == s["preemptions"]
    assert len(sent) == s["swap_outs"] and len(checked) == s["swap_ins"]
    # K and V pages (and K, V scale rows), each scattered back verbatim
    assert all(checked)
    assert all(len(v) == (4 if mode else 2) for v in sent.values())
    for key in ("preemptions", "swap_outs", "swap_out_bytes",
                "swap_in_bytes"):
        assert s[key] == js[key], key
    assert s["swap_out_bytes"] == s["swap_in_bytes"] > 0
    assert eng.kv_pool.blocks_in_use == 0


def test_quant_recompute_preemption_exact(weights, ample_int8):
    """preempt="recompute" under int8: the f32 prefill view keeps the
    requantization byte-stable, so the tokens equal the unpreempted
    run's, with no swap traffic."""
    _, _, tp = weights
    eng = DecodeEngine(tp, TCFG, batch_slots=4, max_len=MAX_LEN,
                       paged=True, kv_block_tokens=T, kv_quant="int8",
                       preempt="recompute",
                       kv_pool_bytes=_quant_pool_bytes(10))
    assert _drive(eng, TIGHT, [12] * 4) == ample_int8
    s = eng.stats()
    assert s["preemptions"] >= 1
    assert s["swap_out_bytes"] == 0.0 and s["swap_in_bytes"] == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_quant_cow_on_shared_tail_exact(weights, mode):
    """A full-prompt prefix hit on a quantized chain pays exactly one
    copy-on-write block, which moves the bytes and the scale rows
    verbatim; the warm request's tokens equal the cold one's and the
    JAX engine's."""
    jcfg, jp, tp = weights
    sys_p = list(range(1, 13))             # exactly 3 blocks at T=4
    kw = dict(batch_slots=2, max_len=MAX_LEN, paged=True,
              kv_block_tokens=T, kv_quant=mode, prefix_cache=True)
    eng = DecodeEngine(tp, TCFG, **kw)
    cold = _drive(eng, [sys_p], [4])
    s0 = eng.stats()
    copies = []
    real = tengine._cow_blocks

    def cow(tensors, src, dst):
        real(tensors, src, dst)
        copies.append(len(tensors) == 4 and all(
            torch.equal(tengine.raw(t)[:, src.long()],
                        tengine.raw(t)[:, dst.long()]) for t in tensors))

    tengine._cow_blocks = cow
    try:
        warm = _drive(eng, [sys_p], [4])
    finally:
        tengine._cow_blocks = real
    assert warm == cold and copies == [True]
    s1 = eng.stats()
    assert s1["kv_block_cows"] - s0["kv_block_cows"] == 1
    assert s1["kv_blocks_shared"] - s0["kv_blocks_shared"] == 2
    assert s1["prefix_copy_dispatches"] == s0["prefix_copy_dispatches"]
    jeng = jengine.DecodeEngine(jp, jcfg, **kw)
    assert _drive(jeng, [sys_p], [4]) + _drive(jeng, [sys_p], [4]) == \
        cold + warm


# ---------------------------------------------------------------------------
# On the card: replayed graphs against the eager loop, int8 pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graphs and B2 run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_replay_tokens_equal_eager_on_int8_pool(cuda):
    """A bf16 model with head dim 64 on an int8 pool with the prefix
    cache and chunked prefill: the engine's replayed graphs and the same
    engine run eagerly emit the same tokens, B2 launched n_layers times
    per decode iteration on both."""
    cfg = tllama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, ffn_dim=512,
                             max_seq_len=256)
    params = tllama.llama_init(cfg, seed=2, device=cuda, dtype=cfg.dtype)
    rng = np.random.RandomState(2)
    shared = rng.randint(1, cfg.vocab_size, size=32).tolist()
    prompts = [shared + rng.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (5, 17, 40, 9, 23, 31)]
    budgets = [12, 20, 7, 16, 9, 24]
    runs = []
    for graphed in (True, False):
        eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128,
                           paged=True, kv_block_tokens=16, kv_quant="int8",
                           prefix_cache=True, scheduler="prefix",
                           prefill_chunk=16)
        if not graphed:
            eng._graphs = None
        pak.launches = 0
        got = _drive(eng, prompts, budgets)
        assert pak.launches == cfg.n_layers * eng.decode_iterations
        runs.append((got, eng.stats()))
    (g_toks, g_stats), (e_toks, e_stats) = runs
    assert g_toks == e_toks
    assert [len(t) for t in g_toks] == budgets
    assert g_stats["decode_graph_replays"] > 0
    assert e_stats["decode_graph_replays"] == 0
    assert g_stats["kv_blocks_shared"] > 0
    assert g_stats["chunked_prefill_stalls"] > 0
