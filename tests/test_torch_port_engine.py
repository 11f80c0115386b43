"""PyTorch port, serving: the paged DecodeEngine (``paged=True``) on the CPU.

Token identity is the engine's contract: with the same weights (seeded
numpy through `ray_tpu_torch.convert`), the port's paged engine emits
the greedy tokens of the JAX paged engine and of JAX solo `generate`,
also when a tight pool forces recompute preemption; sampled tokens
equal the port's own solo `generate` under the same per-request seeds
(the port's noise is not JAX's threefry stream). Five requests through
two slots with the budgets of tests/test_engine_paged.py churn
admissions, so blocks are freed and reused across requests.
"""

import faulthandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import engine as jengine
from ray_tpu.models import generate as jgen
from ray_tpu.models import llama as jllama
from ray_tpu_torch import DecodeEngine
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.prefix_cache import block_bytes
from torch_port_helpers import numpy_params

JCFG = jllama.LlamaConfig.nano()
TCFG = tllama.LlamaConfig.nano()
T = 4            # kv_block_tokens
MAX_LEN = 32
BUDGETS = [7, 4, 9, 5, 6]
MAX_STEPS = 200  # bound on every engine loop here


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


@pytest.fixture(scope="module")
def weights():
    tree = numpy_params(JCFG, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, params_from_numpy(tree, TCFG, device="cpu")


def _prompts():
    """tests/test_engine_paged.py's churn mix: two prompts sharing an
    8-token prefix, three short ones."""
    rng = np.random.RandomState(7)
    base = [rng.randint(1, JCFG.vocab_size, size=rng.randint(3, 9)).tolist()
            for _ in range(5)]
    shared = list(range(3, 11))
    return [shared + p for p in base[:2]] + base[2:]


def _drive(eng, prompts, budgets, seeds=None):
    ids = [eng.submit(p, n, **({} if seeds is None else {"rng": seeds[i]}))
           for i, (p, n) in enumerate(zip(prompts, budgets))]
    for _ in range(MAX_STEPS):
        if not eng.pending():
            break
        eng.step()
    assert not eng.pending(), "engine did not drain within MAX_STEPS"
    return [eng.pop_result(r) for r in ids]


def _jax_solo(jp, prompt, n):
    out = jgen.generate(jp, jnp.asarray([prompt], jnp.int32), JCFG,
                        max_new_tokens=n)
    return np.asarray(out)[0, len(prompt):].tolist()


def _port_solo(tp, prompt, n, **kw):
    out = tgen.generate(tp, torch.tensor([prompt]), TCFG, max_new_tokens=n,
                        **kw)
    return out[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def port_greedy(weights):
    """The port engine's greedy run over the churn mix, and the engine."""
    _, tp = weights
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       paged=True, kv_block_tokens=T)
    return _drive(eng, _prompts(), BUDGETS), eng


def test_greedy_engine_drains_cleanly(port_greedy):
    _, eng = port_greedy
    assert eng.kv_pool.blocks_in_use == 0      # every block returned
    s = eng.stats()
    assert s["paged"] == 1.0 and s["requests_finished"] == 5
    assert s["host_syncs"] == s["decode_dispatches"]   # one pull per block
    assert s["tokens_generated"] == sum(BUDGETS)


def test_greedy_tokens_identical_to_jax_engine(weights, port_greedy):
    jp, _ = weights
    jeng = jengine.DecodeEngine(jp, JCFG, batch_slots=2, max_len=MAX_LEN,
                                paged=True, kv_block_tokens=T)
    assert port_greedy[0] == _drive(jeng, _prompts(), BUDGETS)


def test_greedy_tokens_identical_to_jax_generate(weights, port_greedy):
    jp, _ = weights
    want = [_jax_solo(jp, p, n) for p, n in zip(_prompts(), BUDGETS)]
    assert port_greedy[0] == want


def test_sampled_tokens_identical_to_port_generate(weights):
    _, tp = weights
    prompts = _prompts()
    mode = dict(greedy=False, temperature=0.9, top_k=5)
    seeds = [1000 + i for i in range(len(prompts))]
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       paged=True, kv_block_tokens=T, **mode)
    got = _drive(eng, prompts, BUDGETS, seeds)
    want = [_port_solo(tp, p, n, rng=s, **mode)
            for p, n, s in zip(prompts, BUDGETS, seeds)]
    assert got == want
    assert eng.kv_pool.blocks_in_use == 0


def test_recompute_preemption_keeps_greedy_tokens(weights):
    """A pool of 10 blocks for four rows that each grow to 5 blocks:
    decode must preempt, requeue, re-prefill prompt + emitted tokens,
    and still emit JAX's tokens."""
    jp, tp = weights
    prompts = [[7, 8, 9, 10, 11], [3, 1, 4, 1, 5], [2, 7, 1, 8, 2],
               [9, 9, 8, 8, 7]]
    budgets = [12] * 4
    pool = 10 * block_bytes(TCFG.n_layers, T, TCFG.n_kv_heads,
                            TCFG.head_dim, 4)
    eng = DecodeEngine(tp, TCFG, batch_slots=4, max_len=MAX_LEN,
                       paged=True, kv_block_tokens=T, kv_pool_bytes=pool,
                       preempt="recompute")
    assert eng.kv_pool.blocks_total == 10
    got = _drive(eng, prompts, budgets)
    assert got == [_jax_solo(jp, p, n) for p, n in zip(prompts, budgets)]
    s = eng.stats()
    assert s["preemptions"] >= 1 and s["swap_ins"] == s["preemptions"]
    assert s["requests_swapped"] == 0.0
    assert eng.kv_pool.blocks_in_use == 0


@pytest.mark.parametrize("knob", [
    {"tp": 2}, {"mesh": "mesh"}, {"sanitize": True}],
    ids=lambda k: next(iter(k)))
def test_out_of_slice_knobs_raise(weights, knob):
    _, tp = weights
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                     paged=True, kv_block_tokens=T, **knob)


def test_engine_argument_checks(weights):
    _, tp = weights
    with pytest.raises(ValueError, match="divisible"):
        DecodeEngine(tp, TCFG, batch_slots=2, max_len=30, paged=True,
                     kv_block_tokens=T)
    with pytest.raises(ValueError, match="preempt"):
        DecodeEngine(tp, TCFG, max_len=MAX_LEN, paged=True,
                     kv_block_tokens=T, preempt="drop")
    eng = DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN,
                       paged=True, kv_block_tokens=T)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1] * 30, 8)
    with pytest.raises(ValueError, match="resume_tokens"):
        eng.submit([1, 2], 1, resume_tokens=[3])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DecodeEngine(tp, TCFG, batch_slots=2, max_len=MAX_LEN, tp=2)
