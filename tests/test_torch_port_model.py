"""PyTorch port, model math: Llama layers, cached forwards, sampling
filters and solo generation against the JAX package on nano.

Weights are seeded numpy arrays handed to both packages (the port's
through `ray_tpu_torch.convert`). Float outputs: 1e-5 abs/rel on single
ops and 1e-4 on whole forwards — f32 throughout, the difference is
summation order. Token outputs are held to equality.
"""

import faulthandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jgen
from ray_tpu.models import llama as jllama
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import llama as tllama
from torch_port_helpers import numpy_params

JCFG = jllama.LlamaConfig.nano()
TCFG = tllama.LlamaConfig.nano()


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
    tree = numpy_params(JCFG, seed=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jparams, params_from_numpy(tree, TCFG, device="cpu")


def test_config_presets_match():
    for name in ("llama3_8b", "llama2_7b", "nano"):
        j, t = getattr(jllama.LlamaConfig, name)(), \
            getattr(tllama.LlamaConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads",
                  "n_kv_heads", "ffn_dim", "max_seq_len", "rope_theta",
                  "norm_eps", "remat", "remat_policy", "flash_block_q",
                  "flash_block_k", "loss_chunk"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert j.num_params() == t.num_params()
        assert j.head_dim == t.head_dim


def test_llama_init_shapes_and_dtype():
    cfg = tllama.LlamaConfig.nano(dtype=torch.bfloat16)
    p = tllama.llama_init(cfg, seed=0, device="cpu")
    want = jax.eval_shape(lambda: jllama.llama_init(jax.random.PRNGKey(0),
                                                    JCFG))
    got = jax.tree_util.tree_map(lambda x: tuple(x.shape), p)
    assert got == jax.tree_util.tree_map(lambda x: tuple(x.shape), want)
    assert all(x.dtype == torch.bfloat16
               for x in jax.tree_util.tree_leaves(p))
    again = tllama.llama_init(cfg, seed=0, device="cpu")
    assert torch.equal(p["layers"]["wq"], again["layers"]["wq"])


@pytest.mark.parametrize("shape", [(2, 3, 64), (1, 5, 16)])
def test_rmsnorm(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    s = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    want = jllama._rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5)
    got = tllama._rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    pos = rng.randint(0, 100, size=(2, 5)).astype(np.int32)
    want = jllama._rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_forward_cached_prefill_then_decode(weights):
    """Prefill [2, 6] at offset 0, then one decode token at slot 6:
    logits and the written cache match JAX."""
    jp, tp = weights
    rng = np.random.RandomState(2)
    toks = rng.randint(1, JCFG.vocab_size, size=(2, 6)).astype(np.int32)
    nxt = rng.randint(1, JCFG.vocab_size, size=(2, 1)).astype(np.int32)
    jc = jgen.init_cache(JCFG, 2, 16)
    tc = tgen.init_cache(TCFG, 2, 16, device="cpu")
    for start, chunk in ((0, toks), (6, nxt)):
        jl, jc = jgen.forward_cached(jp, jnp.asarray(chunk), jc, start,
                                     JCFG)
        tl, tc = tgen.forward_cached(tp, torch.from_numpy(chunk).long(),
                                     tc, start, TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4, rtol=1e-4)


def test_forward_cached_rows_per_row_offsets(weights):
    """Rows at different offsets over a pre-filled cache (the engine's
    admission prefill)."""
    jp, tp = weights
    rng = np.random.RandomState(4)
    shape = (JCFG.n_layers, 2, 16, JCFG.n_kv_heads, JCFG.head_dim)
    k0 = rng.randn(*shape).astype(np.float32)
    v0 = rng.randn(*shape).astype(np.float32)
    toks = rng.randint(1, JCFG.vocab_size, size=(2, 4)).astype(np.int32)
    starts = np.array([0, 5], np.int32)
    jl, jc = jgen.forward_cached_rows(
        jp, jnp.asarray(toks), {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(starts), JCFG)
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    tl, tc = tgen.forward_cached_rows(tp, torch.from_numpy(toks).long(), tc,
                                      torch.from_numpy(starts), TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("top_k,top_p", [(3, None), (None, 0.55),
                                         (4, 0.7), (1, None),
                                         (None, 1.0)])
def test_filter_logits_masks_equal(top_k, top_p):
    """Integer-valued logits make ties everywhere, including at the
    top-k cut and inside the nucleus; the argsort-scatter tie rule
    must pick the same survivors as JAX."""
    rng = np.random.RandomState(5)
    logits = rng.randint(-3, 4, size=(4, 32)).astype(np.float32)
    want = jgen.filter_logits(jnp.asarray(logits), top_k, top_p)
    got = tgen.filter_logits(torch.from_numpy(logits), top_k, top_p)
    neg = np.finfo(np.float32).min
    np.testing.assert_array_equal(got.numpy() == neg,
                                  np.asarray(want) == neg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("plen,n", [(5, 10), (9, 7)])
def test_solo_greedy_generate_tokens_identical(weights, plen, n):
    jp, tp = weights
    rng = np.random.RandomState(plen)
    prompt = rng.randint(1, JCFG.vocab_size, size=(2, plen)).astype(np.int32)
    want = np.asarray(jgen.generate(jp, jnp.asarray(prompt), JCFG,
                                    max_new_tokens=n))
    got = tgen.generate(tp, torch.from_numpy(prompt).long(), TCFG,
                        max_new_tokens=n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_stream_depends_on_key_and_index_only():
    """Row b's noise is a function of (key, token index): the same
    (key, index) pair gives the same draw in any row of any batch, and
    another index gives another draw."""
    keys = torch.tensor([[1, 2], [7, 9], [1, 2]])
    idx = torch.tensor([4, 4, 4])
    g = tgen._gumbel(keys, idx, 64)
    assert torch.equal(g[0], g[2]) and not torch.equal(g[0], g[1])
    solo = tgen._gumbel(keys[2:], idx[2:], 64)
    assert torch.equal(solo[0], g[2])
    assert not torch.equal(tgen._gumbel(keys[:1], idx[:1] + 1, 64)[0], g[0])
    assert torch.isfinite(g).all()
