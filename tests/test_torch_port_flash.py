"""PyTorch port, attention: the `attention` dispatch, `mha_reference`
and flash attention (forward, lse, backward, autograd) against the JAX
package, on CPU.

The same seeded numpy inputs go to both packages. On the JAX side the
Pallas kernels run in interpret mode (`_flash_fwd(..., with_lse=True)`,
`_flash_bwd`, `flash_attention(..., interpret=True)`), as
tests/test_ops.py runs them, with tiles of 16 or 32 rows so that the
padding and causal block skipping are exercised; on the port's side the
CPU tensors take the kernels' plain versions. Tolerances, all f32: 1e-5
abs/rel per op (o, lse, dq/dk/dv of one call), 1e-4 for gradients
through a whole autograd graph; the difference is summation order.
"""

import faulthandler
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tflash

# ray_tpu.ops re-exports functions under these modules' names
jattn = importlib.import_module("ray_tpu.ops.attention")
jflash = importlib.import_module("ray_tpu.ops.flash_attention")

# name -> (B, H, Hkv, Sq, Sk, D, causal, block_q, block_k)
_CASES = {
    "causal": (2, 4, 4, 48, 48, 16, True, 16, 16),
    "noncausal": (2, 4, 4, 48, 48, 16, False, 16, 32),
    "gqa_ragged": (1, 4, 2, 40, 40, 16, True, 32, 32),
    "sq_lt_sk": (2, 4, 2, 24, 56, 16, True, 16, 32),
    "sq_gt_sk": (1, 4, 2, 40, 24, 16, True, 16, 16),
}


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


def _inputs(name, seed=0):
    B, H, Hkv, Sq, Sk, D = _CASES[name][:6]
    rng = np.random.RandomState(seed + sum(_CASES[name][:6]))
    q = rng.randn(B, H, Sq, D).astype(np.float32)
    k = rng.randn(B, Hkv, Sk, D).astype(np.float32)
    v = rng.randn(B, Hkv, Sk, D).astype(np.float32)
    do = rng.randn(B, H, Sq, D).astype(np.float32)
    return q, k, v, do


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(_CASES))
def test_flash_fwd_o_and_lse_match_pallas(name):
    causal, bq, bk = _CASES[name][6:]
    q, k, v, _ = _inputs(name)
    scale = q.shape[-1] ** -0.5
    jo, jl = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale, causal, bq, bk, True,
                               with_lse=True)
    to, tl = tflash._flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), scale, causal, bq, bk,
                               with_lse=True)
    _close(to, jo, 1e-5)
    _close(tl, jl, 1e-5)
    if name == "sq_gt_sk":
        # q rows 0..15 sit before the first kv position: fully masked
        assert bool((to[:, :, :16] == 0).all())
        assert bool((tl[:, :, :16] <= -5e29).all())


@pytest.mark.parametrize("name", list(_CASES))
def test_flash_bwd_matches_pallas(name):
    causal, bq, bk = _CASES[name][6:]
    q, k, v, do = _inputs(name, seed=1)
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = jflash._flash_fwd(jq, jk, jv, scale, causal, bq, bk, True,
                               with_lse=True)
    want = jflash._flash_bwd(jq, jk, jv, jo, jl, jdo, scale, causal, bq, bk,
                             True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tl = tflash._flash_fwd(tq, tk, tv, scale, causal, with_lse=True)
    got = tflash._flash_bwd(tq, tk, tv, to, tl, tdo, scale, causal)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    if name == "sq_gt_sk":
        assert bool((got[0][:, :, :16] == 0).all())


def test_flash_bwd_precomputed_delta_and_grad_dtype():
    """delta given by the caller (as ring attention does per kv shard)
    and grad_dtype=float32 reach the same numbers as the JAX driver."""
    causal, bq, bk = _CASES["sq_lt_sk"][6:]
    q, k, v, do = _inputs("sq_lt_sk", seed=2)
    scale = 0.3
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jl = jflash._flash_fwd(jq, jk, jv, scale, causal, bq, bk, True,
                               with_lse=True)
    jdelta = jnp.sum(jdo * jo, axis=-1, keepdims=True) * 0.5
    want = jflash._flash_bwd(jq, jk, jv, jo, jl, jdo, scale, causal, bq, bk,
                             True, delta=jdelta, grad_dtype=jnp.float32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tl = tflash._flash_fwd(tq, tk, tv, scale, causal, with_lse=True)
    tdelta = torch.from_numpy(np.array(jdelta))
    got = tflash._flash_bwd(tq, tk, tv, to, tl, tdo, scale, causal,
                            delta=tdelta, grad_dtype=torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5)
    # bf16 inputs with grad_dtype=float32 keep f32 partials
    bf = [t.bfloat16() for t in (tq, tk, tv, to, tdo)]
    dq, dk, dv = tflash._flash_bwd(bf[0], bf[1], bf[2], bf[3], tl, bf[4],
                                   scale, causal, grad_dtype=torch.float32)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float32,) * 3


@pytest.mark.parametrize("name", ["gqa_ragged", "sq_gt_sk"])
def test_flash_attention_autograd_matches_jax_grad(name):
    causal, bq, bk = _CASES[name][6:]
    q, k, v, w = _inputs(name, seed=3)

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, causal=causal, block_q=bq,
                                   block_k=bk, interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tflash.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                               block_k=bk)
    tval = (o * torch.from_numpy(w)).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-4)
    for t, jg in zip((tq, tk, tv), jgrads):
        _close(t.grad, jg, 1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", [24, 40])
def test_mha_reference_matches_jax(causal, sq):
    q, k, v, _ = _inputs("sq_gt_sk" if sq == 40 else "sq_lt_sk", seed=4)
    want = jattn.mha_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = tattn.mha_reference(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    _close(got, want, 1e-5)


def test_mha_reference_segment_ids_match_jax():
    q, k, v, _ = _inputs("causal", seed=5)
    seg = np.repeat(np.array([[0, 1, 2], [3, 3, 4]]), 16, axis=1)
    want = jattn.mha_reference(*map(jnp.asarray, (q, k, v)), causal=True,
                               segment_ids=jnp.asarray(seg))
    got = tattn.mha_reference(*map(torch.from_numpy, (q, k, v)),
                              causal=True,
                              segment_ids=torch.from_numpy(seg))
    _close(got, want, 1e-5)


@pytest.fixture(scope="module")
def dispatch_case():
    """Inputs, loss weights and the JAX reference's output and grads."""
    q, k, v, w = _inputs("gqa_ragged", seed=6)

    def jloss(q, k, v):
        return jnp.sum(jattn.attention(q, k, v, impl="reference")
                       * jnp.asarray(w))

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    out = jattn.attention(jq, jk, jv, impl="reference")
    return (q, k, v, w), out, jgrads


@pytest.mark.parametrize("impl", ["auto", "kernel", "reference"])
def test_attention_dispatch_agrees_with_reference(dispatch_case, impl):
    """On CPU tensors "auto" is the reference and "kernel" the kernels'
    plain versions through the autograd wrapper; all agree with the
    JAX reference, values and gradients."""
    (q, k, v, w), jout, jgrads = dispatch_case
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.attention(*ts, impl=impl, block_q=16, block_k=8)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jout, 1e-5)
    for t, jg in zip(ts, jgrads):
        _close(t.grad, jg, 1e-4)


@pytest.mark.parametrize("bad", ["impl", "block_q", "block_k", "heads"])
def test_attention_rejects_bad_arguments(bad):
    q = torch.zeros(1, 3 if bad == "heads" else 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    kw = {"impl": "pallas"} if bad == "impl" else \
        {bad: 0} if bad.startswith("block") else {"impl": "kernel"}
    with pytest.raises(ValueError):
        tattn.attention(q, k, k, **kw)
