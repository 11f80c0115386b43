"""PyTorch port, ops layer: paged attention and KV quantization.

The port's plain `paged_attention` is held against the JAX reference
(`ray_tpu.ops.attention.paged_attention(impl="reference")`) on seeded
numpy inputs, and its kv_quant arithmetic against the JAX bytes. The
hand-written CUDA kernel needs the card; `chip_smoke.py` holds it
against the plain version there. Here the tests check the dispatch
seam and the wrapper's argument checks, which run before any build.
"""

import faulthandler

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import kv_quant as jq
from ray_tpu.ops.attention import paged_attention as jax_paged_attention
from ray_tpu_torch.ops import kv_quant as tq
from ray_tpu_torch.ops.attention import paged_attention
from ray_tpu_torch.ops.paged_attention_kernel import paged_attention_kernel
from torch_port_helpers import byte_view, to_torch


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


def _quantized(x, mode):
    """numpy f32 pages -> (quantized pages, scales) via the JAX code."""
    qspec = jq.resolve_kv_quant(mode)
    xj = jnp.asarray(x)
    s = jq.block_scale(jnp.max(jnp.abs(xj), axis=(1, 3)), qspec)
    return (np.asarray(jq.quantize(xj, s[:, None, :, None], qspec)),
            np.asarray(s))


def _paged_case(B, S, H, KV, D, T, MB, seed):
    """Seeded pages, block tables, ragged q_slots. Row 0 is fully
    masked (q_slot -1); the other rows' frontiers land mid-block at
    different depths; table entries past a row's live blocks point at
    the garbage-filled null block 0 or at other rows' blocks; the valid
    length sits below the span, so deep queries are capped by it."""
    rng = np.random.RandomState(seed)
    NB = B * MB + 3
    k = rng.randn(NB, T, KV, D).astype(np.float32)
    v = rng.randn(NB, T, KV, D).astype(np.float32)
    q = rng.randn(B, S, H, D).astype(np.float32)
    span = MB * T
    valid = span - 3
    bt = np.zeros((B, MB), np.int32)
    q_slots = np.full((B, S), -1, np.int32)
    for b in range(1, B):
        frontier = min(span - S, 1 + (5 * b + 2) % span)
        q_slots[b] = frontier + np.arange(S)
        live = min(MB, (q_slots[b].max() + T) // T)
        bt[b, :live] = 1 + b * MB + np.arange(live)
        # garbage tail: other rows' blocks and the null block
        bt[b, live:] = rng.randint(0, NB, size=MB - live)
    return q, k, v, bt, q_slots, valid


# (B, S, H, KV, D, T, MB): GQA x2/x4, a 5-query window (speculative
# verify width), and a long walk over tiny blocks.
_SHAPES = [(3, 1, 4, 2, 16, 4, 4), (3, 1, 8, 2, 32, 8, 2),
           (2, 5, 4, 4, 16, 4, 3), (2, 3, 6, 2, 8, 2, 8)]


@pytest.mark.parametrize("pool", [None, "int8", "fp8_e4m3"],
                         ids=["f32", "int8", "fp8"])
@pytest.mark.parametrize("shape", _SHAPES,
                         ids=["gqa2", "gqa4", "s5", "walk8"])
def test_paged_attention_matches_jax_reference(shape, pool):
    """f32 tolerance 1e-5 abs/rel: same ops, but the einsums and the
    softmax sum in another order than XLA's."""
    q, k, v, bt, q_slots, valid = _paged_case(*shape, seed=sum(shape))
    ks = vs = None
    if pool is not None:
        k, ks = _quantized(k, pool)
        v, vs = _quantized(v, pool)
    want = jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(q_slots), kv_valid_len=valid, impl="reference",
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    got = paged_attention(
        to_torch(q), to_torch(k), to_torch(v), to_torch(bt),
        to_torch(q_slots), kv_valid_len=valid, impl="reference",
        k_scale=None if ks is None else to_torch(ks),
        v_scale=None if vs is None else to_torch(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_auto_on_cpu_is_the_plain_version():
    q, k, v, bt, q_slots, valid = _paged_case(2, 1, 4, 2, 16, 4, 3, 1)
    args = [to_torch(x) for x in (q, k, v, bt, q_slots)]
    ref = paged_attention(*args, kv_valid_len=valid, impl="reference")
    auto = paged_attention(*args, kv_valid_len=valid)
    assert torch.equal(auto, ref)


@pytest.mark.parametrize("case", ["impl", "kernel_on_cpu", "scales",
                                  "heads"])
def test_dispatch_seam_raises(case):
    q, k, v, bt, q_slots, valid = _paged_case(2, 1, 4, 2, 64, 4, 3, 2)
    q, k, v, bt, q_slots = (to_torch(x) for x in (q, k, v, bt, q_slots))
    kw = dict(kv_valid_len=valid)
    if case == "impl":
        with pytest.raises(ValueError, match="impl"):
            paged_attention(q, k, v, bt, q_slots, impl="flash", **kw)
    elif case == "kernel_on_cpu":
        with pytest.raises(ValueError, match="CUDA"):
            paged_attention(q, k, v, bt, q_slots, impl="kernel", **kw)
    elif case == "scales":
        with pytest.raises(ValueError, match="together"):
            paged_attention(q, k, v, bt, q_slots,
                            k_scale=torch.ones(k.shape[0], k.shape[2]),
                            **kw)
    else:
        with pytest.raises(ValueError, match="heads"):
            paged_attention(torch.zeros(2, 1, 3, 64), k, v, bt, q_slots,
                            **kw)


def _wrapper_args(case):
    """Valid-shaped CPU arguments for the kernel wrapper, broken in one
    way per case; "cpu" breaks only the device."""
    B, S, H, KV, D, T, NB, MB = 2, 1, 4, 2, 64, 4, 9, 4
    a = dict(q=torch.zeros(B, S, H, D, dtype=torch.bfloat16),
             k_pages=torch.zeros(NB, T, KV, D, dtype=torch.bfloat16),
             v_pages=torch.zeros(NB, T, KV, D, dtype=torch.bfloat16),
             block_tables=torch.zeros(B, MB, dtype=torch.int32),
             q_slots=torch.zeros(B, S, dtype=torch.int32))
    if case == "q_dtype":
        a["q"] = a["q"].to(torch.float16)
    elif case == "head_dim":
        a["q"] = torch.zeros(B, S, H, 96, dtype=torch.bfloat16)
        a["k_pages"] = torch.zeros(NB, T, KV, 96, dtype=torch.bfloat16)
        a["v_pages"] = a["k_pages"].clone()
    elif case == "kv_mismatch":
        a["v_pages"] = a["v_pages"].float()
    elif case == "table_dtype":
        a["block_tables"] = a["block_tables"].long()
    elif case == "slots_shape":
        a["q_slots"] = torch.zeros(B, S + 1, dtype=torch.int32)
    elif case == "quant_without_scales":
        a["k_pages"] = torch.zeros(NB, T, KV, D, dtype=torch.int8)
        a["v_pages"] = a["k_pages"].clone()
    elif case == "non_contiguous":
        a["q"] = torch.zeros(B, H, S + 1, D, dtype=torch.bfloat16
                             ).transpose(1, 2)
    return a


@pytest.mark.parametrize("case,match", [
    ("q_dtype", "q dtype"), ("head_dim", "head dim"),
    ("kv_mismatch", "differ"), ("table_dtype", "block_tables"),
    ("slots_shape", "q_slots"), ("quant_without_scales", "scale"),
    ("non_contiguous", "contiguous"), ("cpu", "CUDA")])
def test_kernel_wrapper_rejects(case, match):
    """The wrapper refuses what the kernel does not take, before any
    build; valid CPU tensors are refused for being on the CPU."""
    with pytest.raises(ValueError, match=match):
        paged_attention_kernel(**_wrapper_args(case), kv_valid_len=16)


@pytest.mark.parametrize("zero_block", [False, True],
                         ids=["dense", "zero_block"])
@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_kv_quant_bytes_equal_jax(mode, zero_block):
    """block_scale / quantize / dequantize: byte-equal to JAX."""
    rng = np.random.RandomState(11)
    x = (rng.randn(6, 4, 2, 16) * 3.0).astype(np.float32)
    if zero_block:
        x[2] = 0.0
        x[4, :, 1] = 0.0
    jspec, tspec = jq.resolve_kv_quant(mode), tq.resolve_kv_quant(mode)
    j_amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=(1, 3))
    j_s = jq.block_scale(j_amax, jspec)
    j_q = jq.quantize(jnp.asarray(x), j_s[:, None, :, None], jspec)
    j_dq = jq.dequantize(j_q, j_s[:, None, :, None])
    t_amax = torch.from_numpy(x).abs().amax(dim=(1, 3))
    t_s = tq.block_scale(t_amax, tspec)
    t_q = tq.quantize(torch.from_numpy(x), t_s[:, None, :, None], tspec)
    t_dq = tq.dequantize(t_q, t_s[:, None, :, None])
    assert t_q.dtype == tspec.dtype
    np.testing.assert_array_equal(byte_view(t_s), byte_view(j_s))
    np.testing.assert_array_equal(byte_view(t_q), byte_view(j_q))
    np.testing.assert_array_equal(byte_view(t_dq), byte_view(j_dq))
