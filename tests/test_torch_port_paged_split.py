"""PyTorch port, the split-KV plan of the paged decode kernel (B2).

The kernel (``ray_tpu_torch/csrc/paged_attention.cu``) splits each
row's block table into contiguous ranges, attends each range in its own
thread block, and merges the partials in a second pass. Two things of
that design run here, on the CPU:

- `split_plan`, the host's plan from static shapes: its splits cover
  every block-table entry exactly once and none lies past the table;
- `split_kv_reference`, the kernel's algorithm in plain PyTorch (f32
  partials per split, then the exact f32 merge), against the JAX
  reference `ray_tpu.ops.attention.paged_attention(impl="reference")`
  on the same numpy-seeded inputs, at splits of 1 page, 3 pages and the
  whole span, on bf16 and int8 pools, with splits that hold no live
  slot. Tolerance 1e-5 abs/rel: f32 arithmetic in both, summed in
  another order (and the int8 scales applied after the dot product
  instead of before). A bf16 pool goes to the JAX reference widened to
  f32, because the kernel keeps its probabilities in f32 where the
  reference rounds them to the pool's type.
"""

import faulthandler

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import kv_quant as jq
from ray_tpu.ops.attention import paged_attention as jax_paged_attention
from ray_tpu_torch.ops.paged_attention_kernel import (split_kv_reference,
                                                      split_plan)
from torch_port_helpers import to_torch


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


# (max_blocks, block_tokens, batch, kv_heads, sms): the serving and
# kernel-phase shape of Llama-3-8B, one row, a table of one entry, more
# splits than entries would allow, a ragged last split, pages longer
# than the minimum split.
@pytest.mark.parametrize("mb,t,b,kv,sms", [
    (64, 32, 8, 8, 132), (64, 32, 1, 8, 132), (1, 16, 1, 1, 132),
    (5, 4, 3, 2, 132), (300, 16, 2, 8, 132), (7, 256, 8, 8, 132),
    (64, 32, 5, 8, 132), (0, 32, 2, 8, 132)])
def test_split_plan_covers_the_table(mb, t, b, kv, sms):
    per, splits = split_plan(mb, t, b, kv, sms)
    assert per >= 1 and splits >= 1
    hits = np.zeros(mb, np.int64)
    for i in range(splits):
        lo, hi = i * per, min((i + 1) * per, mb)
        assert lo < hi or mb == 0, f"split {i} is empty"
        assert hi <= mb
        hits[lo:hi] += 1
    assert (hits == 1).all()


def test_split_plan_fills_the_card_at_decode_shapes():
    """At Llama-3-8B's decode shape (8 rows, 8 kv heads, 64 entries of
    32 slots) the grid has more blocks than an H100 has SMs."""
    per, splits = split_plan(64, 32, 8, 8, 132)
    assert splits * 8 * 8 > 132
    assert per * 32 >= 128


def _case(S, pool, seed):
    """Rows of B=3, H=8, KV=2, D=16, T=4, MB=8: row 0 has no live slot,
    row 1's frontier is in its second page (so later splits are empty),
    row 2's reaches the last page and is capped by the valid length;
    table entries past a row's live pages point at the null block 0 or
    at other rows' pages (garbage, always masked)."""
    B, H, KV, D, T, MB = 3, 8, 2, 16, 4, 8
    rng = np.random.RandomState(seed)
    NB = B * MB + 3
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(NB, T, KV, D).astype(np.float32)
    v = rng.randn(NB, T, KV, D).astype(np.float32)
    span = MB * T
    q_slots = np.full((B, S), -1, np.int32)
    q_slots[1] = 5 + np.arange(S)
    q_slots[2] = span - S + np.arange(S)
    bt = rng.randint(0, NB, size=(B, MB)).astype(np.int32)
    for b in (1, 2):
        live = (q_slots[b].max() + T) // T
        bt[b, :live] = 1 + b * MB + np.arange(live)
    k_s = v_s = None
    if pool == "int8":
        spec = jq.resolve_kv_quant("int8")
        scales = []
        for x in (k, v):
            s = jq.block_scale(jnp.max(jnp.abs(jnp.asarray(x)), axis=(1, 3)),
                               spec)
            scales.append((np.asarray(jq.quantize(
                jnp.asarray(x), s[:, None, :, None], spec)), np.asarray(s)))
        (k, k_s), (v, v_s) = scales
    return q, k, v, bt, q_slots, span - 3, k_s, v_s


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("pages", [1, 3, 8], ids=["p1", "p3", "span"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_split_reference_matches_jax(pool, pages, S):
    q, k, v, bt, q_slots, valid, k_s, v_s = _case(S, pool, seed=7 + S)
    tk, tv = to_torch(k), to_torch(v)
    if pool == "bf16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
        k, v = tk.float().numpy(), tv.float().numpy()
    scales = {} if k_s is None else dict(k_scale=to_torch(k_s),
                                         v_scale=to_torch(v_s))
    got = split_kv_reference(to_torch(q), tk, tv, to_torch(bt),
                             to_torch(q_slots), kv_valid_len=valid,
                             pages_per_split=pages, **scales)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(q_slots), kv_valid_len=valid, impl="reference",
        k_scale=None if k_s is None else jnp.asarray(k_s),
        v_scale=None if v_s is None else jnp.asarray(v_s)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    # Row 0 has no live slot: the kernel's algorithm writes 0, the JAX
    # reference averages v.
    assert bool((got[0] == 0).all())
    np.testing.assert_allclose(got[1:].numpy(), want[1:], atol=1e-5,
                               rtol=1e-5)
