"""PyTorch port, the hand-written paged-attention kernel on the card.

Holds `paged_attention(impl="kernel")` against the port's plain version
(`impl="reference"`) on the same CUDA tensors, over every template
instance the kernel is built for: q in f32 and bf16; pages in f32,
bf16, int8 and fp8-e4m3; head dims 64 and 128; GQA groups of 1, 4 and
8 query heads; one query per row and a 5-query window; ragged rows,
garbage block-table entries and a row with no live slot. The kernel has
no CPU mode, so every test needs a CUDA card and nvcc and skips without
them. The file imports no JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest -m gpu tests/test_torch_port_kernel.py -q

Tolerances: f32 q with any page type, 1e-5 abs/rel (f32 arithmetic in
both, summed in another order); bf16 q, 2e-2 abs/rel (the kernel writes
bf16, the plain version is evaluated in f32 from the same bf16 or
quantized inputs).
"""

import faulthandler

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import kv_quant
from ray_tpu_torch.ops import paged_attention_kernel as pak
from ray_tpu_torch.ops.attention import paged_attention

pytestmark = pytest.mark.gpu

# (B, S, H, KV, D, T, MB)
_SHAPES = {"gqa4_d64": (3, 1, 8, 2, 64, 4, 5),
           "s5_d128": (2, 5, 4, 4, 128, 8, 3),
           "llama3_8b": (4, 1, 32, 8, 128, 32, 4)}
_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _case(B, S, H, KV, D, T, MB, seed):
    """Seeded pages, tables and ragged q_slots: row 0 has no live slot;
    table entries past a row's live blocks point at the null block 0 or
    at other rows' blocks; the valid length sits below the span."""
    rng = np.random.RandomState(seed)
    NB = B * MB + 3
    span = MB * T
    bt = np.zeros((B, MB), np.int32)
    q_slots = np.full((B, S), -1, np.int32)
    for b in range(1, B):
        frontier = min(span - S, 1 + (7 * b + 3) % span)
        q_slots[b] = frontier + np.arange(S)
        live = min(MB, (q_slots[b].max() + T) // T)
        bt[b, :live] = 1 + b * MB + np.arange(live)
        bt[b, live:] = rng.randint(0, NB, size=MB - live)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(NB, T, KV, D).astype(np.float32)
    v = rng.randn(NB, T, KV, D).astype(np.float32)
    return q, k, v, bt, q_slots, span - 2


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("qdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(_SHAPES), ids=list(_SHAPES))
def test_kernel_matches_plain_version(cuda, shape, qdt, pool):
    q, k, v, bt, q_slots, valid = _case(*_SHAPES[shape],
                                        seed=sum(_SHAPES[shape]))
    dev = lambda x: torch.from_numpy(x).to(cuda)            # noqa: E731
    q, k, v = dev(q), dev(k), dev(v)
    ks = vs = None
    if pool in ("f32", "bf16"):
        dt = torch.float32 if pool == "f32" else torch.bfloat16
        k, v = k.to(dt), v.to(dt)
        plain_k, plain_v = k.float(), v.float()
    else:
        spec = kv_quant.resolve_kv_quant(pool)
        ks = kv_quant.block_scale(k.abs().amax(dim=(1, 3)), spec)
        vs = kv_quant.block_scale(v.abs().amax(dim=(1, 3)), spec)
        k = kv_quant.quantize(k, ks[:, None, :, None], spec)
        v = kv_quant.quantize(v, vs[:, None, :, None], spec)
        plain_k, plain_v = k, v
    if qdt == "bf16":
        q = q.bfloat16()
    bt, qs = dev(bt), dev(q_slots)
    kw = dict(kv_valid_len=valid, k_scale=ks, v_scale=vs)
    before = pak.launches
    out = paged_attention(q, k, v, bt, qs, impl="kernel", **kw)
    assert pak.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = paged_attention(q.float(), plain_k, plain_v, bt, qs,
                          impl="reference", **kw)
    # No live slot: the kernel writes 0, the plain version (like the
    # JAX reference) averages v.
    dead = torch.from_numpy((q_slots < 0).all(axis=1)).to(cuda)
    assert bool((out[dead] == 0).all())
    tol = _TOL[qdt]
    torch.testing.assert_close(out.float()[~dead], ref[~dead],
                               atol=tol, rtol=tol)
