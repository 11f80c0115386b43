"""PyTorch port, the hand-written attention kernels on the card.

Holds each kernel against the port's plain version on the same CUDA
tensors, over every template instance it is built for.

Paged decode attention (`paged_attention(impl="kernel")` against
`impl="reference"`): q in f32 and bf16; pages in f32, bf16, int8 and
fp8-e4m3; head dims 64 and 128; GQA groups of 1, 4 and 8 query heads;
one query per row and a 5-query window; ragged rows, garbage
block-table entries and a row with no live slot; rows that span many
splits of the split-KV plan, with query windows ending on the span's
last slot, just before a split boundary, on it and one past it; and 40
query rows per block (several passes over the pages). Tolerances: f32
q, 1e-5 abs/rel (exact f32 FMAs, summed in another order); bf16 q, 2e-2
abs/rel (the kernel writes bf16 and, on its tensor-core path, rounds p
to bf16 for p.v; the plain version is evaluated in f32 from the same
bf16 or quantized inputs). A second check holds the tensor-core path on
bf16, int8 and fp8 pools to an f64 evaluation, next to the error of
`split_kv_reference` (all f32) on the same inputs.

Flash attention (kernels B1, B3a, B3b against `_flash_fwd_reference`
and `_flash_bwd_reference`; bf16 inputs take the wgmma kernels of
``flash_attention_sm90.cu``, f32 inputs those of ``flash_attention.cu``):
inputs in f32 and bf16, gradients in the input type or f32
(``grad_dtype``), head dims 64 and 128, at six shapes: GQA with lengths
no tile divides, a kv prefix (Sq < Sk, non-causal), Sq > Sk causal
(fully masked rows, which must be exactly 0 in o and dq), two
multi-tile causal shapes (GQA 8/2 at 1000 x 1000; 700 x 330 with dead
rows) and a causal kv prefix with a q length no 128-row tile divides
(GQA 4/2, 300 x 1000). Tolerances: f32, 1e-4 abs/rel (the online softmax and
the tile order change the summation order); bf16, 2e-2 abs/rel (bf16
outputs; p rounded to bf16 per tile in the kernel, once in the plain
version).

The kernels have no CPU mode, so every test needs a CUDA card and nvcc
and skips without them. The file imports no JAX, so it also runs where
JAX is missing:

    python -m pytest --noconftest -m gpu tests/test_torch_port_kernel.py -q
"""

import faulthandler

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import flash_attention_kernel as fak
from ray_tpu_torch.ops import kv_quant
from ray_tpu_torch.ops import paged_attention_kernel as pak
from ray_tpu_torch.ops.attention import mha_reference, paged_attention

pytestmark = pytest.mark.gpu

# (B, S, H, KV, D, T, MB). The long-row shapes take their frontiers from
# the split plan (`_long_case`); "two_pass" serves g*S = 40 query rows.
_SHAPES = {"gqa4_d64": (3, 1, 8, 2, 64, 4, 5),
           "s5_d128": (2, 5, 4, 4, 128, 8, 3),
           "llama3_8b": (4, 1, 32, 8, 128, 32, 4),
           "long_rows": (5, 1, 32, 8, 128, 32, 64),
           "long_rows_s5": (5, 5, 32, 8, 128, 32, 64),
           "two_pass": (2, 5, 32, 4, 64, 16, 6)}
_LONG = ("long_rows", "long_rows_s5")
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


def _long_case(B, S, H, KV, D, T, MB, seed, sms):
    """`_case` with rows that span many splits: row 0 has no live slot,
    and rows 1-4 have query windows whose last slot is the span's last
    slot (live: the valid length is the span), the slot before the
    first split boundary, the boundary slot and the one past it."""
    q, k, v, bt, q_slots, _ = _case(B, S, H, KV, D, T, MB, seed)
    span = MB * T
    edge = pak.split_plan(MB, T, B, KV, sms)[0] * T
    for b, last in zip(range(1, B), (span - 1, edge - 1, edge, edge + 1)):
        q_slots[b] = last - S + 1 + np.arange(S)
        live = min(MB, (last + T) // T)
        bt[b, :live] = 1 + b * MB + np.arange(live)
    return q, k, v, bt, q_slots, span


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("qdt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(_SHAPES), ids=list(_SHAPES))
def test_kernel_matches_plain_version(cuda, shape, qdt, pool):
    if shape in _LONG:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        q, k, v, bt, q_slots, valid = _long_case(
            *_SHAPES[shape], seed=sum(_SHAPES[shape]), sms=sms)
    else:
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


def _f64_attention(q, k, v, bt, q_slots, valid):
    """The plain version's math evaluated in float64, with no rounding
    anywhere: q [B, S, H, D], dequantized pages k, v [NB, T, KV, D]."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    span = bt.shape[1] * T
    kr = k[bt.long()].reshape(B, span, KV, D).repeat_interleave(H // KV, 2)
    vr = v[bt.long()].reshape(B, span, KV, D).repeat_interleave(H // KV, 2)
    s = torch.einsum("bshd,bthd->bhst", q, kr) * D ** -0.5
    slots = torch.arange(span, device=q.device)
    mask = (slots[None, None, None, :] <= q_slots[:, None, :, None].long()) \
        & (slots[None, None, None, :] < valid)
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vr)


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8_e4m3"])
def test_kernel_error_against_f64_reference(cuda, pool):
    """ROADMAP C3: the tensor-core path rounds p * v_scale to bf16 before
    p.v, where the Pallas kernel keeps p in f32. At Llama-3-8B decode
    shapes (long rows across many splits), B2's error against an f64
    evaluation of the plain version must stay within twice the error of
    `split_kv_reference` (the same split-KV algorithm with every step in
    f32) on the same inputs: both write bf16, so the output's own bf16
    rounding is common to both, and a p rounding that mattered would
    show as a multiple of it."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    q, k, v, bt, q_slots, valid = _long_case(
        *_SHAPES["long_rows"], seed=31, sms=sms)
    dev = lambda x: torch.from_numpy(x).to(cuda)            # noqa: E731
    q, k, v = dev(q).bfloat16(), dev(k), dev(v)
    ks = vs = None
    if pool == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
        kd, vd = k.double(), v.double()
    else:
        spec = kv_quant.resolve_kv_quant(pool)
        ks = kv_quant.block_scale(k.abs().amax(dim=(1, 3)), spec)
        vs = kv_quant.block_scale(v.abs().amax(dim=(1, 3)), spec)
        k = kv_quant.quantize(k, ks[:, None, :, None], spec)
        v = kv_quant.quantize(v, vs[:, None, :, None], spec)
        kd = k.double() * ks.double()[:, None, :, None]
        vd = v.double() * vs.double()[:, None, :, None]
    bt, qs = dev(bt), dev(q_slots)
    live = torch.from_numpy((q_slots >= 0).any(axis=1)).to(cuda)
    want = _f64_attention(q.double(), kd, vd, bt, qs, valid)[live]
    out = paged_attention(q, k, v, bt, qs, impl="kernel", kv_valid_len=valid,
                          k_scale=ks, v_scale=vs)
    per = pak.split_plan(bt.shape[1], k.shape[1], bt.shape[0], k.shape[2],
                         sms)[0]
    split = pak.split_kv_reference(q, k, v, bt, qs, kv_valid_len=valid,
                                   pages_per_split=per, k_scale=ks,
                                   v_scale=vs)
    err_kernel = (out[live].double() - want).abs()
    err_split = (split[live].double() - want).abs()
    print(f"[C3] pool={pool}: max abs err vs f64: kernel "
          f"{err_kernel.max().item():.3e}, split_kv_reference "
          f"{err_split.max().item():.3e}; mean {err_kernel.mean().item():.3e}"
          f" vs {err_split.mean().item():.3e}")
    assert err_kernel.max() <= 2 * err_split.max()
    assert err_kernel.mean() <= 2 * err_split.mean()


# (B, H, Hkv, Sq, Sk, causal). The last two span many tiles of every
# kernel, more kv tiles than the wgmma kernels' rings have stages, and
# ragged tails on both sides (the second with dead rows, Sq > Sk).
_FLASH_SHAPES = {"gqa_ragged": (2, 4, 2, 100, 100, True),
                 "prefix_noncausal": (1, 2, 1, 70, 130, False),
                 "masked_rows": (1, 3, 3, 150, 90, True),
                 "multi_tile_gqa": (2, 8, 2, 1000, 1000, True),
                 "multi_tile_masked": (1, 4, 1, 700, 330, True),
                 "prefix_causal_ragged": (1, 4, 2, 300, 1000, True)}
_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
_FLASH_TOL = {"f32": 1e-4, "bf16": 2e-2}


def _flash_case(shape, D, dt, device, seed):
    B, H, Hkv, Sq, Sk, causal = _FLASH_SHAPES[shape]
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, H, Sq, D, generator=g, device=device).to(dt)
    k = torch.randn(B, Hkv, Sk, D, generator=g, device=device).to(dt)
    v = torch.randn(B, Hkv, Sk, D, generator=g, device=device).to(dt)
    do = torch.randn(B, H, Sq, D, generator=g, device=device).to(dt)
    return q, k, v, do, causal, Sq - Sk


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(_FLASH_SHAPES))
def test_flash_fwd_kernel_matches_plain_version(cuda, shape, dt, D):
    q, k, v, _, causal, dead = _flash_case(shape, D, _DT[dt], cuda, D)
    scale = D ** -0.5
    before = fak.fwd_launches
    o, lse = fa._flash_fwd(q, k, v, scale, causal, with_lse=True)
    torch.cuda.synchronize()
    assert fak.fwd_launches == before + 1
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    ro, rlse = fa._flash_fwd_reference(q, k, v, scale, causal)
    tol = _FLASH_TOL[dt]
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=tol, rtol=tol)
    if causal and dead > 0:
        assert bool((o[:, :, :dead] == 0).all())
        assert bool((lse[:, :, :dead] <= -5e29).all())


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dt,grad", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32")])
@pytest.mark.parametrize("shape", list(_FLASH_SHAPES))
def test_flash_bwd_kernels_match_plain_version(cuda, shape, dt, grad, D):
    q, k, v, do, causal, dead = _flash_case(shape, D, _DT[dt], cuda, D + 1)
    scale = D ** -0.5
    o, lse = fa._flash_fwd_reference(q, k, v, scale, causal)
    grad_dtype = None if grad == dt else _DT[grad]
    before = (fak.dq_launches, fak.dkv_launches)
    got = fa._flash_bwd(q, k, v, o, lse, do, scale, causal,
                        grad_dtype=grad_dtype)
    torch.cuda.synchronize()
    assert (fak.dq_launches, fak.dkv_launches) == (before[0] + 1,
                                                   before[1] + 1)
    want = fa._flash_bwd_reference(q, k, v, o, lse, do, scale, causal,
                                   grad_dtype=grad_dtype)
    tol = _FLASH_TOL[dt]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == _DT[grad] and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=name)
    if causal and dead > 0:
        assert bool((got[0][:, :, :dead] == 0).all())


def test_flash_attention_autograd_launches_kernels(cuda):
    """The autograd wrapper on CUDA: one forward and one of each
    backward kernel per call, values and grads equal to the plain
    attention's (f32, 1e-4)."""
    q, k, v, do, _, _ = _flash_case("gqa_ragged", 64, torch.float32, cuda, 7)
    before = (fak.fwd_launches, fak.dq_launches, fak.dkv_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fak.fwd_launches, fak.dq_launches, fak.dkv_launches) == tuple(
        n + 1 for n in before)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = mha_reference(*plain, causal=True)
    ref.backward(do)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)
