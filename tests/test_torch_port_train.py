"""PyTorch port, training: `llama_forward`, `llama_loss` with its
gradients, and `make_train_step` with `adamw` against the JAX package on
CPU.

The same seeded numpy weights and tokens go to both packages (the
port's through `ray_tpu_torch.convert`). Configs are nano-sized and f32.
Tolerances, stated per check: 1e-4 abs/rel for whole forwards (logits),
losses, gradients and grad norms — f32 throughout, the difference is
summation order; 1e-5 on the parameters after three AdamW steps (each
step moves a parameter by at most about lr = 1e-3, and the two
optimizers compute the same update in another order).
"""

import dataclasses
import faulthandler
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models.training import make_sharded_train_step
from ray_tpu.parallel import create_mesh
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import training as ttrain
from torch_port_helpers import numpy_params

# __graft_entry__.py:entry()'s config, and nano (GQA 4/2)
_CONFIGS = {
    "entry": dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=256,
                  vocab_size=512),
    "nano": {},
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


def _configs(name, **kw):
    base = dict(_CONFIGS[name], **kw)
    port_kw = {k: v for k, v in base.items() if k != "attn_impl"}
    jcfg = jllama.LlamaConfig.nano(**base)
    tcfg = tllama.LlamaConfig.nano(**port_kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def nano_weights():
    jcfg = jllama.LlamaConfig.nano()
    tree = numpy_params(jcfg, seed=7)
    return tree, jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(cfg, shape, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size, size=shape).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name,impl", [("entry", "auto"), ("nano", "auto"),
                                       ("nano", "kernel")])
def test_llama_forward_logits_match_jax(nano_weights, name, impl):
    """Logits of the entry() config and of nano; "kernel" takes the
    flash kernels' plain versions on CPU, held to the JAX forward
    through the Pallas kernel in interpret mode."""
    jcfg, tcfg = _configs(name)
    jcfg = dataclasses.replace(jcfg, attn_impl="flash" if impl == "kernel"
                               else "auto")
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    tree = nano_weights[0] if name == "nano" else numpy_params(jcfg, seed=0)
    tokens = _tokens(jcfg, (2, 64 if name == "entry" else 40), seed=1)
    want = jllama.llama_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(tokens), jcfg)
    got = tllama.llama_forward(params_from_numpy(tree, tcfg, device="cpu"),
                               torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, 1e-4)


def _loss_case(case):
    """(config overrides, batch builder) of a llama_loss case."""
    if case == "loss_chunk":
        return dict(loss_chunk=8), "tokens"
    if case == "remat":
        return dict(remat=True), "tokens"
    if case == "kernel":
        return dict(attn_impl="kernel"), "tokens"
    return {}, case


def _batch(kind, cfg, seed):
    if kind == "tokens":
        return {"tokens": _tokens(cfg, (2, 33), seed)}
    rng = np.random.RandomState(seed)
    mask = (rng.rand(2, 32) > 0.3).astype(np.float32)
    return {"inputs": _tokens(cfg, (2, 32), seed),
            "targets": _tokens(cfg, (2, 32), seed + 1), "mask": mask}


@pytest.mark.parametrize("case", ["tokens", "inputs_mask", "loss_chunk",
                                  "remat", "kernel"])
def test_llama_loss_and_grads_match_jax(nano_weights, case):
    """The loss and every gradient leaf against jax.value_and_grad, for
    both batch forms, a mask, loss chunking, per-layer remat and the
    flash autograd path ("kernel": the port's plain flash versions,
    the JAX reference attention)."""
    overrides, kind = _loss_case(case)
    tree, jparams = nano_weights
    jcfg = jllama.LlamaConfig.nano(
        **{k: v for k, v in overrides.items() if k != "attn_impl"})
    tcfg = tllama.LlamaConfig.nano(**overrides)
    batch = _batch(kind, jcfg, seed=2)
    jloss, jgrads = jax.value_and_grad(jllama.llama_loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tparams = ttrain._tree_map(lambda p: p.requires_grad_(),
                               params_from_numpy(tree, tcfg, device="cpu"))
    tloss = tllama.llama_loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    want = jax.tree_util.tree_leaves(jgrads)
    got = ttrain._leaves(tparams)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        _close(g.grad, w, 1e-4)


def test_train_steps_match_jax(nano_weights):
    """Three steps of make_train_step + adamw against
    make_sharded_train_step + optax.adamw(1e-3) on a one-device mesh:
    loss and grad_norm at every step, every parameter after the last."""
    tree, jparams = nano_weights
    jcfg, tcfg = jllama.LlamaConfig.nano(), tllama.LlamaConfig.nano()
    batch = _batch("tokens", jcfg, seed=3)
    mesh = create_mesh({"dp": 1}, jax.devices()[:1])
    jinit, jstep = make_sharded_train_step(
        lambda p, b: jllama.llama_loss(p, b, jcfg), optax.adamw(1e-3), mesh,
        jllama.llama_param_specs(jcfg), donate=False)
    tinit, tstep = ttrain.make_train_step(
        lambda p, b: tllama.llama_loss(p, b, tcfg), ttrain.adamw(1e-3),
        device="cpu")
    jp, jopt = jinit(jparams)
    tp, topt = tinit(params_from_numpy(tree, tcfg, device="cpu"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        jp, jopt, jm = jstep(jp, jopt, jb)
        tp2, topt, tm = tstep(tp, topt, tb)
        assert tp2 is tp, "the step updates params in place"
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        losses.append(tm["loss"].item())
    assert losses[2] < losses[0], losses
    for g, w in zip(ttrain._leaves(tp), jax.tree_util.tree_leaves(jp)):
        _close(g, w, 1e-5)


def test_adamw_has_optax_defaults():
    assert ttrain.adamw(3e-4) == ttrain.AdamW(3e-4, 0.9, 0.999, 1e-8, 1e-4)
    opt = ttrain.adamw(3e-4, weight_decay=0.0).init(
        {"w": torch.zeros(2, requires_grad=True)})
    assert opt.param_groups[0]["weight_decay"] == 0.0
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)


@pytest.mark.parametrize("kw", [dict(remat_policy="bogus"),
                                dict(remat_policy="save:"),
                                dict(remat_policy="save:qkv+nope"),
                                dict(flash_block_q=0),
                                dict(flash_block_k=-8)])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jllama.LlamaConfig(**kw)
    with pytest.raises(ValueError):
        tllama.LlamaConfig(**kw)


@pytest.mark.parametrize("kw", [dict(attn_impl="ring"),
                                dict(attn_impl="ulysses")])
def test_unported_options_raise_not_implemented(kw, nano_weights):
    """The sequence-parallel options, once refused here, run: without an
    sp group (a ring of one block, Ulysses over one rank) llama_forward
    and llama_loss with its gradients equal JAX's with reference
    attention (1e-4; JAX's ring and Ulysses need an sp axis bound by
    shard_map). Their sp > 1 parity is `test_torch_port_sp.py`'s."""
    tree, jparams = nano_weights
    jcfg, tcfg = _configs("nano", attn_impl="reference")
    tcfg = dataclasses.replace(tcfg, **kw)
    tokens = _tokens(jcfg, (2, 17), seed=4)
    params = params_from_numpy(tree, tcfg, device="cpu")
    _close(tllama.llama_forward(params, torch.from_numpy(tokens[:, :-1]),
                                tcfg),
           jllama.llama_forward(jparams, jnp.asarray(tokens[:, :-1]), jcfg),
           1e-4)
    batch = {"tokens": tokens}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jllama.llama_loss(p, batch, jcfg))(jparams)
    leaves = ttrain._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.llama_loss(params, {"tokens": torch.from_numpy(tokens)},
                             tcfg)
    _close(loss, jloss, 1e-4)
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("name", ["llama3_8b", "llama2_7b", "nano"])
def test_flops_per_token_matches_jax(name):
    j = getattr(jllama.LlamaConfig, name)()
    t = getattr(tllama.LlamaConfig, name)()
    for s in (128, 2048):
        assert tllama.llama_flops_per_token(t, s) == \
            jllama.llama_flops_per_token(j, s)


def test_master_weight_dtype():
    """llama_init stores cfg.param_dtype by default (f32 master weights,
    as the JAX llama_init does; bf16 when the config asks), and
    params_from_numpy cfg.dtype (serving); an explicit dtype wins."""
    cfg = tllama.LlamaConfig.nano(dtype=torch.bfloat16)
    tree = numpy_params(jllama.LlamaConfig.nano())
    for dtype, init_want, conv_want in (
            (None, torch.float32, torch.bfloat16),
            (torch.bfloat16, torch.bfloat16, torch.bfloat16),
            (torch.float32, torch.float32, torch.float32)):
        p = tllama.llama_init(cfg, seed=0, device="cpu", dtype=dtype)
        q = params_from_numpy(tree, cfg, device="cpu", dtype=dtype)
        assert {x.dtype for x in ttrain._leaves(p)} == {init_want}
        assert {x.dtype for x in ttrain._leaves(q)} == {conv_want}
    half = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    assert {x.dtype for x in ttrain._leaves(tllama.llama_init(
        half, seed=0, device="cpu"))} == {torch.bfloat16}
    loss = tllama.llama_loss(p, {"tokens": torch.zeros(1, 9,
                                                       dtype=torch.long)},
                             cfg)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def _bf16_head(seed=11):
    """Seeded numpy hidden states [2, 8, 256], lm_head [256, 1000] (f32
    master) and targets of a bf16 config, the hidden states already
    rounded to bf16 (as llama_hidden hands them over)."""
    jcfg = jllama.LlamaConfig.nano(dim=256, vocab_size=1000,
                                   dtype=jnp.bfloat16)
    tcfg = tllama.LlamaConfig.nano(dim=256, vocab_size=1000,
                                   dtype=torch.bfloat16)
    rng = np.random.RandomState(seed)
    h = rng.standard_normal((2, 8, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 1000)) * 256 ** -0.5).astype(np.float32)
    targets = rng.randint(0, 1000, size=(2, 8)).astype(np.int32)
    return jcfg, tcfg, h, w, targets


def test_bf16_logits_and_nll_keep_f32_accumulator():
    """A bf16 config's vocab projection keeps JAX's f32 accumulator
    (preferred_element_type=float32) in `llama_forward` and `_nll`: the
    same bf16 hidden states and lm_head give the same logits and token
    nll at 1e-5 (f32 sums of exact bf16 products in another order).
    Rounding the product to bf16 first is off by ~1e-2."""
    jcfg, tcfg, h, w, targets = _bf16_head()
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    th = torch.from_numpy(h).bfloat16()
    assert np.array_equal(np.asarray(jh.astype(jnp.float32)),
                          th.float().numpy())
    tokens = np.zeros((2, 8), np.int32)
    with mock.patch.object(jllama, "llama_hidden", lambda *a, **k: jh), \
            mock.patch.object(tllama, "llama_hidden", lambda *a, **k: th):
        want = jllama.llama_forward({"lm_head": jnp.asarray(w)},
                                    jnp.asarray(tokens), jcfg)
        got = tllama.llama_forward({"lm_head": torch.from_numpy(w)},
                                   torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, 1e-5)
    want = jllama._nll(jh, jnp.asarray(targets), jnp.asarray(w), jcfg)
    got = tllama._nll(th, torch.from_numpy(targets), torch.from_numpy(w),
                      tcfg)
    _close(got, want, 1e-5)


def test_bf16_nll_grads_match_jax():
    """Gradients of a bf16 config's summed token nll in the hidden
    states (bf16) and the f32 master lm_head, against jax.grad of
    `_nll`: both sum in f32 and round to bf16 at the same points, so
    they agree to within one bf16 rounding (2**-7 relative, 1e-2 here)
    where the f32 sums fall either side of a rounding boundary."""
    jcfg, tcfg, h, w, targets = _bf16_head(seed=12)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    jdh, jdw = jax.grad(
        lambda a, b: jllama._nll(a, jnp.asarray(targets), b, jcfg).sum(),
        argnums=(0, 1))(jh, jnp.asarray(w))
    th = torch.from_numpy(h).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tllama._nll(th, torch.from_numpy(targets), tw, tcfg).sum().backward()
    assert th.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    np.testing.assert_allclose(th.grad.float().numpy(),
                               np.asarray(jdh.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw),
                               rtol=1e-2, atol=1e-6)


# ---------------------------------------------------------------------------
# The reference's configs build in the port (ROADMAP C5)
# ---------------------------------------------------------------------------

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
           jnp.float16: torch.float16}
# nano widths: the bench configs' every other field is kept
_NANO_WIDTHS = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=4, ffn_dim=128, max_seq_len=64)


def _port_config(jcfg):
    """The port config with every field of the JAX one, dtypes mapped:
    the two configs have the same fields, ``ring_axis`` (the sp axis
    name) included."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    port_fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    assert set(fields) == port_fields
    assert tllama.LlamaConfig().ring_axis == jllama.LlamaConfig().ring_axis
    for k, v in fields.items():
        if not isinstance(v, (bool, int, float, str, type(None))):
            fields[k] = _DTYPES[jnp.dtype(v).type]
    return tllama.LlamaConfig(**fields)


@pytest.mark.parametrize("name", ["flagship_config", "large_config"])
def test_bench_configs_build_and_train(name):
    """bench.py's two training configs build as port configs field for
    field (attn_impl="flash"; large's bf16 param_dtype) and, cut to nano
    widths, take a make_train_step step from llama_init's master weights
    in param_dtype."""
    import bench

    jcfg = getattr(bench, name)()
    tcfg = _port_config(jcfg)
    assert tcfg.attn_impl == "flash" == jcfg.attn_impl
    assert tcfg.param_dtype == _DTYPES[jnp.dtype(jcfg.param_dtype).type]
    small = dataclasses.replace(tcfg, **_NANO_WIDTHS)
    params = tllama.llama_init(small, seed=0, device="cpu")
    assert {x.dtype for x in ttrain._leaves(params)} == {small.param_dtype}
    init_fn, step_fn = ttrain.make_train_step(
        lambda p, b: tllama.llama_loss(p, b, small),
        ttrain.adamw(1e-3, weight_decay=0.0), device="cpu")
    params, opt = init_fn(params)
    tokens = torch.from_numpy(_tokens(small, (2, 17), seed=4)).long()
    params, opt, m = step_fn(params, opt, {"tokens": tokens})
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert {x.dtype for x in ttrain._leaves(params)} == {small.param_dtype}


def test_flash_spelling_equals_kernel(nano_weights):
    """attn_impl="flash" (the JAX package's name) runs what "kernel"
    runs: the same forward, bit for bit, through `attention`, and the
    same kernel wrapper through the paged `paged_attention` seam."""
    from ray_tpu_torch.ops import attention as tattn

    tree = nano_weights[0]
    tokens = torch.from_numpy(_tokens(jllama.LlamaConfig.nano(), (2, 24),
                                      seed=5)).long()
    outs = []
    for impl in ("flash", "kernel"):
        cfg = tllama.LlamaConfig.nano(attn_impl=impl)
        outs.append(tllama.llama_forward(
            params_from_numpy(tree, cfg, device="cpu"), tokens, cfg))
    assert torch.equal(outs[0], outs[1])
    # the paged seam routes both spellings to B2's wrapper, which takes
    # CUDA tensors only (CPU tensors take impl="reference")
    q = torch.zeros(2, 1, 4, 64)
    pages = torch.zeros(5, 4, 2, 64)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    slots = torch.tensor([[5], [7]], dtype=torch.int32)
    for impl in ("flash", "kernel"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tattn.paged_attention(q, pages, pages, bt, slots,
                                  kv_valid_len=8, impl=impl)
