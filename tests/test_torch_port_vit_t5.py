"""PyTorch port, the other model families: ViT, T5 (with its cached
generation) and the MLP against `ray_tpu.models.vit`, `.t5` and `.mlp`;
T5's step over {"dp": 2} against JAX's; the three families under steps
that split tp ({"tp": 2}, and ViT and T5 over {"fsdp": 2, "tp": 2})
against JAX's step on the same mesh; the fused-qkv exchange's index
math; a tp group of one rank against no group (MoE too); the refusal of an sp-split step (ROADMAP A13b); and the flash
kernels' plain versions at head dim 32 (ViT's) against JAX's
`mha_reference`.

The same seeded numpy weights and inputs go to both packages. f32
throughout. Tolerances: logits and losses 1e-5, gradients 1e-4
(relative to each leaf's largest: summation order), generated greedy
tokens exactly; the dp = 2 and the tp steps (once per session,
`torch_port_a13`): losses and grad norms within 1e-4 relative, the
first step's gradient blocks within 1e-4 (relative to the leaf's
largest), the params after three AdamW steps within 1e-5 with an
absolute floor of lr / 10, and each rank's leaf shapes equal to JAX's
shards'; the index math and the one-rank group exactly.
"""

import faulthandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_a13 as a13
from ray_tpu.models import mlp as jmlp
from ray_tpu.models import t5 as jt5
from ray_tpu.models import vit as jvit
from ray_tpu.ops.attention import mha_reference as j_mha
from ray_tpu_torch import convert
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models import t5 as tt5
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.training import _leaves, _tree_map
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops import flash_attention_kernel as fak
from ray_tpu_torch.parallel import data_parallel as dp
from ray_tpu_torch.parallel import tensor_parallel as ttp
from torch_port_helpers import flat_tree, once

VIT = dict(image_size=8, patch_size=4, dim=64, n_layers=2, n_heads=2,
           ffn_dim=96, num_classes=10)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(a13.COMPUTE_S + 60, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "torch_port_a13", "a13-worlds",
                a13.compute)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check_grads(params, jgrads):
    for g, w in zip(_leaves(params), jax.tree_util.tree_leaves(jgrads)):
        assert _rel(g.grad.numpy(), w) <= 1e-4


def _leaf_params(tree):
    return _tree_map(lambda x: x.requires_grad_(True), tree)


@pytest.mark.parametrize("remat", [False, True])
def test_vit_matches_jax(remat):
    """Logits, loss and every gradient of a head-dim-32 ViT (patchify,
    tanh GELU, f32 layernorm rounded before scale and bias)."""
    jcfg = jvit.ViTConfig(**VIT, dtype=jnp.float32, remat=remat)
    tcfg = tvit.ViTConfig(**VIT, dtype=torch.float32, remat=remat)
    assert tcfg.dim // tcfg.n_heads == 32
    tree = a13.vit_numpy_params(jcfg, seed=1)
    rng = np.random.RandomState(2)
    batch = {"images": rng.rand(3, 8, 8, 3).astype(np.float32),
             "labels": rng.randint(0, 10, (3,)).astype(np.int32)}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jvit.vit_loss(p, jb, jcfg))(jp)
    params = _leaf_params(convert.vit_params_from_numpy(
        tree, tcfg, device="cpu", dtype=torch.float32))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        tvit.vit_forward(params, tb["images"], tcfg).detach().numpy(),
        np.asarray(jvit.vit_forward(jp, jb["images"], jcfg)),
        rtol=1e-5, atol=1e-5)
    loss = tvit.vit_loss(params, tb, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    _check_grads(params, jgrads)


@pytest.mark.parametrize("remat", [False, True])
def test_t5_matches_jax(remat):
    """Encoder memory, decoder logits (the tied head), the pad-masked
    loss and every gradient."""
    jcfg = jt5.T5Config.nano(dtype=jnp.float32, remat=remat)
    tcfg = tt5.T5Config.nano(dtype=torch.float32, remat=remat)
    tree = a13.t5_numpy_params(jcfg, seed=2)
    batch = a13.t5_batch(jcfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jloss, jgrads = jax.value_and_grad(lambda p: jt5.t5_loss(p, jb, jcfg))(jp)
    params = _leaf_params(convert.t5_params_from_numpy(
        tree, tcfg, device="cpu", dtype=torch.float32))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        tt5.t5_encode(params, tb["src"], tcfg).detach().numpy(),
        np.asarray(jt5.t5_encode(jp, jb["src"], jcfg)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        tt5.t5_forward(params, tb["src"], tb["tgt"], tcfg).detach().numpy(),
        np.asarray(jt5.t5_forward(jp, jb["src"], jb["tgt"], jcfg)),
        rtol=1e-5, atol=1e-5)
    loss = tt5.t5_loss(params, tb, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    _check_grads(params, jgrads)


@pytest.mark.parametrize("case", ["plain", "eos", "src_live"])
def test_t5_generate_greedy_matches_jax(case):
    """`t5_generate`'s greedy tokens equal JAX's token for token; ``eos``
    stops rows at a token the model emits (after it a row emits eos),
    ``src_live`` masks source positions out of the cross-attention."""
    jcfg = jt5.T5Config.nano(dtype=jnp.float32)
    tcfg = tt5.T5Config.nano(dtype=torch.float32)
    tree = a13.t5_numpy_params(jcfg, seed=6)
    src = a13.t5_batch(jcfg, 7)["src"]
    kw = {}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    params = convert.t5_params_from_numpy(tree, tcfg, device="cpu",
                                          dtype=torch.float32)
    if case == "eos":
        first = np.asarray(jt5.t5_generate(jp, jnp.asarray(src), jcfg,
                                           max_new_tokens=12))
        kw["eos_id"] = int(first[0, 2])
    if case == "src_live":
        live = np.random.RandomState(8).rand(*src.shape) > 0.4
        live[:, 0] = True
        kw["src_live"] = live
    want = np.asarray(jt5.t5_generate(
        jp, jnp.asarray(src), jcfg, max_new_tokens=12,
        **{k: jnp.asarray(v) if k == "src_live" else v
           for k, v in kw.items()}))
    got = tt5.t5_generate(params, torch.tensor(src), tcfg, max_new_tokens=12,
                          **{k: torch.tensor(v) if k == "src_live" else v
                             for k, v in kw.items()})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "eos":
        row = got[0].tolist()
        assert row[row.index(kw["eos_id"]):] == \
            [kw["eos_id"]] * (12 - row.index(kw["eos_id"]))


def test_t5_generate_sampled_port_semantics():
    """Sampling draws from the caller's generator: the same seed gives the
    same tokens, the tokens lie in the vocab, and a temperature near 0
    gives the greedy tokens (JAX's threefry bits are not reproduced)."""
    tcfg = tt5.T5Config.nano(dtype=torch.float32)
    params = tt5.t5_init(tcfg, seed=1, device="cpu")
    src = torch.tensor(a13.t5_batch(tcfg, 7)["src"])

    def sample(seed, temperature=1.0):
        return tt5.t5_generate(params, src, tcfg, max_new_tokens=8,
                               greedy=False, temperature=temperature,
                               rng=torch.Generator().manual_seed(seed))

    a, b = sample(3), sample(3)
    assert torch.equal(a, b) and not torch.equal(a, sample(4))
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()
    greedy = tt5.t5_generate(params, src, tcfg, max_new_tokens=8)
    assert torch.equal(sample(5, temperature=1e-6), greedy)


def test_mlp_matches_jax():
    jcfg = jmlp.MLPConfig(in_dim=20, hidden=(16, 12))
    tcfg = tmlp.MLPConfig(in_dim=20, hidden=(16, 12))
    tree = a13.mlp_numpy_params(jcfg, seed=3)
    rng = np.random.RandomState(4)
    batch = {"x": rng.rand(6, 20).astype(np.float32),
             "y": rng.randint(0, 10, (6,)).astype(np.int32)}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = jax.value_and_grad(lambda p: jmlp.mlp_loss(
        p, jax.tree_util.tree_map(jnp.asarray, batch), jcfg))(jp)
    params = _leaf_params(convert.mlp_params_from_numpy(tree, tcfg,
                                                        device="cpu"))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        tmlp.mlp_forward(params, tb["x"], tcfg).detach().numpy(),
        np.asarray(jmlp.mlp_forward(jp, jnp.asarray(batch["x"]), jcfg)),
        rtol=1e-5, atol=1e-6)
    loss = tmlp.mlp_loss(params, tb, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    _check_grads(params, jgrads)


def test_configs_and_specs_match_jax():
    """num_params, shapes of the init trees and the param specs of ViT's
    and T5's default configs equal JAX's; MLPConfig's defaults too."""
    for jcfg, tcfg, jinit, tinit, jspecs, tspecs in (
            (jvit.ViTConfig(), tvit.ViTConfig(), jvit.vit_init,
             tvit.vit_init, jvit.vit_param_specs, tvit.vit_param_specs),
            (jt5.T5Config.nano(), tt5.T5Config.nano(), jt5.t5_init,
             tt5.t5_init, jt5.t5_param_specs, tt5.t5_param_specs)):
        assert tcfg.num_params() == jcfg.num_params()
        shapes = flat_tree(jax.tree_util.tree_map(
            lambda x: tuple(x.shape), jinit(jax.random.PRNGKey(0), jcfg)))
        got = tinit(tcfg, device="cpu")
        assert {k: tuple(v.shape) for k, v in flat_tree(got).items()} \
            == shapes
        assert sum(v.numel() for v in _leaves(got)) == tcfg.num_params()
        want = flat_tree(jax.tree_util.tree_map(
            tuple, jspecs(jcfg),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        assert flat_tree(tspecs(tcfg)) == want
    assert tt5.T5Config().num_params() == jt5.T5Config().num_params()
    assert tmlp.MLPConfig() == tmlp.MLPConfig(784, (512, 512), 10)
    assert jmlp.MLPConfig().hidden == tmlp.MLPConfig().hidden


def test_converters_check_keys():
    tcfg = tt5.T5Config.nano()
    tree = a13.t5_numpy_params(jt5.T5Config.nano(), seed=0)
    del tree["dec_final_norm"]
    with pytest.raises(ValueError, match="keys"):
        convert.t5_params_from_numpy(tree, tcfg, device="cpu")


def test_t5_dp_step_uneven_pads_matches_jax(worlds):
    """{"dp": 2} over two gloo ranks whose shards hold 14 and 2 live
    labels of 16: three AdamW steps against JAX's step (a pad-masked mean
    over the GLOBAL batch; a mean of the two shards' means would give
    another loss)."""
    ranks, ref = worlds["w2"]
    want = ref["t5_step"]
    for out in ranks:
        got = out["t5_step"]
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=1e-4)
        for k, p in got["params"].items():
            np.testing.assert_allclose(p, want["params"][k], rtol=1e-5,
                                       atol=a13.LR / 10)


# one leaf a case whose rank shard the JAX tests name: ViT's wqkv as
# [L, d / fsdp, 3d / tp], T5's cross_wq as [L, d / fsdp, heads / tp, k]
TP_SHARDS = {
    "vit-tp2": {"layers/wqkv": [2, 64, 96], "head": [64, 5]},
    "vit-fsdp2-tp2": {"layers/wqkv": [2, 32, 96], "head": [32, 5]},
    "t5-tp2": {"decoder/cross_wq": [2, 64, 2, 16], "embed": [128, 64]},
    "t5-fsdp2-tp2": {"decoder/cross_wq": [2, 32, 2, 16], "embed": [128, 32]},
    "mlp-tp2": {"layer0/w": [20, 16]},
}


@pytest.mark.parametrize("case", list(TP_SHARDS))
def test_tp_split_step_matches_jax(worlds, case):
    """ViT, T5 and the MLP under make_sharded_train_step over {"tp": 2}
    (ViT and T5 also over {"fsdp": 2, "tp": 2}, the JAX tests' fsdp x
    tp) against JAX's step on the same mesh (`a13.check_tp_case`); the
    shards are really split, as the JAX tests check them, and the MLP,
    which names no logical axes, runs whole on every rank."""
    model = case.split("-")[0]
    if model == "vit":
        specs = tvit.vit_param_specs(tvit.ViTConfig(**a13.torch_kw(
            a13.TP_VIT_KW)))
    elif model == "t5":
        specs = tt5.t5_param_specs(tt5.T5Config.nano())
    else:
        specs = _tree_map(lambda _: (), a13.mlp_numpy_params(
            tmlp.MLPConfig(**a13.TP_MLP_KW)))
    got = a13.check_tp_case(worlds, case, flat_tree(specs), _rel)
    for out in got:
        for name, shape in TP_SHARDS[case].items():
            assert out["shapes"][name] == shape, (name, out["shapes"][name])


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_fused_heads_index_math(tp):
    """The fused-qkv exchange at tp 2, 3 and 4 (12 heads of 4): each
    rank's contiguous shard of ``wqkv`` [5, 3·48] gathered gives its
    heads' q/k/v columns, the full matrix's ``[3, heads, head_dim]``
    slice; and its backward hands each rank the columns of its own
    shard of the full-width gradient the ranks' head columns make up.
    `_FusedHeads` runs with the gathers faked from the shards."""
    from unittest import mock

    rng = np.random.RandomState(tp)
    d, h, hd = 48, 12, 4
    full = torch.tensor(rng.standard_normal((5, 3 * d)))
    heads = full.reshape(5, 3, h, hd)
    hl = h // tp
    grads = [torch.tensor(rng.standard_normal((5, 3 * d // tp)))
             for _ in range(tp)]
    whole = torch.zeros(5, 3, h, hd, dtype=full.dtype)
    for r in range(tp):
        whole[:, :, r * hl:(r + 1) * hl] = grads[r].reshape(5, 3, hl, hd)
    whole = whole.reshape(5, 3 * d)
    shards = full.chunk(tp, dim=-1)
    for r in range(tp):
        cols = ttp.fused_head_columns(d, r, tp)
        want = heads[:, :, r * hl:(r + 1) * hl].reshape(5, -1)
        assert torch.equal(full[:, cols], want)
        group = ttp.TPGroup(object(), r, tp, False)
        # the forward gathers the shards, the backward the ranks' grads
        calls = iter([shards, grads])

        def gathered(op, x, g, host=False, calls=calls, group=group):
            assert op == "gather" and g is group
            return torch.stack(next(calls))

        w = shards[r].clone().requires_grad_()
        with mock.patch.object(ttp, "collective", gathered):
            out = ttp.fused_heads(w, group, d, h)
            assert torch.equal(out, want)
            (gw,) = torch.autograd.grad(out, w, grads[r])
        assert torch.equal(gw, whole.chunk(tp, dim=-1)[r])


def test_tp_shards_need_their_group():
    """ViT's and T5's tp shards without their group, or a whole leaf
    under a split group, raise instead of running as another model."""
    vcfg = tvit.ViTConfig(**a13.torch_kw(a13.TP_VIT_KW))
    params = tvit.vit_init(vcfg, device="cpu")
    params["layers"]["wqkv"] = params["layers"]["wqkv"][..., :96]
    with pytest.raises(ValueError, match="need their group"):
        tvit.vit_forward(params, torch.zeros(1, 8, 8, 3), vcfg)
    tcfg = tt5.T5Config.nano(dtype=torch.float32)
    tparams = tt5.t5_init(tcfg, device="cpu")
    with pytest.raises(ValueError, match="split over tp"):
        tt5.t5_encode(tparams, torch.ones(1, 4, dtype=torch.long), tcfg,
                      ttp.TPGroup(object(), 0, 2, False))


@pytest.mark.parametrize("model", ["moe", "vit", "t5"])
def test_size_one_tp_group_is_the_unsplit_step(model):
    """A tp group of one rank (what `tp_group` gives for a mesh whose tp
    axis has size 1) runs no collective and no other op: the loss and
    every gradient equal those of the call without a group, bit for
    bit."""
    from ray_tpu_torch.models import moe as tmoe

    rng = np.random.RandomState(5)
    if model == "moe":
        cfg = tmoe.MoeConfig.nano_moe(dtype=torch.float32)
        params = tmoe.moe_init(cfg, device="cpu")
        batch = {"tokens": torch.from_numpy(rng.randint(0, 256, (2, 9)))}
        loss_fn = tmoe.moe_loss
    elif model == "vit":
        cfg = tvit.ViTConfig(**VIT, dtype=torch.float32)
        params = tvit.vit_init(cfg, device="cpu")
        batch = {"images": torch.from_numpy(
            rng.rand(2, 8, 8, 3).astype(np.float32)),
            "labels": torch.from_numpy(rng.randint(0, 10, 2))}
        loss_fn = tvit.vit_loss
    else:
        cfg = tt5.T5Config.nano(dtype=torch.float32)
        params = tt5.t5_init(cfg, device="cpu")
        batch = {"src": torch.from_numpy(rng.randint(1, 256, (2, 6))),
                 "tgt": torch.from_numpy(rng.randint(0, 256, (2, 5)))}
        loss_fn = tt5.t5_loss
    leaves = [p.requires_grad_() for p in _leaves(params)]
    runs = []
    for tp in (None, ttp.tp_group(None)):
        loss = loss_fn(params, batch, cfg, tp=tp)
        runs.append([loss] + list(torch.autograd.grad(loss, leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_sp_split_step_refuses_in_process():
    """The same refusal for a step whose mesh splits sp (the batch split
    the step publishes, set here by hand)."""
    tcfg = tvit.ViTConfig(**VIT, dtype=torch.float32)
    params = tvit.vit_init(tcfg, device="cpu")
    batch = {"images": torch.rand(2, 8, 8, 3),
             "labels": torch.zeros(2, dtype=torch.long)}
    with dp.batch_split(dp.BatchSplit(None, 0, 1, {"sp": 2, "dp": 1})):
        with pytest.raises(NotImplementedError, match="A13b"):
            tvit.vit_loss(params, batch, tcfg)
    tvit.vit_loss(params, batch, tcfg)      # outside a step it runs


@pytest.mark.parametrize("causal,sq,sk,h,hkv", [
    (False, 17, 17, 4, 4), (True, 24, 24, 4, 2), (False, 8, 20, 2, 2)],
    ids=["vit", "causal-gqa", "cross"])
def test_flash_plain_head_dim_32_matches_mha_reference(causal, sq, sk, h,
                                                       hkv):
    """B1's and B3's plain versions at D = 32 (ViT's head dim): the
    forward against `ray_tpu`'s `mha_reference` within 1e-5, dq, dk and
    dv against its vjp within 1e-4; the kernels' wrappers list 32."""
    assert 32 in fak.HEAD_DIMS
    rng = np.random.RandomState(9)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in
                  ((2, h, sq, 32), (2, hkv, sk, 32), (2, hkv, sk, 32),
                   (2, h, sq, 32)))
    want, back = jax.vjp(lambda *x: j_mha(*x, causal=causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wgrads = back(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    for got, w in zip(grads, wgrads):
        assert _rel(got.numpy(), w) <= 1e-4
