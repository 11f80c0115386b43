"""PyTorch port, Mixtral-style MoE: `ray_tpu_torch.models.moe` against
`ray_tpu.models.moe`, and its `ep` and `tp` axes and global routing
under `make_sharded_train_step` against JAX's step.

The same seeded numpy weights and tokens go to both packages (the
port's through `ray_tpu_torch.convert`). f32 throughout. Tolerances:
logits and losses 1e-5, gradients 1e-4 (relative to each leaf's largest
gradient: the difference is summation order); routing tensors exactly.
The {"dp": 2, "ep": 2} world runs once per session in fresh
interpreters (`torch_port_a13`), its JAX side on the virtual CPU
devices: losses and grad norms within 1e-4 relative, the first step's
gradient shards within 1e-4 of JAX's, the params after three AdamW steps
within 1e-5 with an absolute floor of lr / 10. The {"tp": 2} and
{"ep": 2, "tp": 2} steps are held the same way, and each rank's leaf
shapes to JAX's shards'.
"""

import faulthandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_a13 as a13
from ray_tpu.models import moe as jmoe
from ray_tpu_torch.convert import moe_params_from_numpy
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.training import _leaves, _tree_map
from torch_port_helpers import flat_tree, once


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


def _configs(**kw):
    kw = dict({"dtype": "float32", "remat": False}, **kw)
    return (jmoe.MoeConfig.nano_moe(**a13.jax_kw(kw)),
            tmoe.MoeConfig.nano_moe(**a13.torch_kw(kw)))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tokens(cfg, seed=0, shape=(4, 17)):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("capacity", [1.25, 0.5], ids=["even", "drops"])
@pytest.mark.parametrize("remat", [False, True])
def test_moe_matches_jax(capacity, remat):
    """Logits, aux loss, loss and every gradient of `moe_loss` equal
    JAX's; ``drops`` routes at half the even capacity, so tokens are
    dropped; ``remat`` checkpoints each layer (same values)."""
    jcfg, tcfg = _configs(capacity_factor=capacity, remat=remat)
    tree = a13.moe_numpy_params(jcfg, seed=3)
    tokens = _tokens(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jlogits, jaux = jmoe.moe_forward(jparams, jnp.asarray(tokens[:, :-1]),
                                     jcfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jmoe.moe_loss(
        p, {"tokens": jnp.asarray(tokens)}, jcfg))(jparams)

    params = _tree_map(lambda x: x.requires_grad_(True), moe_params_from_numpy(
        tree, tcfg, device="cpu", dtype=torch.float32))
    logits, aux = tmoe.moe_forward(params, torch.tensor(tokens[:, :-1]),
                                   tcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    loss = tmoe.moe_loss(params, {"tokens": torch.tensor(tokens)}, tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    for g, w in zip(_leaves(params), jax.tree_util.tree_leaves(jgrads)):
        assert _rel(g.grad.numpy(), w) <= 1e-4


def _jax_routing(xf, w_router, cfg):
    """`ray_tpu.models.moe._moe_ffn`'s routing lines."""
    gates = jax.nn.softmax(jnp.einsum("gd,de->ge", xf, w_router), axis=-1)
    weights, expert_idx = jmoe._route_topk(gates, cfg.top_k)
    flat = jax.nn.one_hot(expert_idx, cfg.n_experts,
                          dtype=jnp.int32).reshape(-1, cfg.n_experts)
    position = jnp.cumsum(flat, axis=0) - 1
    position = (position * flat).sum(-1).reshape(expert_idx.shape)
    return gates, weights, expert_idx, position


@pytest.mark.parametrize("router", ["seeded", "tied"])
def test_routing_exact(router):
    """`_route`'s expert choices, capacity positions and in-capacity mask
    equal JAX's exactly (the weights and gates to 1e-6); ``tied`` gives
    every expert the same gate, where `jax.lax.top_k` picks the lowest
    indices first."""
    jcfg, tcfg = _configs(capacity_factor=0.5)
    rng = np.random.RandomState(1)
    xf = rng.standard_normal((40, jcfg.dim)).astype(np.float32)
    w = (rng.standard_normal((jcfg.dim, jcfg.n_experts)) * 0.2
         ).astype(np.float32)
    if router == "tied":
        w[:] = 0.0
    want = _jax_routing(jnp.asarray(xf), jnp.asarray(w), jcfg)
    got = tmoe._route(torch.tensor(xf), torch.tensor(w), tcfg)
    capacity = int(jcfg.capacity_factor * 40 * jcfg.top_k / jcfg.n_experts)
    for g, x in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal((got[3] < capacity).numpy(),
                                  np.asarray(want[3] < capacity))
    if router == "tied":
        assert (got[2].numpy() == [0, 1]).all()
    else:
        assert not (got[3] < capacity).numpy().all()     # tokens dropped


@pytest.mark.parametrize("name", ["mixtral_8x7b", "nano_moe"])
def test_counts_match_jax(name):
    """num_params, active_params and moe_flops_per_token equal JAX's."""
    jcfg = getattr(jmoe.MoeConfig, name)()
    tcfg = getattr(tmoe.MoeConfig, name)()
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.active_params() == jcfg.active_params()
    assert tmoe.moe_flops_per_token(tcfg, 2048) == \
        jmoe.moe_flops_per_token(jcfg, 2048)
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "ffn_dim", "n_experts", "top_k", "capacity_factor",
                  "router_aux_coef", "max_seq_len", "rope_theta"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


def test_specs_match_jax():
    """moe_param_specs under the default rules equal JAX's
    PartitionSpecs."""
    jcfg, tcfg = _configs()
    want = flat_tree(jax.tree_util.tree_map(
        tuple, jmoe.moe_param_specs(jcfg),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert flat_tree(tmoe.moe_param_specs(tcfg)) == want


def test_remat_policy_refused():
    for policy in ("save_dots", "save:qkv"):
        with pytest.raises(ValueError, match="remat_policy='full' only"):
            tmoe.MoeConfig.nano_moe(remat_policy=policy)
        with pytest.raises(ValueError):
            jmoe.MoeConfig.nano_moe(remat_policy=policy)


def test_expert_shards_need_their_group():
    """Params holding half the experts without an ep group raise, as a
    tp shard without its group does in Llama."""
    _, tcfg = _configs()
    params = tmoe.moe_init(tcfg, device="cpu")
    params["layers"] = {k: (v[:, :2] if k.startswith("we_") else v)
                        for k, v in params["layers"].items()}
    with pytest.raises(ValueError, match="expert-parallel shards"):
        tmoe.moe_loss(params, {"tokens": torch.tensor(_tokens(tcfg))}, tcfg)


def test_init_shapes_and_scales():
    """moe_init builds JAX's tree, shapes and dtypes (seeded draws)."""
    jcfg, tcfg = _configs()
    want = flat_tree(jax.tree_util.tree_map(
        lambda x: x.shape, jmoe.moe_init(jax.random.PRNGKey(0), jcfg)))
    got = tmoe.moe_init(tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in flat_tree(got).items()} == want
    again = tmoe.moe_init(tcfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(_leaves(got),
                                                 _leaves(again)))
    assert got["layers"]["we_gate"].dtype == torch.float32


def test_dp_ep_step_matches_jax(worlds):
    """{"dp": 2, "ep": 2} over four gloo ranks against JAX's step over
    MeshSpec(dp=2, ep=2): three steps' losses and grad norms, the first
    step's gradient shards (each rank's experts) and the final params.
    The batch is one where routing each dp shard on its own would give
    another loss (JAX's loss on the whole batch != the mean of its two
    halves'), so the global capacity count is what makes them equal."""
    ranks, ref = worlds["w4"]
    jm = ref["moe_step"]
    assert abs(jm["whole"] - np.mean(jm["halves"])) > 1e-2
    assert sorted(tuple(r["moe_step"]["ep"]) for r in ranks) == \
        [(0, 2), (0, 2), (1, 2), (1, 2)]
    for r in ranks:
        got = r["moe_step"]
        np.testing.assert_allclose(got["metrics"], jm["metrics"], rtol=1e-4)
        np.testing.assert_allclose(got["metrics"][0][0], jm["whole"],
                                   rtol=1e-5)
        e0, el = got["ep"][0] * 2, 2
        for k, g in got["grads"].items():
            want = np.asarray(jm["grads"][k])
            if "/we_" in k:
                want = want[:, e0:e0 + el]
            assert _rel(g, want) <= 1e-4, k
        for k, p in got["params"].items():
            want = np.asarray(jm["params"][k])
            if "/we_" in k:
                want = want[:, e0:e0 + el]
            np.testing.assert_allclose(p, want, rtol=1e-5, atol=a13.LR / 10)


@pytest.mark.parametrize("case,shards", [
    ("moe-tp2", {"layers/we_down": [2, 4, 64, 64], "tok_embed": [128, 64],
                 "layers/wq": [2, 64, 2, 16],
                 "layers/w_router": [2, 64, 4]}),
    ("moe-ep2-tp2", {"layers/we_gate": [2, 2, 64, 64],
                     "layers/we_down": [2, 2, 64, 64],
                     "lm_head": [64, 128]})])
def test_tp_step_matches_jax(worlds, case, shards):
    """`moe_loss(..., tp=)` under make_sharded_train_step over {"tp": 2}
    and {"ep": 2, "tp": 2} against JAX's step on the same mesh
    (`a13.check_tp_case`): the heads as Llama's, the expert widths and
    the vocab split over tp, the router whole on every rank."""
    specs = flat_tree(tmoe.moe_param_specs(_configs()[1]))
    for out in a13.check_tp_case(worlds, case, specs, _rel):
        for name, shape in shards.items():
            assert out["shapes"][name] == shape, (name, out["shapes"][name])


def test_batch_split_reaches_a_recompute_on_another_thread():
    """The step's batch split is bound into each MoE layer at forward
    time, so a checkpoint's recompute routes as the forward did even when
    the backward runs on another thread (autograd's device thread on the
    card does not see the step's context). The split here is rank 1 of a
    twin pair whose other rank holds the same rows (collectives faked);
    the gradients of a backward on another thread equal those of one on
    this thread."""
    import threading
    from unittest import mock

    from ray_tpu_torch.parallel import data_parallel as dp

    _, tcfg = _configs(capacity_factor=0.5, remat=True)
    tokens = torch.tensor(_tokens(tcfg))
    twin = dp.BatchSplit(group=None, rank=1, size=2)
    fakes = dict(
        gather_over_batch=lambda x, split: torch.stack([x.detach()] * 2),
        sum_over_batch=lambda x, split: 2 * x.detach(),
        summed_over_batch=lambda x, split: 2 * x)

    def grads(other_thread):
        params = _tree_map(lambda x: x.requires_grad_(True),
                           tmoe.moe_init(tcfg, seed=1, device="cpu"))
        with mock.patch.multiple(dp, **fakes), dp.batch_split(twin):
            loss = tmoe.moe_loss(params, {"tokens": tokens}, tcfg)
        errors = []

        def backward():
            try:
                with mock.patch.multiple(dp, **fakes):
                    loss.backward()
            except Exception as e:      # noqa: BLE001 - reported below
                errors.append(e)

        if other_thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        else:
            backward()
        assert not errors, errors
        return [p.grad for p in _leaves(params)]

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)
