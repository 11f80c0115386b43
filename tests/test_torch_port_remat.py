"""PyTorch port, the remat policies of `llama_hidden`: "full",
"save_dots" and "save:<names>" on nano (per-layer checkpoints on).

Each policy's loss and gradients equal `jax.value_and_grad` of the JAX
package's `llama_loss` under the same policy at 1e-4 abs/rel (the
tolerance of `test_torch_port_train.py::test_train_steps_match_jax`:
f32, summation order), and equal the port's own "full" bit for bit (a
policy changes what is kept, not a value). What each policy keeps shows
in the products its backward reruns, counted by the name they carry
(`llama._named`), and in the attention's one recompute per layer.
"""

import collections
import faulthandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jllama
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.ops import flash_attention as tfa
from torch_port_helpers import numpy_params

POLICIES = ("full", "save_dots", "save:ffn_gate+ffn_up+ffn_down",
            "save:qkv+attn_out+wo_out")
# products rerun in the backward, per layer, by name. "full" reruns six
# of the seven: the recompute stops at the last tensor the backward
# needs, before ffn_down's product (as JAX's partial evaluation drops
# it). bench.py's policy reruns the four attention products.
RERUN = {
    "full": {"qkv": 3, "wo_out": 1, "ffn_gate": 1, "ffn_up": 1},
    "save_dots": {},
    "save:ffn_gate+ffn_up+ffn_down": {"qkv": 3, "wo_out": 1},
    "save:qkv+attn_out+wo_out": {"ffn_gate": 1, "ffn_up": 1},
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


class _CountProducts(TorchDispatchMode):
    """Matrix products dispatched while active, by checkpoint name."""

    def __init__(self):
        super().__init__()
        self.by_name = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in tllama._PRODUCT_OPS:
            self.by_name[tllama._CHECKPOINT_NAME.get()] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def weights_and_batch():
    cfg = jllama.LlamaConfig.nano()
    rng = np.random.RandomState(4)
    return numpy_params(cfg, seed=3), {
        "tokens": rng.randint(0, cfg.vocab_size, (2, 25)).astype(np.int32)}


def _port_loss_and_grads(tree, batch, policy, attn_impl="auto"):
    cfg = tllama.LlamaConfig.nano(remat=True, remat_policy=policy,
                                  attn_impl=attn_impl)
    params = ttrain._tree_map(lambda p: p.requires_grad_(),
                              params_from_numpy(tree, cfg, device="cpu"))
    loss = tllama.llama_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    with _CountProducts() as counter:
        grads = torch.autograd.grad(loss, ttrain._leaves(params))
    return loss.detach(), grads, counter.by_name


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_jax(weights_and_batch, policy):
    tree, batch = weights_and_batch
    jcfg = jllama.LlamaConfig.nano(remat=True, remat_policy=policy)
    jloss, jgrads = jax.value_and_grad(jllama.llama_loss)(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, grads, _ = _port_loss_and_grads(tree, batch, policy)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want) == 12
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_keeps_values_and_reruns_what_it_does_not_save(
        weights_and_batch, policy):
    """Through the flash autograd path (its plain versions on the CPU):
    loss and grads bit-equal to "full"; the backward reruns exactly the
    products the policy does not keep, and the attention forward once
    per layer (its lse is no named value)."""
    tree, batch = weights_and_batch
    n_layers = tllama.LlamaConfig.nano().n_layers
    calls = collections.Counter()
    real = tfa._flash_fwd_reference

    def counted(*args, **kwargs):
        calls["fwd"] += 1
        return real(*args, **kwargs)

    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "_flash_fwd_reference", counted)
        for pol in ("full", policy):
            calls.clear()
            got[pol] = _port_loss_and_grads(tree, batch, pol, "kernel")
            assert calls["fwd"] == 2 * n_layers, (pol, calls)
    (loss, grads, reruns), (floss, fgrads, _) = got[policy], got["full"]
    assert torch.equal(loss, floss)
    assert all(torch.equal(a, b) for a, b in zip(grads, fgrads))
    want = {name: n * n_layers for name, n in RERUN[policy].items()}
    assert {k: v for k, v in reruns.items() if k is not None} == want
