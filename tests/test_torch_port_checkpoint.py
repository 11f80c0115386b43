"""PyTorch port, array checkpoints and `convert.params_to_numpy`.

A checkpoint written by either package's `save_pytree` restores in the
other bit for bit (f32, bf16, int8 and fp8 leaves; whole and sharded),
a torn checkpoint raises in both, and a run resumed from a checkpoint
of its params and AdamW state takes the uninterrupted run's next step
bit for bit. The gloo worlds of `test_torch_port_sharded.py` save under
a mesh and restore under another.
"""

import faulthandler
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import create_mesh
from ray_tpu.train import array_checkpoint as jckpt
from ray_tpu_torch.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.train import array_checkpoint as tckpt
from torch_port_helpers import byte_view, numpy_params, to_torch


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


def _numpy_tree():
    """Seeded leaves of every stored dtype, numpy (ml_dtypes) side."""
    rng = np.random.RandomState(9)
    f = rng.standard_normal((4, 6)).astype(np.float32)
    return {
        "f32": f,
        "layers": {"bf16": (f * 3).astype(ml_dtypes.bfloat16),
                   "fp8": (f * 50).astype(ml_dtypes.float8_e4m3fn)},
        "int8": rng.randint(-128, 128, (8, 3)).astype(np.int8),
        "step": np.asarray(7.0, np.float32),
    }


def _to_torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_torch_tree(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return to_torch(tree)


def _same_bits(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g = g if isinstance(g, torch.Tensor) else np.asarray(g)
        assert tuple(g.shape) == np.shape(w)
        assert np.array_equal(byte_view(g.reshape(-1)),
                              byte_view(np.asarray(w).reshape(-1)))


def test_jax_checkpoint_restores_in_port(tmp_path):
    """JAX's save: bf16 and fp8 leaves sharded over a 2-device mesh
    (two `.d<id>` files each), the rest host arrays (`.p0`)."""
    tree = _numpy_tree()
    mesh = create_mesh({"fsdp": 2}, jax.devices()[:2])
    sharded = dict(tree, layers={
        k: jax.device_put(v, NamedSharding(mesh, P("fsdp", None)))
        for k, v in tree["layers"].items()})
    jckpt.save_pytree(sharded, str(tmp_path))
    names = sorted(os.listdir(tmp_path / "data"))
    assert sum(".d" in n for n in names) == 4 and \
        sum(".p0" in n for n in names) == 3, names
    got = tckpt.restore_pytree(tree, str(tmp_path))
    assert got["layers"]["bf16"].dtype == torch.bfloat16
    assert got["layers"]["fp8"].dtype == torch.float8_e4m3fn
    _same_bits(got, tree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = _numpy_tree()
    tckpt.save_pytree(_to_torch_tree(tree), str(tmp_path))
    index = jckpt._merged_index(str(tmp_path))
    assert sorted(index) == ["f32", "int8", "layers/bf16", "layers/fp8",
                             "step"]
    assert index["layers/bf16"]["dtype"] == "bfloat16"
    assert index["layers/fp8"]["dtype"] == "float8_e4m3fn"
    got = jckpt.restore_pytree(tree, str(tmp_path))
    assert got["layers"]["bf16"].dtype == ml_dtypes.bfloat16
    _same_bits(got, tree)
    _same_bits(tckpt.restore_pytree(tree, str(tmp_path)), tree)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_checkpoint_raises(tmp_path, writer):
    tree = _numpy_tree()
    if writer == "jax":
        jckpt.save_pytree(tree, str(tmp_path))
    else:
        tckpt.save_pytree(_to_torch_tree(tree), str(tmp_path))
    os.remove(tmp_path / "data" / "leaf00001.p0.npy")
    for restore in (jckpt.restore_pytree, tckpt.restore_pytree):
        with pytest.raises(ValueError, match="incomplete"):
            restore(tree, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_pytree(tree, str(tmp_path / "data"))


def test_params_to_numpy_inverts_params_from_numpy():
    """f32 comes back as the same array; a bf16 tree comes back as the
    f32 values of JAX's bf16 rounding of the same numbers."""
    jcfg = jllama.LlamaConfig.nano()
    tree = numpy_params(jcfg, seed=2)
    tcfg = tllama.LlamaConfig.nano()
    back = params_to_numpy(params_from_numpy(tree, tcfg, device="cpu"))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    back = params_to_numpy(params_from_numpy(tree, tcfg, device="cpu",
                                             dtype=torch.bfloat16))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        assert g.dtype == np.float32 and np.array_equal(g, want)


def test_resume_from_checkpoint_is_bit_exact(tmp_path):
    """Two steps, save params and AdamW state, a third step; then fresh
    tensors restored from the checkpoint take the third step again:
    loss, grad norm and every updated leaf and moment bit-equal."""
    cfg = tllama.LlamaConfig.nano()
    tree = numpy_params(jllama.LlamaConfig.nano(), seed=4)
    batch = {"tokens": torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 17)))}
    opt = ttrain.adamw(1e-3)
    init, step = ttrain.make_train_step(
        lambda p, b: tllama.llama_loss(p, b, cfg), opt, device="cpu")
    params, state = init(params_from_numpy(tree, cfg, device="cpu"))
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    tckpt.save_pytree(params, str(tmp_path / "params"))
    tckpt.save_pytree(opt.state_tree(state, params), str(tmp_path / "opt"))
    params, state, want = step(params, state, batch)

    fresh, fstate = init(tckpt.restore_pytree(params, str(tmp_path /
                                                          "params")))
    opt.load_state_tree(fstate, fresh, tckpt.restore_pytree(
        opt.state_tree(fstate, fresh), str(tmp_path / "opt")))
    fresh, fstate, got = step(fresh, fstate, batch)
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    for a, b in zip(ttrain._leaves(fresh), ttrain._leaves(params)):
        assert torch.equal(a, b)
    for key in ("exp_avg", "exp_avg_sq", "step"):
        for a, b in zip(ttrain._leaves(opt.state_tree(fstate, fresh)[key]),
                        ttrain._leaves(opt.state_tree(state, params)[key])):
            assert torch.equal(a, b)
