"""PyTorch port, the device pieces of Train, Data and channels
(`ray_tpu_torch.data`, `ray_tpu_torch.train.predictor`,
`ray_tpu_torch.train.huggingface`,
`ray_tpu_torch.experimental.channel`) against the JAX package, on the
CPU.

The port takes the reference's objects by duck typing, and these tests
pass them in: a source with ``iter_batches`` (read by JAX's
``Dataset.iter_jax_batches`` called unbound, so no cluster starts), the
reference's ``Checkpoint`` and its shared-memory ``Channel``. Held to
JAX:

- the iterator's batches by value, and each rank's region of a batch
  split over a mesh axis against ``addressable_shards`` of JAX's
  ``NamedSharding`` on four CPU devices (the cases of
  `tests/test_data.py`'s `TestJaxIngest`);
- `TorchPredictor` against `JaxPredictor` on a dict checkpoint and on an
  array checkpoint with a template (`tests/test_predictor.py`'s cases);
- the HF step on `tests/test_train_huggingface.py`'s tiny GPT2: the Flax
  weights carried into the torch model by `load_flax_params` equal
  transformers' own ``load_flax_weights_in_pytorch_model``'s bit for
  bit; the f32 logits within 1e-5 and the loss within rtol 1e-6; then
  20 steps of ``adam(1e-2)`` in both packages (the port's
  `make_sharded_train_step` over {"dp": 1} on a one-rank gloo world):
  every loss within rtol 1e-4 of JAX's, both below 0.7 of the first;
  the save/load round trip bit-equal;
- `DeviceChannel` over the reference's shm ``Channel``: f32 and bf16
  tensors back bit-equal, other values passed through.
"""

import faulthandler
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ray_tpu.data.dataset import Dataset
from ray_tpu.experimental.channel.shm_channel import Channel
from ray_tpu.parallel import create_mesh as jax_mesh
from ray_tpu.train.array_checkpoint import save_pytree
from ray_tpu.train.checkpoint import Checkpoint
from ray_tpu.train.predictor import JaxPredictor
from ray_tpu_torch.data import iter_device_batches
from ray_tpu_torch.experimental.channel import DeviceChannel
from ray_tpu_torch.train.predictor import TorchPredictor

transformers = pytest.importorskip("transformers")


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


class _Source:
    """A duck-typed Data source: seeded numpy columns, batched in order
    (a ragged last batch unless ``drop_last``)."""

    def __init__(self, n=64, seed=0):
        rng = np.random.RandomState(seed)
        self.cols = {"x": np.arange(n, dtype=np.float32),
                     "id": np.arange(n, dtype=np.int64) * 3,
                     "img": rng.rand(n, 2, 3).astype(np.float32)}
        self.n = n

    def iter_batches(self, *, batch_size=256, batch_format="numpy",
                     drop_last=False):
        assert batch_format == "numpy"
        for i in range(0, self.n, batch_size):
            if drop_last and i + batch_size > self.n:
                return
            yield {k: v[i:i + batch_size] for k, v in self.cols.items()}


@pytest.mark.parametrize("batch_size", [16, 24], ids=["even", "ragged"])
def test_iter_device_batches_match_jax(batch_size):
    src = _Source(60)
    want = list(Dataset.iter_jax_batches(src, batch_size=batch_size))
    got = list(iter_device_batches(src, batch_size=batch_size,
                                   device="cpu"))
    assert len(got) == len(want) == -(-60 // batch_size)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("axes,spec", [({"dp": 4}, ("dp",)),
                                       ({"dp": 2, "fsdp": 2},
                                        (("dp", "fsdp"),))],
                         ids=["dp4", "dp2xfsdp2"])
def test_rank_slices_match_named_sharding(axes, spec):
    """Each rank's region of every column is the shard JAX's
    NamedSharding(mesh, P(*spec)) puts on that rank's device."""
    mesh = jax_mesh(axes, jax.devices()[:4])
    sharding = NamedSharding(mesh, P(*spec))
    src = _Source(64)
    want = list(Dataset.iter_jax_batches(src, batch_size=16,
                                         sharding=sharding))
    devices = list(mesh.devices.flat)
    names = list(mesh.axis_names)
    seen = []
    for rank in range(4):
        coord = dict(zip(names, np.unravel_index(
            rank, mesh.devices.shape)))
        coord = {a: int(i) for a, i in coord.items()}
        got = list(iter_device_batches(src, batch_size=16, device="cpu",
                                       mesh=axes, spec=spec,
                                       coordinate=coord))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for k in w:
                shard = next(s for s in w[k].addressable_shards
                             if s.device == devices[rank])
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(shard.data))
                assert g[k].shape[0] == 4
            seen += g["x"].tolist()
    assert sorted(seen) == list(range(64))     # each row on one rank


def test_device_batches_feed_a_function():
    """`test_iter_jax_batches_feeds_jit`'s case: the batches' sum."""
    src = _Source(8)
    total = sum(float(torch.sum(b["x"]))
                for b in iter_device_batches(src, batch_size=4,
                                             device="cpu"))
    assert total == float(sum(range(8)))


def test_iter_device_batches_runs_on_cuda_by_default():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(iter_device_batches(_Source(8), batch_size=4))


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

def _linear_apply(params, batch):
    return batch["x"] @ params["w"] + params["b"]


def test_predictor_dict_checkpoint_matches_jax():
    ckpt = Checkpoint.from_dict(
        {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                    "b": np.float32(1.0)}})
    try:
        batch = {"x": np.array([[1.0, 2.0], [-3.0, 0.5]], np.float32)}
        want = JaxPredictor.from_checkpoint(
            ckpt, apply_fn=_linear_apply).predict(batch)
        got = TorchPredictor.from_checkpoint(
            ckpt, apply_fn=_linear_apply, device="cpu").predict(batch)
        assert sorted(got) == sorted(want) == ["predictions"]
        np.testing.assert_array_equal(got["predictions"],
                                      want["predictions"])
        np.testing.assert_allclose(got["predictions"],
                                   [[7.0, 10.0, 13.0], [2.5, 0.0, -2.5]])
    finally:
        shutil.rmtree(ckpt.path, ignore_errors=True)


def test_predictor_array_checkpoint_matches_jax(tmp_path):
    """An array checkpoint written by JAX's `save_pytree`, restored
    through the port's `restore_pytree` by a template; a dict output
    comes back per key."""
    params = {"w": np.arange(6, dtype=np.float32).reshape(3, 2),
              "b": np.array([0.5, -1.0], np.float32)}
    d = str(tmp_path / "ajc")
    save_pytree(params, d)
    ckpt = Checkpoint.from_directory(d)

    def apply(p, b):
        return {"y": _linear_apply(p, b), "w_sum": p["w"].sum(0)}

    batch = {"x": np.random.RandomState(0).randn(5, 3).astype(np.float32)}
    want = JaxPredictor.from_checkpoint(
        ckpt, apply_fn=apply,
        template={"w": np.zeros((3, 2)), "b": np.zeros(2)}).predict(batch)
    got = TorchPredictor.from_checkpoint(
        ckpt, apply_fn=apply, device="cpu",
        template={"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    ).predict(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(got["w_sum"], params["w"].sum(0))
    with pytest.raises(ValueError, match="neither a dict checkpoint"):
        TorchPredictor.from_checkpoint(ckpt, apply_fn=apply, device="cpu")


# ---------------------------------------------------------------------------
# HuggingFace: the Flax GPT2 and the torch GPT2 of one config
# ---------------------------------------------------------------------------

def _tiny_gpt2_config():
    return transformers.GPT2Config(
        n_embd=32, n_layer=2, n_head=2, vocab_size=128, n_positions=64)


@pytest.fixture(scope="module")
def gpt2_pair():
    """(Flax model, torch model with its weights, batch)."""
    from ray_tpu_torch.train.huggingface import load_flax_params

    fm = transformers.FlaxGPT2LMHeadModel(_tiny_gpt2_config(), seed=0)
    tm = load_flax_params(transformers.GPT2LMHeadModel(_tiny_gpt2_config()),
                          fm.params)
    rng = np.random.default_rng(0)
    return fm, tm, {"input_ids": rng.integers(0, 128, (4, 33))}


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank gloo world and its {"dp": 1} mesh, closed after the
    module."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import create_mesh, initialize_distributed

    owned = not dist.is_initialized()
    initialize_distributed(None, 1, 0, device_type="cpu")
    yield create_mesh({"dp": 1}, device_type="cpu")
    if owned:
        dist.destroy_process_group()


def test_flax_weights_carry_as_transformers_does(gpt2_pair):
    from transformers.modeling_flax_pytorch_utils import \
        load_flax_weights_in_pytorch_model

    fm, tm, _ = gpt2_pair
    ref = load_flax_weights_in_pytorch_model(
        transformers.GPT2LMHeadModel(_tiny_gpt2_config()), fm.params)
    got, want = tm.state_dict(), ref.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert tm.lm_head.weight is tm.transformer.wte.weight


def test_hf_logits_and_loss_match_flax(gpt2_pair):
    from ray_tpu.train.huggingface import flax_causal_lm_loss

    from ray_tpu_torch.train.huggingface import causal_lm_loss, model_params

    fm, tm, batch = gpt2_pair
    inputs = batch["input_ids"][:, :-1]
    want = np.asarray(fm(inputs, params=fm.params).logits)
    with torch.no_grad():
        tm.eval()
        got = tm(torch.as_tensor(inputs)).logits.numpy()
    assert got.shape == want.shape == (4, 32, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jloss = float(flax_causal_lm_loss(fm)(fm.params, batch))
    with torch.no_grad():
        tloss = float(causal_lm_loss(tm)(model_params(tm), batch))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)


def test_hf_train_step_tracks_flax_and_round_trips(gpt2_pair,
                                                   one_rank_mesh, tmp_path):
    """`test_flax_train_step_learns` in both packages from equal
    weights: 21 steps of adam(1e-2) on one batch (the port:
    `adamw(1e-2, weight_decay=0.0)`, optax's adam), the losses within
    rtol 1e-4 of each other at every step and both below 0.7 of the
    first; then the port's save/load round trip, bit for bit."""
    import optax

    from ray_tpu.train.huggingface import flax_train_step
    from ray_tpu_torch.models.training import adamw
    from ray_tpu_torch.train.huggingface import (hf_train_step,
                                                 load_hf_checkpoint,
                                                 model_params,
                                                 save_hf_checkpoint)

    fm, tm, batch = gpt2_pair
    jinit, jstep = flax_train_step(
        fm, optax.adam(1e-2), mesh=jax_mesh({"dp": 1}, jax.devices()[:1]))
    tinit, tstep = hf_train_step(tm, adamw(1e-2, weight_decay=0.0),
                                 one_rank_mesh)
    jp, jo = jinit(fm.params)
    tp, to = tinit(model_params(tm))
    jl, tl = [], []
    for _ in range(21):
        jp, jo, jm = jstep(jp, jo, batch)
        tp, to, tmet = tstep(tp, to, batch)
        jl.append(float(jm["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert jl[-1] < 0.7 * jl[0] and tl[-1] < 0.7 * tl[0], (jl, tl)

    d = str(tmp_path / "hf_ckpt")
    host = {k: v.detach().clone() for k, v in tp.items()}
    save_hf_checkpoint(tm, host, d)
    model2, restored = load_hf_checkpoint(transformers.GPT2LMHeadModel, d,
                                          device="cpu")
    assert sorted(restored) == sorted(host)
    for k in host:
        assert torch.equal(restored[k], host[k]), k
    with torch.no_grad():
        out = model2(torch.as_tensor(batch["input_ids"][:, :-1]))
    assert out.logits.shape == (4, 32, 128)


# ---------------------------------------------------------------------------
# Device channel
# ---------------------------------------------------------------------------

def test_device_channel_over_shm_channel(tmp_path):
    """`test_device_channel_jax_array`'s case over the reference's shm
    Channel, with a bf16 tensor (bit-cast on the way) and a plain value
    beside it."""
    path = Channel.create(n_readers=1, directory=str(tmp_path))
    writer = DeviceChannel(Channel(path), device="cpu")
    reader = DeviceChannel(Channel(path, reader_id=0), device="cpu")
    try:
        x = torch.arange(16.0)
        writer.write(x)
        out = reader.read(timeout=10)
        assert float(out.sum()) == 120.0 and torch.equal(out, x)
        y = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)
                        ).to(torch.bfloat16)
        writer.write(y)
        out = reader.read(timeout=10)
        assert out.dtype == torch.bfloat16 and torch.equal(out, y)
        writer.write({"step": 3})
        assert reader.read(timeout=10) == {"step": 3}
    finally:
        writer.close()
        reader.close()
        Channel(path).destroy()
