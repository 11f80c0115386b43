"""PyTorch port, pipeline parallelism: `ray_tpu_torch.parallel.pipeline`
(`stack_stage_params`, `make_pipelined_fn`) and the pp axis of
`make_sharded_train_step`, against `ray_tpu.parallel.pipeline` and
JAX's step.

The pp = 2 and pp = 4 worlds run once per session in fresh interpreters
(`torch_port_a13`), the JAX side on the virtual CPU devices. Tolerances
as `tests/test_parallel_advanced.py` holds JAX's pipeline to its
sequential stack: the output within 1e-5, gradients within 1e-4
(relative to the leaf's largest); the step's losses and grad norms
within 1e-5 (first) and 1e-4, its params after three AdamW steps within
1e-5 with an absolute floor of lr / 10. f32 throughout.
"""

import faulthandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_a13 as a13
from ray_tpu.parallel.pipeline import stack_stage_params as j_stack
from ray_tpu_torch.parallel import pipeline as tpipe
from torch_port_helpers import once


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


@pytest.mark.parametrize("n", [2, 4])
def test_pipelined_fn_matches_sequential(worlds, n):
    """Every pp rank returns the pipeline's output (JAX's `psum`
    replication) equal to JAX's pipelined output and to the stages run
    in turn; under the seeded cotangent each rank's gradient of the
    stack is its own stage's (JAX's row, zeros elsewhere), and the
    input's gradient is JAX's on every rank."""
    ranks, ref = worlds[f"w{n}"]
    want = ref[f"pipe{n}"]
    for r, out in enumerate(ranks):
        got = out[f"pipe{n}"]
        seq_y, seq_dx, seq_dw, seq_db = got["seq"]
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["y"], seq_y, rtol=1e-5, atol=1e-5)
        assert _rel(got["dx"], want["dx"]) <= 1e-4
        assert _rel(got["dx"], seq_dx) <= 1e-4
        for key, seq in (("dw", seq_dw), ("db", seq_db)):
            mine = np.asarray(got[key])
            assert _rel(mine[r], np.asarray(want[key])[r]) <= 1e-4
            assert _rel(mine[r], np.asarray(seq)[r]) <= 1e-4
            assert not np.delete(mine, r, axis=0).any()


def test_pp_step_matches_jax(worlds):
    """{"pp": 2} with the stack specced ("pp", None, None) and a leaf
    used before the pipeline on both ranks: three AdamW steps against
    JAX's step on the same mesh; the first step's gradients equal JAX's
    (and the stages' run in turn), the replicated leaf's the same on
    both ranks, never summed over pp; each rank holds its stage."""
    ranks, ref = worlds["w2"]
    want = ref["pp_step"]
    for r, out in enumerate(ranks):
        got = out["pp_step"]
        np.testing.assert_allclose(got["metrics"][0], want["metrics"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=1e-4)
        assert _rel(got["grads"]["emb"], want["grads"]["emb"]) <= 1e-4
        assert _rel(got["grads"]["emb"], want["seq_grads"]["emb"]) <= 1e-4
        for grads in (want["grads"], want["seq_grads"]):
            assert _rel(got["grads"]["w"],
                        np.asarray(grads["w"])[r:r + 1]) <= 1e-4
        np.testing.assert_allclose(got["params"]["w"],
                                   np.asarray(want["params"]["w"])[r:r + 1],
                                   rtol=1e-5, atol=a13.LR / 10)
        np.testing.assert_allclose(got["params"]["emb"],
                                   want["params"]["emb"], rtol=1e-5,
                                   atol=a13.LR / 10)
    assert ranks[0]["pp_step"]["grads"]["emb"] == \
        ranks[1]["pp_step"]["grads"]["emb"]


def test_stack_stage_params_matches_jax():
    rng = np.random.RandomState(0)
    stages = [{"w": rng.rand(3, 4).astype(np.float32),
               "sub": {"b": rng.rand(4).astype(np.float32)}}
              for _ in range(3)]
    want = j_stack([jax.tree_util.tree_map(jnp.asarray, s) for s in stages])
    got = tpipe.stack_stage_params(
        [{"w": torch.tensor(s["w"]), "sub": {"b": torch.tensor(s["sub"]["b"])}}
         for s in stages])
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["sub"]["b"].numpy(),
                                  np.asarray(want["sub"]["b"]))


def test_one_stage_runs_microbatches_in_process():
    """Without a pp axis the pipelined function runs its one stage on
    each microbatch: the stage applied to the whole batch, and its
    gradients, within 1e-6."""
    rng = np.random.RandomState(2)
    w = torch.tensor(rng.standard_normal((1, 8, 8)).astype(np.float32) * 0.3,
                     requires_grad=True)
    b = torch.zeros((1, 8), requires_grad=True)
    x = torch.tensor(rng.standard_normal((6, 8)).astype(np.float32))
    fn = tpipe.make_pipelined_fn(a13.stage_fn, None, 3)
    y = fn({"w": w, "b": b}, x)
    want = a13.stage_fn({"w": w[0], "b": b[0]}, x)
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)
    g1 = torch.autograd.grad(y.sum(), (w, b))
    g2 = torch.autograd.grad(want.sum(), (w, b))
    for p, q in zip(g1, g2):
        np.testing.assert_allclose(p.numpy(), q.numpy(), atol=1e-6)


def test_pipelined_fn_refuses_bad_inputs():
    fn = tpipe.make_pipelined_fn(a13.stage_fn, None, 4)
    w, b = torch.zeros((2, 8, 8)), torch.zeros((2, 8))
    with pytest.raises(ValueError, match="leading stage dim"):
        fn({"w": w, "b": b}, torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="microbatches"):
        fn({"w": w[:1], "b": b[:1]}, torch.zeros((6, 8)))
