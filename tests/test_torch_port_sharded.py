"""PyTorch port, the sharded train step: `make_sharded_train_step` over
gloo worlds on the CPU against the JAX package's on the same mesh.

Each world runs as fresh interpreters, one per rank
(`torch_port_helpers.rank_main`), meeting at a file store in the test's
tmp directory; the JAX reference runs here on the virtual CPU devices of
`tests/conftest.py`. Both take the same seeded numpy weights and
batches. Tolerances: 1e-4 relative on losses and grad norms against
JAX, and 1e-5 abs/rel on the params after three AdamW steps with lr
1e-3 (as `test_torch_port_train.py`: f32 throughout, the difference is
summation order); against the port's own one-card `make_train_step` on
the same global batch, 1e-5 relative on losses and norms and 1e-6 on
the params (the sharded step only splits the sums).
"""

import faulthandler
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models.training import make_sharded_train_step
from ray_tpu.parallel import create_hybrid_mesh, create_mesh
from ray_tpu.train import array_checkpoint as jckpt
from ray_tpu_torch.parallel.mesh import AXIS_ORDER
from ray_tpu_torch.train import array_checkpoint as tckpt
from torch_port_helpers import flat_tree, numpy_params

LR, STEPS = 1e-3, 3
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

# world -> (axis sizes, through create_hybrid_mesh, axes that must
# refuse, the mesh the checkpoint is restored under)
WORLDS = {
    "dp2": ({"dp": 2}, False, [{"pp": 2}, {"sp": 2}], None),
    "fsdp2": ({"fsdp": 2}, False, [{"ep": 2}, {"pp": 2}], {"dp": 2}),
    "dcn2_fsdp2": ({"dcn": 2, "fsdp": 2}, True, [], None),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(150, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _inputs(cfg):
    """Seeded numpy weights, a token batch of 4 rows and a masked batch
    whose row shards hold different mask counts (rows 2 and 3 none)."""
    rng = np.random.RandomState(5)
    mask = np.zeros((4, 16), np.float32)
    mask[0] = 1
    mask[1] = rng.rand(16) > 0.5
    return {
        "params": numpy_params(cfg, seed=7),
        "tokens": rng.randint(0, cfg.vocab_size, (4, 17)).astype(np.int32),
        "inputs": rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32),
        "targets": rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32),
        "mask": mask,
    }


def _start_world(tmp, name, inputs):
    """Start the world's ranks; returns a function that waits for them
    and reads what each rank wrote."""
    axes, hybrid, unported, restore_mesh = WORLDS[name]
    world = int(np.prod(list(axes.values())))
    npz = os.path.join(tmp, "inputs.npz")
    np.savez(npz, **{f"params/{k}": v for k, v in
                     flat_tree(inputs["params"]).items()},
             **{k: v for k, v in inputs.items() if k != "params"})
    job = os.path.join(tmp, "job.json")
    with open(job, "w") as f:
        json.dump({"world": world, "store": f"file://{tmp}/store",
                   "mesh": axes, "hybrid": hybrid, "inputs": npz,
                   "out": tmp, "lr": LR, "steps": STEPS,
                   "unported": unported, "restore_mesh": restore_mesh}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [TESTS, REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import torch_port_helpers as h; h.rank_main()", job, str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]

    def finish():
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=120)
                errs.append(err.decode()[-3000:])
        finally:
            for p in procs:
                p.kill()
        assert all(p.returncode == 0 for p in procs), "\n".join(errs)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out

    return finish


@pytest.fixture(scope="module")
def fsdp2_world(tmp_path_factory):
    """The fsdp=2 world's tmp dir and rank outputs, run once a module."""
    tmp = tmp_path_factory.mktemp("fsdp2")
    return tmp, _start_world(str(tmp), "fsdp2",
                             _inputs(jllama.LlamaConfig.nano()))()


def _jax_world(name, inputs, cfg):
    axes, hybrid, _, _ = WORLDS[name]
    devices = jax.devices()[:int(np.prod(list(axes.values())))]
    mesh = (create_hybrid_mesh if hybrid else create_mesh)(axes, devices)
    init, step = make_sharded_train_step(
        lambda p, b: jllama.llama_loss(p, b, cfg), optax.adamw(LR), mesh,
        jllama.llama_param_specs(cfg), donate=False)
    params0 = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    params, state = init(params0)
    metrics = []
    for _ in range(STEPS):
        params, state, m = step(params, state,
                                {"tokens": jnp.asarray(inputs["tokens"])})
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    p0, s0 = init(params0)
    _, _, m = step(p0, s0, {k: jnp.asarray(inputs[k])
                            for k in ("inputs", "targets", "mask")})
    return mesh, metrics, [float(m["loss"]), float(m["grad_norm"])], params


@pytest.mark.parametrize("name", ["dp2", "fsdp2", "dcn2_fsdp2"])
def test_sharded_step_matches_jax(tmp_path, request, name):
    """One gloo world per case: the mesh's names, sizes and rank layout
    are JAX's; every rank's loss and grad norm over three steps equal
    JAX's `make_sharded_train_step` with `optax.adamw` on the same mesh,
    and the port's one-card step's; the params the world saves (each
    rank its own region) restore whole, in both packages, to JAX's; a
    masked batch whose shards hold 16, ~8, 0 and 0 tokens gives JAX's
    global masked mean; sp/ep/pp axes refuse, naming their item. Also
    on each world: a step without donation leaves its inputs and gives
    the donated step's metrics; a replicated batch over split params
    gives the one-card step's; `auto_mesh` puts every rank on fsdp and
    `local_mesh` holds this rank alone."""
    cfg = jllama.LlamaConfig.nano()
    inputs = _inputs(cfg)
    if name == "fsdp2":
        tmp_path, ranks = request.getfixturevalue("fsdp2_world")
        jmesh, jmetrics, jmasked, jparams = _jax_world(name, inputs, cfg)
    else:
        finish = _start_world(str(tmp_path), name, inputs)
        jmesh, jmetrics, jmasked, jparams = _jax_world(name, inputs, cfg)
        ranks = finish()

    axes = WORLDS[name][0]
    jids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, out in enumerate(ranks):
        assert out["names"] == list(jmesh.axis_names)
        assert out["names"] == list(AXIS_ORDER)
        assert np.array_equal(np.array(out["ranks"]), jids)
        assert out["info"] == [len(ranks), r, len(ranks)]
        assert out["pruned_same"]
        np.testing.assert_allclose(out["sharded"], jmetrics, rtol=1e-4)
        np.testing.assert_allclose(out["sharded"], out["one_card"],
                                   rtol=1e-5)
        assert out["one_card_max_diff"] <= 1e-6, out["one_card_max_diff"]
        np.testing.assert_allclose(out["masked"], jmasked, rtol=1e-4)
        loss, norm, unchanged, new_tree = out["kept"]
        assert [loss, norm] == out["sharded"][0] and unchanged and new_tree
        np.testing.assert_allclose(out["replicated_batch"],
                                   out["one_card"][0], rtol=1e-5)
        assert out["auto_mesh"] == np.arange(len(ranks)).reshape(
            [1, 1, 1, len(ranks), 1, 1, 1]).tolist()
        assert out["local_mesh"] == [np.full([1] * 7, r).tolist(),
                                     list(AXIS_ORDER)]
        assert len(out["refused"]) == len(WORLDS[name][2])
    for msg, item in zip(ranks[0]["refused"], ("A13", "A12")
                         if name == "dp2" else ("A13", "A13")):
        assert f"ROADMAP {item}" in msg, msg
    assert dict(zip(ranks[0]["names"], np.array(ranks[0]["ranks"]).shape)) \
        == {a: axes.get(a, 1) for a in AXIS_ORDER}

    ckpt = str(tmp_path / "ckpt" / "params")
    want = jax.tree_util.tree_leaves(jparams)
    got = tckpt.restore_pytree(jparams, ckpt)
    for g, w in zip(jax.tree_util.tree_leaves(got), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    for g, w in zip(jax.tree_util.tree_leaves(
            jckpt.restore_pytree(jparams, ckpt)), want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_fsdp_checkpoint_resumes_under_dp(fsdp2_world):
    """The fsdp=2 world's checkpoint (params and AdamW state, each rank
    its own halves) restores under {"dp": 2} as whole leaves, and a
    fourth step from it equals the fsdp world's own fourth step (1e-5
    relative: the two meshes sum the gradients in another order)."""
    cfg = jllama.LlamaConfig.nano()
    tmp_path, ranks = fsdp2_world
    for out in ranks:
        assert out["restored_shapes"]["wq"] == [cfg.n_layers, cfg.dim,
                                                cfg.n_heads, cfg.head_dim]
        np.testing.assert_allclose(out["resumed"], out["continued"],
                                   rtol=1e-5)
    opt = tckpt._merged_index(str(tmp_path / "ckpt" / "opt"))
    assert opt["exp_avg/layers/wq"]["shape"] == [cfg.n_layers, cfg.dim,
                                                 cfg.n_heads, cfg.head_dim]
    assert len(opt["exp_avg/layers/wq"]["shards"]) == 2     # fsdp halves
    assert len(opt["step/lm_head"]["shards"]) == 1          # written once
