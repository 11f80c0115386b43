"""PyTorch port, sequence parallelism: ring and Ulysses attention over an
sp group, `attn_impl="ring"|"ulysses"` in `llama_forward` and
`llama_loss`, and the sp axis of `make_sharded_train_step`, against the
JAX package.

The port runs one process per rank. Two gloo worlds of fresh
interpreters (`torch_port_helpers.sp_rank_main`) run every case in one
launch each: a 2-rank world ({"sp": 2}) and a 4-rank world ({"sp": 4}
for the ops and the forward; {"fsdp": 2, "sp": 2} and {"tp": 2, "sp":
2} for the step). The JAX side runs the same functions on the virtual
CPU devices of `tests/conftest.py`: ring and Ulysses under `shard_map`
(`ring_attention_sharded`, impl "pallas" in interpret mode and "xla"),
the forward under `shard_map` with global positions, and the step with
`attn_impl="reference"` on the same mesh (JAX's ring under
`make_sharded_train_step` raises NameError, the sp axis being unbound
there; reference attention over a sequence-split batch is the same
function). Both worlds and the JAX parts are computed once per test
session and shared by the xdist workers through a file lock.

Tolerances: ring outputs 2e-5 and gradients 1e-4 (`tests/test_ops.py`'s
for the JAX ring against its reference); Ulysses and the forward logits
2e-4 (`tests/test_parallel_advanced.py`'s, `tests/test_models.py`'s);
the steps as `test_torch_port_tp.py` holds them: the first step's loss
and grad norm within 1e-5 relative, the later steps' within 1e-4, the
params after three AdamW steps (eps 1e-6) within 1e-5 relative with an
absolute floor of lr / 10. f32 throughout.
"""

import faulthandler
import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ray_tpu.models import llama as jllama
from ray_tpu.ops.attention import mha_reference as j_mha
from ray_tpu.models.training import make_sharded_train_step
from ray_tpu.ops import ulysses_attention as j_ulysses
from ray_tpu.ops.ring_attention import ring_attention_sharded as j_ring
from ray_tpu.parallel import create_mesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.llama import LlamaConfig as TConfig
from ray_tpu_torch.models.llama import llama_param_specs as tspecs
from ray_tpu_torch.ops.ring_attention import LocalRing, ring_attention
from ray_tpu_torch.parallel import sequence_parallel as seqp
from ray_tpu_torch.parallel.mesh import AXIS_ORDER
from ray_tpu_torch.parallel.sharding import local_region
from torch_port_helpers import (child_env, die_with_parent, flat_tree,
                                nest_tree, numpy_params, once)

LR, EPS, STEPS = 1e-3, 1e-6, 3
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RING_CASES = [dict(id=f"{c}-{impl}", causal=c == "causal", impl=impl,
                   inputs="ring-gqa")
              for c in ("causal", "noncausal") for impl in ("pallas", "xla")]
FWD_CFG = dict(n_kv_heads=4)
POLICIES = {"full": dict(remat=True, remat_policy="full"),
            "bench": dict(remat=True,
                          remat_policy="save:ffn_gate+ffn_up+ffn_down",
                          loss_chunk=4)}
# world -> (ranks, the step's meshes: name -> (axes, config, whether
# Ulysses must refuse the config's kv heads there))
WORLDS = {
    "sp2": (2, {"sp2": ({"sp": 2}, {}, False)}),
    "sp4": (4, {"fsdp2_sp2": ({"fsdp": 2, "sp": 2}, {}, False),
                "tp2_sp2": ({"tp": 2, "sp": 2}, {"n_kv_heads": 4}, False),
                "tp2_sp2_gqa": ({"tp": 2, "sp": 2}, {}, True)}),
}
MESHES = {m: (w, spec) for w, (_, ms) in WORLDS.items()
          for m, spec in ms.items()}
COMPUTE_S, RANK_LIMIT_S = 240, 200
JAX_PARTS = (("sp2", "ops"), ("sp4", "ops"), ("sp2", "steps"),
             ("sp4", "steps"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(COMPUTE_S + 60, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _inputs(world):
    """Seeded numpy inputs of a world of ``world`` ranks (flat npz keys)."""
    rng = np.random.RandomState(11 + world)
    s = 8 * world

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = {}
    for name, hkv in (("ring-gqa", 2), ("ulysses", 4)):
        out.update({f"{name}/q": normal(2, 4, s, 16),
                    f"{name}/k": normal(2, hkv, s, 16),
                    f"{name}/v": normal(2, hkv, s, 16),
                    f"{name}/g": normal(2, 4, s, 16)})
    fcfg = jllama.LlamaConfig.nano(**FWD_CFG)
    out.update({f"fwd_params/{k}": v for k, v in
                flat_tree(numpy_params(fcfg, seed=3)).items()})
    out["fwd_tokens"] = rng.randint(0, fcfg.vocab_size, (2, 32)).astype(
        np.int32)
    for m, (_, cfg, _) in WORLDS["sp2" if world == 2 else "sp4"][1].items():
        out.update({f"{m}/{k}": v for k, v in flat_tree(numpy_params(
            jllama.LlamaConfig.nano(**cfg), seed=7)).items()})
    out["tokens"] = rng.randint(0, 256, (4, 17)).astype(np.int32)
    return out


def _start_world(name, out_dir):
    ranks, meshes = WORLDS[name]
    out_dir.mkdir(exist_ok=True)
    npz = out_dir / "inputs.npz"
    np.savez(npz, **_inputs(ranks))
    job = out_dir / "job.json"
    job.write_text(json.dumps({
        "world": ranks, "store": f"file://{out_dir}/store",
        "inputs": str(npz), "out": str(out_dir), "lr": LR, "eps": EPS,
        "steps": STEPS, "ring_cases": RING_CASES, "fwd_cfg": FWD_CFG,
        "policies": POLICIES, "shift_mesh": "sp2",
        "train_meshes": {m: {"axes": axes, "cfg": cfg,
                             "ulysses_error": err}
                         for m, (axes, cfg, err) in meshes.items()},
        "limit_s": RANK_LIMIT_S}))
    env = child_env()
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import torch_port_helpers as h; h.sp_rank_main()", str(job),
         str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(ranks)]

    def read():
        return [json.loads((out_dir / f"rank{r}.json").read_text())
                for r in range(ranks)]

    return procs, read


def _vjp(fn, data, prefix):
    q, k, v, g = (jnp.asarray(data[f"{prefix}/{x}"]) for x in "qkvg")
    o, back = jax.vjp(fn, q, k, v)
    return {"o": np.asarray(o).tolist(),
            "grads": [np.asarray(x).tolist() for x in back(g)]}


def _jax_ops(n, data):
    """Ring (both impls) and Ulysses over {"sp": n}, with their vjps under
    the seeded cotangent, and the forward of each attn_impl."""
    mesh = create_mesh({"sp": n}, jax.devices()[:n])
    out = {"ring": {c["id"]: _vjp(functools.partial(
        j_ring, mesh=mesh, causal=c["causal"], impl=c["impl"]), data,
        c["inputs"]) for c in RING_CASES}}
    seq = P(None, None, "sp", None)
    uly = jax.shard_map(
        functools.partial(j_ulysses, axis_name="sp", causal=True,
                          impl="reference"),
        mesh=mesh, in_specs=(seq, seq, seq), out_specs=seq, check_vma=False)
    out["ulysses"] = _vjp(uly, data, "ulysses")
    params = jax.tree_util.tree_map(jnp.asarray, nest_tree(
        {k[len("fwd_params/"):]: v for k, v in data.items()
         if k.startswith("fwd_params/")}))
    tokens = jnp.asarray(data["fwd_tokens"])
    positions = jnp.broadcast_to(jnp.arange(tokens.shape[1]), tokens.shape)
    out["forward"] = {}
    for impl in ("ring", "ulysses"):
        cfg = jllama.LlamaConfig.nano(**FWD_CFG, attn_impl=impl)
        fwd = jax.shard_map(
            lambda p, t, pos, cfg=cfg: jllama.llama_forward(
                p, t, cfg, positions=pos),
            mesh=mesh, in_specs=(P(), P(None, "sp"), P(None, "sp")),
            out_specs=P(None, "sp"), check_vma=False)
        out["forward"][impl] = np.asarray(
            fwd(params, tokens, positions)).tolist()
    cfg = jllama.LlamaConfig.nano(**FWD_CFG, attn_impl="reference")
    out["forward"]["reference"] = np.asarray(
        jllama.llama_forward(params, tokens, cfg)).tolist()
    return out


def _jax_steps(world, data, out_dir):
    """JAX's step with reference attention on each of the world's sp
    meshes: metrics, and the params after the steps in an npz."""
    _, meshes = WORLDS[world]
    out = {}
    for m, (axes, cfg_kw, _) in meshes.items():
        cfg = jllama.LlamaConfig.nano(**cfg_kw, attn_impl="reference")
        n = int(np.prod(list(axes.values())))
        mesh = create_mesh(axes, jax.devices()[:n])
        params = jax.tree_util.tree_map(jnp.asarray, nest_tree(
            {k[len(f"{m}/"):]: v for k, v in data.items()
             if k.startswith(f"{m}/")}))
        init, step = make_sharded_train_step(
            lambda p, b, cfg=cfg: jllama.llama_loss(p, b, cfg),
            optax.adamw(LR, eps=EPS), mesh, jllama.llama_param_specs(cfg),
            batch_logical=("batch", "length"), donate=False)
        p, s = init(params)
        metrics = []
        for _ in range(STEPS):
            p, s, mt = step(p, s, {"tokens": jnp.asarray(data["tokens"])})
            metrics.append([float(mt["loss"]), float(mt["grad_norm"])])
        path = str(out_dir / f"jax-{m}.npz")
        np.savez(path, **{k: np.asarray(v) for k, v in
                          flat_tree(p).items()})
        out[m] = {"metrics": metrics, "params": path}
    return out


def jax_main(world, part, path):
    """A fresh interpreter's part of one world's JAX side: run as
    ``python -c "import test_torch_port_sp as t; t.jax_main(W, PART,
    PATH)"``."""
    die_with_parent()
    import pathlib

    data = _inputs(WORLDS[world][0])
    out = (_jax_ops(WORLDS[world][0], data) if part == "ops"
           else _jax_steps(world, data, pathlib.Path(path).parent))
    with open(path, "w") as f:
        json.dump(out, f)


def _compute(out_dir):
    """Both worlds and the JAX parts, each in interpreters of their own,
    all at once."""
    deadline = time.monotonic() + COMPUTE_S
    out_dir.mkdir(exist_ok=True)
    started = {name: _start_world(name, out_dir / name) for name in WORLDS}
    env = child_env(JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_port_sp as t; t.jax_main({w!r}, {part!r}, "
         f"{str(out_dir / f'jax-{w}-{part}.json')!r})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for w, part in JAX_PARTS]
    procs = jax_procs + [p for ranks, _ in started.values() for p in ranks]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            errs.append(err.decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
    failed = [e for p, e in zip(procs, errs) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    ref = {w: {} for w in WORLDS}
    for w, part in JAX_PARTS:
        ref[w][part] = json.loads(
            (out_dir / f"jax-{w}-{part}.json").read_text())
    return {name: (read(), ref[name]) for name, (_, read) in started.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """name -> (each rank's results, JAX's results)."""
    return once(tmp_path_factory, "torch_port_sp", "sp-worlds", _compute)


def _block(full, rank, n, dim=2):
    full = np.asarray(full)
    s = full.shape[dim] // n
    return np.take(full, range(rank * s, (rank + 1) * s), axis=dim)


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ["sp2", "sp4"])
@pytest.mark.parametrize("case", ["causal-pallas", "causal-xla",
                                  "noncausal-pallas", "noncausal-xla"])
def test_ring_matches_jax(worlds, world, case):
    """Each rank's output block and its q/k/v gradient blocks equal
    JAX's `ring_attention_sharded` under the same impl (GQA 4/2): the
    kernel schedule ("pallas": B1 per block, B3a/B3b with f32 partials,
    dk/dv rotated home) against the Pallas ring, the plain ring
    against `_ring_xla`."""
    ranks, ref = worlds[world]
    want = ref["ops"]["ring"][case]
    for r, out in enumerate(ranks):
        got = out["ring"][case]
        np.testing.assert_allclose(got["o"], _block(want["o"], r,
                                                    len(ranks)),
                                   atol=2e-5, rtol=2e-5)
        for g, w, name in zip(got["grads"], want["grads"], "qkv"):
            np.testing.assert_allclose(g, _block(w, r, len(ranks)),
                                       atol=1e-4, rtol=1e-4,
                                       err_msg=f"d{name}")


@pytest.mark.parametrize("world", ["sp2", "sp4"])
def test_ring_sharded_gathers_the_whole_output(worlds, world):
    """`ring_attention_sharded` takes the global tensors, runs the rank's
    block and returns the whole output on every rank: JAX's."""
    ranks, ref = worlds[world]
    for out in ranks:
        np.testing.assert_allclose(out["ring_sharded"],
                                   ref["ops"]["ring"]["causal-pallas"]["o"],
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("world", ["sp2", "sp4"])
def test_ulysses_matches_jax(worlds, world):
    """Two all-to-alls around the plain attention: each rank's output
    block and gradient blocks equal JAX's `ulysses_attention` under
    `shard_map`."""
    ranks, ref = worlds[world]
    want = ref["ops"]["ulysses"]
    for r, out in enumerate(ranks):
        got = out["ulysses"]
        np.testing.assert_allclose(got["o"], _block(want["o"], r,
                                                    len(ranks)),
                                   atol=2e-4, rtol=2e-4)
        for g, w in zip(got["grads"], want["grads"]):
            np.testing.assert_allclose(g, _block(w, r, len(ranks)),
                                       atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("case", ["causal-pallas", "causal-xla",
                                  "noncausal-pallas", "noncausal-xla"])
def test_local_ring_matches_whole_attention(case):
    """`LocalRing(4)`: the ring's own code over four blocks held by one
    process (the chip check's one-card ring) gives JAX's whole-sequence
    `mha_reference` and its gradients (GQA 4/2), at the ring's
    tolerances."""
    causal, impl = case.split("-")
    causal = causal == "causal"
    rng = np.random.RandomState(5)
    q, g = (rng.standard_normal((2, 4, 32, 16)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
            for _ in range(2))
    o, back = jax.vjp(lambda a, b, c: j_mha(a, b, c, causal=causal),
                      *(jnp.asarray(x) for x in (q, k, v)))
    want = back(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = ring_attention(*leaves, sp=LocalRing(4), causal=causal,
                         impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(o),
                               atol=2e-5, rtol=2e-5)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for a, w, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ["sp2", "sp4"])
@pytest.mark.parametrize("impl", ["ring", "ulysses", "reference"])
def test_llama_forward_under_sp_matches_jax(worlds, world, impl):
    """`llama_forward` on each rank's block of the tokens (global
    positions by default) gives that block of JAX's `shard_map`'d
    forward with global positions ("ring", "ulysses"), or of JAX's
    whole-sequence forward ("reference": k/v gathered over sp)."""
    ranks, ref = worlds[world]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(
            out["forward"][impl],
            _block(ref["ops"]["forward"][impl], r, len(ranks), dim=1),
            atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _coord(axes, rank):
    sizes = [axes.get(a, 1) for a in AXIS_ORDER]
    return dict(zip(AXIS_ORDER, (int(i) for i in
                                 np.unravel_index(rank, sizes))))


@pytest.mark.parametrize("mesh", ["sp2", "fsdp2_sp2", "tp2_sp2",
                                  "tp2_sp2_gqa"])
@pytest.mark.parametrize("impl", ["ring", "ulysses", "reference"])
@pytest.mark.parametrize("policy", ["full", "bench"])
def test_sharded_step_over_sp_matches_jax(worlds, mesh, impl, policy):
    """make_sharded_train_step with "length" -> "sp": loss and grad norm
    of three AdamW steps, and every rank's params after them, equal
    JAX's step with reference attention on the same mesh, for the
    port's ring, Ulysses and gathered-sequence attention, under "full"
    remat and bench.py's policy with a chunked loss (the ring's
    collectives rerun in each layer's recompute). On the GQA config at
    tp = 2 a rank holds one kv head, which does not split over sp = 2:
    Ulysses refuses it."""
    world, (axes, cfg_kw, ulysses_error) = MESHES[mesh]
    ranks, ref = worlds[world]
    run = f"{mesh}-{impl}-{policy}"
    if impl == "ulysses" and ulysses_error:
        for out in ranks:
            assert "n_kv_heads=1 must be divisible by sp=2" in \
                out["errors"][run]
        return
    want = ref["steps"][mesh]
    jparams = dict(np.load(want["params"]))
    specs = flat_tree(tspecs(TConfig.nano(**cfg_kw)))
    sizes = {a: axes.get(a, 1) for a in AXIS_ORDER}
    for r, out in enumerate(ranks):
        got = out["train"][run]
        np.testing.assert_allclose(got["metrics"][0], want["metrics"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=1e-4)
        for name, p in np.load(got["params"]).items():
            full = jparams[name]
            region = local_region(full.shape, specs[name], sizes,
                                  _coord(axes, r))
            np.testing.assert_allclose(p, full[region], rtol=1e-5,
                                       atol=LR / 10, err_msg=name)


def test_tokens_batch_is_split_after_the_shift(worlds):
    """A {"tokens": [B, S+1]} batch over sp: the step shifts it into
    inputs and targets, then splits, so every block keeps its last
    target: the same metrics as inputs/targets split by hand, and JAX's
    (test above); the params a step starts from are the numpy tree's,
    unchanged (`convert.params_from_numpy` needs nothing for sp)."""
    ranks, _ = worlds["sp2"]
    for out in ranks:
        assert out["shift"]["tokens"] == out["shift"]["split"]
        assert out["init_is_tree"]


def test_sp_refusals(worlds):
    """Clear ValueErrors, not another computation: a shifted length sp
    does not divide; a 'tokens' block handed to llama_loss under sp; an
    sp mesh whose batch does not split the sequence; Ulysses over kv
    heads sp does not divide (JAX's all-to-all cannot split them
    either); the ring's unequal causal blocks (JAX's message)."""
    for name, (ranks, _) in worlds.items():
        for out in ranks:
            e = out["errors"]
            n = len(ranks)
            assert f"n_kv_heads=1 must be divisible by sp={n}" in \
                e["ulysses_kv"]
            assert "causal ring attention requires equal q/kv shards" in \
                e["ring_unequal"]
            if name != "sp2":
                continue
            assert "sp=2 does not divide the sequence length 15" in \
                e["shift_length"]
            assert "pass 'inputs' and 'targets'" in e["loss_tokens"]
            assert 'batch_logical=("batch", "length")' in \
                e["unsplit_length"]


def test_step_refuses_a_model_without_sp(worlds):
    """A loss_fn that hands the model no sp group under a step that
    splits the sequence raises (in `llama_hidden`) instead of training
    on attention within each rank's block with positions from 0; the
    same guard in one process: inside `splitting(2)` the model refuses
    sp=None and a group of one, and outside it runs."""
    for out in worlds["sp2"][0]:
        assert "splits the sequence over sp=2" in \
            out["errors"]["loss_without_sp"]
        assert "pass sp=sp_group(mesh)" in out["errors"]["loss_without_sp"]
    cfg = TConfig.nano()
    params = tllama.llama_init(cfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with seqp.splitting(2):
        for sp in (None, seqp.SPGroup(None, 0, 1)):
            with pytest.raises(ValueError, match="splits the sequence"):
                tllama.llama_hidden(params, tokens, cfg, sp=sp)
    assert tllama.llama_hidden(params, tokens, cfg).shape == (1, 8, cfg.dim)
