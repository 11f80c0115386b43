"""Shared inputs and gloo worlds of the port's other model families and
its last two mesh axes (tests/test_torch_port_moe.py,
tests/test_torch_port_pipeline.py, tests/test_torch_port_vit_t5.py).

Inputs are made from a seed with numpy and handed to both packages.
Two worlds of fresh interpreters (`rank_main`, gloo on the CPU) run
every distributed case in one launch each, while three more
interpreters run the JAX side (`jax_main`) on 8 virtual CPU devices,
one a world for its cases but the tp ones and one for the tp cases of
both:

- "w2" (2 ranks): `make_pipelined_fn` over {"pp": 2} against the stack
  of stages run in turn; the step over {"pp": 2} with stage-specced
  leaves and a replicated leaf before the pipeline; T5's step over
  {"dp": 2} on a batch whose shards hold different pad counts; MoE,
  ViT, T5 and the MLP each under a {"tp": 2} step;
- "w4" (4 ranks): MoE over {"dp": 2, "ep": 2}, three AdamW steps and
  the first step's gradients; `make_pipelined_fn` over {"pp": 4}; ViT
  and T5 over {"fsdp": 2, "tp": 2} and MoE over {"ep": 2, "tp": 2}.

Each tp case (`TP_CASES`) makes three AdamW steps and records the
metrics, the first step's gradients, the params after the steps and
each leaf's shape on the rank; the JAX side the same on the same mesh,
with each leaf's addressable shard shape (`check_tp_case`).

`compute` runs the worlds and the JAX side at once; the test modules share
its result through `torch_port_helpers.once`. This module imports no
JAX at its top: the rank interpreters import it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from torch_port_helpers import (child_env, die_with_parent, flat_tree,
                                nest_tree)

LR, EPS, STEPS = 1e-3, 1e-6, 3
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLDS = {"w2": 2, "w4": 4}
COMPUTE_S, RANK_LIMIT_S = 200, 170
# MoE under {"dp": 2, "ep": 2}: nano_moe in f32 with capacity 0.5 x the
# even share, so routing drops tokens and a per-rank capacity count
# would drop others than the global one
MOE_KW = dict(dtype="float32", remat=False, capacity_factor=0.5)
# the pipeline: stages x microbatches x global batch x width
PIPE = {2: (2, 4, 8, 16), 4: (4, 8, 16, 32)}
T5_KW = dict(dtype="float32", remat=False)
# tensor parallelism: each family's step on the world's meshes, ViT and
# T5 with a layer checkpoint (its recompute reruns the collectives)
TP_VIT_KW = dict(image_size=8, patch_size=4, dim=64, n_layers=2, n_heads=2,
                 ffn_dim=96, num_classes=10, dtype="float32", remat=True)
TP_T5_KW = dict(dtype="float32", remat=True)
TP_MLP_KW = dict(in_dim=20, hidden=(16, 12))
TP_CASES = {2: {"moe-tp2": ("moe", {"tp": 2}), "vit-tp2": ("vit", {"tp": 2}),
                "t5-tp2": ("t5", {"tp": 2}), "mlp-tp2": ("mlp", {"tp": 2})},
            4: {"vit-fsdp2-tp2": ("vit", {"fsdp": 2, "tp": 2}),
                "t5-fsdp2-tp2": ("t5", {"fsdp": 2, "tp": 2}),
                "moe-ep2-tp2": ("moe", {"ep": 2, "tp": 2})}}


def torch_kw(kw):
    """A config's keyword arguments with dtype names as torch dtypes."""
    return {k: getattr(torch, v) if k == "dtype" else v
            for k, v in kw.items()}


def jax_kw(kw):
    import jax.numpy as jnp

    return {k: getattr(jnp, v) if k == "dtype" else v
            for k, v in kw.items()}


def _rng(seed):
    rng = np.random.RandomState(seed)

    def normal(shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return rng, normal


def moe_numpy_params(cfg, seed=0):
    """`moe_init`'s layout and scales; norm scales perturbed from 1."""
    from ray_tpu.models.moe import _moe_layer_shapes

    _, normal = _rng(seed)
    layers = {}
    for name, (shape, _, fan_in) in _moe_layer_shapes(cfg).items():
        full = (cfg.n_layers,) + shape
        layers[name] = (1.0 + normal(full, 0.1) if fan_in is None
                        else normal(full, fan_in ** -0.5))
    return {"tok_embed": normal((cfg.vocab_size, cfg.dim), 0.02),
            "layers": layers,
            "final_norm": 1.0 + normal((cfg.dim,), 0.1),
            "lm_head": normal((cfg.dim, cfg.vocab_size), cfg.dim ** -0.5)}


def vit_numpy_params(cfg, seed=0):
    """`vit_init`'s layout and scales; scales perturbed from 1 and biases
    and the class token from 0."""
    from ray_tpu.models.vit import _layer_shapes

    _, normal = _rng(seed)
    layers = {}
    for name, (shape, _, fan_in) in _layer_shapes(cfg).items():
        full = (cfg.n_layers,) + shape
        layers[name] = (1.0 + normal(full, 0.1) if fan_in is None
                        else normal(full, 0.1) if fan_in == 0
                        else normal(full, fan_in ** -0.5))
    d = cfg.dim
    return {"patch_embed": normal((cfg.patch_dim, d), cfg.patch_dim ** -0.5),
            "cls_token": normal((d,), 0.1),
            "pos_embed": normal((cfg.n_patches + 1, d), 0.02),
            "layers": layers,
            "final_ln_scale": 1.0 + normal((d,), 0.1),
            "final_ln_bias": normal((d,), 0.1),
            "head": normal((d, cfg.num_classes), d ** -0.5)}


def t5_numpy_params(cfg, seed=0):
    """`t5_init`'s layout and scales; norm scales perturbed from 1."""
    from ray_tpu.models.t5 import _dec_shapes, _enc_shapes

    _, normal = _rng(seed)

    def stack(shapes):
        return {name: (1.0 + normal((cfg.n_layers,) + shape, 0.1)
                       if fan_in is None else
                       normal((cfg.n_layers,) + shape, fan_in ** -0.5))
                for name, (shape, _, fan_in) in shapes.items()}

    return {"embed": normal((cfg.vocab_size, cfg.dim), cfg.dim ** -0.5),
            "encoder": stack(_enc_shapes(cfg)),
            "decoder": stack(_dec_shapes(cfg)),
            "enc_final_norm": 1.0 + normal((cfg.dim,), 0.1),
            "dec_final_norm": 1.0 + normal((cfg.dim,), 0.1)}


def mlp_numpy_params(cfg, seed=0):
    _, normal = _rng(seed)
    dims = [cfg.in_dim, *cfg.hidden, cfg.n_classes]
    return {f"layer{i}": {"w": normal((dims[i], dims[i + 1]),
                                      dims[i] ** -0.5),
                          "b": normal((dims[i + 1],), 0.1)}
            for i in range(len(dims) - 1)}


def t5_batch(cfg, seed, rows=4, src=12, tgt=9):
    """{'src', 'tgt'} with pad runs at the ends of the target rows: rows
    0-1 hold 1 and 2 pads, rows 2-3 hold 6 and 8 (so a 2-way row split
    gives shards of very different live counts)."""
    rng, _ = _rng(seed)
    batch = {"src": rng.randint(1, cfg.vocab_size, (rows, src)),
             "tgt": rng.randint(1, cfg.vocab_size, (rows, tgt))}
    for r, pads in enumerate((1, 2, 6, 8)[:rows]):
        batch["tgt"][r, tgt - pads:] = cfg.pad_id
    return {k: v.astype(np.int32) for k, v in batch.items()}


def _tp_inputs(model, seed):
    """A tp case's numpy params and batch (flat npz keys)."""
    from ray_tpu.models.mlp import MLPConfig
    from ray_tpu.models.moe import MoeConfig
    from ray_tpu.models.t5 import T5Config
    from ray_tpu.models.vit import ViTConfig

    rng, _ = _rng(seed)
    if model == "moe":
        cfg = MoeConfig.nano_moe(**jax_kw(MOE_KW))
        params = moe_numpy_params(cfg, seed)
        batch = {"tokens": rng.randint(0, cfg.vocab_size, (4, 17))}
    elif model == "vit":
        cfg = ViTConfig(**jax_kw(TP_VIT_KW))
        params = vit_numpy_params(cfg, seed)
        batch = {"images": rng.rand(4, 8, 8, 3).astype(np.float32),
                 "labels": rng.randint(0, 10, (4,))}
    elif model == "t5":
        cfg = T5Config.nano(**jax_kw(TP_T5_KW))
        params = t5_numpy_params(cfg, seed)
        batch = t5_batch(cfg, seed + 1)
    else:
        params = mlp_numpy_params(MLPConfig(**TP_MLP_KW), seed)
        batch = {"x": rng.rand(6, 20).astype(np.float32),
                 "y": rng.randint(0, 10, (6,))}
    batch = {k: v.astype(np.int32) if v.dtype.kind == "i" else v
             for k, v in batch.items()}
    return {**{f"p/{k}": v for k, v in flat_tree(params).items()},
            **{f"b/{k}": v for k, v in batch.items()}}


def inputs(world):
    """The seeded numpy inputs of a world (flat npz keys)."""
    from ray_tpu.models.moe import MoeConfig
    from ray_tpu.models.t5 import T5Config

    rng, normal = _rng(20 + world)
    S, M, gb, d = PIPE[world]
    out = {f"pipe{world}/w": normal((S, d, d), 0.3),
           f"pipe{world}/b": normal((S, d), 0.1),
           f"pipe{world}/x": normal((gb, d)),
           f"pipe{world}/g": normal((gb, d))}
    if world == 2:
        S, M, gb, d = PIPE[2]
        out.update({"pstep/emb": normal((d, d), d ** -0.5),
                    "pstep/w": normal((S, d, d), 0.3),
                    "pstep/x": normal((gb, d))})
        tcfg = T5Config.nano(**jax_kw(T5_KW))
        out.update({f"t5/{k}": v for k, v in
                    flat_tree(t5_numpy_params(tcfg, seed=4)).items()})
        out.update({f"t5b/{k}": v for k, v in t5_batch(tcfg, 5).items()})
    else:
        mcfg = MoeConfig.nano_moe(**jax_kw(MOE_KW))
        out.update({f"moe/{k}": v for k, v in
                    flat_tree(moe_numpy_params(mcfg, seed=6)).items()})
        out["moe_tokens"] = rng.randint(0, mcfg.vocab_size,
                                        (4, 17)).astype(np.int32)
    for i, (case, (model, _)) in enumerate(TP_CASES[world].items()):
        out.update({f"{case}/{k}": v for k, v in
                    _tp_inputs(model, 30 + 10 * world + i).items()})
    return out


def subtree(data, prefix):
    return nest_tree({k[len(prefix) + 1:]: v for k, v in data.items()
                      if k.startswith(prefix + "/")})


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


# ---------------------------------------------------------------- the ranks

def _pipeline_case(data, n, out):
    """`make_pipelined_fn` over {"pp": n}: the output and, under the
    seeded cotangent, the gradients of the stacked params and of x."""
    from ray_tpu_torch.parallel import create_mesh, make_pipelined_fn

    S, M, gb, d = PIPE[n]
    mesh = create_mesh({"pp": n}, device_type="cpu")
    fn = make_pipelined_fn(stage_fn, mesh, M)
    w = torch.tensor(data[f"pipe{n}/w"], requires_grad=True)
    b = torch.tensor(data[f"pipe{n}/b"], requires_grad=True)
    x = torch.tensor(data[f"pipe{n}/x"], requires_grad=True)
    y = fn({"w": w, "b": b}, x)
    dw, db, dx = torch.autograd.grad(
        y, (w, b, x), torch.tensor(data[f"pipe{n}/g"]))
    # the same stack run in turn, in this process
    seq = x
    for i in range(S):
        seq = stage_fn({"w": w[i], "b": b[i]}, seq)
    sdw, sdb, sdx = torch.autograd.grad(
        seq, (w, b, x), torch.tensor(data[f"pipe{n}/g"]))
    out[f"pipe{n}"] = {
        "y": y.detach().tolist(), "dx": dx.tolist(),
        "dw": dw.tolist(), "db": db.tolist(),
        "seq": [t.detach().tolist() for t in (seq, sdx, sdw, sdb)]}


def pipe_loss_fn(pipelined):
    """The pp step's loss: a replicated leaf before the pipeline, the
    stage-specced stack, a mean square after it."""
    def loss_fn(p, b):
        h = torch.tanh(b["x"] @ p["emb"])
        return (pipelined({"w": p["w"]}, h) ** 2).mean()
    return loss_fn


def _steps(step_fn, params, state, batch, steps=STEPS):
    metrics = []
    for _ in range(steps):
        params, state, m = step_fn(params, state, batch)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    return params, state, metrics


def _first_grads(state, params, b1=0.9):
    """Each leaf's gradient of the first step, from AdamW's first moment
    after it (m = (1 - b1) g)."""
    from ray_tpu_torch.models import training

    tree = training.AdamW.state_tree(state, params)["exp_avg"]
    return {k: (v / (1 - b1)).tolist() for k, v in flat_tree(tree).items()}


def _pp_step(data, out):
    from ray_tpu_torch.models import training
    from ray_tpu_torch.parallel import create_mesh, make_pipelined_fn

    S, M, gb, d = PIPE[2]
    mesh = create_mesh({"pp": 2}, device_type="cpu")
    loss_fn = pipe_loss_fn(make_pipelined_fn(
        lambda p, x: torch.tanh(x @ p["w"]), mesh, M))
    specs = {"emb": (None, None), "w": ("pp", None, None)}
    init, step = training.make_sharded_train_step(
        loss_fn, training.adamw(LR, eps=EPS), mesh, specs)
    params, state = init({"emb": torch.tensor(data["pstep/emb"]),
                          "w": torch.tensor(data["pstep/w"])})
    p1, s1, m1 = step(params, state, {"x": data["pstep/x"]})
    first = [[m1["loss"].item(), m1["grad_norm"].item()]]
    grads = _first_grads(s1, p1)
    p, s, metrics = _steps(step, p1, s1, {"x": data["pstep/x"]}, STEPS - 1)
    out["pp_step"] = {"metrics": first + metrics, "grads": grads,
                      "params": {k: v.detach().tolist()
                                 for k, v in p.items()}}


def _t5_step(data, out):
    from ray_tpu_torch.convert import t5_params_from_numpy
    from ray_tpu_torch.models import training
    from ray_tpu_torch.models.t5 import T5Config, t5_loss, t5_param_specs
    from ray_tpu_torch.parallel import create_mesh

    cfg = T5Config.nano(**torch_kw(T5_KW))
    mesh = create_mesh({"dp": 2}, device_type="cpu")
    init, step = training.make_sharded_train_step(
        lambda p, b: t5_loss(p, b, cfg), training.adamw(LR, eps=EPS), mesh,
        t5_param_specs(cfg))
    params, state = init(t5_params_from_numpy(subtree(data, "t5"), cfg,
                                              device="cpu",
                                              dtype=torch.float32))
    batch = {k: data[f"t5b/{k}"] for k in ("src", "tgt")}
    p, _, metrics = _steps(step, params, state, batch)
    out["t5_step"] = {"metrics": metrics, "params": {
        k: v.detach().tolist() for k, v in flat_tree(p).items()}}


def _tp_step(data, world, case, out):
    """``case`` of `TP_CASES[world]`: three AdamW steps of the family's
    loss with the tp layer, over its mesh."""
    from ray_tpu_torch import convert
    from ray_tpu_torch.models import mlp, moe, t5, training, vit
    from ray_tpu_torch.parallel import create_mesh, tp_group

    model, axes = TP_CASES[world][case]
    mesh = create_mesh(axes, device_type="cpu")
    tp = tp_group(mesh)
    tree = subtree(data, f"{case}/p")
    batch = {k[len(case) + 3:]: v for k, v in data.items()
             if k.startswith(f"{case}/b/")}
    kw = dict(device="cpu", dtype=torch.float32)
    if model == "moe":
        cfg = moe.MoeConfig.nano_moe(**torch_kw(MOE_KW))
        ep = tp_group(mesh, "ep")
        loss_fn = lambda p, b: moe.moe_loss(p, b, cfg, ep=ep, tp=tp)  # noqa: E731
        specs = moe.moe_param_specs(cfg)
        params = convert.moe_params_from_numpy(tree, cfg, **kw)
    elif model == "vit":
        cfg = vit.ViTConfig(**torch_kw(TP_VIT_KW))
        loss_fn = lambda p, b: vit.vit_loss(p, b, cfg, tp=tp)  # noqa: E731
        specs = vit.vit_param_specs(cfg)
        params = convert.vit_params_from_numpy(tree, cfg, **kw)
    elif model == "t5":
        cfg = t5.T5Config.nano(**torch_kw(TP_T5_KW))
        loss_fn = lambda p, b: t5.t5_loss(p, b, cfg, tp=tp)  # noqa: E731
        specs = t5.t5_param_specs(cfg)
        params = convert.t5_params_from_numpy(tree, cfg, **kw)
    else:
        cfg = mlp.MLPConfig(**TP_MLP_KW)
        loss_fn = lambda p, b: mlp.mlp_loss(p, b, cfg)  # noqa: E731
        params = convert.mlp_params_from_numpy(tree, cfg, **kw)
        specs = training._tree_map(lambda _: (), params)
    init, step = training.make_sharded_train_step(
        loss_fn, training.adamw(LR, eps=EPS), mesh, specs)
    p1, s1, m1 = step(*init(params), batch)
    first = [[m1["loss"].item(), m1["grad_norm"].item()]]
    grads = _first_grads(s1, p1)
    p, _, metrics = _steps(step, p1, s1, batch, STEPS - 1)
    out[case] = {
        "coord": dict(zip(mesh.mesh_dim_names,
                          map(int, mesh.get_coordinate()))),
        "metrics": first + metrics, "grads": grads,
        "params": {k: v.detach().tolist() for k, v in flat_tree(p).items()},
        "shapes": {k: list(v.shape) for k, v in flat_tree(p).items()}}


def _moe_step(data, out):
    from ray_tpu_torch.convert import moe_params_from_numpy
    from ray_tpu_torch.models import training
    from ray_tpu_torch.models.moe import MoeConfig, moe_loss, moe_param_specs
    from ray_tpu_torch.parallel import create_mesh, tp_group

    cfg = MoeConfig.nano_moe(**torch_kw(MOE_KW))
    mesh = create_mesh({"dp": 2, "ep": 2}, device_type="cpu")
    ep = tp_group(mesh, "ep")
    init, step = training.make_sharded_train_step(
        lambda p, b: moe_loss(p, b, cfg, ep=ep),
        training.adamw(LR, eps=EPS), mesh, moe_param_specs(cfg))
    params, state = init(moe_params_from_numpy(
        subtree(data, "moe"), cfg, device="cpu", dtype=torch.float32))
    batch = {"tokens": data["moe_tokens"]}
    p1, s1, m1 = step(params, state, batch)
    first = [[m1["loss"].item(), m1["grad_norm"].item()]]
    grads = _first_grads(s1, p1)
    p, _, metrics = _steps(step, p1, s1, batch, STEPS - 1)
    out["moe_step"] = {
        "ep": [ep.rank, ep.size], "metrics": first + metrics,
        "grads": grads, "params": {k: v.detach().tolist()
                                   for k, v in flat_tree(p).items()}}


def rank_main():
    """One rank of a world; run as ``python -c "import torch_port_a13 as
    t; t.rank_main()" JOB RANK``. Writes ``out/rank<k>.json``."""
    import faulthandler

    import torch.distributed as dist

    die_with_parent()
    with open(sys.argv[1]) as f:
        job = json.load(f)
    faulthandler.dump_traceback_later(RANK_LIMIT_S, exit=True)
    torch.set_num_threads(1)
    rank = int(sys.argv[2])

    from ray_tpu_torch.parallel import initialize_distributed

    initialize_distributed(job["store"], job["world"], rank,
                           device_type="cpu")
    data = dict(np.load(job["inputs"]))
    out = {}
    if job["world"] == 2:
        _pipeline_case(data, 2, out)
        _pp_step(data, out)
        _t5_step(data, out)
    else:
        _moe_step(data, out)
        _pipeline_case(data, 4, out)
    for case in TP_CASES[job["world"]]:
        _tp_step(data, job["world"], case, out)
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# ------------------------------------------------------------ the JAX side

def _jax_pipeline(data, n, devices):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import create_mesh
    from ray_tpu.parallel.pipeline import make_pipelined_fn

    S, M, gb, d = PIPE[n]
    mesh = create_mesh({"pp": n}, devices[:n])

    def jstage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    fn = make_pipelined_fn(jstage, mesh, M)
    params = {"w": jnp.asarray(data[f"pipe{n}/w"]),
              "b": jnp.asarray(data[f"pipe{n}/b"])}
    y, back = jax.vjp(fn, params, jnp.asarray(data[f"pipe{n}/x"]))
    dp, dx = back(jnp.asarray(data[f"pipe{n}/g"]))
    return {"y": np.asarray(y).tolist(), "dx": np.asarray(dx).tolist(),
            "dw": np.asarray(dp["w"]).tolist(),
            "db": np.asarray(dp["b"]).tolist()}


def _as_step_returns(params, state, specs, mesh):
    """JAX's init placed as its step returns params and AdamW state
    (each spec without its size-1 axes and trailing Nones, the count
    replicated; the init leaves the state on one device), so that the
    step compiles once and not again at its second call. Placement only:
    the values are the init's."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    sizes = dict(mesh.shape)

    def returned(spec):
        out = []
        for e in spec:
            axes = [a for a in ((e,) if isinstance(e, str) else e or ())
                    if sizes[a] > 1]
            out.append(tuple(axes) if len(axes) > 1 else
                       axes[0] if axes else None)
        while out and out[-1] is None:
            out.pop()
        return NamedSharding(mesh, P(*out))

    shardings = jax.tree_util.tree_map(
        returned, specs, is_leaf=lambda x: isinstance(x, P))

    def put(tree):
        return jax.tree_util.tree_map(jax.device_put, tree, shardings)

    adam = state[0]
    adam = adam._replace(count=jax.device_put(adam.count,
                                              NamedSharding(mesh, P())),
                         mu=put(adam.mu), nu=put(adam.nu))
    return put(params), (adam,) + tuple(state[1:])


def _jax_steps(loss_fn, mesh, specs, params, batch):
    """JAX's step: metrics of STEPS AdamW steps, the first step's
    gradients (AdamW's first moment after it, m = (1 - b1) g), the final
    params and each leaf's addressable shard shape under its spec."""
    import jax
    import optax

    from ray_tpu.models.training import make_sharded_train_step

    init, step = make_sharded_train_step(
        loss_fn, optax.adamw(LR, eps=EPS), mesh, specs, donate=False)
    p, s = init(params)
    # the shards as the specs place them (the step may return a leaf in
    # another layout: MoE's replicated wk and wv come back split on tp)
    shapes = {k: list(v.addressable_shards[0].data.shape)
              for k, v in flat_tree(p).items()}
    p, s = _as_step_returns(p, s, specs, mesh)
    metrics = []
    for i in range(STEPS):
        p, s, m = step(p, s, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
        if i == 0:
            grads = {k: (np.asarray(v) / 0.1).tolist() for k, v in
                     flat_tree(jax.device_get(s[0].mu)).items()}
    return {"metrics": metrics, "grads": grads, "params": {
        k: np.asarray(v).tolist() for k, v in flat_tree(
            jax.device_get(p)).items()}, "shapes": shapes}


def _jax_tp_case(data, case, world, devices):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.models import mlp, moe, t5, vit
    from ray_tpu.parallel import MeshSpec, create_mesh

    model, axes = TP_CASES[world][case]
    n = int(np.prod(list(axes.values())))
    mesh = create_mesh(MeshSpec(**axes).resolve(n), devices[:n])
    params = jax.tree_util.tree_map(jnp.asarray, subtree(data, f"{case}/p"))
    batch = {k[len(case) + 3:]: jnp.asarray(v) for k, v in data.items()
             if k.startswith(f"{case}/b/")}
    # JAX's remat changes no value, only what its compile must plan
    if model == "moe":
        cfg = moe.MoeConfig.nano_moe(**jax_kw(MOE_KW))
        loss, specs = moe.moe_loss, moe.moe_param_specs(cfg)
    elif model == "vit":
        cfg = vit.ViTConfig(**jax_kw(dict(TP_VIT_KW, remat=False)))
        loss, specs = vit.vit_loss, vit.vit_param_specs(cfg)
    elif model == "t5":
        cfg = t5.T5Config.nano(**jax_kw(dict(TP_T5_KW, remat=False)))
        loss, specs = t5.t5_loss, t5.t5_param_specs(cfg)
    else:
        cfg = mlp.MLPConfig(**TP_MLP_KW)
        loss = mlp.mlp_loss
        specs = jax.tree_util.tree_map(lambda _: P(), params)
    return _jax_steps(lambda p, b: loss(p, b, cfg), mesh, specs, params,
                      batch)


def jax_main(part, path):
    """One part of the JAX side, in a fresh interpreter: ``python -c
    "import torch_port_a13 as t; t.jax_main(PART, PATH)"``; "w2" and
    "w4" run their world's cases but the tp ones, "tp" the `TP_CASES`
    of both worlds (one interpreter: a second would pay JAX's start and
    first compiles again, and the three run side by side)."""
    die_with_parent()
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel import MeshSpec, create_mesh
    from ray_tpu.parallel.pipeline import make_pipelined_fn

    devices = jax.devices()
    out = {}
    if part == "tp":
        for n, cases in TP_CASES.items():
            data = inputs(n)
            for case in cases:
                out[case] = _jax_tp_case(data, case, n, devices)
    elif part == "w2":
        data = inputs(2)
        out["pipe2"] = _jax_pipeline(data, 2, devices)
        S, M, gb, d = PIPE[2]
        mesh = create_mesh({"pp": 2}, devices[:2])
        fn = make_pipelined_fn(lambda p, x: jnp.tanh(x @ p["w"]), mesh, M)

        def pipe_loss(p, b):
            h = jnp.tanh(b["x"] @ p["emb"])
            return jnp.mean(fn({"w": p["w"]}, h) ** 2)

        params = {"emb": jnp.asarray(data["pstep/emb"]),
                  "w": jnp.asarray(data["pstep/w"])}
        batch = {"x": jnp.asarray(data["pstep/x"])}
        out["pp_step"] = _jax_steps(
            pipe_loss, mesh, {"emb": P(None, None), "w": P("pp", None, None)},
            params, batch)
        out["pp_step"]["grads"] = {
            k: np.asarray(v).tolist() for k, v in
            jax.grad(pipe_loss)(params, batch).items()}
        # the same loss through the stages run in turn
        def seq_loss(p, b):
            h = jnp.tanh(b["x"] @ p["emb"])
            for i in range(S):
                h = jnp.tanh(h @ p["w"][i])
            return jnp.mean(h ** 2)
        out["pp_step"]["seq_grads"] = {
            k: np.asarray(v).tolist() for k, v in
            jax.grad(seq_loss)(params, batch).items()}

        from ray_tpu.models.t5 import T5Config, t5_loss, t5_param_specs

        cfg = T5Config.nano(**jax_kw(T5_KW))
        out["t5_step"] = _jax_steps(
            lambda p, b: t5_loss(p, b, cfg),
            create_mesh({"dp": 2}, devices[:2]), t5_param_specs(cfg),
            jax.tree_util.tree_map(jnp.asarray, subtree(data, "t5")),
            {k: jnp.asarray(data[f"t5b/{k}"]) for k in ("src", "tgt")})
    else:
        from ray_tpu.models.moe import MoeConfig, moe_loss, moe_param_specs

        data = inputs(4)
        cfg = MoeConfig.nano_moe(**jax_kw(MOE_KW))
        params = jax.tree_util.tree_map(jnp.asarray, subtree(data, "moe"))
        tokens = jnp.asarray(data["moe_tokens"])
        mesh = create_mesh(MeshSpec(dp=2, ep=2).resolve(4), devices[:4])
        out["moe_step"] = _jax_steps(
            lambda p, b: moe_loss(p, b, cfg), mesh, moe_param_specs(cfg),
            params, {"tokens": tokens})
        out["moe_step"]["grads"] = {
            k: np.asarray(v).tolist() for k, v in flat_tree(jax.grad(
                lambda p: moe_loss(p, {"tokens": tokens}, cfg))(
                    params)).items()}
        out["moe_step"]["whole"] = float(
            moe_loss(params, {"tokens": tokens}, cfg))
        out["moe_step"]["halves"] = [
            float(moe_loss(params, {"tokens": tokens[i:i + 2]}, cfg))
            for i in (0, 2)]
        out["pipe4"] = _jax_pipeline(data, 4, devices)
    with open(path, "w") as f:
        json.dump(out, f)


def _start_world(name, out_dir):
    ranks = WORLDS[name]
    out_dir.mkdir(exist_ok=True)
    npz = out_dir / "inputs.npz"
    np.savez(npz, **inputs(ranks))
    job = out_dir / "job.json"
    job.write_text(json.dumps({"world": ranks,
                               "store": f"file://{out_dir}/store",
                               "inputs": str(npz), "out": str(out_dir)}))
    env = child_env()
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import torch_port_a13 as t; t.rank_main()",
         str(job), str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(ranks)]

    def read():
        return [json.loads((out_dir / f"rank{r}.json").read_text())
                for r in range(ranks)]

    return procs, read


def compute(out_dir):
    """Both worlds and their JAX sides, all at once: {world: (each
    rank's results, JAX's)}."""
    deadline = time.monotonic() + COMPUTE_S
    out_dir.mkdir(exist_ok=True)
    # the JAX side's programs are tiny: its time is XLA's compiles, which
    # these flags halve (the programs' values are checked as before)
    env = child_env(JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join((
        "--xla_force_host_platform_device_count=8",
        "--xla_backend_optimization_level=0",
        "--xla_llvm_disable_expensive_passes=true")))
    parts = list(WORLDS) + ["tp"]
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import torch_port_a13 as t; t.jax_main({part!r}, "
         f"{str(out_dir / f'jax-{part}.json')!r})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for part in parts]
    started = {w: _start_world(w, out_dir / w) for w in WORLDS}
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

    jax = {part: json.loads((out_dir / f"jax-{part}.json").read_text())
           for part in parts}
    return {w: (read(), {**jax[w], **{case: jax["tp"][case] for case in
                                      TP_CASES[WORLDS[w]]}})
            for w, (_, read) in started.items()}


# ------------------------------------------------------------ the checks

def tp_world(case):
    return next(f"w{n}" for n, cases in TP_CASES.items() if case in cases)


def check_tp_case(worlds, case, specs, rel):
    """Every rank of ``case`` (`TP_CASES`) against JAX's step on the same
    mesh: the loss and grad norm of the three steps within 1e-4
    relative; the rank's block (``specs``, flat) of the first step's
    gradients within 1e-4 of JAX's relative to the leaf's largest
    (``rel``); its block of the params after the steps within 1e-5 with
    an absolute floor of lr / 10; and each leaf's shape on the rank
    equal to JAX's addressable shard's. Returns the ranks' results."""
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    from ray_tpu_torch.parallel.sharding import local_region

    ranks, ref = worlds[tp_world(case)]
    want = ref[case]
    axes = TP_CASES[int(tp_world(case)[1:])][case][1]
    sizes = {a: axes.get(a, 1) for a in AXIS_ORDER}
    for out in ranks:
        got = out[case]
        assert got["shapes"] == want["shapes"]
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=1e-4)
        for kind in ("grads", "params"):
            for name, v in got[kind].items():
                full = np.asarray(want[kind][name])
                block = full[local_region(full.shape, specs[name], sizes,
                                          got["coord"])]
                if kind == "grads":
                    assert rel(v, block) <= 1e-4, (name, rel(v, block))
                else:
                    np.testing.assert_allclose(v, block, rtol=1e-5,
                                               atol=LR / 10, err_msg=name)
    return [out[case] for out in ranks]
