"""Shared inputs for the PyTorch-port tests (tests/test_torch_port_*.py).

Inputs are made from a seed with numpy and handed to both packages, so
the JAX reference and the port compute on the same numbers.

`rank_main` is one gloo rank of a sharded-training world: the tests
start it as a fresh interpreter (never a fork of a process that has
used torch), so this module imports no JAX at its top.
"""

import json
import sys

import numpy as np
import torch


def numpy_params(cfg, seed=0):
    """Seeded numpy Llama params in `llama_init`'s layout and scales;
    norm scales are perturbed from 1 so the tests see them applied."""
    from ray_tpu.models.llama import _layer_shapes

    rng = np.random.RandomState(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    layers = {}
    for name, (shape, _, fan_in) in _layer_shapes(cfg).items():
        full = (cfg.n_layers,) + shape
        layers[name] = (1.0 + normal(full, 0.1) if fan_in is None
                        else normal(full, fan_in ** -0.5))
    return {
        "tok_embed": normal((cfg.vocab_size, cfg.dim), 0.02),
        "layers": layers,
        "final_norm": 1.0 + normal((cfg.dim,), 0.1),
        "lm_head": normal((cfg.dim, cfg.vocab_size), cfg.dim ** -0.5),
    }


def to_torch(x):
    """numpy (incl. ml_dtypes float8_e4m3fn) -> CPU torch tensor."""
    x = np.asarray(x)
    if x.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(x.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(x.copy())


def byte_view(x):
    """Raw bytes of a numpy array or torch tensor, as numpy uint8."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def flat_tree(tree, prefix=""):
    """{"a": {"b": x}} -> {"a/b": x}: a param tree as npz keys."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def nest_tree(flat):
    """Inverse of `flat_tree`."""
    out = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


class FakeClock:
    """A deterministic clock that tests advance by hand, injected as an
    engine's, fleet's or autoscaler's ``clock``."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        assert dt >= 0, "monotonic clocks do not rewind"
        self.t += dt


def fleet_factory(engine_cls, params, cfg, **kw):
    """A fleet's ``engine_factory``: replica ``name`` becomes an
    ``engine_cls(params, cfg, engine_id=name, ...)`` with 2 slots and
    max_len 32 unless ``kw`` says otherwise."""
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 32)

    def make(name):
        return engine_cls(params, cfg, engine_id=name, **kw)
    return make


def drive_fleet(fleet, max_steps=400):
    """Step ``fleet`` until nothing is pending: (each step's emissions
    {fid: tokens}, each step's ``replica_health()``)."""
    steps, health = [], []
    for _ in range(max_steps):
        if not fleet.pending():
            break
        steps.append({f: list(t) for f, t in fleet.step().items()})
        health.append(fleet.replica_health())
    assert not fleet.pending(), f"fleet did not drain in {max_steps} steps"
    return steps, health


def rank_main():
    """One rank of the world a job file describes; run as
    ``python -c "import torch_port_helpers as h; h.rank_main()" JOB RANK``.

    The job: ``world`` ranks meeting at the ``store`` init method, the
    ``mesh`` axis sizes (through `create_hybrid_mesh` when ``hybrid``),
    the seeded ``inputs`` (an npz of the nano params and batches), the
    ``out`` directory. The rank takes ``steps`` AdamW steps of the sharded
    step on the global ``tokens`` batch, the same steps of the one-card
    `make_train_step`, one sharded step without donation, one with the
    batch replicated, one on the masked batch, builds `auto_mesh` and
    `local_mesh`, checks
    that each axis of ``unported`` refuses, saves its params and AdamW
    state to ``out/ckpt``, and with ``restore_mesh`` restores both under
    that mesh and takes one more step there and on its own mesh. It
    writes what it saw to ``out/rank<k>.json``."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.dump_traceback_later(120, exit=True)
    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        job = json.load(f)
    rank = int(sys.argv[2])

    from ray_tpu_torch.convert import params_from_numpy
    from ray_tpu_torch.models import llama, training
    from ray_tpu_torch.parallel import (DEFAULT_RULES, auto_mesh,
                                        create_hybrid_mesh, create_mesh,
                                        initialize_distributed, local_mesh,
                                        prune_rules_for_mesh)
    from ray_tpu_torch.parallel.sharding import mesh_axis_sizes, shard_pytree
    from ray_tpu_torch.train.array_checkpoint import (restore_pytree,
                                                      save_pytree)

    info = initialize_distributed(job["store"], job["world"], rank,
                                  device_type="cpu")
    build = create_hybrid_mesh if job["hybrid"] else create_mesh
    mesh = build(job["mesh"], device_type="cpu")
    cfg = llama.LlamaConfig.nano()
    specs = llama.llama_param_specs(cfg)
    data = dict(np.load(job["inputs"]))
    tree = nest_tree({k[len("params/"):]: v for k, v in data.items()
                      if k.startswith("params/")})
    opt = training.adamw(job["lr"])
    loss_fn = lambda p, b: llama.llama_loss(p, b, cfg)  # noqa: E731

    def fresh():
        return params_from_numpy(tree, cfg, device="cpu",
                                 dtype=torch.float32)

    out = {"info": [info.num_processes, info.process_id,
                    info.global_device_count],
           "names": list(mesh.mesh_dim_names),
           "ranks": mesh.mesh.tolist(),
           "coordinate": list(mesh.get_coordinate())}
    dims = {"heads": cfg.n_heads, "kv": cfg.n_kv_heads, "embed": cfg.dim}
    out["pruned_same"] = (
        prune_rules_for_mesh(DEFAULT_RULES, mesh, dims)
        == prune_rules_for_mesh(DEFAULT_RULES, mesh_axis_sizes(mesh), dims))

    init_fn, step_fn = training.make_sharded_train_step(
        loss_fn, opt, mesh, specs)
    params, state = init_fn(fresh())
    batch = {"tokens": data["tokens"]}
    out["sharded"] = []
    for _ in range(job["steps"]):
        params, state, m = step_fn(params, state, batch)
        out["sharded"].append([m["loss"].item(), m["grad_norm"].item()])

    one_init, one_step = training.make_train_step(loss_fn, opt,
                                                  device="cpu")
    p1, s1 = one_init(fresh())
    out["one_card"] = []
    for _ in range(job["steps"]):
        p1, s1, m = one_step(p1, s1, batch)
        out["one_card"].append([m["loss"].item(), m["grad_norm"].item()])
    mine = shard_pytree(p1, specs, mesh)
    out["one_card_max_diff"] = max(
        (a.detach() - b.detach()).abs().max().item() for a, b in
        zip(training._leaves(params), training._leaves(mine)))

    # without donation the step leaves its inputs as they were
    k_init, k_step = training.make_sharded_train_step(
        loss_fn, opt, mesh, specs, donate=False)
    kp, ks = k_init(fresh())
    before = [x.detach().clone() for x in training._leaves(kp)]
    kp2, _, m = k_step(kp, ks, batch)
    out["kept"] = [m["loss"].item(), m["grad_norm"].item(), all(
        torch.equal(a.detach(), b)
        for a, b in zip(training._leaves(kp), before)), kp2 is not kp]
    # the batch replicated while the params stay split: each rank takes
    # its own block of the whole gradient, with no reduction
    rules = dict(DEFAULT_RULES, batch=None)
    r_init, r_step = training.make_sharded_train_step(
        loss_fn, opt, mesh, llama.llama_param_specs(cfg, rules),
        rules=rules)
    rp, rs = r_init(fresh())
    _, _, m = r_step(rp, rs, batch)
    out["replicated_batch"] = [m["loss"].item(), m["grad_norm"].item()]
    out["auto_mesh"] = auto_mesh(device_type="cpu").mesh.tolist()
    local = local_mesh("cpu")
    out["local_mesh"] = [local.mesh.tolist(), list(local.mesh_dim_names)]

    masked = {k: data[k] for k in ("inputs", "targets", "mask")}
    m_init, m_step = training.make_sharded_train_step(loss_fn, opt, mesh,
                                                      specs)
    mp, ms = m_init(fresh())
    _, _, m = m_step(mp, ms, masked)
    out["masked"] = [m["loss"].item(), m["grad_norm"].item()]

    out["refused"] = []
    for axes in job["unported"]:
        try:
            training.make_sharded_train_step(
                loss_fn, opt, create_mesh(axes, device_type="cpu"), specs)
        except NotImplementedError as e:
            out["refused"].append(str(e))

    ckpt = job["out"] + "/ckpt"
    state_specs = opt.state_specs(specs)
    save_pytree(params, ckpt + "/params", mesh=mesh, specs=specs)
    save_pytree(opt.state_tree(state, params), ckpt + "/opt", mesh=mesh,
                specs=state_specs)
    dist.barrier()
    if job.get("restore_mesh"):
        other = create_mesh(job["restore_mesh"], device_type="cpu")
        r_init, r_step = training.make_sharded_train_step(
            loss_fn, opt, other, specs)
        rp = training._tree_map(
            lambda x: x.requires_grad_(True),
            restore_pytree(specs, ckpt + "/params", mesh=other,
                           specs=specs))
        rs = opt.init(rp)
        opt.load_state_tree(rs, rp, restore_pytree(
            state_specs, ckpt + "/opt", mesh=other, specs=state_specs))
        _, _, m = r_step(rp, rs, batch)
        out["resumed"] = [m["loss"].item(), m["grad_norm"].item()]
        out["restored_shapes"] = {k: list(v.shape)
                                  for k, v in rp["layers"].items()}
        _, _, m = step_fn(params, state, batch)
        out["continued"] = [m["loss"].item(), m["grad_norm"].item()]
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
