"""Shared inputs for the PyTorch-port tests (tests/test_torch_port_*.py).

Inputs are made from a seed with numpy and handed to both packages, so
the JAX reference and the port compute on the same numbers.

`rank_main` is one gloo rank of a sharded-training world: the tests
start it as a fresh interpreter (never a fork of a process that has
used torch), so this module imports no JAX at its top.
"""

import ctypes
import dataclasses
import json
import os
import signal
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
    `local_mesh`, takes one step over each mesh of ``model_axes`` (an
    ep or pp axis the llama specs do not split: the batch and every leaf
    replicated over it), saves its params and AdamW
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

    out["model_axes"] = []
    for axes in job["model_axes"]:
        a_init, a_step = training.make_sharded_train_step(
            loss_fn, opt, create_mesh(axes, device_type="cpu"), specs)
        ap, as_ = a_init(fresh())
        _, _, m = a_step(ap, as_, batch)
        out["model_axes"].append([m["loss"].item(), m["grad_norm"].item()])

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


class _ProductFlops:
    """Counts the FLOPs of every matrix product dispatched while it is
    active (mm, bmm, addmm, baddbmm: 2 * output size * contraction)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        ops = {torch.ops.aten.mm.default: -1, torch.ops.aten.bmm.default: -1,
               torch.ops.aten.addmm.default: -1,
               torch.ops.aten.baddbmm.default: -1}
        counter = self
        self.flops = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func in ops:
                    a = args[-2]
                    counter.flops += 2 * out.numel() * a.shape[-1]
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _engine_case(case, params, cfg, draft, adapters, tp):
    """Run one engine case at tp degree ``tp``: (tokens per request, the
    engine)."""
    from ray_tpu_torch.models.engine import DecodeEngine
    from ray_tpu_torch.models.lora import LoraConfig

    kw = dict(case["kw"])
    if case.get("draft"):
        kw.update(draft_params=draft, draft_cfg=cfg)
    if case.get("lora"):
        kw.update(lora=LoraConfig(**dict(
            case["lora"], targets=tuple(case["lora"]["targets"]))))
    eng = DecodeEngine(params, cfg, tp=tp, **kw)
    for aid in sorted(adapters if case.get("lora") else {}):
        eng.register_adapter(aid, adapters[aid])
    seeds = case.get("seeds") or [None] * len(case["prompts"])
    aids = case.get("aids") or [None] * len(case["prompts"])
    ids = [eng.submit(p, n, rng=s, adapter_id=a) for p, n, s, a in
           zip(case["prompts"], case["budgets"], seeds, aids)]
    out = eng.run()
    return [out[i] for i in ids], eng


_STAT_KEYS = ("tp_degree", "decode_dispatches", "host_syncs",
              "host_lag_steps", "host_transfer_bytes", "prefix_evictions",
              "adapter_evictions", "adapter_prefetches", "adapter_hits",
              "decode_graphs", "spec_dispatches", "kv_quant_enabled",
              "preemptions")


def _engine_record(eng):
    """What the tests read of an engine after its run."""
    s = eng.stats()
    rec = {"stats": {k: s[k] for k in _STAT_KEYS if k in s},
           "rules": eng._rules, "kv_heads": list(eng._kv_heads),
           "wq": list(eng.params["layers"]["wq"].shape),
           "tok_embed": list(eng.params["tok_embed"].shape)}
    if eng.paged:
        rec["pool_k"] = list(eng._pool_k.shape)
        rec["blocks_in_use"] = eng.kv_pool.blocks_in_use
        rec["trie_blocks"] = (eng._prefix.blocks_in_use
                              if eng._prefix is not None else 0)
    else:
        rec["cache_k"] = list(eng.cache["k"].shape)
    if eng.adapter_pool is not None:
        rec["stacks"] = {n: [list(ab["a"].shape), list(ab["b"].shape)]
                         for n, ab in eng.adapter_pool.stacks.items()}
        rec["refs"] = list(eng.adapter_pool._refs)
    return rec


def _tp_specials(job, params, cfg, tp, out):
    """The world's non-matrix cases: drain, knobs, registry, skewed
    clocks and a handoff."""
    from ray_tpu_torch.models.engine import DecodeEngine
    from ray_tpu_torch.models.scheduler import EngineDraining
    from ray_tpu_torch.parallel import create_mesh
    from ray_tpu_torch.util import metrics as tmetrics

    prompts = job["special_prompts"]
    # begin_drain with run-ahead blocks in flight
    eng = DecodeEngine(params, cfg, batch_slots=2, max_len=64, tp=tp,
                       pipeline_depth=2, decode_horizon=4)
    a, b = eng.submit(prompts[0], 12), eng.submit(prompts[1], 12)
    eng.step()
    lag = eng.stats()["host_lag_steps"]
    drained = eng.drain()
    try:
        eng.submit(prompts[2], 4)
        refused = False
    except EngineDraining:
        refused = True
    one = DecodeEngine(params, cfg, batch_slots=2, max_len=64)
    a1, b1 = one.submit(prompts[0], 12), one.submit(prompts[1], 12)
    solo = one.run()
    out["drain"] = {"lag": lag, "tokens": [drained[a], drained[b]],
                    "solo": [solo[a1], solo[b1]],
                    "refused": refused, "pending": eng.pending(),
                    "lag_after": eng.stats()["host_lag_steps"]}

    # a request exported at tp, imported by a one-card engine
    kw = dict(batch_slots=2, max_len=64, paged=True, kv_block_tokens=4,
              kv_quant="int8")
    src = DecodeEngine(params, cfg, tp=tp, **kw)
    src.prefill_only = True
    rid = src.submit(prompts[0], 6)
    while not src.handoff_ready():
        src.step()
    handoff = src.export_request(rid)
    dst = DecodeEngine(params, cfg, **kw)
    r2 = dst.import_request(handoff)
    got = dst.run()[r2]
    solo = DecodeEngine(params, cfg, **kw)
    r3 = solo.submit(prompts[0], 6)
    out["handoff"] = {"tokens": got, "solo": solo.run()[r3],
                      "mode_swap": dst.stats()["swap_ins"],
                      "k_shape": list(handoff["kv"]["k"].shape),
                      "pool_shape": list(handoff["kv"]["pool_shape"]),
                      "src_blocks": src.kv_pool.blocks_in_use}

    # skewed clocks: each rank's clock starts 100 s after the last's
    clock = FakeClock(100.0 * int(job["rank"]))
    eng = DecodeEngine(params, cfg, batch_slots=1, max_len=64, tp=tp,
                       clock=clock)
    ids = [eng.submit(p, 4, deadline_s=5.0) for p in prompts[:3]]
    clock.advance(3.0 + 7.0 * int(job["rank"]))
    eng.step()
    clock.advance(10.0)
    res = eng.run()
    out["clock"] = {"shed": eng.requests_shed,
                    "tokens": [res.get(i) for i in ids]}

    if job.get("knobs"):
        knobs = {}
        mesh = create_mesh({"tp": tp}, device_type="cpu")
        eng = DecodeEngine(params, cfg, batch_slots=2, max_len=64,
                           mesh=mesh)
        r = eng.submit([5, 6, 7], 4)
        knobs["mesh_tokens"] = eng.run()[r]
        knobs["mesh_tp_degree"] = eng.tp_degree
        one = DecodeEngine(params, cfg, batch_slots=2, max_len=64)
        r = one.submit([5, 6, 7], 4)
        knobs["solo_tokens"] = one.run()[r]
        from torch.distributed.device_mesh import DeviceMesh

        dp_mesh = DeviceMesh("cpu", torch.arange(int(job["world"])),
                             mesh_dim_names=("dp",))
        for name, kw in (("both", dict(mesh=mesh, tp=tp)),
                         ("zero", dict(tp=0)),
                         ("exceeds", dict(tp=int(job["world"]) + 1)),
                         ("axis", dict(mesh=dp_mesh))):
            try:
                DecodeEngine(params, cfg, batch_slots=2, max_len=64, **kw)
                knobs[name] = None
            except ValueError as e:
                knobs[name] = str(e)
        eng = DecodeEngine(params, cfg, batch_slots=2, max_len=64, tp=tp,
                           engine_id="tp-metrics-test")
        for p in prompts[:2]:
            eng.submit(p, 5)
        eng.run()
        s = eng.stats()
        rows = {r["name"]: r["value"] for r in tmetrics.snapshots()
                if r["tags"].get("engine") == "tp-metrics-test"}
        knobs["registry"] = {
            "stats_tp": s["tp_degree"],
            "stats_bytes": s["host_transfer_bytes"],
            "stats_bytes_per_token": s["host_transfer_bytes_per_token"],
            "gauge_tp": rows.get("llm_engine_tp_degree"),
            "counter_bytes": rows.get(
                "llm_engine_host_transfer_bytes_total")}
        out["knobs"] = knobs


def _tp_training(job, tree, data, cfg, out):
    """make_sharded_train_step over the job's training mesh with the tp
    loss: per-step metrics, the first step's gradients (from AdamW's
    first moment), the params after the steps, a checkpoint restored
    under ``restore_mesh``, and the FLOPs of one step against the
    one-card step on this rank's rows."""
    import torch.distributed as dist

    from ray_tpu_torch.convert import params_from_numpy
    from ray_tpu_torch.models import llama, training
    from ray_tpu_torch.parallel import create_mesh, tp_group
    from ray_tpu_torch.parallel.sharding import logical_to_mesh, shard_tensor
    from ray_tpu_torch.train.array_checkpoint import (restore_pytree,
                                                      save_pytree)

    def fresh():
        return params_from_numpy(tree, cfg, device="cpu",
                                 dtype=torch.float32)

    mesh = create_mesh(job["train_mesh"], device_type="cpu")
    tp = tp_group(mesh)
    specs = llama.llama_param_specs(cfg)
    opt = training.adamw(job["lr"], eps=job["eps"])
    loss_fn = lambda p, b: llama.llama_loss(p, b, cfg, tp=tp)  # noqa: E731
    batch = {"tokens": data["tokens"]}

    def train(cfg, tree):
        init_fn, step_fn = training.make_sharded_train_step(
            lambda p, b: llama.llama_loss(p, b, cfg, tp=tp), opt, mesh,
            llama.llama_param_specs(cfg))
        params, state = init_fn(params_from_numpy(
            tree, cfg, device="cpu", dtype=torch.float32))
        metrics, grads = [], None
        for i in range(job["steps"]):
            params, state, m = step_fn(params, state, batch)
            metrics.append([m["loss"].item(), m["grad_norm"].item()])
            if i == 0:
                moments = opt.state_tree(state, params)["exp_avg"]
                grads = {k: (v / 0.1).tolist() for k, v in flat_tree(
                    training._tree_map(lambda x: x.detach(),
                                       moments)).items()}
        return params, {"metrics": metrics, "grads": grads,
                        "params": {k: v.detach().tolist() for k, v in
                                   flat_tree(params).items()}}

    params, out["train"] = train(cfg, tree)
    if job.get("mqa"):
        # MQA: the one kv head is read by every rank, nothing is cut
        out["mqa_train"] = train(
            dataclasses.replace(cfg, n_kv_heads=1),
            nest_tree({k[len("mqa/"):]: v for k, v in data.items()
                       if k.startswith("mqa/")}))[1]

    # one step's products against the one-card step on this rank's rows
    rows = shard_tensor(torch.as_tensor(data["tokens"]),
                        logical_to_mesh(("batch", None)), mesh)
    f_init, f_step = training.make_sharded_train_step(loss_fn, opt, mesh,
                                                      specs)
    fp, fs = f_init(fresh())
    with _ProductFlops() as sharded:
        f_step(fp, fs, batch)
    o_init, o_step = training.make_train_step(
        lambda p, b: llama.llama_loss(p, b, cfg), opt, device="cpu")
    op, os_ = o_init(fresh())
    with _ProductFlops() as one:
        o_step(op, os_, {"tokens": rows})
    out["flops"] = [sharded.flops, one.flops]

    # bench.py's remat policy with a chunked loss: the first step again
    rcfg = dataclasses.replace(cfg, remat=True, loss_chunk=4,
                               remat_policy="save:ffn_gate+ffn_up+ffn_down")
    r_init, r_step = training.make_sharded_train_step(
        lambda p, b: llama.llama_loss(p, b, rcfg, tp=tp), opt, mesh, specs)
    rp, rs = r_init(fresh())
    m = r_step(rp, rs, batch)[2]
    out["remat_first"] = [m["loss"].item(), m["grad_norm"].item()]

    ckpt = job["out"] + "/ckpt"
    save_pytree(params, ckpt + "/params", mesh=mesh, specs=specs)
    dist.barrier()
    if job.get("restore_mesh"):
        other = create_mesh(job["restore_mesh"], device_type="cpu")
        rp = restore_pytree(specs, ckpt + "/params", mesh=other,
                            specs=specs)
        out["restored"] = {k: v.tolist() for k, v in flat_tree(rp).items()}


def _tp_lora_training(job, tree, data, cfg, out):
    """The mesh form of make_lora_train_step over {"tp": world}."""
    from ray_tpu_torch.convert import params_from_numpy
    from ray_tpu_torch.models import llama, training
    from ray_tpu_torch.models.lora import LoraConfig, make_lora_train_step
    from ray_tpu_torch.parallel import create_mesh, tp_group

    mesh = create_mesh({"tp": int(job["world"])}, device_type="cpu")
    tp = tp_group(mesh)
    lcfg = LoraConfig(**dict(job["lora_cfg"],
                             targets=tuple(job["lora_cfg"]["targets"])))
    lora = nest_tree({k[len("lora_train/"):]: torch.from_numpy(v.copy())
                      for k, v in data.items()
                      if k.startswith("lora_train/")})
    init_fn, step_fn = make_lora_train_step(
        lambda p, b: llama.llama_loss(p, b, cfg, tp=tp),
        training.adamw(job["lr"], eps=job["eps"]), mesh, cfg, lcfg,
        llama.llama_param_specs(cfg))
    base, lora, state = init_fn(
        params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32),
        lora)
    metrics = []
    for _ in range(job["steps"]):
        lora, state, m = step_fn(lora, state, base, {"tokens":
                                                     data["tokens"]})
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    out["lora_train"] = {"metrics": metrics, "lora": {
        k: v.detach().tolist() for k, v in flat_tree(lora).items()}}


def once(tmp_path_factory, subdir, name, compute):
    """``compute(path)``'s JSON result, computed by the first xdist worker
    of the session that asks (in ``subdir`` of the directory every worker
    sees) and read back by the rest. A failure is computed once too: the
    workers that ask after it raise its traceback at once."""
    import traceback

    import filelock

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    shared = root / subdir
    shared.mkdir(exist_ok=True)
    result = shared / f"{name}.json"
    failed = shared / f"{name}.failed"
    with filelock.FileLock(str(shared / f"{name}.lock")):
        if not result.exists() and not failed.exists():
            try:
                out = compute(shared / name)
            except BaseException:
                failed.write_text(traceback.format_exc()[-6000:])
                raise
            tmp = shared / f"{name}.json.tmp"
            tmp.write_text(json.dumps(out))
            tmp.rename(result)
    if failed.exists():
        raise RuntimeError(f"{name} failed in another worker:\n"
                           + failed.read_text())
    return json.loads(result.read_text())


def child_env(**extra):
    """The environment of a child interpreter: the tests and the repo on
    its path, and this process named as the parent it dies with."""
    tests = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PARENT_PID=str(os.getpid()),
                PYTHONPATH=os.pathsep.join(
                    [tests, os.path.dirname(tests),
                     os.environ.get("PYTHONPATH", "")]),
                **extra)


def die_with_parent():
    """Have the kernel kill this process when the process that started it
    exits (``PARENT_PID`` names that one), so that a test worker killed
    mid-run leaves no ranks or reference interpreters behind."""
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PDEATHSIG
    if os.getppid() != int(os.environ.get("PARENT_PID", os.getppid())):
        os._exit(1)


def tp_rank_main():
    """One rank of a tensor-parallel world a job file describes; run as
    ``python -c "import torch_port_helpers as h; h.tp_rank_main()" JOB
    RANK``. It runs every engine case of the job at tp = ``tp`` and
    (``also_tp1``) on a one-card engine, the special cases
    (`_tp_specials`), the sharded training step over ``train_mesh``
    (`_tp_training`) and, with ``lora_cfg``, the mesh LoRA step; it
    writes what it saw to ``out/rank<k>.json``."""
    import faulthandler

    import torch.distributed as dist

    die_with_parent()
    with open(sys.argv[1]) as f:
        job = json.load(f)
    faulthandler.dump_traceback_later(job["limit_s"], exit=True)
    torch.set_num_threads(1)
    rank = int(sys.argv[2])
    job["rank"] = rank

    from ray_tpu_torch.convert import params_from_numpy
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import initialize_distributed

    initialize_distributed(job["store"], job["world"], rank,
                           device_type="cpu")
    cfg = llama.LlamaConfig.nano()
    data = dict(np.load(job["inputs"]))
    tree = nest_tree({k[len("params/"):]: v for k, v in data.items()
                      if k.startswith("params/")})
    params = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    adapters = {}
    for key, v in data.items():
        if key.startswith("adapters/"):
            adapters.setdefault(key.split("/")[1], {})[key] = v
    adapters = {aid: nest_tree({k[len(f"adapters/{aid}/"):]: v
                                for k, v in flat.items()})
                for aid, flat in adapters.items()}
    tp = job["tp"]
    out = {"cases": {}}
    for case in job["cases"]:
        toks, eng = _engine_case(case, params, cfg, params, adapters, tp)
        rec = _engine_record(eng)
        rec["tokens"] = toks
        if case.get("also_tp1", True):
            rec["tokens_tp1"], one = _engine_case(case, params, cfg, params,
                                                  adapters, None)
            rec["tp1"] = _engine_record(one)
        out["cases"][case["id"]] = rec
    _tp_specials(job, params, cfg, tp, out)
    _tp_training(job, tree, data, cfg, out)
    if job.get("lora_cfg"):
        _tp_lora_training(job, tree, data, cfg, out)
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _sp_ops(job, data, sp, out):
    """Ring and Ulysses on this rank's blocks of the global inputs, and
    their gradients under the global cotangent's block."""
    from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                                  ring_attention_sharded)
    from ray_tpu_torch.ops.ulysses import ulysses_attention

    n, r = sp.size, sp.rank

    def block(x):
        s = x.shape[2] // n
        return torch.from_numpy(x[:, :, r * s:(r + 1) * s].copy())

    def run(fn, prefix):
        q, k, v, g = (block(data[f"{prefix}/{x}"]).requires_grad_(x != "g")
                      for x in "qkvg")
        o = fn(q, k, v)
        grads = torch.autograd.grad(o, (q, k, v), g)
        return {"o": o.detach().tolist(),
                "grads": [x.tolist() for x in grads]}

    out["ring"] = {}
    for case in job["ring_cases"]:
        out["ring"][case["id"]] = run(
            lambda q, k, v: ring_attention(q, k, v, sp=sp,
                                           causal=case["causal"],
                                           impl=case["impl"]),
            case["inputs"])
    q, k, v = (torch.from_numpy(data[f"ring-gqa/{x}"]) for x in "qkv")
    out["ring_sharded"] = ring_attention_sharded(
        q, k, v, sp, causal=True, impl="pallas").tolist()
    out["ulysses"] = run(
        lambda q, k, v: ulysses_attention(q, k, v, sp=sp, causal=True),
        "ulysses")
    errors = out["errors"] = {}
    try:       # kv heads that do not split over sp
        q, k, v = (block(data[f"ring-gqa/{x}"]) for x in "qkv")
        ulysses_attention(q, k[:, :1], v[:, :1], sp=sp)
    except ValueError as e:
        errors["ulysses_kv"] = str(e)
    try:       # unequal causal blocks
        qb = block(data["ring-gqa/q"])
        ring_attention(qb, qb[:, :2, :-1], qb[:, :2, :-1], sp=sp,
                       impl="pallas")
    except ValueError as e:
        errors["ring_unequal"] = str(e)


def _sp_forward(job, data, sp, out):
    """llama_forward on this rank's block of the tokens, per attn_impl."""
    from ray_tpu_torch.convert import params_from_numpy
    from ray_tpu_torch.models import llama

    tree = nest_tree({k[len("fwd_params/"):]: v for k, v in data.items()
                      if k.startswith("fwd_params/")})
    tokens = torch.from_numpy(data["fwd_tokens"])
    s = tokens.shape[1] // sp.size
    mine = tokens[:, sp.rank * s:(sp.rank + 1) * s]
    out["forward"] = {}
    for impl in ("ring", "ulysses", "reference"):
        cfg = llama.LlamaConfig.nano(**dict(job["fwd_cfg"], attn_impl=impl))
        params = params_from_numpy(tree, cfg, device="cpu",
                                   dtype=torch.float32)
        with torch.no_grad():
            out["forward"][impl] = llama.llama_forward(
                params, mine, cfg, sp=sp).tolist()


def _sp_training(job, data, out):
    """make_sharded_train_step over each of the world's sp meshes, per
    attn_impl and remat policy: the metrics of the steps, and the params
    after them in ``out/<run>-rank<k>.npz``."""
    import dataclasses

    from ray_tpu_torch.convert import params_from_numpy
    from ray_tpu_torch.models import llama, training
    from ray_tpu_torch.parallel import create_mesh, tp_group
    from ray_tpu_torch.parallel.sequence_parallel import sp_group

    rank = job["rank"]
    tokens = data["tokens"]
    out["train"], out["errors"] = {}, out.get("errors", {})
    for mname, spec in job["train_meshes"].items():
        mesh = create_mesh(spec["axes"], device_type="cpu")
        tp, sp = tp_group(mesh), sp_group(mesh)
        tree = nest_tree({k[len(f"{mname}/"):]: v for k, v in data.items()
                          if k.startswith(f"{mname}/")})
        base = llama.LlamaConfig.nano(**spec["cfg"])
        specs = llama.llama_param_specs(base)
        opt = training.adamw(job["lr"], eps=job["eps"])

        def step(cfg, batch=None):
            init_fn, step_fn = training.make_sharded_train_step(
                lambda p, b: llama.llama_loss(p, b, cfg, tp=tp, sp=sp),
                opt, mesh, specs, batch_logical=("batch", "length"))
            params, state = init_fn(params_from_numpy(
                tree, cfg, device="cpu", dtype=torch.float32))
            metrics = []
            for _ in range(job["steps"]):
                params, state, m = step_fn(
                    params, state, batch or {"tokens": tokens})
                metrics.append([m["loss"].item(), m["grad_norm"].item()])
            return params, metrics

        for impl in ("ring", "ulysses", "reference"):
            for policy, kw in job["policies"].items():
                cfg = dataclasses.replace(base, attn_impl=impl, **kw)
                run = f"{mname}-{impl}-{policy}"
                if impl == "ulysses" and spec.get("ulysses_error"):
                    try:
                        step(cfg)
                    except ValueError as e:
                        out["errors"][run] = str(e)
                    continue
                params, metrics = step(cfg)
                path = f"{job['out']}/{run}-rank{rank}.npz"
                np.savez(path, **{k: v.detach().numpy() for k, v in
                                  flat_tree(params).items()})
                out["train"][run] = {"metrics": metrics, "params": path}
        if mname != job["shift_mesh"]:
            continue
        # the tokens form against inputs/targets split by hand; the
        # params a step starts from are the numpy tree's, unchanged
        cfg = dataclasses.replace(base, attn_impl="ring")
        _, split = step(cfg, {"inputs": tokens[:, :-1],
                              "targets": tokens[:, 1:]})
        out["shift"] = {"split": split,
                        "tokens": out["train"][f"{mname}-ring-full"][
                            "metrics"]}
        init_fn, _ = training.make_sharded_train_step(
            lambda p, b: llama.llama_loss(p, b, cfg, sp=sp), opt, mesh,
            specs, batch_logical=("batch", "length"))
        start, _ = init_fn(params_from_numpy(tree, cfg, device="cpu",
                                             dtype=torch.float32))
        out["init_is_tree"] = all(
            np.array_equal(v.detach().numpy(), flat_tree(tree)[k])
            for k, v in flat_tree(start).items())
        _, bad_step = training.make_sharded_train_step(
            lambda p, b: llama.llama_loss(p, b, cfg, sp=sp), opt, mesh,
            specs, batch_logical=("batch", "length"))
        try:
            bad_step(start, opt.init(start), {"tokens": tokens[:, :-1]})
        except ValueError as e:
            out["errors"]["shift_length"] = str(e)
        try:
            llama.llama_loss(start, {"tokens": torch.from_numpy(tokens)},
                             cfg, sp=sp)
        except ValueError as e:
            out["errors"]["loss_tokens"] = str(e)
        try:
            training.make_sharded_train_step(
                lambda p, b: llama.llama_loss(p, b, cfg, sp=sp), opt,
                mesh, specs)
        except ValueError as e:
            out["errors"]["unsplit_length"] = str(e)
        # a loss_fn that hands the model no sp group: refused, not
        # trained on block-local attention
        _, blind_step = training.make_sharded_train_step(
            lambda p, b: llama.llama_loss(p, b, cfg), opt, mesh, specs,
            batch_logical=("batch", "length"))
        try:
            blind_step(start, opt.init(start), {"tokens": tokens})
        except ValueError as e:
            out["errors"]["loss_without_sp"] = str(e)


def sp_rank_main():
    """One rank of a sequence-parallel world a job file describes; run
    as ``python -c "import torch_port_helpers as h; h.sp_rank_main()"
    JOB RANK``. It runs ring and Ulysses attention over {"sp": world}
    (`_sp_ops`), `llama_forward` per attn_impl (`_sp_forward`) and the
    sharded step over the job's sp meshes (`_sp_training`), and writes
    what it saw to ``out/rank<k>.json``."""
    import faulthandler

    import torch.distributed as dist

    die_with_parent()
    with open(sys.argv[1]) as f:
        job = json.load(f)
    faulthandler.dump_traceback_later(job["limit_s"], exit=True)
    torch.set_num_threads(1)
    rank = job["rank"] = int(sys.argv[2])

    from ray_tpu_torch.parallel import create_mesh, initialize_distributed
    from ray_tpu_torch.parallel.sequence_parallel import sp_group

    initialize_distributed(job["store"], job["world"], rank,
                           device_type="cpu")
    data = dict(np.load(job["inputs"]))
    sp = sp_group(create_mesh({"sp": job["world"]}, device_type="cpu"))
    out = {"sp": [sp.rank, sp.size]}
    _sp_ops(job, data, sp, out)
    _sp_forward(job, data, sp, out)
    _sp_training(job, data, out)
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
