"""PyTorch port, tensor parallelism: the "tp" axis in the DecodeEngine,
in `make_sharded_train_step` and in the LoRA planes, against the JAX
package on the same mesh.

The port runs one process per rank. Two gloo worlds of fresh
interpreters (`torch_port_helpers.tp_rank_main`) run every case in one
launch each: a 2-rank world serving at tp = 2 and training over {"tp":
2}, and a 4-rank world serving at tp = 4 (nano's 2 kv heads then
replicate: each rank holds the one its q heads read) and training over
{"fsdp": 2, "tp": 2}; the 2-rank world also trains an MQA variant of
nano (one kv head, which every rank's q heads read, so nothing is cut
from the replicated wk/wv) over {"tp": 2}. Every rank also runs each
engine case on a one-card engine. The JAX side runs the same engines and steps on the
virtual CPU devices of `tests/conftest.py`. Both worlds and the JAX side
are computed once per test session and shared by the xdist workers
through a file lock; the parametrised tests then read the results.

Contracts and tolerances: greedy tokens equal the JAX engine's at the
same tp exactly; sampled tokens equal the port's own one-card engine
(the Gumbel hash is not threefry); every rank emits the same tokens.
The first step's loss and grad norm and every gradient leaf match JAX's
within 1e-5 relative (f32 throughout; each gradient element with an
absolute floor of 1e-5 of its leaf's largest value); the later steps'
metrics within 1e-4, as `test_torch_port_sharded.py` holds the dp and
fsdp steps, and the params after three AdamW steps (the checkpoint
restored under {"dp": 2} too) within 1e-5 relative with an absolute
floor of lr / 10 = 1e-4. AdamW's normalised step moves a parameter whose
gradient is near eps by up to lr whatever the gradient's size, and the
f32 gradients carry ~1e-7 of absolute error (the tp step's and the
one-card step's alike, against an f64 evaluation), so a few such
elements differ by ~2e-5 after three steps. The steps use eps 1e-6 on
both sides (optax's default 1e-8 lets gradients near 1e-9 do the
same). Each rank's products are 1/tp of a one-card step on its rows,
counted by a TorchDispatchMode.
"""

import faulthandler
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

from ray_tpu.models import llama as jllama
from ray_tpu.models import lora as jlora
from ray_tpu.models.engine import DecodeEngine as JaxEngine
from ray_tpu.models.prefix_cache import block_bytes
from ray_tpu.models.training import make_sharded_train_step
from ray_tpu.parallel import create_mesh
from ray_tpu.parallel.sharding import DEFAULT_RULES as JRULES
from ray_tpu.parallel.sharding import prune_rules_for_mesh as jprune
from ray_tpu_torch.models import lora as tlora
from ray_tpu_torch.models.llama import LlamaConfig as TConfig
from ray_tpu_torch.models.llama import llama_param_specs as tspecs
from ray_tpu_torch.parallel import DEFAULT_RULES, local_heads
from ray_tpu_torch.parallel.sharding import local_region, prune_rules_for_mesh
from torch_port_helpers import (child_env, die_with_parent, flat_tree,
                                numpy_params, once)

LR, EPS, STEPS = 1e-3, 1e-6, 3
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
T = 4                                # paged block tokens
LORA = {"rank": 4, "alpha": 8.0,
        "targets": ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"]}
MODES = {"greedy": {"greedy": True},
         "top_k": {"greedy": False, "temperature": 0.9, "top_k": 5}}
FEATURES = {"plain_d1": {"pipeline_depth": 1},
            "plain_d2": {"pipeline_depth": 2},
            "prefix_d1": {"prefix_cache": True, "prefix_block": 4,
                          "pipeline_depth": 1},
            "prefix_d2": {"prefix_cache": True, "prefix_block": 4,
                          "pipeline_depth": 2}}
# world -> (ranks, tp degree, training mesh, restore mesh, extras)
WORLDS = {"tp2": (2, 2, {"tp": 2}, {"dp": 2}, True),
          "tp4": (4, 4, {"fsdp": 2, "tp": 2}, None, False)}
# seconds the worlds and the JAX side may take, all of them together
# (about a minute on 8 idle CPU cores); a rank exits on its own after
# RANK_LIMIT_S
COMPUTE_S, RANK_LIMIT_S = 330, 300
# the JAX side's interpreters: (world, part); "tokens k/n" runs every
# n-th engine case from the k-th, so that no one interpreter is the long
# pole of the session's first tp test
JAX_PARTS = (("tp2", "tokens 0/3"), ("tp2", "tokens 1/3"),
             ("tp2", "tokens 2/3"), ("tp2", "steps"),
             ("tp4", "tokens 0/1"), ("tp4", "steps"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hang_guard():
    faulthandler.dump_traceback_later(240, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _prompts(n, seed=7, lo=3, hi=9):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _cases(tp):
    """The engine cases of the world of degree ``tp`` (JSON-able)."""
    base = _prompts(5)
    shared = list(range(3, 11))          # 2 full prefix blocks at T=4
    prompts = [shared + p for p in base[:2]] + base[2:]
    budgets = [7, 4, 9, 5, 6]
    seeds = [1000 + i for i in range(5)]
    cases = []

    def add(cid, kw, prompts=prompts, budgets=budgets, mode="greedy",
            **extra):
        kw = dict(kw, **MODES[mode])
        kw.setdefault("batch_slots", 2)
        kw.setdefault("max_len", 64)
        cases.append(dict(id=cid, kw=kw, prompts=prompts, budgets=budgets,
                          seeds=None if mode == "greedy" else seeds,
                          greedy=mode == "greedy", **extra))

    for mode in MODES:
        for feat, kw in FEATURES.items():
            add(f"matrix-{mode}-{feat}", kw, mode=mode)
    add("chunked", {"prefill_chunk": 3, "prefix_cache": True,
                    "prefix_block": 4},
        prompts=_prompts(4, seed=31, lo=6, hi=14), budgets=[5, 7, 4, 6])
    rng = np.random.RandomState(3)
    evict = []
    for i in range(3):
        pref = rng.randint(1, 256, size=8).tolist()
        evict += [pref + [30 + i], pref + [40 + i]]
    bb = block_bytes(2, 4, 2, 16, 4)
    add("eviction", {"prefix_cache": True, "prefix_block": 4,
                     "prefix_cache_bytes": 4 * bb, "pipeline_depth": 2},
        prompts=evict, budgets=[5] * 6)
    add("bytes", {"pipeline_depth": 2}, prompts=_prompts(4, seed=41),
        budgets=[6, 8, 5, 7])
    lprompts = [shared + [1, 2, 3, 4], shared + [5, 6, 7],
                [9, 10, 11, 12, 13], [3, 1, 4], shared + [2, 2]]
    spec_prompts = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2, 3, 4]]
    if tp == 4:
        # the kv-replicated layouts (one of nano's 2 kv heads a rank) of
        # the adapter stacks, the draft plane and a quantized pool, held
        # to the one-card engine
        add("lora-greedy", {"max_len": 40, "max_live_adapters": 2,
                            "paged": True, "kv_block_tokens": T},
            prompts=lprompts, lora=LORA,
            aids=["ad0", "ad1", None, "ad2", "ad0"], jax=False)
        add("spec", {"max_len": 32, "spec_window": 4, "paged": True,
                     "kv_block_tokens": T, "kv_quant": "fp8_e4m3"},
            prompts=spec_prompts, budgets=[10, 8, 9], draft=True,
            jax=False)
    if tp == 2:
        paged = {"paged": True, "kv_block_tokens": T,
                 "prefix_cache": True}
        for mode in MODES:
            add(f"paged-{mode}", paged, mode=mode)
        for quant in (None, "int8", "fp8_e4m3"):
            add(f"kvquant-{quant}", {"paged": True, "kv_block_tokens": T,
                                     "kv_quant": quant},
                prompts=_prompts(4), budgets=[7, 4, 6, 5])
        # 4 rows of up to 5 blocks on a 12-block pool: decode growth
        # preempts, by swap and by recompute
        for mode in ("swap", "recompute"):
            add(f"preempt-{mode}", {"paged": True, "kv_block_tokens": T,
                                    "batch_slots": 4, "preempt": mode,
                                    "kv_pool_bytes": 12 * block_bytes(
                                        2, T, 2, 16, 4)},
                prompts=_prompts(4, seed=13, lo=5, hi=9),
                budgets=[10, 10, 10, 10])
        for mode in MODES:
            add(f"lora-{mode}", {"max_len": 40, "max_live_adapters": 2},
                prompts=lprompts, mode=mode, lora=LORA,
                aids=["ad0", "ad1", None, "ad2", "ad0"])
        add("lora-paged", {"max_len": 40, "max_live_adapters": 2,
                           "paged": True, "kv_block_tokens": T,
                           "kv_quant": "int8"},
            prompts=lprompts, lora=LORA,
            aids=["ad0", "ad1", None, "ad2", "ad0"], jax=False)
        add("spec", {"max_len": 32, "spec_window": 4},
            prompts=spec_prompts, budgets=[10, 8, 9], draft=True)
        add("spec-paged-int8", {"max_len": 32, "spec_window": 4,
                                "paged": True, "kv_block_tokens": T,
                                "kv_quant": "int8"},
            prompts=spec_prompts, budgets=[10, 8, 9], draft=True,
            jax=False)
    return cases


def _inputs(cfg):
    """Seeded numpy weights, adapters and a token batch of 4 rows."""
    rng = np.random.RandomState(5)
    params = numpy_params(cfg, seed=7)
    lcfg = jlora.LoraConfig(rank=LORA["rank"], alpha=LORA["alpha"],
                            targets=tuple(LORA["targets"]))
    dims = tlora.lora_dims(TConfig.nano(), tlora.LoraConfig(
        rank=LORA["rank"], targets=tuple(LORA["targets"])))

    def adapter(scale_b):
        return {"layers": {
            name: {"a": (rng.standard_normal((cfg.n_layers, n_in,
                                              lcfg.rank))
                         * n_in ** -0.5).astype(np.float32),
                   "b": (rng.standard_normal((cfg.n_layers, lcfg.rank,
                                              n_out))
                         * scale_b).astype(np.float32)}
            for name, (n_in, n_out) in dims.items()}}

    return {"params": params,
            "mqa_params": numpy_params(jllama.LlamaConfig.nano(n_kv_heads=1),
                                       seed=11),
            "adapters": {f"ad{i}": adapter(0.05) for i in range(3)},
            "lora_train": adapter(0.01),
            "tokens": rng.randint(0, cfg.vocab_size, (4, 17)).astype(
                np.int32)}


def _wait(procs, deadline):
    """Wait for ``procs`` until ``deadline`` (time.monotonic()); their
    stderr tails. Every one of them is killed on the way out."""
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            errs.append(err.decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
    return errs


def _start_world(name, out_dir):
    """Start the world's ranks; returns them and a function that reads
    what each rank wrote."""
    ranks, tp, train_mesh, restore_mesh, extras = WORLDS[name]
    cfg = jllama.LlamaConfig.nano()
    inputs = _inputs(cfg)
    out_dir.mkdir(exist_ok=True)
    npz = out_dir / "inputs.npz"
    np.savez(npz, **{f"params/{k}": v
                     for k, v in flat_tree(inputs["params"]).items()},
             **{f"adapters/{k}": v
                for k, v in flat_tree(inputs["adapters"]).items()},
             **{f"lora_train/{k}": v
                for k, v in flat_tree(inputs["lora_train"]).items()},
             **{f"mqa/{k}": v
                for k, v in flat_tree(inputs["mqa_params"]).items()},
             tokens=inputs["tokens"])
    job = out_dir / "job.json"
    job.write_text(json.dumps({
        "world": ranks, "tp": tp, "store": f"file://{out_dir}/store",
        "inputs": str(npz), "out": str(out_dir), "lr": LR, "eps": EPS,
        "steps": STEPS, "cases": _cases(tp), "train_mesh": train_mesh,
        "restore_mesh": restore_mesh, "knobs": extras,
        "lora_cfg": LORA if extras else None,
        "mqa": extras,
        "special_prompts": _prompts(3, seed=5), "limit_s": RANK_LIMIT_S}))
    env = child_env()
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import torch_port_helpers as h; h.tp_rank_main()", str(job),
         str(r)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(ranks)]

    def read():
        return [json.loads((out_dir / f"rank{r}.json").read_text())
                for r in range(ranks)]

    return procs, read


def _jax_engine(case, params, adapters, tp):
    kw = dict(case["kw"])
    if case.get("draft"):
        kw.update(draft_params=params, draft_cfg=jllama.LlamaConfig.nano())
    if case.get("lora"):
        kw["lora"] = jlora.LoraConfig(rank=LORA["rank"],
                                      alpha=LORA["alpha"],
                                      targets=tuple(LORA["targets"]))
    eng = JaxEngine(params, jllama.LlamaConfig.nano(), tp=tp, **kw)
    if case.get("lora"):
        for aid in sorted(adapters):
            eng.register_adapter(aid, jax.tree_util.tree_map(
                jnp.asarray, adapters[aid]))
    aids = case.get("aids") or [None] * len(case["prompts"])
    ids = [eng.submit(p, n, adapter_id=a) for p, n, a in
           zip(case["prompts"], case["budgets"], aids)]
    out = eng.run()
    return [out[i] for i in ids]


def _run_jax(name, part):
    """A part of JAX's side of a world: its greedy engine tokens at the
    world's tp (``part`` "tokens k/n": every n-th case from the k-th),
    or its training step on the world's training mesh (and the first
    gradients) and the mesh LoRA step ("steps")."""
    ranks, tp, train_mesh, _, extras = WORLDS[name]
    cfg = jllama.LlamaConfig.nano()
    inputs = _inputs(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    if part.startswith("tokens"):
        k, n = map(int, part.split()[1].split("/"))
        cases = [c for c in _cases(tp) if c["greedy"] and c.get("jax", True)]
        return {"tokens": {c["id"]: _jax_engine(c, params,
                                                 inputs["adapters"], tp)
                           for c in cases[k::n]}}
    devices = jax.devices()[:ranks]
    mesh = create_mesh(train_mesh, devices)
    batch = {"tokens": jnp.asarray(inputs["tokens"])}

    def train(cfg, params):
        loss = lambda p, b: jllama.llama_loss(p, b, cfg)  # noqa: E731
        init, step = make_sharded_train_step(
            loss, optax.adamw(LR, eps=EPS), mesh,
            jllama.llama_param_specs(cfg), donate=False)
        p, s = init(params)
        metrics = []
        for _ in range(STEPS):
            p, s, m = step(p, s, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        grads = jax.grad(loss)(params, batch)
        return {"metrics": metrics,
                "grads": {k: np.asarray(v).tolist()
                          for k, v in flat_tree(grads).items()},
                "params": {k: np.asarray(v).tolist()
                           for k, v in flat_tree(p).items()}}

    out = {"train": train(cfg, params)}
    loss = lambda p, b: jllama.llama_loss(p, b, cfg)  # noqa: E731
    if extras:
        out["mqa_train"] = train(
            jllama.LlamaConfig.nano(n_kv_heads=1),
            jax.tree_util.tree_map(jnp.asarray, inputs["mqa_params"]))
        lcfg = jlora.LoraConfig(rank=LORA["rank"], alpha=LORA["alpha"],
                                targets=tuple(LORA["targets"]))
        tp_mesh = create_mesh({"tp": ranks}, devices)
        init, step = jlora.make_lora_train_step(
            loss, optax.adamw(LR, eps=EPS), tp_mesh, cfg, lcfg,
            jllama.llama_param_specs(cfg))
        base, lora, st = init(params, jax.tree_util.tree_map(
            jnp.asarray, inputs["lora_train"]))
        lm = []
        for _ in range(STEPS):
            lora, st, m = step(lora, st, base, batch)
            lm.append([float(m["loss"]), float(m["grad_norm"])])
        out["lora_train"] = {"metrics": lm, "lora": {
            k: np.asarray(v).tolist() for k, v in flat_tree(lora).items()}}
    return out


def jax_main(name, part, path):
    """A fresh interpreter's part of one world's JAX side: run as
    ``python -c "import test_torch_port_tp as t; t.jax_main(NAME, PART,
    PATH)"``."""
    die_with_parent()
    with open(path, "w") as f:
        json.dump(_run_jax(name, part), f)


def _compute(out_dir):
    """Both worlds, and the two parts of each world's JAX side in
    interpreters of their own (on 8 virtual CPU devices, as
    `tests/conftest.py` sets them up), all at once."""
    deadline = time.monotonic() + COMPUTE_S
    out_dir.mkdir(exist_ok=True)
    started = {name: _start_world(name, out_dir / name) for name in WORLDS}
    env = child_env(JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_procs = {(name, part): subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_port_tp as t; t.jax_main({name!r}, {part!r}, "
         f"{str(out_dir / f'jax-{i}.json')!r})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i, (name, part) in enumerate(JAX_PARTS)}
    procs = list(jax_procs.values()) + [
        p for ranks, _ in started.values() for p in ranks]
    errs = _wait(procs, deadline)
    failed = [e for p, e in zip(procs, errs) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    ref = {name: {"tokens": {}} for name in WORLDS}
    for i, (name, _) in enumerate(jax_procs):
        got = json.loads((out_dir / f"jax-{i}.json").read_text())
        ref[name]["tokens"].update(got.pop("tokens", {}))
        ref[name].update(got)
    return {name: (read(), ref[name]) for name, (_, read) in started.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """name -> (each rank's results, JAX's results)."""
    return once(tmp_path_factory, "torch_port_tp", "tp-worlds", _compute)


def _case(ranks, cid):
    """The case's record, after checking every rank emitted the same."""
    recs = [r["cases"][cid] for r in ranks]
    for rec in recs[1:]:
        assert rec["tokens"] == recs[0]["tokens"], cid
    return recs


# ---------------------------------------------------------------------------
# Serving: token identity, tp x sampling x prefix cache x pipeline depth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ["tp2", "tp4"])
@pytest.mark.parametrize("mode", ["greedy", "top_k"])
@pytest.mark.parametrize("feature", ["plain_d1", "plain_d2", "prefix_d1",
                                     "prefix_d2"])
def test_tp_token_identity_matrix(worlds, world, mode, feature):
    """Every rank of the tp engine emits the one-card engine's tokens
    (and, greedy, JAX's tp engine's); the single [H, B] transfer per
    drained block survives and the ring ends empty."""
    ranks, ref = worlds[world]
    cid = f"matrix-{mode}-{feature}"
    for rec in _case(ranks, cid):
        assert rec["tokens"] == rec["tokens_tp1"], cid
        if mode == "greedy":
            assert rec["tokens"] == ref["tokens"][cid], cid
        s = rec["stats"]
        assert s["tp_degree"] == WORLDS[world][1]
        assert rec["tp1"]["stats"]["tp_degree"] == 1.0
        assert s["decode_dispatches"] == s["host_syncs"]
        assert s["host_lag_steps"] == 0.0
        # a gloo group's collectives cannot be captured: eager loop
        assert s["decode_graphs"] == 0.0


@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_chunked_prefill_identity(worlds, world):
    ranks, ref = worlds[world]
    for rec in _case(ranks, "chunked"):
        assert rec["tokens"] == rec["tokens_tp1"] == ref["tokens"]["chunked"]


@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_identity_under_eviction_pressure(worlds, world):
    """A prefix pool too small for the working set evicts exactly as on
    one card (the host trie never sees the mesh): same tokens, same
    evictions."""
    ranks, ref = worlds[world]
    for rec in _case(ranks, "eviction"):
        assert rec["tokens"] == rec["tokens_tp1"] == ref["tokens"][
            "eviction"]
        assert rec["stats"]["prefix_evictions"] > 0
        assert rec["stats"]["prefix_evictions"] == \
            rec["tp1"]["stats"]["prefix_evictions"]


@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_mid_flight_drain(worlds, world):
    """begin_drain with run-ahead blocks in flight: in-flight requests
    finish with their one-card tokens, nothing new admits, the ring
    empties."""
    ranks, _ = worlds[world]
    for out in ranks:
        d = out["drain"]
        assert d["lag"] >= 1.0 and d["refused"] and not d["pending"]
        assert d["lag_after"] == 0.0
        assert d["tokens"] == ranks[0]["drain"]["tokens"]
        assert d["tokens"] == d["solo"]


def test_tp_host_transfer_bytes_flat(worlds):
    """The token block is replicated: the bytes each drain pulls are the
    same at tp = 1 and tp = 4, and so is the number of pulls."""
    ranks, _ = worlds["tp4"]
    for rec in _case(ranks, "bytes"):
        s, s1 = rec["stats"], rec["tp1"]["stats"]
        assert s["host_transfer_bytes"] > 0
        assert s["host_transfer_bytes"] == s1["host_transfer_bytes"]
        assert s["host_syncs"] == s1["host_syncs"]


def test_tp_mesh_knob_and_validation(worlds):
    """mesh= takes a prebuilt {"tp": 2} mesh; bad combinations fail at
    construction with JAX's messages."""
    ranks, _ = worlds["tp2"]
    for out in ranks:
        k = out["knobs"]
        assert k["mesh_tp_degree"] == 2
        assert k["mesh_tokens"] == k["solo_tokens"]
        assert "not both" in k["both"]
        assert "tp must be >= 1" in k["zero"]
        assert "exceeds" in k["exceeds"]
        assert "'tp' axis" in k["axis"]


@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_kv_rule_degrades_by_divisibility(worlds, world):
    """nano has 2 kv heads: tp = 2 splits the KV axis, tp = 4 cannot, so
    the rule replicates while heads and vocab still split; the rank's
    cache then holds the one kv head its q heads read."""
    ranks, _ = worlds[world]
    tp = WORLDS[world][1]
    for r, out in enumerate(ranks):
        rec = out["cases"]["matrix-greedy-plain_d1"]
        assert rec["rules"]["heads"] == "tp"
        assert rec["rules"]["vocab"] == "tp"
        assert rec["rules"]["kv"] == ("tp" if tp == 2 else None)
        assert rec["wq"][2] == 4 // tp
        assert rec["tok_embed"][0] == 256 // tp
        assert rec["kv_heads"] == [r * 2 // tp]
        assert rec["cache_k"][3] == 1
        assert rec["tp1"]["cache_k"][3] == 2


def test_tp_plane_reaches_stats_and_registry(worlds):
    ranks, _ = worlds["tp2"]
    for out in ranks:
        reg = out["knobs"]["registry"]
        assert reg["stats_tp"] == 2.0 and reg["gauge_tp"] == 2.0
        assert reg["stats_bytes"] > 0 and reg["stats_bytes_per_token"] > 0
        assert reg["counter_bytes"] == reg["stats_bytes"]


# ---------------------------------------------------------------------------
# The tp2 cases of the paged, kv-quant, LoRA and speculative matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["paged-greedy", "paged-top_k",
                                  "kvquant-None", "kvquant-int8",
                                  "kvquant-fp8_e4m3"])
def test_tp2_paged_and_kvquant(worlds, case):
    """The paged pool (bf16 storage here f32, int8, fp8) at tp = 2:
    JAX's greedy tokens, the one-card engine's sampled ones, and every
    retired row's blocks back in the pool."""
    ranks, ref = worlds["tp2"]
    for rec in _case(ranks, case):
        assert rec["tokens"] == rec["tokens_tp1"], case
        if case in ref["tokens"]:
            assert rec["tokens"] == ref["tokens"][case], case
        assert rec["blocks_in_use"] == rec["trie_blocks"]
        assert rec["pool_k"][3] == 1 and rec["tp1"]["pool_k"][3] == 2
        quant = case.split("-")[1] not in ("None", "greedy", "top_k")
        assert rec["stats"]["kv_quant_enabled"] == float(quant)


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_tp2_preemption(worlds, mode):
    """A pool too small for the rows' decode growth preempts at tp = 2
    exactly as on one card (host decisions; each rank swaps its own kv
    heads): JAX's tokens, and every block back."""
    ranks, ref = worlds["tp2"]
    case = f"preempt-{mode}"
    for rec in _case(ranks, case):
        assert rec["tokens"] == rec["tokens_tp1"] == ref["tokens"][case]
        assert rec["stats"]["preemptions"] >= 1
        assert rec["stats"]["preemptions"] == \
            rec["tp1"]["stats"]["preemptions"]
        assert rec["blocks_in_use"] == 0


@pytest.mark.parametrize("world,case", [("tp2", "lora-greedy"),
                                        ("tp2", "lora-top_k"),
                                        ("tp2", "lora-paged"),
                                        ("tp4", "lora-greedy")])
def test_tp_mixed_adapter_matrix(worlds, world, case):
    """Three adapters and base rows through two slots at tp = 2 (and at
    tp = 4, where each rank's wk/wv b-stacks hold the one kv head its q
    head reads): JAX's greedy tokens, the one-card engine's sampled ones,
    residency cycled, every slot reference returned."""
    ranks, ref = worlds[world]
    for rec in _case(ranks, case):
        assert rec["tokens"] == rec["tokens_tp1"], case
        if case in ref["tokens"]:
            assert rec["tokens"] == ref["tokens"][case], case
        s = rec["stats"]
        assert s["adapter_evictions"] >= 1.0
        assert s["adapter_prefetches"] >= 3.0
        assert not any(rec["refs"])


@pytest.mark.parametrize("world,case", [("tp2", "spec"),
                                        ("tp2", "spec-paged-int8"),
                                        ("tp4", "spec")])
def test_tp_speculative(worlds, world, case):
    """Both planes shard over the same tp group (the draft by its own
    pruned rules): the one-card engine's tokens, and JAX's greedy tokens
    on the f32 pool."""
    ranks, ref = worlds[world]
    for rec in _case(ranks, case):
        assert rec["tokens"] == rec["tokens_tp1"], case
        if case in ref["tokens"]:
            assert rec["tokens"] == ref["tokens"][case], case
        assert rec["stats"]["spec_dispatches"] > 0


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_lora_stack_specs_prune_parity(tp):
    """The port's lora_stack_specs equal JAX's under the serving rules
    pruned at each tp degree (wk/wv's b-stack splits at tp = 2 and
    replicates at tp = 4, with the base kv rule)."""
    jcfg = jllama.LlamaConfig.nano()
    tcfg = TConfig.nano()
    dims = {"heads": 4, "qkv": 4, "kv": 2, "mlp": 128, "vocab": 256,
            "embed": 64, "batch": 2}
    jmesh = create_mesh({"tp": tp}, jax.devices()[:tp])
    jrules = jprune(dict(JRULES, kv="tp"), jmesh, dims)
    trules = prune_rules_for_mesh(dict(DEFAULT_RULES, kv="tp"), {"tp": tp},
                                  dims)
    assert trules == jrules
    jl = jlora.LoraConfig(rank=4, targets=tuple(LORA["targets"]))
    tl = tlora.LoraConfig(rank=4, targets=tuple(LORA["targets"]))
    want = jlora.lora_stack_specs(jcfg, jl, jrules)
    got = tlora.lora_stack_specs(tcfg, tl, trules)
    for name in want:
        for k in ("a", "b"):
            assert got[name][k] == tuple(want[name][k]), (name, k)
    assert tlora.lora_param_specs(tl, trules) == {
        "layers": {n: {"a": tuple(v["a"]), "b": tuple(v["b"])}
                   for n, v in jlora.lora_param_specs(jl, jrules)[
                       "layers"].items()}}


def test_tp2_engine_stacks_match_specs(worlds):
    """The live tp = 2 engine's stacks are each rank's region under the
    engine's own pruned rules (wk's b-stack split with the kv axis)."""
    ranks, _ = worlds["tp2"]
    tcfg = TConfig.nano()
    tl = tlora.LoraConfig(rank=4, targets=tuple(LORA["targets"]))
    rec = ranks[0]["cases"]["lora-greedy"]
    specs = tlora.lora_stack_specs(tcfg, tl, rec["rules"])
    dims = tlora.lora_dims(tcfg, tl)
    for name, (a_shape, b_shape) in rec["stacks"].items():
        n_in, n_out = dims[name]
        full_a, full_b = (2, 3, n_in, 4), (2, 3, 4, n_out)
        for shape, full, spec in ((a_shape, full_a, specs[name]["a"]),
                                  (b_shape, full_b, specs[name]["b"])):
            region = local_region(full, spec, {"tp": 2}, {"tp": 0})
            assert shape == [s.stop - s.start for s in region], name
    assert rec["stacks"]["wk"][1][3] == 16        # one of 2 kv heads


# ---------------------------------------------------------------------------
# Host decisions and the handoff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_skewed_clocks_take_rank0s_decision(worlds, world):
    """Each rank's clock starts 100 s after the last's and runs at its
    own pace; deadline shedding still takes one decision on every rank
    (rank 0's reading): the first request runs, the two queued ones are
    shed once rank 0's clock passes their deadline, and no collective
    hangs."""
    ranks, _ = worlds[world]
    first = ranks[0]["clock"]
    assert first["shed"] == 2
    assert len(first["tokens"][0]) == 4 and first["tokens"][1:] == [[], []]
    for out in ranks[1:]:
        assert out["clock"] == first


@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_export_imports_on_one_card(worlds, world):
    """A request exported after its prefill at tp (int8 pages and scales
    gathered over tp) imports into a one-card engine by swap, and decodes
    the one-card engine's tokens."""
    ranks, _ = worlds[world]
    for out in ranks:
        h = out["handoff"]
        assert h["tokens"] == h["solo"]
        assert h["mode_swap"] == 1.0
        assert h["k_shape"][3] == 2 and h["pool_shape"] == [2, 2, 16]
        assert h["src_blocks"] == 0


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _close(got, want, name):
    """A gradient: 1e-5 relative, with a floor of 1e-5 of the leaf's
    largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


def _close_after_steps(got, want, name):
    """A param after AdamW steps: 1e-5 relative, with an absolute floor
    of lr / 10 (see the module docstring)."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=LR / 10, err_msg=name)


def _metrics_close(got, want):
    """The first step's loss and grad norm within 1e-5 relative; the
    later steps' within 1e-4, as `test_torch_port_sharded.py` holds them
    (each AdamW update carries the products' summation order forward)."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _region(name, full, mesh_axes, coord):
    specs = flat_tree(tspecs(TConfig.nano()))
    return np.asarray(full)[local_region(np.shape(full), specs[name],
                                         mesh_axes, coord)]


@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_train_matches_jax(worlds, world):
    """make_sharded_train_step over {"tp": 2} / {"fsdp": 2, "tp": 2}:
    loss and grad norm of three AdamW steps, every rank's gradient
    shards of the first step and its params after the steps equal JAX's
    step on the same mesh."""
    ranks, ref = worlds[world]
    names = ("dcn", "dp", "pp", "fsdp", "ep", "sp", "tp")
    sizes = {a: WORLDS[world][2].get(a, 1) for a in names}
    for r, out in enumerate(ranks):
        coord = dict(zip(names, np.unravel_index(r, list(sizes.values()))))
        _metrics_close(out["train"]["metrics"], ref["train"]["metrics"])
        for name, g in out["train"]["grads"].items():
            _close(g, _region(name, ref["train"]["grads"][name],
                              sizes, coord), name)
        for name, p in out["train"]["params"].items():
            _close_after_steps(p, _region(name, ref["train"]["params"][name],
                                          sizes, coord), name)


def test_tp_train_mqa_sums_replicated_kv_grads(worlds):
    """n_kv_heads = 1 at tp = 2: every rank's q heads read the one kv
    head, so nothing is cut from the replicated wk/wv, and their partial
    gradients must still be summed over tp. Loss, grad norm, every
    gradient shard and the params after three steps equal JAX's, and
    both ranks hold the same wk/wv."""
    ranks, ref = worlds["tp2"]
    mqa = TConfig.nano(n_kv_heads=1)
    specs = flat_tree(tspecs(mqa))
    sizes = {a: {"tp": 2}.get(a, 1)
             for a in ("dcn", "dp", "pp", "fsdp", "ep", "sp", "tp")}
    for r, out in enumerate(ranks):
        coord = {a: r if a == "tp" else 0 for a in sizes}
        got, want = out["mqa_train"], ref["mqa_train"]
        _metrics_close(got["metrics"], want["metrics"])
        for kind, close in (("grads", _close),
                            ("params", _close_after_steps)):
            for name, v in got[kind].items():
                full = np.asarray(want[kind][name])
                close(v, full[local_region(full.shape, specs[name], sizes,
                                           coord)], name)
    for name in ("layers/wk", "layers/wv"):
        np.testing.assert_array_equal(
            ranks[0]["mqa_train"]["params"][name],
            ranks[1]["mqa_train"]["params"][name], err_msg=name)


@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_remat_and_loss_chunks(worlds, world):
    """The tp step under bench.py's remat policy with a chunked loss
    (collectives rerun in each layer's recompute and each chunk's) gives
    JAX's first-step loss and grad norm."""
    ranks, ref = worlds[world]
    for out in ranks:
        np.testing.assert_allclose(out["remat_first"],
                                   ref["train"]["metrics"][0], rtol=1e-5)


def test_tp_checkpoint_restores_under_dp(worlds):
    """The tp = 2 world's checkpoint (each rank its own head, column and
    vocab blocks) restores under {"dp": 2} as whole leaves equal to
    JAX's params after the same steps."""
    ranks, ref = worlds["tp2"]
    for out in ranks:
        for name, p in out["restored"].items():
            _close_after_steps(p, ref["train"]["params"][name], name)


@pytest.mark.parametrize("world", ["tp2", "tp4"])
def test_tp_products_are_one_tpth(worlds, world):
    """Each rank's matrix products in one step are exactly 1/tp of the
    one-card step's on the same rows: no weight is all-gathered on tp."""
    ranks, _ = worlds[world]
    tp = WORLDS[world][2]["tp"]
    for out in ranks:
        sharded, one = out["flops"]
        assert sharded * tp == one, (sharded, one)


def test_tp_lora_train_matches_jax(worlds):
    """The mesh form of make_lora_train_step at tp = 2 (base split,
    adapters replicated, each rank merging its slice of a @ b): JAX's
    losses, grad norms and adapters."""
    ranks, ref = worlds["tp2"]
    for out in ranks:
        _metrics_close(out["lora_train"]["metrics"],
                       ref["lora_train"]["metrics"])
        for name, v in out["lora_train"]["lora"].items():
            _close_after_steps(v, ref["lora_train"]["lora"][name], name)


# ---------------------------------------------------------------------------
# The tp layer on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_local_regions_are_jax_shards(tp):
    """Each rank's region of every Llama leaf under the serving rules at
    tp is the block JAX's NamedSharding gives that device."""
    from jax.sharding import NamedSharding

    jcfg = jllama.LlamaConfig.nano()
    dims = {"heads": 4, "qkv": 4, "kv": 2, "mlp": 128, "vocab": 256,
            "embed": 64, "batch": 2}
    jmesh = create_mesh({"tp": tp}, jax.devices()[:tp])
    rules = jprune(dict(JRULES, kv="tp"), jmesh, dims)
    jspecs = flat_tree(jax.tree_util.tree_map(
        lambda s: s, jllama.llama_param_specs(jcfg, rules),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    params = flat_tree(numpy_params(jcfg, seed=1))
    tspec = flat_tree(tspecs(TConfig.nano(), rules))
    for name, x in params.items():
        sharding = NamedSharding(jmesh, jspecs[name])
        idx = sharding.devices_indices_map(x.shape)
        for r, dev in enumerate(jmesh.devices.reshape(-1)):
            want = [(s.start or 0, x.shape[d] if s.stop is None else s.stop)
                    for d, s in enumerate(idx[dev])]
            got = local_region(x.shape, tspec[name], {"tp": tp},
                               {"tp": r})
            assert [(s.start, s.stop) for s in got] == want, (name, r)


@pytest.mark.parametrize("tp", [2, 4])
def test_local_heads(tp):
    """The q heads a rank computes and the kv heads they read: Llama-3-8B
    widths (32/8) split kv at tp 2 and 4; nano (4/2) at tp = 4 gives each
    rank one q head and the kv head it reads."""
    big = TConfig.llama3_8b()
    for r in range(tp):
        q, kv = local_heads(big, None, r, tp)
        assert (q.start, q.stop) == (r * 32 // tp, (r + 1) * 32 // tp)
        assert kv == list(range(r * 8 // tp, (r + 1) * 8 // tp))
    nano = TConfig.nano()
    got = [local_heads(nano, None, r, tp)[1] for r in range(tp)]
    assert got == ([[0], [1]] if tp == 2 else [[0], [0], [1], [1]])
    odd = TConfig.nano(n_heads=6, n_kv_heads=3, dim=96)
    # q heads 0-2 of 6 read kv heads 0, 0, 1: one kv head per q head
    assert local_heads(odd, None, 0, 2)[1] == [0, 0, 1]
