"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device  — the card's name and count, nvidia-smi's name and power
               limit; TF32 off for matmuls and cuDNN.
  2. build   — nvcc builds the kernels from ray_tpu_torch/csrc/ (one nvcc
               per source, all started together): the split-KV paged
               kernel, the exact-f32 flash kernels (forward, dq, dk/dv)
               and the wgmma/TMA flash kernels (bf16 forward, dq and
               dk/dv).
  3. kernel  — the paged decode-attention kernel (split pass + combine
               pass) against its plain PyTorch version at Llama-3-8B
               decode shapes (bf16, int8 and fp8 pools; 1 and 5 queries
               per row), with its split plan and grid, and times at S=1
               (the kernel's as a replayed CUDA graph, and per eager call)
               beside the memory bound and their share of it.
  4. small   — a 2-layer f32 model served by the DecodeEngine, dense
               and paged (kernel, CUDA-graph decode loop), must emit the
               greedy tokens of solo `generate` (plain attention).
  5. serve   — Llama-3-8B at its published widths (seeded random bf16
               weights) serves 8 requests (32 new tokens each, greedy)
               through four engines: dense at pipeline depths 2 (the
               JAX defaults, the main path) and 1, paged at depths 2 and
               1, each timed twice in turns and profiled once. In every
               run B2's launch count must equal n_layers x decode
               iterations, there must be one `_device_get` per decode
               dispatch, the decode loop must have been replayed from
               CUDA graphs and every block must return to the pool;
               tokens must be identical across depths 1 and 2 on each
               path, and a dense run through the plain attention must
               agree on every request's first token. Prints steady decode
               tokens/s, TTFT p50, the device-busy share and peak memory
               per engine, and one H=8 paged dispatch timed eager and as
               a replayed graph.
  6. flash   — the flash-attention kernels (forward with lse, dq, dk/dv)
               against their plain PyTorch versions at the flagship
               training shape, the Llama-3-8B shape (GQA) and ragged and
               edge cases (bf16 cases run the wgmma kernels, c_f32 the
               exact-f32 ones, c_d64 D=64); times at the first
               two beside the bound and torch's
               scaled_dot_product_attention forward and backward (timed
               here only; the port never calls it), with each kernel's
               factor over SDPA (the forward's over SDPA's forward, dq's
               and dk/dv's over SDPA's whole backward).
  7. train   — bench.py:flagship_config()'s widths at full depth (only
               remat_policy changed, to "full") train on batch 8 x 2048
               tokens with f32 master weights and adamw(3e-4,
               weight_decay=0.0): one warm-up step and 5 timed steps. The
               loss must fall, the kernels' launch counts must equal
               2 x layers x steps (forward and its recompute under remat)
               and layers x steps (dq, dk/dv), and the plain attention
               must never run. Prints tokens/s, MFU, step time and peak
               memory beside the card's name and power limit.
  8. parity  — one training step's loss, grad norm and gradients at the
               flagship widths with 2 layers, kernels against the plain
               attention, from the same weights and batch.
The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Any failure raises, exits
non-zero and prints no result line; so does a machine without CUDA.
"""

import concurrent.futures
import contextlib
import dataclasses
import json
import subprocess
import time
from unittest import mock

import numpy as np
import torch

# Decode-attention shapes of Llama-3-8B served with 8 slots, 2048-token
# rows and 32-token KV blocks.
B, H, KV, D, T, MB = 8, 32, 8, 128, 32, 64
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor rate
ATOL = RTOL = 2e-2                 # bf16 output rounding + bf16 probs
N_REQUESTS, NEW_TOKENS = 8, 32
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores

# Flash attention cases: (name, B, H, Hkv, Sq, Sk, D, dtype, causal).
# (a) the flagship training shape, (b) Llama-3-8B's (GQA 32/8), then
# ragged and edge cases: a kv prefix (q_offset > 0), Sq > Sk (fully
# masked rows), non-causal, D=64, and an f32 instance.
FLASH_CASES = [
    ("a_flagship", 8, 12, 12, 2048, 2048, 128, "bf16", True),
    ("b_llama3_8b", 2, 32, 8, 2048, 2048, 128, "bf16", True),
    ("c_prefix", 2, 8, 2, 1000, 1500, 128, "bf16", True),
    ("c_masked_rows", 1, 8, 2, 1500, 1000, 128, "bf16", True),
    ("c_noncausal", 2, 8, 8, 777, 777, 128, "bf16", False),
    ("c_d64", 2, 8, 4, 1024, 1024, 64, "bf16", True),
    ("c_f32", 1, 4, 2, 512, 512, 128, "f32", True),
]
FLASH_TIMED = ("a_flagship", "b_llama3_8b")
# bf16: outputs are bf16 and the kernel rounds p to bf16 per tile where
# the plain version rounds it once (as B2 uses); f32: exact f32 FMAs in
# both, the online softmax and the tile order change the summation order.
FLASH_TOL = {"bf16": 2e-2, "f32": 1e-4}
TRAIN_STEPS = 5
# Kernel vs plain attention over a 2-layer training step in bf16
# activations: the attention outputs differ by bf16 rounding, which
# moves the loss by ~1e-4 relative and the gradients by ~1e-3.
PARITY_LOSS_RTOL, PARITY_NORM_RTOL, PARITY_MIN_COS = 2e-3, 2e-2, 0.999


def log(msg):
    print(msg, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to check")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False,"
        " torch.backends.cudnn.allow_tf32 = False")
    return name, count, smi


def build_phase():
    from ray_tpu_torch import _build

    names = ("paged_attention", "flash_attention", "flash_attention_sm90")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    for name in names:
        _build.library(name)
    log(f"[build] {', '.join(names)} ready in "
        f"{time.perf_counter() - t0:.2f} s")


def _time_ms(fn, iters):
    """Mean ms per call over `iters` calls after warm-up (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls=20, reps=20):
    """Mean ms per call of `calls` calls captured in one CUDA graph and
    replayed `reps` times (CUDA events): the card's time for the call
    without the host's Python work per call, which at a few tens of
    microseconds of kernel time would be measured instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _kernel_inputs(S, pool, copies):
    """`copies` independent input sets at the decode shapes (timing
    rotates through them so each launch finds its pages outside the
    50 MB L2). Row 0 has no live slot; the others' frontiers are ragged
    in [1, 2047]; table entries past a row's live blocks point at the
    null block 0, which holds random (finite) garbage."""
    from ray_tpu_torch.ops import kv_quant

    rng = np.random.RandomState(S)
    base = rng.randint(1, MB * T, size=B)
    q_slots = np.full((B, S), -1, np.int32)
    bt = np.zeros((B, MB), np.int32)
    for b in range(1, B):
        q_slots[b] = min(base[b], MB * T - S) + np.arange(S)
        live = (q_slots[b].max() + T) // T
        bt[b, :live] = 1 + b * MB + np.arange(live)
    NB = 1 + B * MB
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(S)
    sets = []
    for _ in range(copies):
        q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
        kf = torch.randn(NB, T, KV, D, generator=g, device=dev)
        vf = torch.randn(NB, T, KV, D, generator=g, device=dev)
        if pool == "bf16":
            kp, vp, ks, vs = kf.bfloat16(), vf.bfloat16(), None, None
        else:
            spec = kv_quant.resolve_kv_quant(pool)
            ks = kv_quant.block_scale(kf.abs().amax(dim=(1, 3)), spec)
            vs = kv_quant.block_scale(vf.abs().amax(dim=(1, 3)), spec)
            kp = kv_quant.quantize(kf, ks[:, None, :, None], spec)
            vp = kv_quant.quantize(vf, vs[:, None, :, None], spec)
        sets.append((q, kp, vp, ks, vs))
    return (sets, torch.from_numpy(bt).to(dev),
            torch.from_numpy(q_slots).to(dev), q_slots)


def _bound_ms(q_slots, S, pool):
    """Least time for these inputs: each live K/V slot read once (per kv
    head), q and the scales and table entries of live blocks read once,
    out written once, over the memory rate; the 4*D flops per live slot
    per query head over the bf16 rate. Returns (ms, bound_by)."""
    span = MB * T
    item = 2 if pool == "bf16" else 1
    live_slots = sum(min(int(r.max()) + 1, span) for r in q_slots
                     if r.max() >= 0)
    live_blocks = sum(-(-min(int(r.max()) + 1, span) // T) for r in q_slots
                      if r.max() >= 0)
    nbytes = (2 * live_slots * KV * D * item          # K and V
              + 2 * B * S * H * D * 2                 # q in, out
              + live_blocks * 4 + B * S * 4           # table, q_slots
              + (0 if pool == "bf16" else 2 * live_blocks * KV * 4))
    flops = sum(4 * H * D * min(int(s) + 1, span)
                for r in q_slots for s in r if s >= 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def kernel_phase():
    from ray_tpu_torch.ops import paged_attention_kernel as pak
    from ray_tpu_torch.ops.attention import paged_attention

    span = MB * T
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per, splits = pak.split_plan(MB, T, B, KV, sms)
    blocks = splits * KV * B
    log(f"[kernel] split plan at B={B}, KV={KV}, MB={MB}, T={T} on {sms} "
        f"SMs: {per} pages ({per * T} slots) per split, {splits} splits, "
        f"{blocks} split blocks")
    assert blocks > sms, f"{blocks} split blocks do not fill {sms} SMs"
    results = {}
    for pool in ("bf16", "int8", "fp8_e4m3"):
        for S in (1, 5):
            sets, bt, qs, qs_np = _kernel_inputs(S, pool,
                                                 4 if S == 1 else 1)
            q, kp, vp, ks, vs = sets[0]
            kw = dict(kv_valid_len=span, k_scale=ks, v_scale=vs)
            out = paged_attention(q, kp, vp, bt, qs, impl="kernel", **kw)
            plain_pages = (kp.float(), vp.float()) if pool == "bf16" \
                else (kp, vp)
            ref = paged_attention(q.float(), *plain_pages, bt, qs,
                                  impl="reference", **kw)
            torch.cuda.synchronize()
            # The kernel writes 0 for a row with no live slot; the plain
            # version (like the JAX reference) averages v there.
            dead = torch.from_numpy((qs_np < 0).all(axis=1)).cuda()
            ref[dead] = 0.0
            out32 = out.float()
            assert torch.isfinite(out32).all(), f"{pool} S={S}: non-finite"
            assert bool((out32[dead] == 0).all()), f"{pool} S={S}: dead row"
            err = (out32 - ref).abs()
            ok = bool((err <= ATOL + RTOL * ref.abs()).all())
            smem, mma = pak.kernel_config(q.dtype, kp.dtype, (H // KV) * S,
                                          D, T)
            line = (f"[kernel] pool={pool} S={S}: max_abs_err="
                    f"{err.max().item():.3e} (atol {ATOL}, rtol {RTOL}); "
                    f"{'tensor-core' if mma else 'FMA'} split kernel, "
                    f"{smem} B dynamic shared memory per block")
            assert ok, line + " FAILED"
            res = {"max_abs_err": err.max().item()}
            if S == 1:
                i = [0]

                def run(impl):
                    q, kp, vp, ks, vs = sets[i[0] % len(sets)]
                    i[0] += 1
                    if impl == "reference" and pool == "bf16":
                        q, kp, vp = q.float(), kp.float(), vp.float()
                    paged_attention(q, kp, vp, bt, qs, kv_valid_len=span,
                                    k_scale=ks, v_scale=vs, impl=impl)

                res["ms"] = _graph_ms(lambda: run("kernel"))
                eager = _time_ms(lambda: run("kernel"), 100)
                res["plain_ms"] = _time_ms(lambda: run("reference"), 10)
                res["bound_ms"], res["bound_by"] = _bound_ms(qs_np, S, pool)
                line += (f"; kernel {res['ms']:.4f} ms on the card (CUDA "
                         f"graph), {eager:.4f} ms per eager call; plain "
                         f"{res['plain_ms']:.4f} ms (eager); bound "
                         f"{res['bound_ms']:.4f} ms ({res['bound_by']}), "
                         f"{res['bound_ms'] / res['ms']:.1%} of bound")
            log(line)
            results[(pool, S)] = res
            del sets, q, kp, vp, ks, vs, out, ref
            torch.cuda.empty_cache()
    return results


def small_phase():
    from ray_tpu_torch import DecodeEngine, LlamaConfig
    from ray_tpu_torch.models.generate import generate
    from ray_tpu_torch.models.llama import llama_init

    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_dim=512, max_seq_len=256,
                      dtype=torch.float32)
    params = llama_init(cfg, seed=1, device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in rng.randint(5, 41, size=6)]
    solo = [generate(params, torch.tensor([p], device="cuda"), cfg,
                     max_new_tokens=16)[0, len(p):].tolist()
            for p in prompts]
    for paged in (False, True):
        eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128,
                           kv_block_tokens=16, paged=paged)
        ids = [eng.submit(p, 16) for p in prompts]
        out = eng.run()
        for rid, want in zip(ids, solo):
            assert out[rid] == want, \
                f"small: request {rid} {out[rid]} != {want}"
        assert eng.stats()["decode_graph_replays"] > 0
        assert not paged or eng.kv_pool.blocks_in_use == 0
    log(f"[small] f32 2-layer engine, dense and paged (kernel, CUDA graphs)"
        f" == solo generate (plain) on {len(prompts)} requests x 16 tokens")


# The serve phase's engines: (label, paged, pipeline_depth). The first is
# the JAX engine's default construction, the main path.
SERVE_RUNS = (("dense, depth 2", False, 2), ("dense, depth 1", False, 1),
              ("paged, depth 2", True, 2), ("paged, depth 1", True, 1))


def _serve(params, cfg, prompts, *, paged, depth, profile=False):
    """One engine serves the prompts from empty: every request submitted,
    then `step()` until nothing is pending. Returns the engine, the
    tokens per request and the run's counts and times."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from ray_tpu_torch import DecodeEngine
    from ray_tpu_torch.models import engine as engine_mod
    from ray_tpu_torch.ops import paged_attention_kernel as pak

    eng = DecodeEngine(params, cfg, batch_slots=8, max_len=2048,
                       kv_block_tokens=32, greedy=True, trace=True,
                       paged=paged, pipeline_depth=depth)
    ids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    gets, done = [0], []
    real_get, real_async = engine_mod._device_get, engine_mod._host_async

    def counted_get(x):
        gets[0] += 1
        return real_get(x)

    def timed_async(x):
        # an event after each block's copy to the host: its completion
        # on the card's clock
        block = real_async(x)
        done.append(torch.cuda.Event(enable_timing=True))
        done[-1].record()
        return block

    prof = (profiler(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
    step_tokens = []
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(engine_mod, "_device_get", counted_get), \
            mock.patch.object(engine_mod, "_host_async", timed_async), prof:
        torch.cuda.synchronize()
        pak.launches = 0
        t0 = time.perf_counter()
        while eng.pending():
            ev = eng.step()
            step_tokens.append(sum(len(t) for t in ev.values()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pak.launches
    run = {"launches": launches, "gets": gets[0], "wall": wall,
           "peak": torch.cuda.max_memory_allocated(),
           # the tokens of every block after the first over the card's
           # time from the first block's completion to the last one's
           "steady": (sum(step_tokens) - step_tokens[0])
           / (done[0].elapsed_time(done[-1]) / 1e3),
           "span_rate": _decode_rate(eng)}
    if profile:
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        run["busy"] = busy_us / 1e6 / wall
    return eng, [eng.pop_result(i) for i in ids], run


def _decode_rate(eng):
    """The trace's span-sum decode rate, kept because earlier versions of
    this script reported it: tokens over the summed dispatch and
    host-drain spans of the engine trace, after the first dispatch and
    the first drain. With run-ahead dispatches it leaves out host time
    between spans and counts dispatched, not emitted, tokens."""
    spans = [e for e in eng.trace.events() if e[1] is None
             and e[0] in ("dispatch", "host_drain")]
    secs = sum(e[4] for e in spans[2:])
    tokens = sum(e[5]["rows"] * e[5]["horizon"] for e in spans[2:]
                 if e[0] == "dispatch")
    return tokens / secs if secs else 0.0


def _check_run(label, cfg, eng, toks, run, plain=False):
    assert all(len(t) == NEW_TOKENS for t in toks), [len(t) for t in toks]
    assert all(0 <= x < cfg.vocab_size for t in toks for x in t)
    assert torch.isfinite(eng._last_logits).all()
    want = 0 if plain else cfg.n_layers * eng.decode_iterations
    assert run["launches"] == want, \
        f"{label}: kernel launches {run['launches']} != {want}"
    assert run["gets"] == eng.decode_dispatches, \
        f"{label}: {run['gets']} _device_get for {eng.decode_dispatches} " \
        "dispatches"
    s = eng.stats()
    assert s["decode_graph_replays"] > 0, f"{label}: no graph replayed"
    assert not eng.paged or eng.kv_pool.blocks_in_use == 0, "blocks leaked"
    return s


def _time_dispatch(eng):
    """One H=8 decode dispatch of a served (now idle) paged engine: host
    clock to completion of its loop run eagerly and of its captured
    graph replayed (means of 5), and the card's time per replay of 5
    back to back (CUDA events). Idle rows do a live row's work."""
    graph = eng._graphs.graphs[(8, True)][0]
    out = {}
    for name, fn in (("eager", lambda: eng._decode_body(8, True)),
                     ("graph", graph.replay)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 5 * 1e3
    out["card"] = _time_ms(graph.replay, 5)
    return out


def serve_phase(smi):
    from ray_tpu_torch import LlamaConfig
    from ray_tpu_torch.models.llama import llama_init

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] Llama-3-8B ({cfg.num_params() / 1e9:.2f} B params, bf16)"
        f" initialised on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in rng.randint(64, 513, size=N_REQUESTS)]
    log(f"[serve] prompt lengths {[len(p) for p in prompts]}, "
        f"max_new_tokens {NEW_TOKENS}, 8 slots, max_len 2048, greedy")

    # Timed runs in turns (A B C D D C B A), then one profiled run each.
    tokens, runs = {}, {}
    order = list(SERVE_RUNS) + list(reversed(SERVE_RUNS))
    main_launches = None
    for i, (label, paged, depth) in enumerate(order):
        eng, toks, run = _serve(params, cfg, prompts, paged=paged,
                                depth=depth)
        s = _check_run(label, cfg, eng, toks, run)
        if i == 0:
            main_launches = run["launches"]
            log(f"[serve] main path ({label}, the JAX defaults): "
                f"{run['launches']} B2 launches = {cfg.n_layers} layers x "
                f"{eng.decode_iterations} decode iterations; "
                f"{eng.decode_dispatches} decode dispatches "
                f"({run['gets']} _device_get), "
                f"{int(s['decode_graph_replays'])} of them replayed from "
                f"{int(s['decode_graphs'])} CUDA graphs; "
                f"{eng.prefill_dispatches} prefill dispatches; pipeline "
                f"depth effective {s['pipeline_depth_effective']:.2f}, "
                f"overrun tokens {int(s['pipeline_overrun_tokens'])}")
        if label in tokens:
            assert toks == tokens[label], f"{label}: tokens changed"
        tokens[label] = toks
        runs.setdefault(label, []).append((run, s))
        if label == "paged, depth 2" and i >= len(SERVE_RUNS):
            t = _time_dispatch(eng)
            log(f"[serve] one H=8 paged decode dispatch (8 rows, 32 "
                f"layers; host clock to completion): eager {t['eager']:.2f}"
                f" ms, replayed CUDA graph {t['graph']:.2f} ms; the card's"
                f" time per replay back to back {t['card']:.2f} ms = "
                f"{t['card'] / 8:.3f} ms per decode iteration, "
                f"{64e3 / t['card']:.1f} tokens/s at 8 rows")
        del eng
        torch.cuda.empty_cache()
    for label, paged, depth in SERVE_RUNS:
        _, _, prof = _serve(params, cfg, prompts, paged=paged, depth=depth,
                            profile=True)
        torch.cuda.empty_cache()
        timed = runs[label]
        steady = [r["steady"] for r, _ in timed]
        spans = [r["span_rate"] for r, _ in timed]
        s = timed[0][1]
        log(f"[serve] {label}: steady decode "
            + " / ".join(f"{x:.1f}" for x in steady)
            + " tokens/s (blocks after the first, card clock; trace span "
            "sum: "
            + " / ".join(f"{x:.1f}" for x in spans)
            + f"), TTFT p50 {s['ttft_s_p50']:.4f} s, wall "
            + " / ".join(f"{r['wall']:.3f}" for r, _ in timed)
            + f" s, device busy {prof['busy']:.1%} of a profiled run's "
            f"wall, peak memory {timed[0][0]['peak'] / 2**30:.2f} GiB; "
            f"on {smi}")
    for path in ("dense", "paged"):
        assert tokens[f"{path}, depth 1"] == tokens[f"{path}, depth 2"], \
            f"{path}: tokens differ between pipeline depths 1 and 2"
    same = sum(a == b for a, b in zip(tokens["dense, depth 2"],
                                      tokens["paged, depth 2"]))
    log(f"[serve] tokens identical across pipeline depths 1 and 2 on both "
        f"paths; dense and paged agree on {same}/{N_REQUESTS} requests")

    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    eng_r, toks_r, run_r = _serve(params, ref_cfg, prompts, paged=False,
                                  depth=2)
    _check_run("reference", ref_cfg, eng_r, toks_r, run_r, plain=True)
    toks = tokens["dense, depth 2"]
    firsts = [a[0] == b[0] for a, b in zip(toks, toks_r)]
    assert all(firsts), f"first tokens differ: {firsts}"
    agree = sum(x == y for a, b in zip(toks, toks_r) for x, y in zip(a, b))
    log(f"[serve] reference run (dense, plain attention): steady decode "
        f"{run_r['steady']:.1f} tokens/s; first tokens equal "
        f"{sum(firsts)}/{len(firsts)}; greedy tokens agreeing "
        f"{agree}/{N_REQUESTS * NEW_TOKENS} = "
        f"{agree / (N_REQUESTS * NEW_TOKENS):.3f} (bf16 near-ties may flip "
        f"later tokens)")
    del eng_r
    torch.cuda.empty_cache()
    return main_launches


def _flash_pairs(Sq, Sk, causal):
    """Unmasked (q, k) pairs of one head: q row i sees kv columns
    <= i + Sk - Sq under the causal mask."""
    if not causal:
        return Sq * Sk
    return int(np.clip(np.arange(Sq) + Sk - Sq + 1, 0, Sk).sum())


def _flash_bound_ms(kernel, B, H, Hkv, Sq, Sk, D, causal, dtype):
    """Least time of one kernel on these inputs: each input read once and
    each output written once over the memory rate, or its products over
    the tensor rate (2 flop per multiply-add per unmasked pair and head
    dim: 2 products in the forward, s/dp/dq in dq, s/dp/dv/dk in dk/dv),
    whichever is larger. Returns (ms, bound_by)."""
    item = 2 if dtype == "bf16" else 4
    q_b, kv_b, rows = B * H * Sq * D * item, B * Hkv * Sk * D * item, \
        B * H * Sq * 4
    products, nbytes = {
        "fwd": (2, 2 * q_b + 2 * kv_b + rows),     # q, k, v -> o, lse
        "dq": (3, 3 * q_b + 2 * kv_b + 2 * rows),  # q, dO, k, v, lse,
                                                   # delta -> dq
        "dkv": (4, 2 * q_b + 4 * kv_b + 2 * rows),  # -> dk, dv
    }[kernel]
    flops = products * 2 * D * B * H * _flash_pairs(Sq, Sk, causal)
    rate = BF16_FLOPS_PER_S if dtype == "bf16" else F32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _time_flash(q, k, v, do, o, lse, scale, causal, gqa):
    """CUDA-event ms of each kernel, its plain version and torch's SDPA
    forward and backward on the same inputs."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import flash_attention_kernel as fak

    delta = fa._delta(o, do)
    t = {
        "fwd": _time_ms(lambda: fak.flash_fwd_kernel(q, k, v, scale, causal,
                                                     True), 20),
        "dq": _time_ms(lambda: fak.flash_bwd_dq_kernel(
            q, k, v, do, lse, delta, scale, causal), 20),
        "dkv": _time_ms(lambda: fak.flash_bwd_dkv_kernel(
            q, k, v, do, lse, delta, scale, causal), 20),
        "plain_fwd": _time_ms(lambda: fa._flash_fwd_reference(
            q, k, v, scale, causal), 3),
        "plain_bwd": _time_ms(lambda: fa._flash_bwd_reference(
            q, k, v, o, lse, do, scale, causal), 3),
    }
    sdpa = dict(is_causal=causal, scale=scale, enable_gqa=gqa)
    t["sdpa_fwd"] = _time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), 20)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, **sdpa)
    t["sdpa_bwd"] = _time_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 20)
    return t


def flash_phase():
    from ray_tpu_torch.ops import flash_attention as fa

    results = {}
    for name, B, H, Hkv, Sq, Sk, D, dts, causal in FLASH_CASES:
        dt = torch.bfloat16 if dts == "bf16" else torch.float32
        tol = FLASH_TOL[dts]
        g = torch.Generator(device="cuda").manual_seed(Sq + Sk + D)
        q, do = (torch.randn(B, H, Sq, D, generator=g, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, Sk, D, generator=g, device="cuda").to(dt)
                for _ in range(2))
        scale = D ** -0.5
        o, lse = fa._flash_fwd(q, k, v, scale, causal, with_lse=True)
        dq, dk, dv = fa._flash_bwd(q, k, v, o, lse, do, scale, causal)
        ro, rlse = fa._flash_fwd_reference(q, k, v, scale, causal)
        # the backward kernels and their plain version from the same o, lse
        rdq, rdk, rdv = fa._flash_bwd_reference(q, k, v, o, lse, do, scale,
                                                causal)
        torch.cuda.synchronize()
        errs = {}
        for key, got, want in (("o", o, ro), ("lse", lse, rlse),
                               ("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            got, want = got.float(), want.float()
            assert torch.isfinite(got).all(), f"[flash] {name} {key}: inf/nan"
            err = (got - want).abs()
            errs[key] = err.max().item()
            assert bool((err <= tol + tol * want.abs()).all()), \
                f"[flash] {name} {key}: max_abs_err {errs[key]:.3e} FAILED"
        dead = Sq - Sk if causal else 0
        if dead > 0:
            assert bool((o[:, :, :dead] == 0).all()), f"{name}: dead o"
            assert bool((dq[:, :, :dead] == 0).all()), f"{name}: dead dq"
        line = (f"[flash] {name}: B={B} H={H}/{Hkv} Sq={Sq} Sk={Sk} D={D} "
                f"{dts} {'causal' if causal else 'non-causal'}: max_abs_err "
                + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
                + f" (atol = rtol = {tol})"
                + (f"; {dead} fully masked rows exactly 0 in o and dq"
                   if dead > 0 else ""))
        res = {"fwd": {"max_abs_err": max(errs["o"], errs["lse"])},
               "dq": {"max_abs_err": errs["dq"]},
               "dkv": {"max_abs_err": max(errs["dk"], errs["dv"])}}
        if name in FLASH_TIMED:
            t = _time_flash(q, k, v, do, o, lse, scale, causal, H != Hkv)
            for kern, plain, lib in (("fwd", "plain_fwd", "sdpa_fwd"),
                                     ("dq", "plain_bwd", "sdpa_bwd"),
                                     ("dkv", "plain_bwd", "sdpa_bwd")):
                bound, by = _flash_bound_ms(kern, B, H, Hkv, Sq, Sk, D,
                                            causal, dts)
                res[kern].update(ms=t[kern], plain_ms=t[plain],
                                 library_ms=t[lib], bound_ms=bound,
                                 bound_by=by)
                line += (f"\n[flash]   {kern}: kernel {t[kern]:.4f} ms, "
                         f"bound {bound:.4f} ms ({by}, {bound / t[kern]:.1%}"
                         f" of bound), plain {t[plain]:.4f} ms, SDPA "
                         f"{t[lib]:.4f} ms, kernel / SDPA "
                         f"{t[kern] / t[lib]:.2f}x")
            line += ("\n[flash]   (the plain backward and SDPA's backward "
                     "each compute dq, dk and dv in one call)")
        log(line)
        results[name] = res
        del q, k, v, do, o, lse, dq, dk, dv, ro, rlse, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def _plain_attention_forbidden():
    """Every plain attention version raises while the block runs."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import flash_attention as fa

    def refuse(*args, **kwargs):
        raise AssertionError("the plain attention ran on the main path")

    with mock.patch.object(attn, "mha_reference", refuse), \
            mock.patch.object(fa, "_flash_fwd_reference", refuse), \
            mock.patch.object(fa, "_flash_bwd_reference", refuse):
        yield


def train_phase(smi):
    from ray_tpu_torch.models.llama import llama_flops_per_token
    from ray_tpu_torch.ops import flash_attention_kernel as fak
    from ray_tpu_torch.profile_train import (BATCH, BENCH_REMAT_POLICY, SEQ,
                                             build_trainer, flagship_config,
                                             train_batch)

    cfg = flagship_config()
    log(f"[train] bench.py:flagship_config() widths at full depth: vocab "
        f"{cfg.vocab_size}, dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, ffn {cfg.ffn_dim} "
        f"({cfg.num_params() / 1e6:.1f} M params); bf16 activations, f32 "
        f"master weights; batch {BATCH} x {SEQ} tokens; adamw(3e-4, "
        f"weight_decay=0.0); changed: remat_policy {BENCH_REMAT_POLICY!r} "
        f"-> 'full' (only full remat is ported, ROADMAP A11b)")
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, step_fn = build_trainer(cfg)
    batch = train_batch(cfg)
    with _plain_attention_forbidden():
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses, norms = [m["loss"].item()], [m["grad_norm"].item()]
        log(f"[train] warm-up step {time.perf_counter() - t0:.3f} s, loss "
            f"{losses[0]:.4f}, grad norm {norms[0]:.4f}")
        torch.cuda.synchronize()
        fak.fwd_launches = fak.dq_launches = fak.dkv_launches = 0
        times = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(m["loss"].item())       # waits for the step
            norms.append(m["grad_norm"].item())
            times.append(time.perf_counter() - t0)
        launches = {"fwd": fak.fwd_launches, "dq": fak.dq_launches,
                    "dkv": fak.dkv_launches}
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), \
        (losses, norms)
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    L = cfg.n_layers
    want = {"fwd": 2 * L * TRAIN_STEPS, "dq": L * TRAIN_STEPS,
            "dkv": L * TRAIN_STEPS}
    assert launches == want, f"launches {launches} != {want}"
    tok_s = BATCH * SEQ * TRAIN_STEPS / sum(times)
    mfu = tok_s * llama_flops_per_token(cfg, SEQ) / BF16_FLOPS_PER_S
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in norms]}")
    log(f"[train] kernel launches in {TRAIN_STEPS} steps: forward "
        f"{launches['fwd']} = 2 x {L} layers x {TRAIN_STEPS} (forward + "
        f"remat recompute), dq {launches['dq']}, dk/dv {launches['dkv']} "
        f"= {L} x {TRAIN_STEPS}; plain attention never ran")
    log(f"[train] step {np.mean(times) * 1e3:.1f} ms mean (min "
        f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); {tok_s:.0f}"
        f" tokens/s; MFU {mfu:.2%} of 989 TFLOP/s bf16 "
        f"({llama_flops_per_token(cfg, SEQ) / 1e9:.3f} GFLOP/token); peak "
        f"memory {peak / 2**30:.2f} GiB; on {smi}")
    del params, opt_state, step_fn
    torch.cuda.empty_cache()
    return launches


def parity_phase():
    from ray_tpu_torch import llama_loss
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.models.training import _leaves, _tree_map
    from ray_tpu_torch.profile_train import flagship_config, train_batch

    cfg = flagship_config(n_layers=2)
    params = llama_init(cfg, seed=0, device="cuda", dtype=torch.float32)
    batch = train_batch(cfg)
    got = {}
    for impl in ("kernel", "reference"):
        tree = _tree_map(lambda p: p.detach().clone().requires_grad_(),
                         params)
        leaves = _leaves(tree)
        loss = llama_loss(tree, batch, dataclasses.replace(cfg,
                                                          attn_impl=impl))
        grads = torch.autograd.grad(loss, leaves)
        norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        got[impl] = (loss.item(), norm.item(), grads)
    (lk, nk, gk), (lr, nr, gr) = got["kernel"], got["reference"]
    cos = [torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0).item()
        for a, b in zip(gk, gr)]
    line = (f"[parity] flagship widths, 2 layers, one step's loss, grad norm"
            f" and gradients: loss kernel {lk:.6f} vs plain {lr:.6f} "
            f"(rtol {PARITY_LOSS_RTOL}), grad norm {nk:.6f} vs {nr:.6f} "
            f"(rtol {PARITY_NORM_RTOL}), min cosine over {len(cos)} grad "
            f"leaves {min(cos):.6f} (>= {PARITY_MIN_COS})")
    assert abs(lk - lr) <= PARITY_LOSS_RTOL * abs(lr), line + " FAILED"
    assert abs(nk - nr) <= PARITY_NORM_RTOL * abs(nr), line + " FAILED"
    assert min(cos) >= PARITY_MIN_COS, line + " FAILED"
    log(line)


def _kernel_entry(name, source, replaces, launches, res):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms")}


def main():
    spent = {}

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[label] = time.perf_counter() - t0
        return out

    name, count, smi = phase("device", device_phase)
    phase("build", build_phase)
    kres = phase("kernel", kernel_phase)
    fres = phase("flash", flash_phase)
    phase("small", small_phase)
    launches = phase("serve", serve_phase, smi)
    tlaunches = phase("train", train_phase, smi)
    phase("parity", parity_phase)
    log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items())
        + f"; total {sum(spent.values()):.1f} s")
    # the main path is bf16: its flash kernels are the wgmma ones
    sm90_src = "ray_tpu_torch/csrc/flash_attention_sm90.cu"
    flash_py = "ray_tpu/ops/flash_attention.py"
    main_flash = fres["a_flagship"]
    log(json.dumps({"kernels": [
        _kernel_entry("paged_attention",
                      "ray_tpu_torch/csrc/paged_attention.cu",
                      "ray_tpu/ops/paged_attention_kernel.py:104",
                      launches, kres[("bf16", 1)]),
        _kernel_entry("flash_fwd", sm90_src, f"{flash_py}:130",
                      tlaunches["fwd"], main_flash["fwd"]),
        _kernel_entry("flash_bwd_dq", sm90_src, f"{flash_py}:192",
                      tlaunches["dq"], main_flash["dq"]),
        _kernel_entry("flash_bwd_dkv", sm90_src, f"{flash_py}:239",
                      tlaunches["dkv"], main_flash["dkv"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
