"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device  — the card's name and count, nvidia-smi's name and power
               limit; TF32 off for matmuls and cuDNN.
  2. build   — nvcc builds the kernels from ray_tpu_torch/csrc/.
  3. kernel  — the paged decode-attention kernel against its plain
               PyTorch version at Llama-3-8B decode shapes (bf16, int8
               and fp8 pools; 1 and 5 queries per row), with times at
               S=1 beside the memory bound.
  4. small   — a 2-layer f32 model served by the paged DecodeEngine
               (kernel) must emit the greedy tokens of solo `generate`
               (plain attention).
  5. serve   — Llama-3-8B at its published widths (seeded random bf16
               weights) serves 8 requests through the paged DecodeEngine;
               the kernel's launch count must equal n_layers x decode
               iterations, every block must return to the pool, and a
               second run through the plain attention must agree on
               every request's first token.
The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Any failure raises, exits
non-zero and prints no result line; so does a machine without CUDA.
"""

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

# Decode-attention shapes of Llama-3-8B served with 8 slots, 2048-token
# rows and 32-token KV blocks.
B, H, KV, D, T, MB = 8, 32, 8, 128, 32, 64
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor rate
ATOL = RTOL = 2e-2                 # bf16 output rounding + bf16 probs
N_REQUESTS, NEW_TOKENS = 8, 32


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

    t0 = time.perf_counter()
    _build.library("paged_attention")
    log(f"[build] paged_attention ready in {time.perf_counter() - t0:.2f} s")


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
    from ray_tpu_torch.ops.attention import paged_attention
    from ray_tpu_torch.ops.paged_attention_kernel import shared_memory_bytes

    span = MB * T
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
            smem = shared_memory_bytes((H // KV) * S, D, T)
            line = (f"[kernel] pool={pool} S={S}: max_abs_err="
                    f"{err.max().item():.3e} (atol {ATOL}, rtol {RTOL}); "
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

                res["ms"] = _time_ms(lambda: run("kernel"), 100)
                res["plain_ms"] = _time_ms(lambda: run("reference"), 10)
                res["bound_ms"], res["bound_by"] = _bound_ms(qs_np, S, pool)
                line += (f"; kernel {res['ms']:.4f} ms, plain "
                         f"{res['plain_ms']:.4f} ms, bound "
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
    eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128,
                       kv_block_tokens=16)
    ids = [eng.submit(p, 16) for p in prompts]
    out = eng.run()
    for rid, p in zip(ids, prompts):
        solo = generate(params, torch.tensor([p], device="cuda"), cfg,
                        max_new_tokens=16)[0, len(p):].tolist()
        assert out[rid] == solo, f"small: request {rid} {out[rid]} != {solo}"
    assert eng.kv_pool.blocks_in_use == 0
    log(f"[small] f32 2-layer engine (kernel) == solo generate (plain) on "
        f"{len(prompts)} requests x 16 tokens")


def _serve(params, cfg, prompts):
    from ray_tpu_torch import DecodeEngine
    from ray_tpu_torch.ops import paged_attention_kernel as pak

    eng = DecodeEngine(params, cfg, batch_slots=8, max_len=2048,
                       kv_block_tokens=32, greedy=True, trace=True)
    ids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    pak.launches = 0
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pak.launches
    return eng, [out[i] for i in ids], launches, wall


def _decode_rate(eng):
    """Tokens per second over decode dispatches after the first (the
    first block's host drain also waits for the admission prefill):
    each dispatch's enqueue plus its host drain, from the engine trace."""
    spans = [e for e in eng.trace.events() if e[1] is None
             and e[0] in ("dispatch", "host_drain")]
    secs = sum(e[4] for e in spans[2:])
    tokens = sum(e[5]["rows"] * e[5]["horizon"] for e in spans[2:]
                 if e[0] == "dispatch")
    return tokens / secs if secs else 0.0


def serve_phase(smi):
    from ray_tpu_torch import LlamaConfig
    from ray_tpu_torch.models.llama import llama_init

    cfg = LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llama_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] Llama-3-8B ({cfg.num_params() / 1e9:.2f} B params, bf16)"
        f" initialised on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in rng.randint(64, 513, size=N_REQUESTS)]
    log(f"[serve] prompt lengths {[len(p) for p in prompts]}, "
        f"max_new_tokens {NEW_TOKENS}")

    eng, toks, launches, wall = _serve(params, cfg, prompts)
    assert all(len(t) == NEW_TOKENS for t in toks), [len(t) for t in toks]
    assert all(0 <= x < cfg.vocab_size for t in toks for x in t)
    assert torch.isfinite(eng._last_logits).all()
    want = cfg.n_layers * eng.decode_iterations
    assert launches == want, f"kernel launches {launches} != {want}"
    assert eng.kv_pool.blocks_in_use == 0, "blocks leaked"
    s = eng.stats()
    rate = _decode_rate(eng)
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] kernel run: {launches} kernel launches = {cfg.n_layers} "
        f"layers x {eng.decode_iterations} decode iterations; "
        f"{eng.decode_dispatches} decode dispatches, "
        f"{eng.prefill_dispatches} prefill dispatches; wall {wall:.3f} s")
    log(f"[serve] TTFT p50 {s['ttft_s_p50']:.4f} s, TPOT p50 "
        f"{s['tpot_s_p50']:.4f} s (mean {s['tpot_s_mean']:.4f} s; a block's"
        f" tokens land together), steady decode {rate:.1f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB on {smi}")
    del eng
    torch.cuda.empty_cache()

    ref_cfg = dataclasses.replace(cfg, attn_impl="reference")
    eng_r, toks_r, launches_r, wall_r = _serve(params, ref_cfg, prompts)
    assert launches_r == 0, "the reference run launched the kernel"
    firsts = [a[0] == b[0] for a, b in zip(toks, toks_r)]
    assert all(firsts), f"first tokens differ: {firsts}"
    agree = sum(x == y for a, b in zip(toks, toks_r) for x, y in zip(a, b))
    log(f"[serve] reference run: wall {wall_r:.3f} s, steady decode "
        f"{_decode_rate(eng_r):.1f} tokens/s; first tokens equal "
        f"{sum(firsts)}/{len(firsts)}; greedy tokens agreeing "
        f"{agree}/{N_REQUESTS * NEW_TOKENS} = "
        f"{agree / (N_REQUESTS * NEW_TOKENS):.3f} (bf16 near-ties may flip "
        f"later tokens)")
    return launches


def main():
    name, count, smi = device_phase()
    build_phase()
    kres = kernel_phase()
    small_phase()
    launches = serve_phase(smi)
    main_case = kres[("bf16", 1)]
    log(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention_kernel.py:104",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
