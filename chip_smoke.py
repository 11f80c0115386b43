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
               decode shapes (bf16, int8 and fp8 pools; 1, 2, 3 and 5
               queries per row: decode and the speculative verify pass
               at spec_window 1, 2, 4) and at the Llama-3.2-1B draft's
               (head dim 64; bf16 and int8; 1 and 2 queries), with its
               split plan and grid, and every case's time (a replayed
               CUDA graph; at S=1, D=128 also per eager call) beside the
               memory bound and their share of it.
  4. small   — a 2-layer f32 model served by the DecodeEngine, dense
               and paged (kernel, CUDA-graph decode loop), must emit the
               greedy tokens of solo `generate` (plain attention), also
               with a speculative draft (an independent 1-layer one and
               the model itself).
  5. serve   — Llama-3-8B at its published widths (seeded random bf16
               weights) serves 8 requests (32 new tokens each, greedy)
               through four engines: dense at pipeline depths 2 (the
               JAX defaults, the main path) and 1, paged at depths 2 and
               1, each timed once and profiled once. In every run B2's
               launch count must equal n_layers x decode iterations,
               there must be one `_device_get` per decode dispatch, the
               decode loop must have been replayed from CUDA graphs and
               every block must return to the pool; the profiled run
               must repeat the timed run's tokens, tokens must be
               identical across depths 1 and 2 on each path, and a dense
               run through the plain attention must agree on every
               request's first token. Prints steady decode tokens/s,
               TTFT p50, the device-busy share and peak memory per
               engine, and one H=8 paged dispatch timed eager and as a
               replayed graph.
  6. kvmem   — the paged engine's memory plane on the same model: 16
               requests in 2 groups of 8 sharing a 512-token system
               prompt (seeded 32-256-token suffixes, 32 new tokens
               each) through 8 slots with the prefix cache, the prefix
               policy, 256-token prefill chunks and swap preemption, on
               an 80-block pool that forces preemption: after a warm-up
               run on other tokens, int8, fp8 and (same block count)
               bf16 pools, int8 under recompute, int8 without the prefix
               cache, and the dense engine with the prefix cache
               (copy-in and copy-out). In every run B2 launches n_layers
               x decode iterations and the plain attention never runs;
               the first swap round trip is byte for byte (pages and
               scale rows); warm admissions share blocks in both groups
               and prefill fewer tokens than cold; every block the trie
               does not hold comes back; given the bf16 run's history,
               int8 and fp8 pick its token at >= 0.5 of positions
               (teacher-forced; the free-running agreement is printed
               beside); kv_bytes_per_token is 65,600 (int8, fp8) and
               131,072 (bf16). Prints steady decode tokens/s, the card's
               ms per decode iteration with B2's and the quantized
               writes' shares, the swap bytes and times, TTFT p50 with
               and without the prefix cache and what one pool budget
               holds in bf16 and int8.
  7. spec    — speculative decoding on the serve phase's traffic and
               Llama-3-8B (30 new tokens, spec_window 4), four engines:
               (a) paged bf16 with a Llama-3.2-1B draft at its published
               widths (random weights, so acceptance near 0), (b) paged
               bf16 drafting with the target itself (acceptance near 1),
               (c) dense (the JAX defaults) and (d) paged int8 with the
               1B draft. In each run B2's launch count must equal
               n_layers per plain decode iteration plus 32 + 16 x W per
               round of width W, every dispatch after its key's first
               must be a replayed CUDA graph, the plain attention never
               runs, every block of both planes comes back, and the
               timed run (after an untimed one) replays only graphs.
               Given the run's own tokens, the non-spec engine on the
               same pool or cache (teacher-forced at the decode step's
               width and at the verify pass's; misses printed with their
               logit gaps) must agree with them to within 0.03 of the
               two widths' own agreement, and on bf16 at >= 0.95 at the
               verify width; (b)'s acceptance must reach that of a draft
               picking the target's decode-width choices, less 0.05,
               and (a)'s stay below (b)'s. A fresh
               engine of each construction, rows live mid-serving,
               checks that a replayed round writes the eager round's
               emits and row state, and times one round on the card with
               its draft and verify parts. Prints steady decode tokens/s
               beside the serve phase's no-draft rate, TTFT p50 and the
               spec counters.
  8. lora    — multi-LoRA serving on the serve phase's model and 8
               prompts (32 new tokens, greedy, scheduler="adapter"):
               requests through three random LoraConfig() adapters
               (rank 8, wq/wk/wv/wo, each delta ~10% of its projection)
               or the base model, [ad0, ad1, -, ad2, ad0, ad1, -, ad2].
               Engines (a) dense depth 2, (b) paged bf16, (c) paged int8,
               4 adapter slots, each beside a plain engine of the same
               construction; each serves once untimed, then timed. In
               every timed run B2 launches n_layers x decode iterations,
               every dispatch is a replayed graph and every slot
               reference and block comes back. Gates: base rows of (a)
               and (b) equal the plain engine's; b = 0 adapters give the
               base tokens; adapter rows differ from the base at > 0.5 of
               positions; layer 0's delta on the card against f64 (2e-2
               of its max); adapter rows' teacher-forced picks of a plain
               engine on lora_merge'd weights within 0.03 of the plain
               engine's agreement with itself on weights rounded through
               a merge and unmerge, every miss a near tie (logit gap
               <= 0.2; the widths-1-and-5 floor printed beside), and the
               same gate failing each fault planted in (a)'s stacks (wo
               delta dropped, scale applied twice, the wrong slot); (c)
               given (b)'s history at >= 0.5; a residency run with 2 slots evicts, prefetches
               and hits, and a graph captured before an eviction and
               re-commit replays the eager dispatch; rank 16 on all
               seven targets; a 2-layer f32 model at 8B widths against
               each adapter's solo run on merged weights (differing picks
               within a 1e-3 logit gap). Prints tokens/s beside plain, ms
               and kernels per iteration, the adapter ops' ms, TTFT p50
               and the host-to-commit time of one adapter.
  9. fleet   — the serving fleet on the serve phase's model and traffic,
               every replica a paged bf16 engine of the serve phase's
               construction, all on one copy of the weights: (a) a
               2-replica LLMFleet (router pow2_affinity); (b) the same
               with FaultInjector killing replica r0 after its second
               step; (c) disaggregated, 1 prefill-class + 1 decode-class
               replica, on bf16 and int8 pools; (d) on the small phase's
               f32 model, colocated, failover and disaggregated fleets.
               Gates: every request gets its 32 tokens, B2 launches
               n_layers x the decode iterations of every engine built,
               every replica's blocks come back, the plain attention
               never runs; (b) no token lost, >= 1 request recovered,
               the tokens streamed before the kill kept verbatim; (c)
               every handoff by swap (bytes in == bytes out > 0), the
               decode replica prefills no prompt token, the first
               handoff's pages, scale rows and logits byte for byte at
               export and after the swap-in, each request's first token
               the argmax of its carried logits; (d) each fleet's tokens
               == solo generate. Prints tokens/s, TTFT p50 and TPOT mean
               beside the serve phase's paged engine, (b)'s agreement
               with (a) and the time from the kill to the last recovered
               request's first new token, (c)'s bytes and ms per handoff.
 10. tp      — tensor parallelism. (a) A world of one NCCL rank: the
               serve phase's dense and paged depth-2 engines built with
               tp=1, and the dense one with mesh=create_mesh({"tp": 1}),
               must repeat the serve phase's tokens bit for bit, launch
               B2 n_layers x decode iterations, replay their graphs and
               report tp_degree 1; the 2-layer flagship's first step
               through make_sharded_train_step over {"dp": 1, "tp": 1}
               with the tp loss must give make_train_step's loss bit for
               bit. (b) Two rank processes (this script with --tp-rank)
               share the card in a gloo world over CUDA tensors (NCCL
               refuses two ranks on one device), each holding half the
               weights and its own pool: the small phase's f32 model,
               dense and paged at tp=2, == solo generate; Llama-3-8B
               paged bf16 and int8 at tp=2 (B2 at H 16 / KV 4) on the
               serve traffic: B2 launches n_layers x decode iterations,
               every block back, teacher-forced agreement with the tp=1
               engine's history >= 0.8 (the free-running agreement
               beside), and a planted fault (TP_SERVE_FAULT) below it;
               the flagship at 2 layers (B1/B3 at H = 6): one step's
               loss and grad norm within TP_LOSS_RTOL / TP_NORM_RTOL of
               the one-rank step's and rank 0's every gradient shard
               within PARITY_MIN_COS cosine of its region of the
               one-rank gradients, while each planted fault of
               TP_TRAIN_FAULTS fails one of these. Prints per-rank
               peak memory and times, which say nothing of tp's speed on
               several cards (two processes share one card; gloo stages
               through the host). (c) B2 at H 16 / KV 4 and H 8 / KV 2
               (bf16, int8, S=1) and the flash kernels at the flagship's
               H = 6 against their plain versions, timed beside their
               bounds.
 11. flash   — the flash-attention kernels (forward with lse, dq, dk/dv)
               against their plain PyTorch versions at the flagship
               training shape, the Llama-3-8B shape (GQA) and ragged and
               edge cases (bf16 cases run the wgmma kernels, c_f32 the
               exact-f32 ones, c_d64 D=64); times at the first
               two beside the bound and torch's
               scaled_dot_product_attention forward and backward (timed
               here only; the port never calls it), with each kernel's
               factor over SDPA (the forward's over SDPA's forward, dq's
               and dk/dv's over SDPA's whole backward).
 12. train   — bench.py:flagship_config() at full depth, its remat
               policy "save:ffn_gate+ffn_up+ffn_down" included, trains
               on batch 8 x 2048 tokens with f32 master weights and
               adamw(3e-4, weight_decay=0.0) through the one-card
               make_train_step: one warm-up step and 5 timed steps. The
               loss must fall, the kernels' launch counts must equal
               2 x layers x steps (forward and its recompute under remat)
               and layers x steps (dq, dk/dv), and the plain attention
               must never run. Prints tokens/s, MFU, step time and peak
               memory beside the card's name and power limit.
 13. sharded-train — the same model, batch and optimizer the way
               bench.py builds its step: a world of one NCCL rank (TCP
               store on 127.0.0.1), create_mesh({"dp": 1}),
               llama_param_specs and make_sharded_train_step; one warm-up
               and 5 timed steps under bench.py's policy, then one
               warm-up and 3 timed steps each under "save_dots" and
               "full". Each run's first loss must be bit-equal to the
               train phase's and its grad norm within 1e-6 relative, the
               loss must fall, the kernels launch as in the train phase
               and the plain attention never runs. Prints step ms,
               tokens/s, MFU and peak memory per policy. Then, at 2
               layers: two steps, save_pytree of params and AdamW state,
               a third step; restored into fresh tensors, the third step
               again must give a bit-equal loss and bit-equal leaves.
               Prints the bytes written and the save and restore times.
 14. lora-train — the train phase's config, batch and depth, adapters
               only: LoraConfig(rank=8, targets=(wq, wv, w_gate)),
               adamw(1e-2), one warm-up and 5 timed steps. The loss must
               fall, the base stay bit-unchanged, every adapter leaf move
               and the kernels launch as in the full step. Prints step
               ms, tokens/s and peak memory beside the full step's.
 15. parity  — one training step's loss, grad norm and gradients at the
               flagship widths with 2 layers, kernels against the plain
               attention, from the same weights and batch.
The line before the last is a JSON object {"kernels": [...]} (a kernel
that more than one path runs at its timed shape also gives each path's
launches, "launches_by_path"); the last line is {"ok": true, "device":
{...}}. Any failure raises, exits non-zero and prints no result line;
so does a machine without CUDA.
"""

import concurrent.futures
import contextlib
import dataclasses
import gc
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


def _kernel_inputs(S, pool, copies, D=D, H=H, KV=KV):
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


def _bound_ms(q_slots, S, pool, D=D, H=H, KV=KV):
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


# B2's kernel-phase cases (pool, S, D): the decode step (S=1), the
# speculative verify pass at spec_window 1, 2 and 4 (S = W+1 = 2, 3, 5;
# Llama-3-8B's head dim 128) and the Llama-3.2-1B draft's steps (S = 1
# and its 2-wide catch-up chunk, head dim 64).
KERNEL_CASES = tuple((pool, S, 128) for pool in ("bf16", "int8", "fp8_e4m3")
                     for S in (1, 2, 3, 5)) + tuple(
    (pool, S, 64) for pool in ("bf16", "int8") for S in (1, 2))


def kernel_phase(cases=KERNEL_CASES, H=H, KV=KV, phase="kernel"):
    """B2 against its plain version at each case (pool, S, D) with H
    query and KV kv heads (Llama-3-8B's by default; a tp rank's in the
    tp phase)."""
    from ray_tpu_torch.ops import paged_attention_kernel as pak
    from ray_tpu_torch.ops.attention import paged_attention

    span = MB * T
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per, splits = pak.split_plan(MB, T, B, KV, sms)
    blocks = splits * KV * B
    log(f"[{phase}] split plan at B={B}, H={H}, KV={KV}, MB={MB}, T={T} on "
        f"{sms} SMs: {per} pages ({per * T} slots) per split, {splits} "
        f"splits, {blocks} split blocks")
    assert blocks > sms, f"{blocks} split blocks do not fill {sms} SMs"
    results = {}
    for pool, S, Dh in cases:
        sets, bt, qs, qs_np = _kernel_inputs(S, pool, 4, Dh, H, KV)
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
        tag = f"{pool} S={S} D={Dh}"
        assert torch.isfinite(out32).all(), f"{tag}: non-finite"
        assert bool((out32[dead] == 0).all()), f"{tag}: dead row"
        err = (out32 - ref).abs()
        ok = bool((err <= ATOL + RTOL * ref.abs()).all())
        smem, mma = pak.kernel_config(q.dtype, kp.dtype, (H // KV) * S,
                                      Dh, T)
        line = (f"[{phase}] pool={pool} S={S} D={Dh} H={H}/{KV}: max_abs_err="
                f"{err.max().item():.3e} (atol {ATOL}, rtol {RTOL}); "
                f"{'tensor-core' if mma else 'FMA'} split kernel, "
                f"{smem} B dynamic shared memory per block")
        assert ok, line + " FAILED"
        res = {"max_abs_err": err.max().item()}
        i = [0]

        def run(impl):
            q, kp, vp, ks, vs = sets[i[0] % len(sets)]
            i[0] += 1
            if impl == "reference" and pool == "bf16":
                q, kp, vp = q.float(), kp.float(), vp.float()
            paged_attention(q, kp, vp, bt, qs, kv_valid_len=span,
                            k_scale=ks, v_scale=vs, impl=impl)

        res["ms"] = _graph_ms(lambda: run("kernel"))
        res["plain_ms"] = _time_ms(lambda: run("reference"), 5)
        res["bound_ms"], res["bound_by"] = _bound_ms(qs_np, S, pool, Dh, H,
                                                     KV)
        line += f"; kernel {res['ms']:.4f} ms on the card (CUDA graph)"
        if S == 1 and Dh == D:
            line += (f", {_time_ms(lambda: run('kernel'), 100):.4f} ms per"
                     " eager call")
        line += (f"; plain {res['plain_ms']:.4f} ms (eager); bound "
                 f"{res['bound_ms']:.4f} ms ({res['bound_by']}), "
                 f"{res['bound_ms'] / res['ms']:.1%} of bound")
        log(line)
        results[(pool, S, Dh)] = res
        del sets, q, kp, vp, ks, vs, out, ref
        torch.cuda.empty_cache()
    return results


def small_model():
    """The small phase's 2-layer f32 model on the card, its 6 seeded
    prompts and their 15 greedy tokens of solo `generate` (whose
    attention is the plain `_cached_attention`): (cfg, params, prompts,
    solo)."""
    from ray_tpu_torch import LlamaConfig
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
                     max_new_tokens=15)[0, len(p):].tolist()
            for p in prompts]
    return cfg, params, prompts, solo


def small_phase():
    from ray_tpu_torch import DecodeEngine
    from ray_tpu_torch.models.llama import llama_init

    cfg, params, prompts, solo = small_model()
    dcfg = dataclasses.replace(cfg, n_layers=1)
    drafts = {"none": {}, "1-layer draft": dict(
        draft_params=llama_init(dcfg, seed=2, device="cuda"),
        draft_cfg=dcfg), "self-draft": dict(draft_params=params,
                                             draft_cfg=cfg)}
    for paged in (False, True):
        for draft, kw in drafts.items():
            eng = DecodeEngine(params, cfg, batch_slots=4, max_len=128,
                               kv_block_tokens=16, paged=paged, **kw)
            ids = [eng.submit(p, 15) for p in prompts]
            out = eng.run()
            for rid, want in zip(ids, solo):
                assert out[rid] == want, \
                    f"small ({draft}): request {rid} {out[rid]} != {want}"
            s = eng.stats()
            assert s["decode_graph_replays"] > 0
            assert not kw or s["spec_dispatches"] > 0
            assert not paged or eng.kv_pool.blocks_in_use == 0
            if draft == "self-draft":
                # 15 = 3 rounds of W+1: in f32 every proposal verifies,
                # through the full-accept draft-lag lane
                assert s["spec_acceptance_rate"] == 1.0, \
                    f"small: self-draft acceptance " \
                    f"{s['spec_acceptance_rate']}"
    log(f"[small] f32 2-layer engine, dense and paged (kernel, CUDA graphs)"
        f", plain and speculative (1-layer and self-draft, the latter at "
        f"acceptance 1.0) == solo generate (plain) on {len(prompts)} "
        f"requests x 15 tokens")


# The serve phase's engines: (label, paged, pipeline_depth). The first is
# the JAX engine's default construction, the main path.
SERVE_RUNS = (("dense, depth 2", False, 2), ("dense, depth 1", False, 1),
              ("paged, depth 2", True, 2), ("paged, depth 1", True, 1))


def _serve(params, cfg, prompts, *, paged, depth, profile=False, **kw):
    """One engine serves the prompts from empty: every request submitted,
    then `step()` until nothing is pending. Returns the engine, the
    tokens per request and the run's counts and times. ``kw``: more
    engine arguments (the tp phase's ``tp=`` / ``mesh=``)."""
    from ray_tpu_torch import DecodeEngine

    eng = DecodeEngine(params, cfg, batch_slots=8, max_len=2048,
                       kv_block_tokens=32, greedy=True, trace=True,
                       paged=paged, pipeline_depth=depth, **kw)
    return _drive(eng, prompts, NEW_TOKENS, profile=profile)


def _drive(eng, prompts, new_tokens, profile=False, aids=None):
    """Submit every prompt to `eng` (request i through adapter
    ``aids[i]``, None = the base model), then `step()` until nothing is
    pending, counting B2's launches, the engine's `_device_get` pulls
    and the most live rows, and timing each token block's arrival on the
    card's clock. Returns the engine, the tokens per request and the
    run's counts and times."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from ray_tpu_torch.models import engine as engine_mod
    from ray_tpu_torch.ops import paged_attention_kernel as pak

    aids = aids or [None] * len(prompts)
    ids = [eng.submit(p, new_tokens, adapter_id=a)
           for p, a in zip(prompts, aids)]
    gets, done = [0], []
    real_get, real_async = engine_mod._device_get, engine_mod._host_async

    def counted_get(x):
        gets[0] += 1
        return real_get(x)

    def timed_async(x):
        # an event after each token block's copy to the host (an [H, B]
        # int32 block; swap-outs copy pages, scales and logits): its
        # completion on the card's clock
        block = real_async(x)
        if x.dtype == torch.int32 and x.dim() == 2:
            done.append(torch.cuda.Event(enable_timing=True))
            done[-1].record()
        return block

    prof = (profiler(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
    step_tokens, most_live, first_token = [], 0, {}
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(engine_mod, "_device_get", counted_get), \
            mock.patch.object(engine_mod, "_host_async", timed_async), prof:
        torch.cuda.synchronize()
        pak.launches = 0
        t0 = time.perf_counter()
        while eng.pending():
            ev = eng.step()
            now = time.perf_counter()
            for rid in ev:
                first_token.setdefault(rid, now - t0)
            step_tokens.append(sum(len(t) for t in ev.values()))
            most_live = max(most_live,
                            sum(r is not None for r in eng.row_req))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pak.launches
    first = next(i for i, n in enumerate(step_tokens) if n)
    run = {"launches": launches, "gets": gets[0], "wall": wall,
           "peak": torch.cuda.max_memory_allocated(),
           "most_live": most_live,
           # host clock from submission to each request's first token
           "ttft_p50": float(np.median([first_token[i] for i in ids])),
           # the tokens of every block after the first over the card's
           # time from the first block's completion to the last one's
           "steady": (sum(step_tokens) - step_tokens[first])
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


def _b2_calls(eng):
    """B2 calls the engine's dispatches make: n_layers per plain decode
    iteration, and per speculative round of width W one per target layer
    (the verify pass) and one per draft layer per draft step (the
    catch-up chunk and W-1 scans)."""
    n = eng.cfg.n_layers * eng.decode_iterations
    if eng.spec_enabled:
        n += sum(k * (eng.cfg.n_layers + eng.draft_cfg.n_layers * w)
                 for w, k in eng.spec_dispatches_by_window.items())
    return n


def _check_run(label, cfg, eng, toks, run, plain=False,
               new_tokens=NEW_TOKENS, base=(0, 0)):
    """``base``: the engine's (B2 calls, decode dispatches) before the
    run, for an engine that served a warm-up run first."""
    assert all(len(t) == new_tokens for t in toks), [len(t) for t in toks]
    assert all(0 <= x < cfg.vocab_size for t in toks for x in t)
    assert torch.isfinite(eng._last_logits).all()
    want = 0 if plain else _b2_calls(eng) - base[0]
    assert run["launches"] == want, \
        f"{label}: kernel launches {run['launches']} != {want}"
    assert run["gets"] == eng.decode_dispatches - base[1], \
        f"{label}: {run['gets']} _device_get for " \
        f"{eng.decode_dispatches - base[1]} dispatches"
    s = eng.stats()
    assert s["decode_graph_replays"] > 0, f"{label}: no graph replayed"
    # every retired row returned its blocks: only the prefix trie holds any
    held = eng._prefix.blocks_in_use if eng._prefix is not None else 0
    assert not eng.paged or eng.kv_pool.blocks_in_use == held, \
        f"{label}: {eng.kv_pool.blocks_in_use} blocks in use, the trie " \
        f"holds {held}"
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


def llama3_8b():
    """Llama-3-8B at Meta's published widths, seeded random bf16 weights
    on the card: (cfg, params), shared by the serve and kvmem phases."""
    from ray_tpu_torch import LlamaConfig
    from ray_tpu_torch.models.llama import llama_init

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama_init(cfg, seed=0, device="cuda", dtype=cfg.dtype)
    torch.cuda.synchronize()
    log(f"[serve] Llama-3-8B ({cfg.num_params() / 1e9:.2f} B params, bf16)"
        f" initialised on the card in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def serve_prompts(vocab_size):
    """The serve phase's 8 prompts (seed 0; 111-423 tokens)."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab_size, size=n).tolist()
            for n in rng.randint(64, 513, size=N_REQUESTS)]


def serve_phase(smi, cfg, params):
    prompts = serve_prompts(cfg.vocab_size)
    log(f"[serve] prompt lengths {[len(p) for p in prompts]}, "
        f"max_new_tokens {NEW_TOKENS}, 8 slots, max_len 2048, greedy")

    # One timed run each (A B C D), then one profiled run each.
    tokens, runs, rates = {}, {}, {}
    main_launches = None
    for i, (label, paged, depth) in enumerate(SERVE_RUNS):
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
        tokens[label] = toks
        runs.setdefault(label, []).append((run, s))
        if label == "paged, depth 2":
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
        _, toks, prof = _serve(params, cfg, prompts, paged=paged,
                               depth=depth, profile=True)
        assert toks == tokens[label], f"{label}: tokens changed"
        torch.cuda.empty_cache()
        timed = runs[label]
        steady = [r["steady"] for r, _ in timed]
        spans = [r["span_rate"] for r, _ in timed]
        s = timed[0][1]
        rates[label] = steady[0]
        if label == "paged, depth 2":
            # what the fleet phase prints its replicas' numbers beside
            paged_run = {"steady": steady[0],
                         "tokens_s": N_REQUESTS * NEW_TOKENS
                         / timed[0][0]["wall"],
                         "ttft_p50": timed[0][0]["ttft_p50"],
                         "tpot_mean": s["tpot_s_mean"],
                         # what the tp phase's tp=1 engines must repeat
                         "tokens": tokens}
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
    return main_launches, rates, paged_run


# The kvmem phase: 16 requests in 2 groups of 8, each group sharing a
# 512-token system prompt (16 blocks) before a seeded 32-256-token
# suffix, 32 new tokens each, through 8 slots of 2048 tokens with
# 32-token blocks, 256-token prefill chunks and the prefix policy, on a
# pool of KVMEM_POOL_BLOCKS blocks: too few for the live rows' decode
# growth, so every paged run preempts (the schedule does not depend on
# the model: 2 preemptions with the prefix cache, 1 without).
KVMEM_GROUPS, KVMEM_PER_GROUP, KVMEM_SYSTEM = 2, 8, 512
KVMEM_SUFFIX = (32, 256)
KVMEM_CHUNK = 256
KVMEM_POOL_BLOCKS = 80
KVMEM_MIN_AGREE = 0.5          # the JAX test_quant_on_token_tolerance_gate


def kvmem_traffic(vocab_size, token_seed=8):
    """The kvmem prompts, the two groups interleaved in submission
    order, and each prompt's group. The suffix lengths come from their
    own seed, so the schedule (which depends on lengths and sharing,
    not on token values) is the same at every vocab size and token
    seed."""
    n = KVMEM_GROUPS * KVMEM_PER_GROUP
    lens = np.random.RandomState(7).randint(KVMEM_SUFFIX[0],
                                            KVMEM_SUFFIX[1] + 1, size=n)
    rng = np.random.RandomState(token_seed)
    systems = [rng.randint(0, vocab_size, size=KVMEM_SYSTEM).tolist()
               for _ in range(KVMEM_GROUPS)]
    groups = [i % KVMEM_GROUPS for i in range(n)]
    prompts = [systems[g] + rng.randint(0, vocab_size, size=k).tolist()
               for g, k in zip(groups, lens)]
    return prompts, groups


def kvmem_engine(params, cfg, *, kv_quant=None, preempt="swap",
                 paged=True, prefix_cache=True, pool_blocks=KVMEM_POOL_BLOCKS):
    """A kvmem engine: paged pools hold `pool_blocks` blocks of their own
    dtype; the dense engine keeps its cache and a default prefix pool."""
    from ray_tpu_torch import DecodeEngine
    from ray_tpu_torch.models.prefix_cache import block_bytes

    kw = dict(batch_slots=8, max_len=2048, greedy=True, trace=True,
              prefix_cache=prefix_cache, prefill_chunk=KVMEM_CHUNK,
              scheduler="prefix" if prefix_cache else "fifo")
    if paged:
        L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        bb = (block_bytes(L, 32, KV, D, 1) + 2 * L * KV * 4 if kv_quant
              else block_bytes(L, 32, KV, D, cfg.dtype.itemsize))
        kw.update(paged=True, kv_block_tokens=32, kv_quant=kv_quant,
                  preempt=preempt, kv_pool_bytes=pool_blocks * bb)
    return DecodeEngine(params, cfg, **kw)


def _watch_first_swap(eng):
    """Hold the engine's first swap preemption byte for byte: at
    swap-out its blocks (pages, and a quantized pool's scale rows) are
    read from the pool and must equal the pinned host copies; at the
    request's swap-in the blocks of its new chain must equal them again.
    Records the bytes, the blocks and the card's time of each leg."""
    from ray_tpu_torch.ops.kv_quant import raw

    rec = {}
    swap_out, swap_in = eng._preempt_row, eng._swap_in_row

    def timed(fn, *args):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end), \
            (time.perf_counter() - t0) * 1e3

    def blocks(ids):
        idx = torch.tensor(ids, dtype=torch.long, device=eng.device)
        return [raw(t).index_select(1, idx).cpu()
                for t in eng._pool_tensors()]

    def preempt(row):
        if "req" in rec or eng.preempt_mode != "swap":
            return swap_out(row)
        req, ids = eng.row_req[row], list(eng._row_blocks[row])
        _, rec["out_ms"], rec["out_host_ms"] = timed(swap_out, row)
        # nothing has written the freed blocks yet: they still hold the
        # victim's bytes
        sent = blocks(ids)
        state = eng._swapped[req.req_id]
        host = [b.data[:, :len(ids)] for b in state.host]
        assert all(torch.equal(a, h) for a, h in zip(sent, host)), \
            "swap-out: host copy differs from the pool's blocks"
        rec.update(req=req.req_id, sent=sent, bytes=state.nbytes,
                   blocks=len(ids))

    def admit(row, req, state):
        if rec.get("req") != req.req_id or "in_ms" in rec:
            return swap_in(row, req, state)
        ok, ms, host_ms = timed(swap_in, row, req, state)
        if ok:
            back = blocks(eng._row_blocks[row])
            assert all(torch.equal(a, b) for a, b in zip(rec["sent"], back)), \
                "swap-in: the new chain's bytes differ from the swap-out's"
            rec.update(in_ms=ms, in_host_ms=host_ms)
        return ok

    eng._preempt_row, eng._swap_in_row = preempt, admit
    return rec


def _iteration_profile(eng, cfg):
    """The card's ms per decode iteration of the engine's largest-horizon
    graph (replayed 3 times under torch.profiler, the idle rows doing a
    live row's work), B2's ms of it, the kernels an iteration launches,
    and, for a quantized pool, the ms
    of one iteration's quantized writes (2 x n_layers `paged_quant_write`
    of 8 rows, captured and replayed as a CUDA graph)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops.kv_quant import paged_quant_write

    H = max(k[0] for k in eng._graphs.graphs)
    graph = eng._graphs.graphs[(H, True)][0]
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 1e3 / (3 * H)
    b2 = sum(e.self_device_time_total for e in rows
             if "paged_decode" in e.key) / 1e3 / (3 * H)
    out = {"H": H, "iter_ms": total, "b2_ms": b2, "write_ms": None,
           "kernels": sum(e.count for e in rows) / (3 * H)}
    if eng.kv_quant_spec is not None:
        B, dev = eng.B, torch.device("cuda")
        bt = (torch.arange(1, B + 1, dtype=torch.int32, device=dev)[:, None]
              .expand(B, eng._mb).contiguous())
        slots = torch.full((B,), 5, dtype=torch.long, device=dev)
        g = torch.Generator(device=dev).manual_seed(0)
        vals = torch.randn(B, 1, cfg.n_kv_heads, cfg.head_dim, generator=g,
                           device=dev).to(cfg.dtype)

        def writes():
            for i in range(cfg.n_layers):
                for pages, scales in ((eng._pool_k, eng._scale_k),
                                      (eng._pool_v, eng._scale_v)):
                    paged_quant_write(pages[i], scales[i], bt, slots, vals,
                                      eng.kv_quant_spec)

        out["write_ms"] = _graph_ms(writes, calls=1, reps=10)
    return out


def _admit_all(eng, rounds=16):
    """Admit every queued request of an idle engine through its own
    admission gate (`DecodeEngine._admission_round`: a cold adapter is
    prefetched and its request deferred, then committed at the next
    round), then run every row's prefill to its end."""
    for _ in range(rounds):
        if not len(eng.scheduler):
            break
        eng._admission_round()
    assert not len(eng.scheduler), f"{len(eng.scheduler)} still queued"
    while eng._row_prefill:
        eng._advance_prefills()


def _forced_picks(params, cfg, prompts, ref, kv_quant, paged=True,
                  width=1, prefill_chunk=KVMEM_CHUNK, lora=None, **eng_kw):
    """The target's greedy choice at each position GIVEN `ref`'s own
    history, on a fresh non-spec engine's pool (``paged=False``: its
    dense cache, read through B2's block-table view): 8 rows at a time
    are prefilled (in ``prefill_chunk``-token chunks), then fed `ref`'s
    tokens
    ``width`` at a time through the engine's decode step (width 1) or
    a speculative round's verify step (width W+1: `_spec_core` /
    `_spec_core_paged`), eagerly, the pool's write and B2 included.
    Returns the picks and, per position, the logit of the pick minus
    that of `ref`'s token (0 where they agree), each [requests,
    tokens]. Unlike the elementwise agreement of two free-running
    streams, one early difference does not reroute the rest of a
    stream. ``lora`` = (LoraConfig, {adapter id: tree}, per-prompt
    adapter ids) runs a LoRA engine, every adapter resident. Rows are
    admitted through the engine's own gate (`_admit_all`). ``eng_kw``:
    more engine arguments (the tp phase's ``mesh=``: the rank's shards
    and its tp group then run the steps)."""
    from ray_tpu_torch import DecodeEngine
    from ray_tpu_torch.models import engine as engine_mod

    n_new = len(ref[0])
    picks = np.zeros((len(prompts), n_new), np.int64)
    gaps = np.zeros((len(prompts), n_new), np.float64)
    for lo in range(0, len(prompts), 8):
        idx = list(range(lo, min(lo + 8, len(prompts))))
        lkw = {}
        if lora is not None:
            lkw = dict(lora=lora[0], max_live_adapters=len(lora[1]))
        eng = DecodeEngine(params, cfg, batch_slots=8, max_len=2048,
                           paged=paged, kv_block_tokens=32,
                           kv_quant=kv_quant, prefill_chunk=prefill_chunk,
                           **lkw, **eng_kw)
        if lora is not None:
            for a, lp in lora[1].items():
                eng.register_adapter(a, lp)
                eng.adapter_pool.prefetch(a)
            eng.adapter_pool.drain_prefetches()
        ids = [eng.submit(prompts[i], n_new,
                          adapter_id=None if lora is None else lora[2][i])
               for i in idx]
        _admit_all(eng)
        rows = list(range(len(idx)))
        assert [eng.row_req[r].req_id for r in rows] == ids
        dev = eng.device
        if paged:
            assert eng._ensure_decode_blocks(rows, n_new, 0)
            bt = torch.from_numpy(eng._bt).to(dev)
        row_len = torch.from_numpy(eng.row_len.astype(np.int64)).to(dev)
        forced = torch.tensor([ref[i] for i in idx], device=dev)
        live = torch.zeros(eng.B, dtype=torch.long, device=dev)
        live[:len(idx)] = 1
        lora_kw = {}
        if lora is not None:
            lora_kw = dict(adapters=eng.adapter_pool.stacks,
                           row_slot=torch.from_numpy(eng._row_slot).to(dev))

        def record(logits, j):
            lg = logits[:len(idx)]
            pick = lg.argmax(-1)
            picks[idx, j] = pick.cpu().numpy()
            gaps[idx, j] = (lg.gather(1, pick[:, None])
                            - lg.gather(1, forced[:, j:j + 1]))[:, 0].cpu(
                                ).numpy()

        record(eng._last_logits, 0)
        for j in range(0, n_new - 1, width):
            S = min(width, n_new - 1 - j)
            toks = torch.zeros((eng.B, S), dtype=torch.long, device=dev)
            toks[:len(idx)] = forced[:, j:j + S]
            with torch.no_grad():
                if paged:
                    logits = engine_mod._spec_core_paged(
                        eng.params, toks, eng._pool_k, eng._pool_v, bt,
                        row_len, cfg, eng._scale_k, eng._scale_v,
                        eng.kv_quant_spec, tp=eng._tp, **lora_kw)
                else:
                    logits = engine_mod._spec_core(
                        eng.params, toks, eng.cache, row_len, cfg,
                        eng.max_len, eng._view_bt, tp=eng._tp, **lora_kw)
            for i in range(S):
                record(logits[:, i], j + i + 1)
            row_len = row_len + live * S
        del eng
        torch.cuda.empty_cache()
    return picks, gaps


def _teacher_forced(params, cfg, prompts, ref, kv_quant):
    """The share of positions at which the pool's greedy choice equals
    `ref`'s token given `ref`'s own history (`_forced_picks`, width
    1)."""
    picks, _ = _forced_picks(params, cfg, prompts, ref, kv_quant)
    return float((picks == np.asarray(ref)).mean())


def kvmem_phase(smi, cfg, params):
    """The paged engine's memory plane on Llama-3-8B (see the module
    docstring); returns nothing, raises on any failed check."""
    from ray_tpu_torch.models import engine as engine_mod

    prompts, groups = kvmem_traffic(cfg.vocab_size)
    cold = sum(len(p) for p in prompts)
    log(f"[kvmem] {len(prompts)} requests in {KVMEM_GROUPS} groups: "
        f"{KVMEM_SYSTEM}-token system prompt + suffixes of "
        f"{[len(p) - KVMEM_SYSTEM for p in prompts]} tokens ({cold} prompt "
        f"tokens cold), {NEW_TOKENS} new tokens each, greedy; 8 slots, "
        f"max_len 2048, 32-token blocks, prefill_chunk {KVMEM_CHUNK}, "
        f"scheduler 'prefix'; paged pools of {KVMEM_POOL_BLOCKS} blocks")
    # A process warm-up on other tokens (same schedule): the prefill
    # GEMM shapes and the quantized write's kernels are new to the
    # process here, and the first measured engine must not pay for them.
    t0 = time.perf_counter()
    with _plain_attention_forbidden():
        _drive(kvmem_engine(params, cfg, kv_quant="int8"),
               kvmem_traffic(cfg.vocab_size, token_seed=9)[0], NEW_TOKENS)
    log(f"[kvmem] warm-up run (int8 pool, other tokens) "
        f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    order = (("int8", dict(kv_quant="int8")),
             ("fp8_e4m3", dict(kv_quant="fp8_e4m3")),
             ("bf16", dict()),
             ("int8 recompute", dict(kv_quant="int8", preempt="recompute")),
             ("int8 prefix off", dict(kv_quant="int8",
                                      prefix_cache=False)),
             ("dense", dict(paged=False)))
    for label, kw in order:
        eng = kvmem_engine(params, cfg, **kw)
        swap = _watch_first_swap(eng) if eng.paged else {}
        with _plain_attention_forbidden():
            eng, toks, run = _drive(eng, prompts, NEW_TOKENS)
        s = _check_run(f"kvmem {label}", cfg, eng, toks, run)
        if eng.paged:
            assert s["preemptions"] >= 1, f"kvmem {label}: no preemption"
        if eng.preempt_mode == "swap" and eng.paged:
            assert s["swap_outs"] >= 1 and "in_ms" in swap, \
                f"kvmem {label}: no swap round trip"
        if eng._prefix is not None:
            hit = {groups[e[1]] for e in eng.trace.events()
                   if e[0] == "prefix_match" and e[5]["hit"]}
            assert hit == set(range(KVMEM_GROUPS)), \
                f"kvmem {label}: prefix hits in groups {hit}"
            assert s["prefill_real_tokens"] < cold
            shared = s["kv_blocks_shared"] if eng.paged \
                else s["prefix_copy_dispatches"]
            assert shared > 0, f"kvmem {label}: nothing shared or copied"
        prof = _iteration_profile(eng, cfg)
        runs[label] = (eng, toks, run, s, swap, prof)
        log(f"[kvmem] {label}: steady decode {run['steady']:.1f} tokens/s "
            f"(card clock), TTFT p50 {run['ttft_p50']:.4f} s, wall "
            f"{run['wall']:.3f} s; B2 launches {run['launches']} = "
            f"{cfg.n_layers} layers x {eng.decode_iterations} decode "
            f"iterations; prefill {int(s['prefill_real_tokens'])} real + "
            f"{int(s['prefill_padded_tokens'])} padded tokens in "
            f"{eng.prefill_dispatches} dispatches; prefix hits "
            f"{int(s['prefix_hits'])}/{int(s['prefix_lookups'])}, blocks "
            f"shared {int(s['kv_blocks_shared'])}, copy-on-write "
            f"{int(s['kv_block_cows'])}, copies {int(s['prefix_copy_dispatches'])}"
            f"; preemptions {int(s['preemptions'])} (swap outs "
            f"{int(s['swap_outs'])}), chunk stalls "
            f"{int(s['chunked_prefill_stalls'])}; most live rows "
            f"{run['most_live']}; kv_bytes_per_token "
            f"{s['kv_bytes_per_token']:.0f}; on {smi}")
        log(f"[kvmem] {label}: decode iteration on the card "
            f"{prof['iter_ms']:.4f} ms (H={prof['H']} graph, profiled), B2 "
            f"{prof['b2_ms']:.4f} ms ({prof['b2_ms'] / prof['iter_ms']:.1%})"
            + ("" if prof["write_ms"] is None else
               f", quantized writes {prof['write_ms']:.4f} ms "
               f"({prof['write_ms'] / prof['iter_ms']:.1%}; 2 x "
               f"{cfg.n_layers} paged_quant_write as a CUDA graph)"))
        if "in_ms" in swap:
            log(f"[kvmem] {label}: first swap, {swap['blocks']} blocks, "
                f"{swap['bytes']} bytes each way (pages"
                + (", scales" if eng.kv_quant else "")
                + f", logits): out {swap['out_ms']:.3f} ms on the card "
                f"({swap['out_host_ms']:.3f} ms host), in {swap['in_ms']:.3f}"
                f" ms ({swap['in_host_ms']:.3f} ms host); byte-exact both "
                "ways")
        torch.cuda.empty_cache()
    # K and V of every layer per token, plus a quantized block's two f32
    # scales per layer and kv head spread over its 32 tokens: 65,600 and
    # 131,072 bytes at Llama-3-8B's widths.
    per_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
    scales = 2 * cfg.n_layers * cfg.n_kv_heads * 4 / 32
    for label, want in (("int8", per_token + scales),
                        ("fp8_e4m3", per_token + scales),
                        ("bf16", per_token * cfg.dtype.itemsize)):
        got = runs[label][3]["kv_bytes_per_token"]
        assert got == want, f"kvmem {label}: {got} bytes/token != {want}"
    log(f"[kvmem] kv_bytes_per_token: int8 and fp8 "
        f"{runs['int8'][3]['kv_bytes_per_token']:.0f}, bf16 "
        f"{runs['bf16'][3]['kv_bytes_per_token']:.0f}")
    total = len(prompts) * NEW_TOKENS
    short = []
    # The free-running streams of random-weight Llama-3-8B fork at near
    # ties: two int8 runs that differ only in prefill grouping (prefix
    # cache on and off) agree on about half of the tokens. The gate is
    # therefore held per position, given the bf16 run's own history;
    # the free-running agreement is printed beside it.
    forced = {mode: _teacher_forced(params, cfg, prompts, runs["bf16"][1],
                                    mode)
              for mode in (None, "int8", "fp8_e4m3")}
    log(f"[kvmem] teacher-forced agreement with the bf16 run's tokens "
        f"(same history, decode step eager): bf16 pool "
        f"{forced[None]:.3f}, int8 {forced['int8']:.3f}, fp8 "
        f"{forced['fp8_e4m3']:.3f} (>= {KVMEM_MIN_AGREE})")
    for mode in ("int8", "fp8_e4m3"):
        if forced[mode] < KVMEM_MIN_AGREE:
            short.append(f"{mode} teacher-forced {forced[mode]:.3f}")
    for label, base in (("int8", "bf16"), ("fp8_e4m3", "bf16"),
                        ("int8 recompute", "int8"),
                        ("int8 prefix off", "int8"), ("dense", "bf16")):
        a, b = runs[label][1], runs[base][1]
        agree = sum(x == y for p, q in zip(a, b)
                    for x, y in zip(p, q)) / total
        firsts = sum(p[0] == q[0] for p, q in zip(a, b))
        common = [next((i for i, (x, y) in enumerate(zip(p, q)) if x != y),
                       len(p)) for p, q in zip(a, b)]
        log(f"[kvmem] {label} tokens agree with the {base} run's on "
            f"{agree:.3f} of {total} (free-running); first tokens "
            f"{firsts}/{len(a)}; tokens before the first difference: mean "
            f"{np.mean(common):.2f}, per request {common}")
    assert not short, f"kvmem: agreement with bf16 below " \
        f"{KVMEM_MIN_AGREE}: {short}"
    bb8 = runs["int8"][0].kv_bytes_per_block
    bb16 = runs["bf16"][0].kv_bytes_per_block
    budget = KVMEM_POOL_BLOCKS * bb8
    need = np.mean([-(-(len(p) + NEW_TOKENS) // 32) for p in prompts])
    log(f"[kvmem] one budget of {budget:.0f} bytes: bf16 "
        f"{int(budget // bb16)} blocks, int8 {int(budget // bb8)} blocks "
        f"({(budget // bb8) / (budget // bb16):.3f}x); live requests of "
        f"this traffic without sharing ({need:.2f} blocks each): bf16 "
        f"{int(budget // bb16 // need)}, int8 {int(budget // bb8 // need)};"
        f" 2048-token rows: bf16 {int(budget // bb16 // 64)}, int8 "
        f"{int(budget // bb8 // 64)}")
    log(f"[kvmem] TTFT p50 with the prefix cache "
        f"{runs['int8'][2]['ttft_p50']:.4f} s, without "
        f"{runs['int8 prefix off'][2]['ttft_p50']:.4f} s (int8 pools, "
        f"same traffic); prefill real tokens "
        f"{int(runs['int8'][3]['prefill_real_tokens'])} vs "
        f"{int(runs['int8 prefix off'][3]['prefill_real_tokens'])} (cold "
        f"{cold})")
    del runs
    torch.cuda.empty_cache()


# The spec phase: the serve phase's traffic on Llama-3-8B, speculative
# rounds of width up to SPEC_WINDOW, SPEC_NEW_TOKENS new tokens each (a
# multiple of W+1, so a fully accepting run truncates no round). Drafts:
# Llama-3.2-1B at its published widths (random weights: acceptance near
# 0, speculation's worst case) or the target itself (acceptance near 1).
SPEC_WINDOW, SPEC_NEW_TOKENS = 4, 30
SPEC_MIN_AGREE = 0.95
SPEC_FLOOR_MARGIN = 0.03     # of the two non-spec widths' agreement
SPEC_RUNS = (("a paged bf16, 1B draft", dict(paged=True), "1b"),
             ("b paged bf16, self-draft", dict(paged=True), "self"),
             ("c dense (the JAX defaults), 1B draft", dict(), "1b"),
             ("d paged int8, 1B draft", dict(paged=True, kv_quant="int8"),
              "1b"))


def llama32_1b():
    """Llama-3.2-1B's published widths (meta-llama/Llama-3.2-1B
    config.json): vocab 128256, dim 2048, 16 layers, 32/8 heads (head
    dim 64), ffn 8192, rope_theta 500000. Cut: the lm_head is untied
    (the port's LlamaConfig has no tying) and the llama3 rope scaling is
    not applied (the port has none); the weights are random."""
    from ray_tpu_torch import LlamaConfig

    return LlamaConfig(vocab_size=128256, dim=2048, n_layers=16, n_heads=32,
                       n_kv_heads=8, ffn_dim=8192, rope_theta=500000.0,
                       max_seq_len=8192)


def _live_rows(eng, prompts, new_tokens):
    """Admit (`_admit_all`) and prefill `prompts` into the (idle)
    engine's rows and stage them as a primary round's inputs: the state
    a round starts from mid-serving."""
    for p in prompts:
        eng.submit(p, new_tokens)
    _admit_all(eng)
    rows = list(range(len(prompts)))
    if eng.paged:
        assert eng._ensure_decode_blocks(rows, SPEC_WINDOW + 1, 0)
    eng._stage_inputs(False, np.full((eng.B,), SPEC_WINDOW, np.int64))


def _round_state(eng):
    """Clones of everything one round or decode dispatch writes: the
    staged inputs and row state, `_last_logits`, and the blocks the rows'
    tables reach (with the null block) of the target's and a speculative
    engine's draft plane, or the whole dense caches."""
    from ray_tpu_torch.ops.kv_quant import raw

    out = [("din", eng._din.clone()), ("logits", eng._last_logits.clone())]
    if eng.paged:
        planes = [(eng._pool_tensors(), eng._bt)]
        if eng.spec_enabled:
            planes.append(([t for t in (eng._pool_dk, eng._pool_dv,
                                        eng._scale_dk, eng._scale_dv)
                            if t is not None], eng._bt_d))
        for tensors, bt in planes:
            ids = torch.from_numpy(np.union1d(bt.reshape(-1), [0])).to(
                eng.device)
            out += [(t, ids, raw(t).index_select(1, ids)) for t in tensors]
    else:
        caches = [eng.cache] + ([eng._d_cache] if eng.spec_enabled else [])
        out += [(t, None, t.clone()) for c in caches
                for t in (c["k"], c["v"])]
    return out


def _restore(eng, state):
    from ray_tpu_torch.ops.kv_quant import raw

    eng._din.copy_(state[0][1])
    eng._last_logits.copy_(state[1][1])
    for t, ids, x in state[2:]:
        if ids is None:
            t.copy_(x)
        else:
            raw(t).index_copy_(1, ids, x)


def _replay_check(eng):
    """Given the same state (rows live mid-serving), the engine's
    captured ("spec", W, all-greedy) graph replayed writes the emit
    block, the row state and draft lanes of the round run eagerly.
    Returns the largest difference of the carried logits."""
    from ray_tpu_torch.ops import paged_attention_kernel as pak

    graph, static, _ = eng._graphs.graphs[("spec", SPEC_WINDOW, True)]
    state = _round_state(eng)
    before = pak.launches
    eager = eng._spec_body(SPEC_WINDOW, True).clone()
    pak.launches = before
    din, logits = eng._din.clone(), eng._last_logits.clone()
    _restore(eng, state)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager), "replayed round: emits differ"
    assert torch.equal(eng._din, din), "replayed round: row state differs"
    return (eng._last_logits - logits).abs().max().item()


def _round_profile(eng, params, cfg):
    """The card's ms of one W=SPEC_WINDOW round from live rows (one
    round captured as a CUDA graph and replayed), of its draft part (the
    2-wide catch-up chunk and W-1 scans) and of its verify pass alone,
    each captured and replayed the same way."""
    from ray_tpu_torch.models import engine as engine_mod

    dp, dc = eng.draft_params, eng.draft_cfg
    st = eng._d_state
    chunk = eng._last_logits.argmax(-1)[:, None].repeat(1, SPEC_WINDOW + 1)
    row_len = st[0].clone()
    if eng.paged:
        bt, bt_d = eng._d_bt.to(torch.int32), eng._d_bt_d.to(torch.int32)

        def target(t, start):
            return engine_mod._spec_core_paged(
                params, t, eng._pool_k, eng._pool_v, bt, start, cfg,
                eng._scale_k, eng._scale_v, eng.kv_quant_spec)

        def draft(t, start):
            return engine_mod._spec_core_paged(
                dp, t, eng._pool_dk, eng._pool_dv, bt_d, start, dc,
                eng._scale_dk, eng._scale_dv, eng.kv_quant_spec)
    else:
        def target(t, start):
            return engine_mod._spec_core(params, t, eng.cache, start, cfg,
                                         eng.max_len, eng._view_bt)

        def draft(t, start):
            return engine_mod._spec_core(dp, t, eng._d_cache, start, dc,
                                         eng.max_len, eng._view_bt)

    def draft_part():
        draft(chunk[:, :2], row_len)
        for j in range(SPEC_WINDOW - 1):
            draft(chunk[:, :1], row_len + 1 + j)

    with torch.no_grad():
        return {"round": _graph_ms(lambda: eng._spec_body(SPEC_WINDOW, True),
                                   calls=1, reps=10),
                "draft": _graph_ms(draft_part, calls=1, reps=10),
                "verify": _graph_ms(lambda: target(chunk, row_len), calls=1,
                                    reps=10)}


def _sim_acceptance(ref, picks, W):
    """The (proposed, accepted) draft tokens of rounds of width W over
    `ref`'s streams by a draft that proposes `picks` (its greedy choice
    at each position given `ref`'s history): a round from position p
    (its t0 = ref[p]) accepts proposals k = 1, 2, .. while picks[p + k]
    == ref[p + k], emits at most the tokens its row has left, and the
    next round starts after its last emit."""
    prop = acc = 0
    for r, q in zip(ref, picks):
        p, n = 0, len(r)
        while p < n:
            a = 0
            while a < W and p + a + 1 < n and q[p + a + 1] == r[p + a + 1]:
                a += 1
            prop += W
            acc += a
            p += a + 1
    return prop, acc


def spec_phase(smi, cfg, params, serve_rates):
    """Speculative decoding on Llama-3-8B (see the module docstring);
    returns engine (a)'s B2 launches."""
    from ray_tpu_torch import DecodeEngine
    from ray_tpu_torch.models.llama import llama_init

    prompts = serve_prompts(cfg.vocab_size)
    dcfg = llama32_1b()
    t0 = time.perf_counter()
    dparams = llama_init(dcfg, seed=1, device="cuda", dtype=dcfg.dtype)
    torch.cuda.synchronize()
    log(f"[spec] Llama-3.2-1B draft ({dcfg.num_params() / 1e9:.2f} B params"
        f" with an untied lm_head, bf16) initialised in "
        f"{time.perf_counter() - t0:.1f} s; target Llama-3-8B; the serve "
        f"phase's 8 prompts, {SPEC_NEW_TOKENS} new tokens each, 8 slots, "
        f"max_len 2048, greedy, spec_window {SPEC_WINDOW}; each engine "
        f"serves the traffic once untimed (its rounds' first dispatches "
        f"and captures), then the timed run")
    W = SPEC_WINDOW
    out = {}
    for label, kw, draft in SPEC_RUNS:
        dp, dc = (params, cfg) if draft == "self" else (dparams, dcfg)

        def engine():
            return DecodeEngine(params, cfg, batch_slots=8, max_len=2048,
                                kv_block_tokens=32, greedy=True, trace=True,
                                draft_params=dp, draft_cfg=dc,
                                spec_window=W, **kw)

        eng = engine()
        with _plain_attention_forbidden():
            _, warm, _ = _drive(eng, prompts, SPEC_NEW_TOKENS)
            base = (_b2_calls(eng), eng.decode_dispatches)
            replays0 = eng._graphs.replays
            eng, toks, run = _drive(eng, prompts, SPEC_NEW_TOKENS)
        s = _check_run(f"spec {label}", cfg, eng, toks, run,
                       new_tokens=SPEC_NEW_TOKENS, base=base)
        assert toks == warm, f"spec {label}: the timed run's tokens changed"
        n_keys = len(eng._graphs.graphs)
        assert s["spec_dispatches"] > 0, f"spec {label}: no round"
        assert s["decode_graph_replays"] == eng.decode_dispatches - n_keys, \
            f"spec {label}: a dispatch after its key's first was not replayed"
        assert not eng.paged or eng.kv_pool.blocks_in_use == 0
        assert not eng.paged or eng.kv_pool_d.blocks_in_use == 0, \
            f"spec {label}: draft blocks not returned"
        by_w = dict(sorted(eng.spec_dispatches_by_window.items()))
        log(f"[spec] {label}: steady decode {run['steady']:.1f} tokens/s "
            f"(card clock; the serve phase's no-draft "
            f"{'paged' if eng.paged else 'dense'} depth-2 run "
            f"{serve_rates['paged, depth 2' if eng.paged else 'dense, depth 2']:.1f}"
            f"), TTFT p50 {run['ttft_p50']:.4f} s, wall {run['wall']:.3f} s;"
            f" over both runs: acceptance {s['spec_acceptance_rate']:.3f}, "
            f"window effective {s['spec_window_effective']:.3f}, rounds "
            f"{int(s['spec_rounds'])}, draft tokens wasted "
            f"{int(s['spec_draft_tokens_wasted'])}, {eng.spec_dispatches} "
            f"spec dispatches by width {by_w}, {eng.decode_iterations} plain "
            f"decode iterations; timed run: B2 launches {run['launches']} = "
            f"{cfg.n_layers} per plain iteration + ({cfg.n_layers} + "
            f"{dc.n_layers} x W) per round, {run['gets']} dispatches, all "
            f"{eng._graphs.replays - replays0} replayed CUDA graphs ({n_keys}"
            f" keys); draft seedings {int(s['spec_prefill_dispatches'])}; "
            f"peak memory {run['peak'] / 2**30:.2f} GiB; on {smi}")
        assert eng._graphs.replays - replays0 == run["gets"], \
            f"spec {label}: the timed run dispatched outside its graphs"
        del eng
        torch.cuda.empty_cache()
        # the target's own choices given this run's history, at the
        # decode step's width and at the verify pass's
        forced = {w: _forced_picks(params, cfg, prompts, toks,
                                   kw.get("kv_quant"), paged="paged" in kw,
                                   width=w, prefill_chunk=None)
                  for w in (1, W + 1)}
        ref = np.asarray(toks)
        agree = {w: float((p == ref).mean()) for w, (p, _) in forced.items()}
        floor = float((forced[1][0] == forced[W + 1][0]).mean())
        miss = [(int(i), int(j), round(float(forced[1][1][i, j]), 4))
                for i, j in zip(*np.nonzero(forced[1][0] != ref))]
        log(f"[spec] {label}: teacher-forced agreement with the non-spec "
            f"engine on the same {'pool' if 'paged' in kw else 'cache'}: "
            f"{agree[1]:.4f} at the decode step's width, {agree[W + 1]:.4f}"
            f" at the verify pass's (S={W + 1}); the two non-spec widths "
            f"agree on {floor:.4f} (the noise floor); misses at width 1 "
            f"(request, position, logit gap): {miss}")
        sim = _sim_acceptance(toks, forced[1][0], W)
        out[label] = dict(run=run, stats=s, agree=agree, floor=floor,
                          sim=sim[1] / sim[0])
        # a fresh engine of the same construction: rows live mid-serving
        eng = engine()
        with _plain_attention_forbidden():
            eng.submit(prompts[0], W + 1)
            eng.run()                                  # captures W=4
            _live_rows(eng, prompts, SPEC_NEW_TOKENS)
            gap = _replay_check(eng)
            prof = _round_profile(eng, params, cfg)
        out[label]["prof"] = prof
        log(f"[spec] {label}: a replayed W={W} round == the round run "
            f"eagerly from the same state (emits, row state, draft lanes; "
            f"carried logits within {gap:.3e}); one round on the card "
            f"{prof['round']:.3f} ms; apart: its draft part {prof['draft']:.3f}"
            f" ms ({prof['draft'] / prof['round']:.1%}), its verify pass "
            f"{prof['verify']:.3f} ms ({prof['verify'] / prof['round']:.1%})"
            f" (CUDA graphs, 8 live rows); on {smi}")
        del eng
        torch.cuda.empty_cache()
    del dparams
    torch.cuda.empty_cache()
    # Random-weight logits sit at near ties (the misses' gaps above), so
    # two valid non-spec computations — the decode step's width and the
    # verify pass's — pick differently at a few percent of positions:
    # that agreement is the noise floor, and the run's tokens must agree
    # with each width to within SPEC_FLOOR_MARGIN of it. On a bf16 pool
    # or cache the verify width is the round's own computation, so the
    # tokens must also agree with it at SPEC_MIN_AGREE; an int8 pool's
    # bytes depend on its write history (a round requantizes blocks
    # holding rejected proposals), which neither width replays.
    short = [f"{k} {v['agree'][W + 1]:.4f} / {v['agree'][1]:.4f} (floor "
             f"{v['floor']:.4f})" for k, v in out.items()
             if min(v["agree"].values()) < v["floor"] - SPEC_FLOOR_MARGIN
             or ("int8" not in k and v["agree"][W + 1] < SPEC_MIN_AGREE)]
    assert not short, f"spec: teacher-forced agreement too low: {short}"
    acc = {k[0]: v["stats"]["spec_acceptance_rate"] for k, v in out.items()}
    sim_b = out[SPEC_RUNS[1][0]]["sim"]
    log(f"[spec] acceptance: 1B draft {acc['a']:.3f} (paged), "
        f"{acc['c']:.3f} (dense), {acc['d']:.3f} (int8); self-draft "
        f"{acc['b']:.3f}, against {sim_b:.3f} for a draft that picks the "
        f"target's decode-width choices on the same streams")
    assert acc["b"] >= sim_b - 0.05, \
        f"spec: self-draft acceptance {acc['b']:.3f} < {sim_b:.3f} - 0.05"
    assert acc["a"] < acc["b"], f"spec: acceptance {acc}"
    return out[SPEC_RUNS[0][0]]["run"]["launches"]


# The lora phase: the serve phase's model and traffic (8 prompts, 32 new
# tokens, greedy) under scheduler="adapter", request i through adapter
# LORA_AIDS[i] (None = the base model), LoraConfig() (the JAX default:
# rank 8, alpha 16, wq/wk/wv/wo). Three random adapters, each delta
# about LORA_DELTA_RMS of its base projection's RMS.
LORA_AIDS = ["ad0", "ad1", None, "ad2", "ad0", "ad1", None, "ad2"]
LORA_DELTA_RMS = 0.1
LORA_RUNS = (("a dense, depth 2 (the JAX defaults)", dict()),
             ("b paged bf16", dict(paged=True)),
             ("c paged int8", dict(paged=True, kv_quant="int8")))
LORA_MIN_EFFECT = 0.5    # adapter rows differ from the base tokens at more
# The teacher-forced gate against merged weights: agreement within
# LORA_FLOOR_MARGIN of the plain engine's rounding floor, and every miss
# a near tie (logit gap <= LORA_TIE_GAP). On an H100 the sound adapter
# rows read 0.927-0.932 against a 0.9375 floor with misses' gaps up to
# 0.078; the faults planted in engine (a)'s stacks (LORA_FAULTS: every
# adapter's wo delta dropped, the scale applied twice, each adapter's
# rows gathering the next adapter's factors) read 0.09-0.27 with gaps
# of 1.4-2.8, and the gate must reject each of them.
LORA_FLOOR_MARGIN = 0.03
LORA_TIE_GAP = 0.2
LORA_FAULTS = ("wo dropped", "scale twice", "wrong slot")
LORA_LAYER_TOL = 2e-2    # one layer's delta against f64, of its max |value|
LORA_F32_GAP = 1e-3      # f32: the largest logit gap of a differing pick
LORA_ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def lora_adapters(cfg, lcfg, n, seed):
    """`n` random adapters on the card: `lora_init`'s A ~ N(0, 1/in) and
    B ~ N(0, sigma), sigma = LORA_DELTA_RMS / (scale x sqrt(rank)), so
    that x A (B x scale) has about LORA_DELTA_RMS of the RMS of x W (x
    of unit RMS after the norm, W ~ N(0, 1/in) as `llama_init` draws
    it)."""
    from ray_tpu_torch import lora_init

    g = torch.Generator(device="cuda").manual_seed(seed)
    sigma = LORA_DELTA_RMS / (lcfg.scale * lcfg.rank ** 0.5)
    out = {}
    for i in range(n):
        lp = lora_init(cfg, lcfg, generator=g, device="cuda")
        for ab in lp["layers"].values():
            ab["b"].normal_(0.0, sigma, generator=g)
        out[f"ad{i}"] = lp
    return out


def _lora_engine(params, cfg, lcfg, loras, max_live=4, **kw):
    from ray_tpu_torch import DecodeEngine

    eng = DecodeEngine(params, cfg, batch_slots=8, max_len=2048,
                       kv_block_tokens=32, greedy=True, trace=True,
                       scheduler="adapter", lora=lcfg,
                       max_live_adapters=max_live, **kw)
    for a, lp in loras.items():
        eng.register_adapter(a, lp)
    return eng


def _lora_drained(label, eng):
    """Every adapter-slot reference back to 0, no pending slot, every
    KV block returned."""
    refs = eng.adapter_pool._refs
    assert not any(refs), f"{label}: adapter refs {refs}"
    assert not eng._pending_slots, f"{label}: {eng._pending_slots}"
    assert not eng.paged or eng.kv_pool.blocks_in_use == 0, \
        f"{label}: {eng.kv_pool.blocks_in_use} blocks still in use"


def _differ(a, b):
    """Share of positions at which two token streams differ."""
    return float((np.asarray(a) != np.asarray(b)).mean())


def _delta_layer_check(eng, cfg, lcfg, loras):
    """Layer 0's wq delta of 8 rows (slots of ad0, ad1, the null slot,
    ad2, ...) by `_lora_delta` on the card (bf16) against an f64
    evaluation of x A (B x scale) from the adapters' f32 factors.
    Returns (max error / max |reference|, delta RMS / base projection
    RMS over the adapter rows)."""
    from ray_tpu_torch.models.generate import _lora_delta

    pool = eng.adapter_pool
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(8, 1, cfg.dim, generator=g, device="cuda").to(cfg.dtype)
    slots = torch.tensor([0 if a is None else pool._slot_of[a]
                          for a in LORA_AIDS], device="cuda")
    ab = {k: v[0] for k, v in pool.stacks["wq"].items()}
    got = _lora_delta(x, ab, slots, cfg.dtype).double()
    ref = torch.zeros_like(got)
    for b, aid in enumerate(LORA_AIDS):
        if aid is not None:
            f = loras[aid]["layers"]["wq"]
            ref[b] = (x[b].double() @ f["a"][0].double()
                      @ (f["b"][0].double() * lcfg.scale))
    null = [b for b, a in enumerate(LORA_AIDS) if a is None]
    assert not got[null].any(), "lora: a null-slot row's delta is not 0"
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    base = (x.reshape(8, -1) @ eng.params["layers"]["wq"][0].reshape(
        cfg.dim, -1)).double()
    live = [b for b, a in enumerate(LORA_AIDS) if a is not None]
    ratio = (ref[live].pow(2).mean().sqrt()
             / base[live].pow(2).mean().sqrt()).item()
    return err, ratio


def _delta_ms(eng, cfg):
    """The card's ms of one decode iteration's adapter ops alone: every
    layer's and target's `_lora_delta` for 8 rows of one token and its
    add onto the projection, captured as a CUDA graph and replayed."""
    from ray_tpu_torch.models.generate import _lora_delta

    pool = eng.adapter_pool
    g = torch.Generator(device="cuda").manual_seed(10)
    slots = torch.tensor([0 if a is None else pool._slot_of.get(a, 0)
                          for a in LORA_AIDS], device="cuda")
    xs = {n: torch.randn(8, 1, d[0], generator=g, device="cuda").to(
        cfg.dtype) for n, d in pool._dims.items()}
    ys = {n: torch.zeros(8, 1, d[1], device="cuda", dtype=cfg.dtype)
          for n, d in pool._dims.items()}

    def deltas():
        for i in range(cfg.n_layers):
            for n, ab in pool.stacks.items():
                ys[n] + _lora_delta(xs[n], {k: v[i] for k, v in ab.items()},
                                    slots, cfg.dtype)

    with torch.no_grad():
        return _graph_ms(deltas, calls=1, reps=10)


def _prefetch_ms(cfg, lcfg, loras):
    """Host clock from `prefetch` to the end of its commit for one
    adapter (pinned host copies, a non-blocking copy on the side stream,
    the in-place commit), synchronised: a one-slot pool cycles the
    adapters twice, each commit evicting the last. Returns the times of
    the second cycle and the adapter's bytes."""
    from ray_tpu_torch.models.adapter_pool import AdapterPool
    from ray_tpu_torch.models.lora import lora_num_params

    pool = AdapterPool(cfg, lcfg, max_live_adapters=1, device="cuda")
    for a, lp in loras.items():
        pool.register(a, lp)
    times = []
    for a in list(loras) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.prefetch(a)
        assert pool.drain_prefetches() == 1
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (times[len(loras):],
            lora_num_params(cfg, lcfg) * cfg.dtype.itemsize)


def _lora_live_rows(eng, prompts, aids):
    """Bind `prompts` to the (idle) LoRA engine's rows through adapters
    `aids` by the engine's own admission gate (`_admit_all`: with two
    slots, committing a cold adapter evicts a resident), prefill them
    and stage a primary dispatch's inputs. Returns the evictions this
    made."""
    pool = eng.adapter_pool
    ev0 = pool.evictions
    for p, a in zip(prompts, aids):
        eng.submit(p, NEW_TOKENS, adapter_id=a)
    _admit_all(eng)
    rows = [r for r in range(eng.B) if eng.row_req[r] is not None]
    if eng.paged:
        assert eng._ensure_decode_blocks(rows, 8, 0)
    eng._stage_inputs(False)
    return pool.evictions - ev0


def _decode_replay_check(eng):
    """Given the same live rows, the engine's captured (H, all-greedy)
    decode graph of the largest H replayed writes the token block and
    row state of the same dispatch run eagerly. Returns (H, the largest
    difference of the carried logits)."""
    from ray_tpu_torch.ops import paged_attention_kernel as pak

    H = max(k[0] for k in eng._graphs.graphs if k[1] is True)
    graph, static, _ = eng._graphs.graphs[(H, True)]
    state = _round_state(eng)
    before = pak.launches
    eager = eng._decode_body(H, True).clone()
    pak.launches = before
    din, logits = eng._din.clone(), eng._last_logits.clone()
    _restore(eng, state)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager), "lora: replayed tokens differ"
    assert torch.equal(eng._din, din), "lora: replayed row state differs"
    return H, (eng._last_logits - logits).abs().max().item()


def _lora_faults(eng, prompts, aids):
    """Engine `eng` (every adapter of `aids` resident) serving `prompts`
    again once per fault of LORA_FAULTS, planted in its adapter stacks
    in place (so its captured graphs read it) and taken out after the
    run. Returns {fault: tokens per request}."""
    pool = eng.adapter_pool
    slots = [pool._slot_of[a] for a in dict.fromkeys(a for a in aids if a)]
    nxt = slots[1:] + slots[:1]
    saved = {n: {k: v.clone() for k, v in ab.items()}
             for n, ab in pool.stacks.items()}
    out = {}
    for fault in LORA_FAULTS:
        for n, ab in pool.stacks.items():
            if fault == "wo dropped" and n == "wo":
                ab["b"][:, slots] = 0
            elif fault == "scale twice":
                ab["b"][:, slots] = saved[n]["b"][:, slots] * 2
            elif fault == "wrong slot":
                for k, v in ab.items():
                    v[:, slots] = saved[n][k][:, nxt]
        with _plain_attention_forbidden():
            _, out[fault], _ = _drive(eng, prompts, NEW_TOKENS, aids=aids)
        for n, ab in pool.stacks.items():
            for k, v in ab.items():
                v.copy_(saved[n][k])
    _lora_drained("lora faults", eng)
    return out


def _lora_serve(params, cfg, prompts, lcfg, loras, kw):
    """A plain engine and a LoRA engine of one construction, each serving
    the traffic once untimed (first dispatches, captures, the LoRA
    engine's prefetches) and once timed with every plain attention
    forbidden; both timed runs checked as the serve phase checks, the
    LoRA one also for all-replayed dispatches and drained slots. Returns
    {False: plain, True: LoRA} runs (tokens, run, stats, iteration
    profile, the LoRA engine's warm tokens) and the LoRA engine."""
    from ray_tpu_torch import DecodeEngine

    out, keep = {}, None
    for use_lora in (False, True):
        if use_lora:
            eng = _lora_engine(params, cfg, lcfg, loras, **kw)
        else:
            eng = DecodeEngine(params, cfg, batch_slots=8, max_len=2048,
                               kv_block_tokens=32, greedy=True, trace=True,
                               **kw)
        aids = LORA_AIDS if use_lora else None
        with _plain_attention_forbidden():
            _, warm, _ = _drive(eng, prompts, NEW_TOKENS, aids=aids)
            base = (_b2_calls(eng), eng.decode_dispatches)
            replays0 = eng._graphs.replays
            eng, toks, run = _drive(eng, prompts, NEW_TOKENS, aids=aids)
        label = f"lora {'adapters' if use_lora else 'plain'} {kw}"
        s = _check_run(label, cfg, eng, toks, run, base=base)
        assert eng._graphs.replays - replays0 == run["gets"], \
            f"{label}: the timed run dispatched outside its graphs"
        if use_lora:
            _lora_drained(label, eng)
            assert s["adapter_prefetches"] == 3.0 and \
                s["adapter_evictions"] == 0.0, s
            keep = eng
        out[use_lora] = dict(toks=toks, warm=warm, run=run, stats=s,
                             prof=_iteration_profile(eng, cfg))
        if not use_lora:
            del eng
            torch.cuda.empty_cache()
    return out, keep


def lora_phase(smi, cfg, params):
    """Multi-LoRA serving on Llama-3-8B (see the module docstring);
    returns engine (a)'s B2 launches in its timed run."""
    from ray_tpu_torch import LoraConfig, lora_init, lora_merge
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.models.lora import lora_num_params

    prompts = serve_prompts(cfg.vocab_size)
    lcfg = LoraConfig()
    loras = lora_adapters(cfg, lcfg, 3, seed=2)
    mb = lora_num_params(cfg, lcfg) * 2 / 1e6
    log(f"[lora] LoraConfig() (rank {lcfg.rank}, alpha {lcfg.alpha}, "
        f"targets {'/'.join(lcfg.targets)}): {mb:.1f} MB an adapter in "
        f"bf16; 3 random adapters (delta RMS ~{LORA_DELTA_RMS} of the base "
        f"projection's); the serve phase's 8 prompts, {NEW_TOKENS} new "
        f"tokens, greedy, scheduler='adapter', adapters {LORA_AIDS}; each "
        f"engine serves once untimed, then timed, beside a plain engine of"
        f" the same construction")
    res = {}
    t0 = time.perf_counter()
    for label, kw in LORA_RUNS:
        runs, eng = _lora_serve(params, cfg, prompts, lcfg, loras, kw)
        res[label] = runs
        plain, ad = runs[False], runs[True]
        base_rows = [i for i, a in enumerate(LORA_AIDS) if a is None]
        same = all(ad["toks"][i] == plain["toks"][i] for i in base_rows)
        effect = {a: _differ([ad["toks"][i] for i, x in enumerate(LORA_AIDS)
                              if x == a],
                             [plain["toks"][i] for i, x in
                              enumerate(LORA_AIDS) if x == a])
                  for a in loras}
        pa, pl = ad["prof"], plain["prof"]
        log(f"[lora] {label}: steady decode {ad['run']['steady']:.1f} "
            f"tokens/s with adapters, {plain['run']['steady']:.1f} plain "
            f"(card clock, same call); TTFT p50 {ad['run']['ttft_p50']:.4f}"
            f" / {plain['run']['ttft_p50']:.4f} s; ms per decode iteration "
            f"{pa['iter_ms']:.3f} / {pl['iter_ms']:.3f} (+{pa['iter_ms'] - pl['iter_ms']:.3f},"
            f" {(pa['iter_ms'] - pl['iter_ms']) / pa['iter_ms']:.1%} of the "
            f"LoRA iteration), kernels an iteration {pa['kernels']:.0f} / "
            f"{pl['kernels']:.0f} (+{pa['kernels'] - pl['kernels']:.0f}), "
            f"B2 {pa['b2_ms']:.3f} ms; B2 launches {ad['run']['launches']} "
            f"= {cfg.n_layers} x {ad['run']['launches'] // cfg.n_layers} "
            f"decode iterations, all {ad['run']['gets']} timed dispatches "
            f"replayed graphs; base rows {'equal' if same else 'DIFFER'}; "
            f"adapter rows differ from the base tokens at "
            + ", ".join(f"{a} {v:.3f}" for a, v in effect.items())
            + f"; warm-run stats: deferrals "
            f"{int(ad['stats']['adapter_prefetch_deferrals'])}, prefetches "
            f"{int(ad['stats']['adapter_prefetches'])}, hits "
            f"{int(ad['stats']['adapter_hits'])}/"
            f"{int(ad['stats']['adapter_lookups'])}; peak memory "
            f"{ad['run']['peak'] / 2**30:.2f} GiB; on {smi}")
        if not label.startswith("c"):
            assert same, f"lora {label}: base rows differ from the plain " \
                f"engine's"
        assert min(effect.values()) > LORA_MIN_EFFECT, \
            f"lora {label}: adapters changed too few tokens {effect}"
        if label.startswith("a"):
            err, ratio = _delta_layer_check(eng, cfg, lcfg, loras)
            dms = _delta_ms(eng, cfg)
            log(f"[lora] layer 0's wq delta on the card (bf16) against f64 "
                f"x A (B x scale): max error {err:.2e} of its max |value| "
                f"(tolerance {LORA_LAYER_TOL}); delta RMS / base RMS "
                f"{ratio:.4f}; null-slot rows exactly 0; one iteration's "
                f"adapter ops alone ({cfg.n_layers} layers x "
                f"{len(lcfg.targets)} targets, 8 rows, as a graph) "
                f"{dms:.3f} ms")
            assert err <= LORA_LAYER_TOL, f"lora: layer check {err}"
            res[label]["delta_ms"] = dms
            res[label]["faults"] = _lora_faults(eng, prompts, LORA_AIDS)
        del eng
        torch.cuda.empty_cache()
    a_label, b_label, c_label = (r[0] for r in LORA_RUNS)

    # b = 0: lora_init's adapters are the base model exactly
    spent = {"engines": time.perf_counter() - t0}
    t0 = time.perf_counter()
    eng = _lora_engine(params, cfg, lcfg,
                       {"z": lora_init(cfg, lcfg, device="cuda")},
                       paged=True)
    eng.adapter_pool.prefetch("z")      # resident: the plain schedule
    eng.adapter_pool.drain_prefetches()
    with _plain_attention_forbidden():
        _, toks, _ = _drive(eng, prompts, NEW_TOKENS, aids=["z"] * 8)
    _lora_drained("lora b=0", eng)
    assert toks == res[b_label][False]["toks"], \
        "lora: b = 0 adapters changed the base tokens"
    del eng
    torch.cuda.empty_cache()
    log("[lora] b = 0 (lora_init) adapters on all 8 rows of (b): the plain "
        "engine's tokens exactly")

    # Teacher-forced: the adapter rows' picks given their own history,
    # by a plain engine on lora_merge'd weights. Merged bf16 weights
    # round W + delta where the engine rounds x W and the delta apart, a
    # perturbation of every weight by about one bf16 step, so near ties
    # flip. Two floors: the plain engine on its own tokens with its
    # weights rounded the same way (bf16(bf16(W + delta) - delta), no
    # change of function), which gates; and the plain engine fed 1 and
    # 5 tokens a row (GEMMs of 8 and 40 rows), which is printed. Every
    # miss must also be a near tie. The same comparison of engine (a)'s
    # tokens under each planted fault (LORA_FAULTS) must fail the gate.
    agree = {a_label: [], b_label: []}
    rounded_floor = {a_label: [], b_label: []}
    fault_hits = {f: [] for f in LORA_FAULTS}
    fault_gaps = {f: [0.0] for f in LORA_FAULTS}
    misses = []
    for aid in loras:
        rows = [i for i, a in enumerate(LORA_AIDS) if a == aid]
        ps = [prompts[i] for i in rows]
        merged = lora_merge(params, loras[aid], cfg, lcfg)
        neg = {"layers": {n: {"a": ab["a"], "b": -ab["b"]}
                          for n, ab in loras[aid]["layers"].items()}}
        rounded = lora_merge(merged, neg, cfg, lcfg)
        for label in (a_label, b_label):
            paged = label == b_label
            ref = [res[label][True]["toks"][i] for i in rows]
            if not paged:
                # (a)'s rows, then each fault's, in one engine
                ref += [res[label]["faults"][f][i] for f in LORA_FAULTS
                        for i in rows]
            picks, gaps = _forced_picks(merged, cfg, ps * (len(ref)
                                                           // len(rows)),
                                        ref, None, paged=paged,
                                        prefill_chunk=None)
            hit = picks == np.asarray(ref)
            n = len(rows)
            agree[label].append(hit[:n])
            misses += [(label[0], aid, rows[i], int(j),
                        round(float(gaps[i, j]), 4))
                       for i, j in zip(*np.nonzero(~hit[:n]))]
            for k, f in enumerate(LORA_FAULTS[:len(ref) // n - 1]):
                h = hit[n * (k + 1):n * (k + 2)]
                fault_hits[f].append(h)
                fault_gaps[f].append(float(gaps[n * (k + 1):n * (k + 2)]
                                           [~h].max(initial=0.0)))
            pref = [res[label][False]["toks"][i] for i in rows]
            picks, _ = _forced_picks(rounded, cfg, ps, pref, None,
                                     paged=paged, prefill_chunk=None)
            rounded_floor[label].append(picks == np.asarray(pref))
        del merged, rounded
        torch.cuda.empty_cache()
    ad_rows = [i for i, a in enumerate(LORA_AIDS) if a is not None]
    ps = [prompts[i] for i in ad_rows]
    ref = [res[a_label][False]["toks"][i] for i in ad_rows]
    p1, _ = _forced_picks(params, cfg, ps, ref, None, paged=False,
                          prefill_chunk=None)
    p5, _ = _forced_picks(params, cfg, ps, ref, None, paged=False, width=5,
                          prefill_chunk=None)
    width_floor = float((p1 == p5).mean())
    tf = {k: float(np.concatenate(v).mean()) for k, v in agree.items()}
    fr = {k: float(np.concatenate(v).mean())
          for k, v in rounded_floor.items()}
    worst = max([0.0] + [m[-1] for m in misses])
    fa = {f: float(np.concatenate(v).mean()) for f, v in fault_hits.items()}
    fg = {f: max(v) for f, v in fault_gaps.items()}

    def passes(agreement, gap, floor):
        return (agreement >= floor - LORA_FLOOR_MARGIN
                and gap <= LORA_TIE_GAP)

    log(f"[lora] teacher-forced agreement of the adapter rows with a plain "
        f"engine on lora_merge'd weights: (a) {tf[a_label]:.4f}, (b) "
        f"{tf[b_label]:.4f}, largest logit gap of a miss {worst:.4f}; "
        f"floors: the plain engine with its weights rounded through a "
        f"merge and unmerge (a) {fr[a_label]:.4f}, (b) {fr[b_label]:.4f}; "
        f"the plain engine at widths 1 and 5 (a) {width_floor:.4f}; gate: "
        f"agreement >= floor - {LORA_FLOOR_MARGIN} and every miss's gap <="
        f" {LORA_TIE_GAP}; planted faults in (a)'s stacks (agreement, "
        f"largest gap): " + ", ".join(
            f"{f} {fa[f]:.4f} / {fg[f]:.4f}" for f in LORA_FAULTS)
        + f"; misses (engine, adapter, row, position, logit gap): {misses}")
    low = [k for k in tf if not passes(tf[k], worst, fr[k])]
    assert not low, f"lora: teacher-forced gate failed for {low}"
    kept = [f for f in LORA_FAULTS if passes(fa[f], fg[f], fr[a_label])]
    assert not kept, f"lora: the teacher-forced gate passes the planted " \
        f"faults {kept}"
    picks, _ = _forced_picks(params, cfg, prompts, res[b_label][True]["toks"],
                             "int8", paged=True, prefill_chunk=None,
                             lora=(lcfg, loras, LORA_AIDS))
    c_agree = float((picks == np.asarray(res[b_label][True]["toks"])).mean())
    log(f"[lora] (c) int8 given (b)'s history: picks (b)'s token at "
        f"{c_agree:.4f} of positions (PR 7's int8 floor {KVMEM_MIN_AGREE}); "
        f"free-running {1 - _differ(res[c_label][True]['toks'], res[b_label][True]['toks']):.4f}")
    assert c_agree >= KVMEM_MIN_AGREE, f"lora: int8 agreement {c_agree}"
    spent["b=0 and teacher-forced"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # residency: two slots for three adapters
    eng = _lora_engine(params, cfg, lcfg, loras, max_live=2, paged=True)
    with _plain_attention_forbidden():
        _, toks, run = _drive(eng, prompts, NEW_TOKENS, aids=LORA_AIDS)
    s = eng.stats()
    _lora_drained("lora residency", eng)
    assert s["adapter_evictions"] >= 1 and s["adapter_prefetches"] >= 3 \
        and s["adapter_hits"] >= 1, s
    assert run["launches"] == _b2_calls(eng)
    res_toks = toks
    with _plain_attention_forbidden():
        cold = next(a for a in loras if not eng.adapter_pool.resident(a))
        warm = next(a for a in loras if a != cold)
        evicted = _lora_live_rows(eng, prompts,
                                  [cold, None, warm, None] * 2)
        H, gap = _decode_replay_check(eng)
        eng.run()
    _lora_drained("lora residency replay", eng)
    assert evicted >= 1, "lora: the live rows made no eviction"
    log(f"[lora] residency ((b) with 2 slots for 3 adapters): evictions "
        f"{int(s['adapter_evictions'])}, prefetches "
        f"{int(s['adapter_prefetches'])}, hits {int(s['adapter_hits'])}/"
        f"{int(s['adapter_lookups'])}, deferrals "
        f"{int(s['adapter_prefetch_deferrals'])}; tokens agree with (b)'s "
        f"timed run at {1 - _differ(res_toks, res[b_label][True]['toks']):.4f}"
        f"; after {evicted} more eviction(s) and re-commits, the H={H} "
        f"graph captured before them replays the eager dispatch's tokens "
        f"and row state (carried logits within {gap:.3e}); all refs 0, "
        f"no pending slot, every block returned")
    del eng
    torch.cuda.empty_cache()
    spent["residency"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    times, nbytes = _prefetch_ms(cfg, lcfg, loras)
    pms = float(np.median(times)) * 1e3
    log(f"[lora] one adapter ({nbytes / 1e6:.1f} MB bf16) host-to-commit "
        f"(prefetch + drain, synchronised): {pms:.3f} ms median of "
        f"{[round(t * 1e3, 3) for t in times]} = {nbytes / 1e6 / pms * 1e3:.0f}"
        f" MB/s")

    # every delta site on the card: rank 16, all seven targets
    lcfg16 = LoraConfig(rank=16, alpha=32.0, targets=LORA_ALL)
    loras16 = lora_adapters(cfg, lcfg16, 3, seed=3)
    eng = _lora_engine(params, cfg, lcfg16, loras16, paged=True)
    with _plain_attention_forbidden():
        eng, toks, run = _drive(eng, prompts, NEW_TOKENS, aids=LORA_AIDS)
    _check_run("lora rank 16", cfg, eng, toks, run)
    _lora_drained("lora rank 16", eng)
    prof = _iteration_profile(eng, cfg)
    dms = _delta_ms(eng, cfg)
    effect = _differ(toks, res[b_label][False]["toks"])
    log(f"[lora] rank 16, all seven targets "
        f"({lora_num_params(cfg, lcfg16) * 2 / 1e6:.1f} MB an adapter), (b):"
        f" {prof['iter_ms']:.3f} ms per decode iteration, "
        f"{prof['kernels']:.0f} kernels an iteration, adapter ops alone "
        f"{dms:.3f} ms; tokens differ from the plain engine's at "
        f"{effect:.3f}")
    del eng, loras16
    torch.cuda.empty_cache()
    spent["prefetch and rank 16"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # f32, 2 layers at 8B widths, all targets: the mixed batch against
    # each adapter's solo run on merged weights
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params32 = llama_init(cfg32, seed=4, device="cuda")
    loras32 = lora_adapters(cfg32, lcfg16, 3, seed=5)
    eng = _lora_engine(params32, cfg32, lcfg16, loras32)
    with _plain_attention_forbidden():
        _, toks32, _ = _drive(eng, prompts, NEW_TOKENS, aids=LORA_AIDS)
    _lora_drained("lora f32", eng)
    del eng
    report, worst = [], 0.0
    for aid in list(loras32) + [None]:
        rows = [i for i, a in enumerate(LORA_AIDS) if a == aid]
        ps = [prompts[i] for i in rows]
        p = params32 if aid is None else lora_merge(params32, loras32[aid],
                                                    cfg32, lcfg16)
        _, solo, _ = _serve(p, cfg32, ps, paged=False, depth=2)
        ref = [toks32[i] for i in rows]
        picks, gaps = _forced_picks(p, cfg32, ps, ref, None, paged=False,
                                    prefill_chunk=None)
        diff = [(int(i), int(j), float(gaps[i, j]))
                for i, j in zip(*np.nonzero(picks != np.asarray(ref)))]
        worst = max([worst] + [g for _, _, g in diff])
        report.append(f"{aid}: solo {'equal' if solo == ref else 'differs'}"
                      f", teacher-forced misses {diff}")
        del p
    del params32
    torch.cuda.empty_cache()
    log(f"[lora] f32, 2 layers at 8B widths, rank 16 on all seven targets: "
        f"the mixed batch against each adapter's solo run on merged weights"
        f" (plain engine): {'; '.join(report)}")
    assert worst <= LORA_F32_GAP, f"lora f32: a pick differs by {worst}"
    spent["f32"] = time.perf_counter() - t0
    log("[lora] phase parts: " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in spent.items()))
    return res[a_label][True]["run"]["launches"]


# The fleet phase: every replica a paged engine of the serve phase's
# construction (8 slots, 32-token blocks, max_len 2048, depth 2).
FLEET_ENGINE = dict(batch_slots=8, max_len=2048, kv_block_tokens=32,
                    paged=True, pipeline_depth=2, greedy=True)
FLEET_KILL_STEP = 2             # replica r0 dies after its second step


class _Built(list):
    """An engine factory for `LLMFleet` that keeps every engine it
    builds (the dead replica's too), so a run's B2 calls can be summed
    over all of them."""

    def __init__(self, params, cfg, **kw):
        super().__init__()
        self.params, self.cfg, self.kw = params, cfg, kw

    def __call__(self, name):
        from ray_tpu_torch import DecodeEngine

        self.append(DecodeEngine(self.params, self.cfg, engine_id=name,
                                 **self.kw))
        return self[-1]


def _fleet_run(fleet, prompts, new_tokens, inj=None):
    """Submit every prompt to the fleet, then step it until nothing is
    pending, counting B2's launches and timing each request's first
    token on the host clock (from the last submit). With a fault
    injector, also note the step its kill fired, the fleet requests the
    dead replica held, the tokens each had streamed by then, and each
    one's first token after it. Returns the fleet ids, the tokens and
    the run's counts and times."""
    from ray_tpu_torch.ops import paged_attention_kernel as pak

    fids = [fleet.submit(p, new_tokens) for p in prompts]
    first, streamed, kill = {}, {f: [] for f in fids}, {}
    torch.cuda.synchronize()
    pak.launches = 0
    t0 = time.perf_counter()
    while fleet.pending():
        held = {rep.name: set(rep.rid_to_fid.values())
                for rep in fleet.replicas}
        fired = len(inj.fired) if inj is not None else 0
        emitted = fleet.step()
        now = time.perf_counter() - t0
        if inj is not None and len(inj.fired) > fired:
            name = inj.fired[-1][0]
            kill = {"t": now, "fids": held[name],
                    "before": {f: list(streamed[f]) for f in held[name]},
                    "first_after": {}}
        for f, toks in emitted.items():
            first.setdefault(f, now)
            if kill and f in kill["fids"] and toks:
                kill["first_after"].setdefault(f, now)
            streamed[f].extend(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pak.launches
    out = fleet.run()
    toks = [out[f] for f in fids]
    assert all(streamed[f] == out[f] for f in fids), \
        "fleet: the streamed tokens differ from the results"
    return fids, toks, {"launches": launches, "wall": wall,
                        "tokens_s": sum(map(len, toks)) / wall,
                        "ttft_p50": float(np.median(
                            [first[f] for f in fids])),
                        "kill": kill}


def _tpot_sums(engines):
    """(sum, count) of the engines' TPOT observations. An engine stamps
    a token when it drains it, so this is exact per request; a fleet's
    host loop sees one replica's tokens only when the fleet step, and so
    the other replicas' steps, end."""
    stats = [e.stats() for e in engines]
    return (sum(s["tpot_s_mean"] * s["tpot_s_count"] for s in stats),
            sum(s["tpot_s_count"] for s in stats))


def _tpot_mean(engines, before=(0.0, 0)):
    """The engines' mean time per output token since ``before`` (a
    `_tpot_sums` snapshot): the engine metric the serve phase prints."""
    total, n = _tpot_sums(engines)
    return (total - before[0]) / (n - before[1])


def _check_fleet(label, cfg, built, toks, run, new_tokens, fleet,
                 replayed=True):
    """Every request has its full budget, B2 ran n_layers per decode
    iteration of every engine built and nothing else, decode graphs were
    replayed (unless ``replayed`` is False: a short run may capture each
    horizon's graph once and never replay it) and every replica's blocks
    came back."""
    assert all(len(t) == new_tokens for t in toks), \
        f"{label}: {[len(t) for t in toks]} tokens"
    assert all(0 <= x < cfg.vocab_size for t in toks for x in t)
    want = sum(_b2_calls(e) for e in built)
    assert run["launches"] == want, \
        f"{label}: kernel launches {run['launches']} != {want}"
    assert not replayed or sum(e.stats()["decode_graph_replays"]
                               for e in built) > 0, \
        f"{label}: no decode graph replayed"
    for rep in fleet.replicas:
        assert rep.engine.kv_pool.blocks_in_use == 0, \
            f"{label} {rep.name}: {rep.engine.kv_pool.blocks_in_use} " \
            "blocks still in use"


def _watch_handoffs(fleet):
    """Wrap the split fleet's prefill engine's `export_request` and its
    decode engine's `_swap_in_row`: record each handoff's bytes, its
    export's host ms (gather, copy to pinned memory and the wait for it)
    and its swap-in's card ms, and the argmax of the carried logits per
    fleet request. The first handoff is held byte for byte: the payload
    equals the prefill pool's blocks (pages and scale rows) and the
    row's logits, and the decode engine's new chain and row logits
    equal the payload after the swap-in."""
    from ray_tpu_torch.ops.kv_quant import raw

    rec = {"bytes": [], "export_ms": [], "import_ms": [], "argmax": {}}
    by_class = {r.replica_class: r for r in fleet.replicas}
    pre_rep, dec = by_class["prefill"], by_class["decode"].engine
    pre = pre_rep.engine
    export, swap_in = pre.export_request, dec._swap_in_row

    def blocks(eng, ids):
        idx = torch.tensor(ids, dtype=torch.long, device=eng.device)
        return [raw(t).index_select(1, idx).cpu()
                for t in eng._pool_tensors()]

    def watched_export(rid):
        row = next(b for b, r in enumerate(pre.row_req)
                   if r is not None and r.req_id == rid)
        first = "sent" not in rec
        if first:
            sent = blocks(pre, list(pre._row_blocks[row]))
            logits = pre._last_logits[row].cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = export(rid)
        rec["export_ms"].append((time.perf_counter() - t0) * 1e3)
        kv = h["kv"]
        parts = [kv["k"], kv["v"]] + ([kv["sk"], kv["sv"]]
                                      if kv["sk"] is not None else [])
        rec["bytes"].append(sum(x.nbytes for x in parts)
                            + kv["logits"].nbytes)
        rec["argmax"][pre_rep.rid_to_fid[rid]] = int(kv["logits"].argmax())
        if first:
            n = kv["n_blocks"]
            assert all(torch.equal(a, x[:, :n])
                       for a, x in zip(sent, parts)), \
                "handoff: the payload differs from the prefill pool's blocks"
            assert torch.equal(logits, kv["logits"]), \
                "handoff: the payload's logits differ from the row's"
            rec.update(sent=sent, logits=logits, prompt=h["prompt"],
                       blocks=n)
        return h

    def watched_swap_in(row, req, state):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ok = swap_in(row, req, state)
        end.record()
        end.synchronize()
        if ok and req.handoff:
            rec["import_ms"].append(start.elapsed_time(end))
            if req.prompt == rec.get("prompt") and "back" not in rec:
                back = blocks(dec, dec._row_blocks[row])
                assert all(torch.equal(a, b)
                           for a, b in zip(rec["sent"], back)), \
                    "handoff: the decode chain's bytes differ from the " \
                    "prefill pool's"
                assert torch.equal(dec._last_logits[row].cpu(),
                                   rec["logits"]), \
                    "handoff: the decode row's logits differ"
                rec["back"] = True
        return ok

    pre.export_request, dec._swap_in_row = watched_export, watched_swap_in
    return rec


def _fleet_exact(cfg, params, prompts, solo):
    """(d): on the small f32 model, a colocated, a failover and a split
    fleet of paged engines each emit exactly solo `generate`'s greedy
    tokens (plain attention)."""
    from ray_tpu_torch import FaultInjector, LLMFleet

    kw = dict(batch_slots=4, max_len=128, kv_block_tokens=16, paged=True)
    for label in ("colocated", "failover", "disaggregated"):
        built = _Built(params, cfg, **kw)
        inj = (FaultInjector(schedule={"exact-r0": [(1, "kill")]})
               if label == "failover" else None)
        fleet = (LLMFleet(built, disaggregated=True, prefill_replicas=1,
                          decode_replicas=1, fleet_id="exact")
                 if label == "disaggregated" else
                 LLMFleet(built, initial_replicas=2, fleet_id="exact",
                          fault_injector=inj))
        with _plain_attention_forbidden():
            _, toks, run = _fleet_run(fleet, prompts, 15, inj)
        _check_fleet(f"fleet exact {label}", cfg, built, toks, run, 15,
                     fleet, replayed=False)
        assert toks == solo, f"fleet exact {label}: tokens != solo generate"
        assert inj is None or (inj.fired and fleet.requests_recovered >= 1)
        assert label != "disaggregated" or \
            fleet.handoffs == len(prompts) > 0
    log(f"[fleet] (d) f32 2-layer model: colocated, failover (r0 killed at "
        f"its step 1) and disaggregated fleets == solo generate (plain "
        f"attention) on {len(prompts)} requests x 15 tokens")


def _warm_passes(fleet, params, cfg, prompts):
    """The same traffic again on ``fleet`` (2 replicas, graphs captured
    by its first pass) and, twice, on a 1-replica fleet of the same
    construction, the second pass warm: {replicas: run}. No gate beyond
    every request's budget: routing, and so the rows a GEMM batches, may
    differ from the first pass."""
    from ray_tpu_torch import LLMFleet

    one = LLMFleet(_Built(params, cfg, **FLEET_ENGINE),
                   initial_replicas=1, fleet_id="fleet-one")
    out = {}
    with _plain_attention_forbidden():
        for n, f, passes in ((2, fleet, 1), (1, one, 2)):
            engines = [r.engine for r in f.replicas]
            for _ in range(passes):
                before = _tpot_sums(engines)
                _, toks, out[n] = _fleet_run(f, prompts, NEW_TOKENS)
                assert all(len(t) == NEW_TOKENS for t in toks)
            out[n]["tpot_mean"] = _tpot_mean(engines, before)
    del one
    return out


def fleet_phase(smi, cfg, params, paged_run):
    """The serving fleet over port engines on Llama-3-8B (see the module
    docstring); returns fleet (a)'s B2 launches."""
    from ray_tpu_torch import FaultInjector, LLMFleet

    prompts = serve_prompts(cfg.vocab_size)
    log(f"[fleet] the serve traffic ({N_REQUESTS} requests, {NEW_TOKENS} "
        f"new tokens, greedy); every replica a paged bf16 engine with 8 "
        f"slots, 32-token blocks, max_len 2048, pipeline depth 2, all on "
        f"one copy of the weights")
    out = {}
    for label in ("colocated", "failover"):
        built = _Built(params, cfg, **FLEET_ENGINE)
        inj = (FaultInjector(schedule={
            f"fleet-{label}-r0": [(FLEET_KILL_STEP, "kill")]})
            if label == "failover" else None)
        fleet = LLMFleet(built, initial_replicas=2, router="pow2_affinity",
                         fleet_id=f"fleet-{label}", fault_injector=inj)
        with _plain_attention_forbidden():
            fids, toks, run = _fleet_run(fleet, prompts, NEW_TOKENS, inj)
        _check_fleet(f"fleet {label}", cfg, built, toks, run, NEW_TOKENS,
                     fleet)
        s = fleet.stats()
        run["tpot_mean"] = _tpot_mean(built)
        out[label] = (toks, run, s)
        if label == "colocated":
            warm = _warm_passes(fleet, params, cfg, prompts)
        if inj is not None:
            kill = run["kill"]
            assert inj.fired == [(f"fleet-{label}-r0", FLEET_KILL_STEP,
                                  "kill")], inj.fired
            assert s["tokens_lost_to_failure"] == 0.0
            assert s["requests_recovered"] >= 1.0 and kill["fids"]
            for f in kill["fids"]:
                got = toks[fids.index(f)]
                assert got[:len(kill["before"][f])] == kill["before"][f], \
                    f"failover: request {f} lost the tokens it had emitted"
            recover_s = max(kill["first_after"][f] for f in kill["fids"]) \
                - kill["t"]
        del fleet, built
        gc.collect()
        torch.cuda.empty_cache()
    toks_a, run_a, s_a = out["colocated"]
    toks_b, run_b, s_b = out["failover"]
    log(f"[fleet] (a) colocated, 2 replicas, router pow2_affinity: "
        f"{run_a['tokens_s']:.1f} tokens/s end to end (wall "
        f"{run_a['wall']:.3f} s), TTFT p50 {run_a['ttft_p50']:.4f} s, TPOT "
        f"mean {run_a['tpot_mean'] * 1e3:.2f} ms; B2 launches "
        f"{run_a['launches']} = {cfg.n_layers} layers x the replicas' "
        f"decode iterations; routed {int(s_a['requests_routed'])} (pow2 wins "
        f"{int(s_a['router_pow2_wins'])}); beside the serve phase's single "
        f"paged engine: {paged_run['tokens_s']:.1f} tokens/s end to end "
        f"({paged_run['steady']:.1f} steady), TTFT p50 "
        f"{paged_run['ttft_p50']:.4f} s, TPOT mean "
        f"{paged_run['tpot_mean'] * 1e3:.2f} ms; on {smi}")
    log(f"[fleet] (a) warm, the same traffic again on engines whose graphs "
        f"are captured: 2 replicas {warm[2]['tokens_s']:.1f} tokens/s end to"
        f" end, TTFT p50 {warm[2]['ttft_p50']:.4f} s, TPOT mean "
        f"{warm[2]['tpot_mean'] * 1e3:.2f} ms; 1 replica "
        f"{warm[1]['tokens_s']:.1f} tokens/s, TTFT p50 "
        f"{warm[1]['ttft_p50']:.4f} s, TPOT mean "
        f"{warm[1]['tpot_mean'] * 1e3:.2f} ms")
    agree = sum(x == y for a, b in zip(toks_a, toks_b) for x, y in zip(a, b))
    log(f"[fleet] (b) failover: r0 killed at its step {FLEET_KILL_STEP} "
        f"holding {len(run_b['kill']['fids'])} requests; recovered "
        f"{int(s_b['requests_recovered'])}, retries {int(s_b['retries'])}, "
        f"tokens lost {int(s_b['tokens_lost_to_failure'])}; kill to the "
        f"last recovered request's first new token {recover_s:.3f} s; "
        f"greedy tokens agreeing with (a) {agree}/{N_REQUESTS * NEW_TOKENS}"
        f" = {agree / (N_REQUESTS * NEW_TOKENS):.3f} (bf16 recompute can "
        f"flip near ties); {run_b['tokens_s']:.1f} tokens/s end to end, "
        f"B2 launches {run_b['launches']}")
    for quant in (None, "int8"):
        label = quant or "bf16"
        built = _Built(params, cfg, **dict(FLEET_ENGINE, kv_quant=quant))
        fleet = LLMFleet(built, disaggregated=True, prefill_replicas=1,
                         decode_replicas=1, fleet_id=f"fleet-split-{label}")
        rec = _watch_handoffs(fleet)
        with _plain_attention_forbidden():
            fids, toks, run = _fleet_run(fleet, prompts, NEW_TOKENS)
        _check_fleet(f"fleet split {label}", cfg, built, toks, run,
                     NEW_TOKENS, fleet)
        s = fleet.stats()
        dec = [e for e in built if not e.prefill_only]
        assert s["handoffs"] == N_REQUESTS == len(rec["bytes"])
        assert s["handoff_in_bytes"] == s["handoff_out_bytes"] \
            == sum(rec["bytes"]) > 0, "a handoff went by recompute"
        assert all(e.stats()["prefill_real_tokens"] == 0 for e in dec), \
            "the decode replica prefilled prompt tokens"
        assert rec.get("back"), "the first handoff was never swapped in"
        for f, t in zip(fids, toks):
            assert t[0] == rec["argmax"][f], \
                f"split {label}: request {f}'s first token is not the " \
                "argmax of its carried logits"
        mb = np.mean(rec["bytes"]) / 1e6
        ems, ims = np.mean(rec["export_ms"]), np.mean(rec["import_ms"])
        log(f"[fleet] (c) disaggregated {label}: 1 prefill + 1 decode "
            f"replica, {N_REQUESTS} handoffs by swap, "
            f"{mb:.2f} MB a handoff ({min(rec['bytes']) / 1e6:.2f}-"
            f"{max(rec['bytes']) / 1e6:.2f}; pages, scale rows and logits; "
            f"first: {rec['blocks']} blocks, byte for byte both ways); "
            f"export {ems:.2f} ms (host clock, {mb / ems:.2f} GB/s), "
            f"swap-in {ims:.2f} ms (card, {mb / ims:.2f} GB/s); "
            f"{run['tokens_s']:.1f} tokens/s end to end, TTFT p50 "
            f"{run['ttft_p50']:.4f} s (submit to first token across the "
            f"handoff), TPOT mean {_tpot_mean(dec) * 1e3:.2f} ms, beside "
            f"(a)'s {run_a['ttft_p50']:.4f} s / "
            f"{run_a['tpot_mean'] * 1e3:.2f} ms; on {smi}")
        del fleet, built, dec
        gc.collect()
        torch.cuda.empty_cache()
    _fleet_exact(*small_model())
    return run_a["launches"]


def lora_train_phase(smi, full):
    """The adapter-only train step at the train phase's widths, batch
    and depth (see the module docstring); ``full`` is the train phase's
    step ms, tokens/s and peak memory. Returns the kernels' launches."""
    from ray_tpu_torch import (LoraConfig, adamw, llama_loss, lora_init,
                               make_lora_train_step)
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.models.training import _leaves
    from ray_tpu_torch.ops import flash_attention_kernel as fak
    from ray_tpu_torch.profile_train import BATCH, SEQ, flagship_config, \
        train_batch

    cfg = flagship_config()
    lcfg = LoraConfig(rank=8, targets=("wq", "wv", "w_gate"))
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn = make_lora_train_step(
        lambda p, b: llama_loss(p, b, cfg), adamw(1e-2), cfg, lcfg)
    base, lora, opt = init_fn(
        llama_init(cfg, seed=0, device="cuda", dtype=torch.float32),
        lora_init(cfg, lcfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(6)))
    base0 = [x.clone() for x in _leaves(base)]
    lora0 = [x.detach().clone() for x in _leaves(lora)]
    batch = train_batch(cfg)
    log(f"[lora-train] the train phase's config, batch and depth; "
        f"LoraConfig(rank={lcfg.rank}, targets={lcfg.targets}) as "
        f"tests/test_models.py trains it; adamw(1e-2); base f32, frozen")
    with _plain_attention_forbidden():
        lora, opt, m = step_fn(lora, opt, base, batch)
        losses = [m["loss"].item()]
        torch.cuda.synchronize()
        fak.fwd_launches = fak.dq_launches = fak.dkv_launches = 0
        times = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            lora, opt, m = step_fn(lora, opt, base, batch)
            losses.append(m["loss"].item())       # waits for the step
            times.append(time.perf_counter() - t0)
        launches = {"fwd": fak.fwd_launches, "dq": fak.dq_launches,
                    "dkv": fak.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"lora-train: loss did not fall {losses}"
    assert all(torch.equal(a, b) for a, b in zip(_leaves(base), base0)), \
        "lora-train: the base changed"
    assert not any(x.requires_grad for x in _leaves(base))
    moved = min((a.detach() - b).abs().max().item()
                for a, b in zip(_leaves(lora), lora0))
    assert moved > 0, "lora-train: an adapter leaf did not move"
    L = cfg.n_layers
    want = {"fwd": 2 * L * TRAIN_STEPS, "dq": L * TRAIN_STEPS,
            "dkv": L * TRAIN_STEPS}
    assert launches == want, f"lora-train: launches {launches} != {want}"
    tok_s = BATCH * SEQ * TRAIN_STEPS / sum(times)
    log(f"[lora-train] losses {[round(x, 4) for x in losses]}; base "
        f"bit-unchanged; every adapter leaf moved (smallest max change "
        f"{moved:.3e}); kernel launches in {TRAIN_STEPS} steps: forward "
        f"{launches['fwd']}, dq {launches['dq']}, dk/dv {launches['dkv']} "
        f"(as the full step)")
    log(f"[lora-train] step {np.mean(times) * 1e3:.1f} ms mean (min "
        f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); {tok_s:.0f} "
        f"tokens/s; peak memory {peak / 2**30:.2f} GiB; the full step of "
        f"the train phase: {full['step_ms']:.1f} ms, {full['tok_s']:.0f} "
        f"tokens/s, {full['peak'] / 2**30:.2f} GiB; on {smi}")
    del base, lora, opt, base0, lora0
    torch.cuda.empty_cache()
    return launches


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


def flash_phase(cases=FLASH_CASES, timed=FLASH_TIMED, phase="flash"):
    from ray_tpu_torch.ops import flash_attention as fa

    results = {}
    for name, B, H, Hkv, Sq, Sk, D, dts, causal in cases:
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
            assert torch.isfinite(got).all(), f"[{phase}] {name} {key}: inf/nan"
            err = (got - want).abs()
            errs[key] = err.max().item()
            assert bool((err <= tol + tol * want.abs()).all()), \
                f"[{phase}] {name} {key}: max_abs_err {errs[key]:.3e} FAILED"
        dead = Sq - Sk if causal else 0
        if dead > 0:
            assert bool((o[:, :, :dead] == 0).all()), f"{name}: dead o"
            assert bool((dq[:, :, :dead] == 0).all()), f"{name}: dead dq"
        line = (f"[{phase}] {name}: B={B} H={H}/{Hkv} Sq={Sq} Sk={Sk} D={D} "
                f"{dts} {'causal' if causal else 'non-causal'}: max_abs_err "
                + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
                + f" (atol = rtol = {tol})"
                + (f"; {dead} fully masked rows exactly 0 in o and dq"
                   if dead > 0 else ""))
        res = {"fwd": {"max_abs_err": max(errs["o"], errs["lse"])},
               "dq": {"max_abs_err": errs["dq"]},
               "dkv": {"max_abs_err": max(errs["dk"], errs["dv"])}}
        if name in timed:
            t = _time_flash(q, k, v, do, o, lse, scale, causal, H != Hkv)
            for kern, plain, lib in (("fwd", "plain_fwd", "sdpa_fwd"),
                                     ("dq", "plain_bwd", "sdpa_bwd"),
                                     ("dkv", "plain_bwd", "sdpa_bwd")):
                bound, by = _flash_bound_ms(kern, B, H, Hkv, Sq, Sk, D,
                                            causal, dts)
                res[kern].update(ms=t[kern], plain_ms=t[plain],
                                 library_ms=t[lib], bound_ms=bound,
                                 bound_by=by)
                line += (f"\n[{phase}]   {kern}: kernel {t[kern]:.4f} ms, "
                         f"bound {bound:.4f} ms ({by}, {bound / t[kern]:.1%}"
                         f" of bound), plain {t[plain]:.4f} ms, SDPA "
                         f"{t[lib]:.4f} ms, kernel / SDPA "
                         f"{t[kern] / t[lib]:.2f}x")
            line += (f"\n[{phase}]   (the plain backward and SDPA's backward "
                     "each compute dq, dk and dv in one call)")
        log(line)
        results[name] = res
        del q, k, v, do, o, lse, dq, dk, dv, ro, rlse, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def _plain_attention_forbidden():
    """Every plain attention version raises while the block runs: the
    plain training attention, the plain flash passes and the engine's
    plain paged attention (prefill's cached attention is plain by
    design, ROADMAP A15)."""
    from ray_tpu_torch.models import engine as engine_mod
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import flash_attention as fa

    def refuse(*args, **kwargs):
        raise AssertionError("the plain attention ran on the main path")

    real_paged = engine_mod.paged_attention

    def paged_kernel_only(q, *args, impl="auto", **kwargs):
        if impl == "reference" or (impl == "auto" and not q.is_cuda):
            refuse()
        return real_paged(q, *args, impl=impl, **kwargs)

    with mock.patch.object(attn, "mha_reference", refuse), \
            mock.patch.object(fa, "_flash_fwd_reference", refuse), \
            mock.patch.object(fa, "_flash_bwd_reference", refuse), \
            mock.patch.object(engine_mod, "paged_attention",
                              paged_kernel_only):
        yield


def train_phase(smi):
    from ray_tpu_torch.models.llama import llama_flops_per_token
    from ray_tpu_torch.ops import flash_attention_kernel as fak
    from ray_tpu_torch.profile_train import (BATCH, BENCH_REMAT_POLICY, SEQ,
                                             build_trainer, flagship_config,
                                             train_batch)

    cfg = flagship_config()
    assert cfg.remat_policy == BENCH_REMAT_POLICY
    log(f"[train] bench.py:flagship_config() at full depth: vocab "
        f"{cfg.vocab_size}, dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, ffn {cfg.ffn_dim} "
        f"({cfg.num_params() / 1e6:.1f} M params), remat_policy "
        f"{cfg.remat_policy!r}; bf16 activations, f32 master weights; "
        f"batch {BATCH} x {SEQ} tokens; adamw(3e-4, weight_decay=0.0); "
        f"make_train_step")
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
    return launches, {"step_ms": np.mean(times) * 1e3, "tok_s": tok_s,
                      "peak": peak, "loss0": losses[0], "norm0": norms[0]}


SHARDED_RUNS = (("save:ffn_gate+ffn_up+ffn_down", 5), ("save_dots", 3),
                ("full", 3))
NORM_RTOL = 1e-6      # the one-rank all-reduce and norm against the train
                      # phase's: the same gradients, summed as one group


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sharded_run(smi, mesh, policy, steps, full):
    """One policy through make_sharded_train_step: a warm-up step held
    to the train phase's first loss and norm, then ``steps`` timed
    steps. Returns the kernels' launches in the timed steps."""
    from ray_tpu_torch.models.llama import llama_flops_per_token
    from ray_tpu_torch.ops import flash_attention_kernel as fak
    from ray_tpu_torch.profile_train import (BATCH, SEQ,
                                             build_sharded_trainer,
                                             flagship_config, train_batch)

    cfg = flagship_config(remat_policy=policy)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, step_fn = build_sharded_trainer(cfg, mesh)
    batch = train_batch(cfg)
    with _plain_attention_forbidden():
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses, norms = [m["loss"].item()], [m["grad_norm"].item()]
        torch.cuda.synchronize()
        fak.fwd_launches = fak.dq_launches = fak.dkv_launches = 0
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(m["loss"].item())       # waits for the step
            norms.append(m["grad_norm"].item())
            times.append(time.perf_counter() - t0)
        launches = {"fwd": fak.fwd_launches, "dq": fak.dq_launches,
                    "dkv": fak.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    label = f"[sharded-train] {policy!r}"
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), \
        (label, losses, norms)
    assert losses[0] == full["loss0"], \
        f"{label}: first loss {losses[0]!r} != the train phase's " \
        f"{full['loss0']!r}"
    assert abs(norms[0] - full["norm0"]) <= NORM_RTOL * full["norm0"], \
        f"{label}: first grad norm {norms[0]!r} vs {full['norm0']!r}"
    assert losses[-1] < losses[0], f"{label}: loss did not fall {losses}"
    L = cfg.n_layers
    want = {"fwd": 2 * L * steps, "dq": L * steps, "dkv": L * steps}
    assert launches == want, f"{label}: launches {launches} != {want}"
    tok_s = BATCH * SEQ * steps / sum(times)
    mfu = tok_s * llama_flops_per_token(cfg, SEQ) / BF16_FLOPS_PER_S
    log(f"{label}: losses {[round(x, 4) for x in losses]}; first loss "
        f"bit-equal to the train phase's ({losses[0]!r}), grad norm "
        f"{norms[0]!r} vs {full['norm0']!r}; launches in {steps} steps: "
        f"forward {launches['fwd']}, dq {launches['dq']}, dk/dv "
        f"{launches['dkv']}; plain attention never ran")
    log(f"{label}: step {np.mean(times) * 1e3:.1f} ms mean (min "
        f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); {tok_s:.0f} "
        f"tokens/s; MFU {mfu:.2%} of 989 TFLOP/s bf16; peak memory "
        f"{peak / 2**30:.2f} GiB; on {smi}")
    del params, opt_state, step_fn
    torch.cuda.empty_cache()
    return launches


def _resume_check(mesh):
    """Two steps at 2 layers, a checkpoint of params and AdamW state,
    a third step; then the third step again from fresh tensors restored
    from the checkpoint, bit for bit."""
    import os
    import tempfile

    from ray_tpu_torch import adamw
    from ray_tpu_torch.models.llama import llama_param_specs
    from ray_tpu_torch.models.training import _leaves, _tree_map
    from ray_tpu_torch.profile_train import (build_sharded_trainer,
                                             flagship_config, train_batch)
    from ray_tpu_torch.train.array_checkpoint import (restore_pytree,
                                                      save_pytree)

    cfg = flagship_config(n_layers=2)
    specs = llama_param_specs(cfg)
    opt = adamw(3e-4, weight_decay=0.0)         # build_sharded_trainer's
    state_specs = opt.state_specs(specs)
    params, opt_state, step_fn = build_sharded_trainer(cfg, mesh)
    batch = train_batch(cfg)
    with _plain_attention_forbidden(), \
            tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):
            params, opt_state, _ = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pytree(params, f"{tmp}/params", mesh=mesh, specs=specs)
        save_pytree(opt.state_tree(opt_state, params), f"{tmp}/opt",
                    mesh=mesh, specs=state_specs)
        t_save = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(tmp) for f in fs)
        params, opt_state, m = step_fn(params, opt_state, batch)
        want = [x.detach().clone() for x in _leaves(params)]
        want_loss = m["loss"].item()
        del params, opt_state
        t0 = time.perf_counter()
        fresh = _tree_map(lambda x: x.requires_grad_(True), restore_pytree(
            specs, f"{tmp}/params", mesh=mesh, specs=specs))
        fstate = opt.init(fresh)
        opt.load_state_tree(fstate, fresh, restore_pytree(
            state_specs, f"{tmp}/opt", mesh=mesh, specs=state_specs))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        fresh, fstate, m = step_fn(fresh, fstate, batch)
        got_loss = m["loss"].item()
    same = [torch.equal(a.detach(), b) for a, b in zip(_leaves(fresh), want)]
    line = (f"[sharded-train] resume at 2 layers: third step's loss "
            f"{got_loss!r} resumed vs {want_loss!r} uninterrupted; "
            f"{sum(same)}/{len(same)} leaves bit-equal; checkpoint "
            f"{nbytes} bytes (params + AdamW state), save {t_save:.3f} s, "
            f"restore {t_restore:.3f} s")
    assert got_loss == want_loss and all(same), line + " FAILED"
    log(line)


def sharded_train_phase(smi, full):
    """bench.py's way into training (see the module docstring); ``full``
    is the train phase's numbers. Returns the kernels' launches under
    bench.py's policy."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import create_mesh, initialize_distributed

    info = initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = create_mesh({"dp": 1})
        log(f"[sharded-train] world of {info.num_processes} NCCL rank "
            f"({dist.get_backend()}); mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}; "
            f"make_sharded_train_step(llama_loss, adamw(3e-4, "
            f"weight_decay=0.0), mesh, llama_param_specs(cfg)) as "
            f"bench.py:137-147")
        launches = {policy: _sharded_run(smi, mesh, policy, steps, full)
                    for policy, steps in SHARDED_RUNS}
        _resume_check(mesh)
    finally:
        dist.destroy_process_group()
    return launches[SHARDED_RUNS[0][0]]


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



# The tp phase (tensor parallelism). (a) tp = 1 over a one-rank NCCL
# world; (b) a two-rank gloo world sharing the one card, each rank a
# process of its own holding half the weights and its own pool; (c) the
# kernels at the ranks' shapes. TP_AGREE: the teacher-forced agreement a
# tp = 2 engine must reach against the tp = 1 engine's history (its
# bf16 partial sums are reduced in another order, so near ties flip).
TP_RANKS = 2
TP_AGREE = 0.8
# The tp = 2 train step against the one-rank step (rank 0 holds each of
# its gradient shards to the same region of the one-rank gradients with
# PARITY_MIN_COS): the relative loss and grad-norm limits sit between the
# sound readings (7.37e-6 / 2.43e-5 on an H100: only the order of the
# bf16 partial sums changes) and the planted faults' below (loss 8.37e-5
# with the partial sums unsummed, the only fault that moves it; norm
# 4.10e-2 and more; min cosine 0.707 and less against the sound 0.9999).
TP_LOSS_RTOL, TP_NORM_RTOL = 2.5e-5, 1e-3
# Planted faults of the tp layer: the gates of (b) must reject each (the
# train ones by loss, norm or a leaf's cosine; the serve one by TP_AGREE).
TP_TRAIN_FAULTS = ("kv-unsummed", "onehot-every-rank", "g-dropped")
TP_SERVE_FAULT = "wo-unsummed"
# B2 at a tp rank's heads of Llama-3-8B: tp = 2 (16 / 4) and tp = 4
# (8 / 2); the flash kernels at the flagship's 12 / 2 = 6 heads.
TP_B2_HEADS = ((16, 4), (8, 2))
TP_B2_CASES = tuple((pool, 1, 128) for pool in ("bf16", "int8"))
TP_FLASH_CASE = ("tp_flagship_h6", 8, 6, 6, 2048, 2048, 128, "bf16", True)


def _tp_world_one(smi, cfg, params, serve_tokens):
    """(a): the serve phase's dense and paged depth-2 engines built with
    tp=1, and the dense one with mesh=create_mesh({"tp": 1}), must repeat
    the serve phase's tokens bit for bit, launch B2 n_layers x decode
    iterations, replay their graphs and report tp_degree 1; a tp = 1
    paged int8 engine's history is kept for (b). Then the 2-layer
    flagship's first step through make_sharded_train_step over {"dp": 1,
    "tp": 1} must give make_train_step's loss bit for bit. Returns the
    histories (b) holds its engines to."""
    import torch.distributed as dist

    from ray_tpu_torch import adamw, llama_loss, make_sharded_train_step
    from ray_tpu_torch.models.llama import llama_init, llama_param_specs
    from ray_tpu_torch.parallel import (create_mesh, initialize_distributed,
                                        tp_group)
    from ray_tpu_torch.profile_train import (build_trainer, flagship_config,
                                             train_batch)

    prompts = serve_prompts(cfg.vocab_size)
    info = initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = create_mesh({"tp": 1})
        assert tp_group(mesh).size == 1
        runs = (("dense, depth 2", False, {"tp": 1}),
                ("paged, depth 2", True, {"tp": 1}),
                ("dense, depth 2", False, {"mesh": mesh}))
        for label, paged, kw in runs:
            eng, toks, run = _serve(params, cfg, prompts, paged=paged,
                                    depth=2, **kw)
            s = _check_run(f"tp {label}", cfg, eng, toks, run)
            knob = next(iter(kw))
            assert s["tp_degree"] == 1.0, s["tp_degree"]
            assert toks == serve_tokens[label], \
                f"tp {label} ({knob}=): tokens differ from the serve phase"
            log(f"[tp] (a) {label}, {knob}=1 on a world of "
                f"{info.num_processes} NCCL rank: tokens bit-equal to the "
                f"serve phase's; {run['launches']} B2 launches = "
                f"{cfg.n_layers} x {eng.decode_iterations} iterations; "
                f"{int(s['decode_graph_replays'])} graph replays; tp_degree "
                f"{s['tp_degree']}; steady {run['steady']:.1f} tokens/s; "
                f"on {smi}")
            del eng
            torch.cuda.empty_cache()
        eng, int8, _ = _serve(params, cfg, prompts, paged=True, depth=2,
                              kv_quant="int8")
        del eng
        torch.cuda.empty_cache()

        tcfg = flagship_config(n_layers=2)
        one = build_trainer(tcfg)
        batch = train_batch(tcfg)
        loss_one = one[2](one[0], one[1], batch)[2]["loss"].item()
        del one
        step_mesh = create_mesh({"dp": 1, "tp": 1})
        tp = tp_group(step_mesh)
        init_fn, step_fn = make_sharded_train_step(
            lambda p, b: llama_loss(p, b, tcfg, tp=tp),
            adamw(3e-4, weight_decay=0.0), step_mesh,
            llama_param_specs(tcfg))
        p, st = init_fn(llama_init(tcfg, seed=0, device="cuda"))
        loss_sh = step_fn(p, st, batch)[2]["loss"].item()
        del p, st
        torch.cuda.empty_cache()
        line = (f"[tp] (a) flagship at 2 layers, make_sharded_train_step "
                f"over {{'dp': 1, 'tp': 1}} with the tp loss: first loss "
                f"{loss_sh!r} vs make_train_step's {loss_one!r}")
        assert loss_sh == loss_one, line + " FAILED"
        log(line + ": bit-equal")
    finally:
        dist.destroy_process_group()
    return {"bf16": serve_tokens["paged, depth 2"], "int8": int8}


def _tp_fault(fault):
    """A planted fault of the tp layer, patched in for a ``with`` block:
    "kv-unsummed" cuts the replicated wk/wv to the rank's kv heads
    without f, so their partial gradients are not summed over tp;
    "onehot-every-rank" subtracts the target's one-hot in the
    vocab-parallel cross-entropy's backward on every rank, also where the
    rank does not hold the target's column (wrong lm_head columns);
    "g-dropped" leaves the wo and w_down partial sums of the train step
    unsummed; "wo-unsummed" leaves the serving layers' wo partial sums
    unsummed (w_down's still summed)."""
    from ray_tpu_torch.models import generate, llama
    from ray_tpu_torch.parallel import tensor_parallel as tpm

    if fault == "kv-unsummed":
        def cut(w, tp, cfg, dim):
            if not tpm.is_split(tp) or w.shape[dim] != cfg.n_kv_heads:
                return w
            kv = tpm.local_heads(cfg, None, tp.rank, tp.size)[1]
            return w.index_select(dim, torch.tensor(kv, device=w.device))
        return mock.patch.object(llama, "select_kv", cut)
    if fault == "onehot-every-rank":
        def backward(ctx, g):
            p, idx, _ = ctx.saved_tensors
            grad = p.clone()
            grad[torch.arange(grad.shape[0], device=grad.device), idx] -= 1
            return grad * g[:, None], None, None
        return mock.patch.object(tpm._VocabCrossEntropy, "backward",
                                 staticmethod(backward))
    if fault == "g-dropped":
        return mock.patch.object(llama, "reduce_from_tp", lambda x, tp: x)
    assert fault == "wo-unsummed", fault
    calls = [0]

    def every_other(x, tp):              # wo's comes first in each layer
        calls[0] += 1
        return x if calls[0] % 2 else tpm.reduce_from_tp(x, tp)
    return mock.patch.object(generate, "reduce_from_tp", every_other)


def _tp_train_grads(tcfg, batch, mesh, tp):
    """One make_sharded_train_step over the tp mesh from the seeded
    flagship weights: (loss, grad norm, this rank's gradient shards, its
    wq shard's shape, flash launches, ms). The gradients are read back
    from AdamW's first moment (b1 x 0 + (1 - b1) x g after one step)."""
    from ray_tpu_torch import adamw, llama_loss, make_sharded_train_step
    from ray_tpu_torch.models.llama import llama_init, llama_param_specs
    from ray_tpu_torch.models.training import _leaves
    from ray_tpu_torch.ops import flash_attention_kernel as fak

    opt = adamw(3e-4, weight_decay=0.0)
    init_fn, step_fn = make_sharded_train_step(
        lambda p, b: llama_loss(p, b, tcfg, tp=tp), opt, mesh,
        llama_param_specs(tcfg))
    params, state = init_fn(llama_init(tcfg, seed=0, device="cuda"))
    fak.fwd_launches = fak.dq_launches = fak.dkv_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m = step_fn(params, state, batch)
    loss, norm = m["loss"].item(), m["grad_norm"].item()
    ms = (time.perf_counter() - t0) * 1e3
    moments = opt.state_tree(state, params)["exp_avg"]
    grads = [g.detach() / (1 - opt.b1) for g in _leaves(moments)]
    return (loss, norm, grads, list(params["layers"]["wq"].shape),
            {"fwd": fak.fwd_launches, "dq": fak.dq_launches,
             "dkv": fak.dkv_launches}, ms)


def _named_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict in `_leaves`'s sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _tp_train_gate(got, one, mesh, specs):
    """(loss rel. error, norm rel. error, min cosine over the leaves and
    the leaf it falls on) of a tp step ``got`` against the one-rank
    step ``one`` = (loss, norm, full gradients), each gradient shard
    against its region of the full gradient."""
    from ray_tpu_torch.parallel.sharding import local_region

    loss, norm, grads = got[:3]
    cos = []
    for (name, spec), g, full in zip(specs, grads, one[2]):
        ref = full[local_region(full.shape, spec, mesh)]
        cos.append((torch.nn.functional.cosine_similarity(
            g.flatten().double(), ref.flatten().double(), dim=0).item(),
            name))
    worst = min(cos)
    return (abs(loss - one[0]) / abs(one[0]),
            abs(norm - one[1]) / abs(one[1]), worst[0], worst[1])


def _tp_train_ok(gate):
    return gate[0] <= TP_LOSS_RTOL and gate[1] <= TP_NORM_RTOL and \
        gate[2] >= PARITY_MIN_COS


def _agreement(a, b):
    return float(np.mean([x == y for p, q in zip(a, b)
                          for x, y in zip(p, q)]))


def tp_rank_main(rank, job_path):
    """One rank of (b), started by `tp_phase` as ``python3 chip_smoke.py
    --tp-rank RANK JOB``: a gloo world of TP_RANKS processes on the one
    card (gloo takes CUDA tensors for all_reduce and broadcast; NCCL
    refuses two ranks on one device). Writes what it saw to the job's
    ``out`` directory."""
    import torch.distributed as dist

    from ray_tpu_torch import DecodeEngine, llama_loss
    from ray_tpu_torch.models.llama import (LlamaConfig, llama_init,
                                            llama_param_specs)
    from ray_tpu_torch.models.training import _leaves, _tree_map
    from ray_tpu_torch.ops import paged_attention_kernel as pak
    from ray_tpu_torch.parallel import create_mesh, tp_group
    from ray_tpu_torch.profile_train import flagship_config, train_batch

    with open(job_path) as f:
        job = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo",
                            init_method=job["store"], world_size=TP_RANKS,
                            rank=rank)
    out = {"rank": rank}
    try:
        mesh = create_mesh({"tp": TP_RANKS})
        tp = tp_group(mesh)
        assert tp.size == TP_RANKS and not tp.capturable

        # the small phase's f32 model, dense and paged == solo generate
        scfg, sparams, sprompts, solo = small_model()
        for paged in (False, True):
            eng = DecodeEngine(sparams, scfg, batch_slots=4, max_len=128,
                               kv_block_tokens=16, paged=paged, mesh=mesh)
            ids = [eng.submit(p, 15) for p in sprompts]
            got = eng.run()
            assert [got[i] for i in ids] == solo, \
                f"rank {rank}: small tp engine (paged={paged}) != solo"
            assert eng.stats()["decode_graphs"] == 0
        del sparams, eng
        out["small"] = True

        # Llama-3-8B, paged bf16 and int8, on the serve traffic
        cfg = LlamaConfig.llama3_8b()
        params = llama_init(cfg, seed=0, device="cuda", dtype=cfg.dtype)
        prompts = serve_prompts(cfg.vocab_size)
        out["serve"] = {}
        for quant in ("bf16", "int8"):
            kq = None if quant == "bf16" else quant
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng, toks, run = _serve(params, cfg, prompts, paged=True,
                                    depth=2, kv_quant=kq, mesh=mesh)
            wall = time.perf_counter() - t0
            s = eng.stats()
            want = cfg.n_layers * eng.decode_iterations
            assert run["launches"] == want, (quant, run["launches"], want)
            assert run["gets"] == eng.decode_dispatches
            assert eng.kv_pool.blocks_in_use == 0, eng.kv_pool.blocks_in_use
            assert s["tp_degree"] == TP_RANKS and s["decode_graphs"] == 0
            assert all(len(t) == NEW_TOKENS for t in toks)
            local = list(eng._pool_k.shape)
            wq = list(eng.params["layers"]["wq"].shape)
            del eng
            torch.cuda.empty_cache()
            ref = job["history"][quant]
            picks, _ = _forced_picks(params, cfg, prompts, ref, kq,
                                     prefill_chunk=None, mesh=mesh)
            forced = float((picks == np.asarray(ref)).mean())
            out["serve"][quant] = {
                "tokens": toks, "launches": run["launches"],
                "iterations": want // cfg.n_layers, "wall": wall,
                "steady": run["steady"], "forced": forced,
                "free": _agreement(toks, ref), "pool": local, "wq": wq,
                "peak": torch.cuda.max_memory_allocated()}

        # the planted serving fault against the same gate
        with _tp_fault(TP_SERVE_FAULT):
            picks, _ = _forced_picks(params, cfg, prompts,
                                     job["history"]["bf16"], None,
                                     prefill_chunk=None, mesh=mesh)
        out["serve_fault"] = float(
            (picks == np.asarray(job["history"]["bf16"])).mean())
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # the flagship at 2 layers: one tp step against the one-rank
        # step, sound and under each planted fault
        tcfg = flagship_config(n_layers=2)
        batch = train_batch(tcfg)
        torch.cuda.reset_peak_memory_stats()
        sound = _tp_train_grads(tcfg, batch, mesh, tp)
        loss, norm, _, wq, launches, ms = sound
        out["train"] = {"loss": loss, "norm": norm, "ms": ms, "wq": wq,
                        "launches": launches,
                        "peak": torch.cuda.max_memory_allocated()}
        faults = {}
        for fault in TP_TRAIN_FAULTS:
            with _tp_fault(fault):
                faults[fault] = _tp_train_grads(tcfg, batch, mesh, tp)
        if rank == 0:
            # the one-rank gradients, with the one-rank step's loss and
            # norm (`make_train_step`'s are llama_loss and the global norm)
            p1 = _tree_map(lambda p: p.requires_grad_(True),
                           llama_init(tcfg, seed=0, device="cuda"))
            l1 = llama_loss(p1, batch, tcfg)
            g1 = torch.autograd.grad(l1, _leaves(p1))
            one = (l1.item(), torch.nn.utils.get_total_norm(g1).item(), g1)
            specs = _named_leaves(llama_param_specs(tcfg))
            out["train"]["one"] = [one[0], one[1]]
            out["train"]["gate"] = _tp_train_gate(sound, one, mesh, specs)
            out["train"]["faults"] = {
                f: _tp_train_gate(got, one, mesh, specs)
                for f, got in faults.items()}
            del p1, g1, one
        del sound, faults
        torch.cuda.empty_cache()
        out["pak_launches_total"] = pak.launches
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def _tp_world_two(smi, history):
    """(b): TP_RANKS rank processes on the one card; returns rank 0's
    results after checking every rank's."""
    import os
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"store": f"tcp://127.0.0.1:{_free_port()}",
                       "out": tmp, "history": history}, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
             job], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(TP_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0].decode())
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, \
                f"[tp] rank {r} exited {p.returncode}:\n{text[-6000:]}"
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    first = ranks[0]
    for other in ranks[1:]:
        for quant in ("bf16", "int8"):
            assert other["serve"][quant]["tokens"] == \
                first["serve"][quant]["tokens"], f"ranks differ ({quant})"
        assert other["train"]["loss"] == first["train"]["loss"]
    log(f"[tp] (b) {TP_RANKS} rank processes on one card in a gloo world "
        f"(cpu:gloo,cuda:gloo) over CUDA tensors; the small f32 model, "
        f"dense and paged at tp={TP_RANKS}: == solo generate on every rank;"
        f" decode loops eager (gloo collectives cannot be captured)")
    for quant in ("bf16", "int8"):
        r = first["serve"][quant]
        line = (f"[tp] (b) Llama-3-8B paged {quant} at tp={TP_RANKS}: pool "
                f"per rank {r['pool']} (kv heads {r['pool'][3]} of 8), wq "
                f"{r['wq']}; {r['launches']} B2 launches = 32 x "
                f"{r['iterations']} iterations (H 16 / KV 4), every block "
                f"back; teacher-forced agreement with the tp=1 engine's "
                f"history {r['forced']:.4f} (>= {TP_AGREE}), free-running "
                f"{r['free']:.4f}; serve wall {r['wall']:.2f} s, steady "
                f"{r['steady']:.1f} tokens/s; peak memory per rank "
                + ", ".join(f"{x['serve'][quant]['peak'] / 2**30:.2f}"
                            for x in ranks)
                + f" GiB; on {smi} (two processes share one card's time and "
                "gloo stages every collective through the host: these "
                "times say nothing of tp's speed on several cards)")
        assert r["forced"] >= TP_AGREE, line + " FAILED"
        log(line)
    line = (f"[tp] (b) planted fault {TP_SERVE_FAULT} (paged bf16): "
            f"teacher-forced agreement {first['serve_fault']:.4f} "
            f"(rejected below {TP_AGREE})")
    assert first["serve_fault"] < TP_AGREE, line + " NOT REJECTED"
    log(line)
    t = first["train"]
    lo, no = t["one"]
    le, ne, cos, leaf = t["gate"]
    line = (f"[tp] (b) flagship at 2 layers, full width, tp={TP_RANKS} "
            f"(wq per rank {t['wq']}; B1/B3 at H=6): one step's loss "
            f"{t['loss']:.6f} vs the one-rank step's {lo:.6f} (relative "
            f"{le:.3e} <= {TP_LOSS_RTOL}), grad norm {t['norm']:.6f} vs "
            f"{no:.6f} ({ne:.3e} <= {TP_NORM_RTOL}), rank 0's gradient "
            f"shards against their regions of the one-rank gradients: min "
            f"cosine {cos:.6f} ({leaf}; >= {PARITY_MIN_COS}); kernel "
            f"launches {t['launches']}; step {t['ms']:.1f} ms, peak memory "
            "per rank "
            + ", ".join(f"{x['train']['peak'] / 2**30:.2f}" for x in ranks)
            + " GiB (two processes on one card, gloo: not a speed)")
    assert _tp_train_ok(t["gate"]), line + " FAILED"
    assert t["launches"] == {"fwd": 4, "dq": 2, "dkv": 2}, line + " FAILED"
    log(line)
    for fault, gate in t["faults"].items():
        line = (f"[tp] (b) planted fault {fault}: loss {gate[0]:.3e}, norm "
                f"{gate[1]:.3e}, min cosine {gate[2]:.6f} ({gate[3]})")
        assert not _tp_train_ok(gate), line + " NOT REJECTED"
        log(line + ": rejected")
    return first


def tp_phase(smi, cfg, holder, serve_tokens):
    """The tp phase (see the module docstring). ``holder`` is a list
    holding the only reference to the 8B weights, which (b) frees before
    its ranks build theirs. Returns {"serve": B2 launches of rank 0's
    bf16 run, "train": the flash kernels' launches of its step}; (c)'s
    kernel cases are checked and printed."""
    history = _tp_world_one(smi, cfg, holder[0], serve_tokens)
    holder.clear()
    gc.collect()
    torch.cuda.empty_cache()
    first = _tp_world_two(smi, history)
    for h, kv in TP_B2_HEADS:
        kernel_phase(TP_B2_CASES, h, kv, phase="tp")
    flash_phase([TP_FLASH_CASE], (TP_FLASH_CASE[0],), phase="tp")
    return {"serve": first["serve"]["bf16"]["launches"],
            "train": first["train"]["launches"]}


# --tp-cards N: the serve traffic at tp = N over NCCL, one rank a card.
# A rank that has not finished within TP_CARDS_LIMIT_S of its start is
# killed; from its eager rerun on, each rank dumps its threads' stacks
# every TP_CARDS_TRACE_S into its trace file, which the parent prints.
TP_CARDS_LIMIT_S, TP_CARDS_TRACE_S = 240, 20


def _first_tokens_profile(eng, prompts):
    """Serve the prompts on ``eng``; the steps up to the last request's
    first token run under torch.profiler. Returns that window's host
    seconds and steps, the card's busy share in it, its NCCL kernels'
    ms and its five costliest device ops (ms)."""
    from torch.profiler import ProfilerActivity, profile

    ids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    seen, steps = set(), 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while len(seen) < len(ids):
            seen.update(eng.step())
            steps += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    while eng.pending():
        eng.step()
    for i in ids:
        eng.pop_result(i)
    dev = [(e.self_device_time_total / 1e3, e.key)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for ms, _ in dev)
    return {"wall": wall, "steps": steps, "busy": busy / 1e3 / wall,
            "nccl_ms": sum(ms for ms, k in dev if "nccl" in k.lower()),
            "top": [[round(ms, 3), k[:60]] for ms, k in sorted(dev)[-5:]]}


def tp_card_rank_main(rank, job_path):
    """One rank of ``--tp-cards``: card ``rank`` of an NCCL world. Each
    layout serves the traffic on one tp engine three times (a warm-up
    with the first-use captures, a timed run, a run whose first tokens
    are profiled); rank 0 then serves it on a one-card engine (warm-up,
    timed). Results go to ``rank<k>.json`` before the last part, the
    paged engine served again with its loop forced eager. Each milestone
    and eager step goes with its host time to ``rank<k>.progress``;
    from the eager rerun until the process group is destroyed the
    rank's stacks are dumped every TP_CARDS_TRACE_S to ``rank<k>.trace``.
    """
    import faulthandler

    import torch.distributed as dist

    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.parallel import create_mesh, initialize_distributed

    with open(job_path) as f:
        job = json.load(f)
    out = job["out"]
    log_f = open(f"{out}/rank{rank}.progress", "w", buffering=1)

    def mark(what):
        log_f.write(f"{time.perf_counter():.3f} {what}\n")

    torch.cuda.set_device(rank)
    initialize_distributed(job["store"], job["tp"], rank)
    mark("initialized")
    cfg = LlamaConfig.llama3_8b()
    params = llama_init(cfg, seed=0, device="cuda", dtype=cfg.dtype)
    prompts = serve_prompts(cfg.vocab_size)
    mesh = create_mesh({"tp": job["tp"]})
    res, engines = {"rank": rank}, {}
    for label, paged in (("dense", False), ("paged", True)):
        eng, _, warm = _serve(params, cfg, prompts, paged=paged, depth=2,
                              mesh=mesh)
        iters = eng.decode_iterations
        _, toks, run = _drive(eng, prompts, NEW_TOKENS)
        s = eng.stats()
        res[label] = {
            "warm_ttft": warm["ttft_p50"], "ttft": run["ttft_p50"],
            "steady": run["steady"], "wall": run["wall"],
            "launches": run["launches"],
            "want": cfg.n_layers * (eng.decode_iterations - iters),
            "graphs": s["decode_graphs"],
            "replays": s["decode_graph_replays"], "tokens": toks,
            "peak": run["peak"],
            "first": _first_tokens_profile(eng, prompts)}
        engines[label] = eng
        mark(f"{label} runs done")
    dist.barrier()
    if rank == 0:
        for label, paged in (("dense", False), ("paged", True)):
            one, _, warm = _serve(params, cfg, prompts, paged=paged,
                                  depth=2)
            _, toks, run = _drive(one, prompts, NEW_TOKENS)
            res[label]["one"] = {"warm_ttft": warm["ttft_p50"],
                                 "ttft": run["ttft_p50"],
                                 "steady": run["steady"], "tokens": toks}
            del one
            torch.cuda.empty_cache()
    dist.barrier()
    mark("one-card runs done")
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    # the paged engine again, eager, each step logged; stacks dumped
    # until the process group is gone
    eng = engines["paged"]
    eng._graphs = None
    trace = open(f"{out}/rank{rank}.trace", "w")
    faulthandler.dump_traceback_later(TP_CARDS_TRACE_S, repeat=True,
                                      file=trace)
    step = eng.step

    def logged():
        mark(f"step at {eng.decode_iterations} iterations")
        got = step()
        torch.cuda.synchronize()
        return got

    eng.step = logged
    _, toks, _ = _drive(eng, prompts, NEW_TOKENS)
    with open(f"{out}/rank{rank}.eager.json", "w") as f:
        json.dump({"tokens": toks}, f)
    mark("eager rerun done")
    dist.barrier()
    mark("barrier passed")
    dist.destroy_process_group()
    mark("process group destroyed")
    faulthandler.cancel_dump_traceback_later()


def tp_cards_main(n):
    """``python3 chip_smoke.py --tp-cards N``: Llama-3-8B on the serve
    traffic at tp = N over NCCL, one rank process a card, against a
    one-card engine in the same call; prints each layout's TTFT p50 of
    the warm-up and of the timed run, its steady rate, its first tokens'
    profile, B2's launches and the eager rerun's outcome."""
    import os
    import sys
    import tempfile

    name, count, smi = device_phase()
    if count < n:
        raise SystemExit(f"--tp-cards {n} needs {n} cards, {count} seen")
    build_phase()
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"store": f"tcp://127.0.0.1:{_free_port()}",
                       "tp": n, "out": tmp}, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-card-rank",
             str(r), job], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]
        deadline, logs, hung = time.monotonic() + TP_CARDS_LIMIT_S, [], False
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(1, deadline - time.monotonic()))[0].decode())
            except subprocess.TimeoutExpired:
                hung = True
                p.kill()
                logs.append(p.communicate()[0].decode())
        for p in procs:
            p.kill()
            p.wait()

        def read(r, ext):
            path = os.path.join(tmp, f"rank{r}.{ext}")
            return open(path).read() if os.path.exists(path) else None

        ranks = [read(r, "json") for r in range(n)]
        r0 = json.loads(ranks[0]) if ranks[0] else None
        for label in ("dense", "paged") if r0 else ():
            x, one = r0[label], r0[label]["one"]
            f = x["first"]
            log(f"[tp-cards] {label}, tp={n} over NCCL: TTFT p50 warm-up "
                f"{x['warm_ttft']:.4f} s, timed {x['ttft']:.4f} s (one "
                f"card: {one['warm_ttft']:.4f} / {one['ttft']:.4f}); steady"
                f" {x['steady']:.1f} tokens/s (one card {one['steady']:.1f})"
                f"; B2 {x['launches']} = {x['want']}; graphs "
                f"{x['graphs']:.0f}, replays {x['replays']:.0f}; peak "
                f"{x['peak'] / 2**30:.2f} GiB a rank; first tokens equal "
                f"{sum(a[0] == b[0] for a, b in zip(x['tokens'], one['tokens']))}"
                f"/{N_REQUESTS}; first-token window (profiled run) "
                f"{f['wall']:.4f} s in {f['steps']} steps, card busy "
                f"{f['busy']:.3f}, NCCL {f['nccl_ms']:.1f} ms, top device "
                f"ops {f['top']}; on {smi}")
            assert x["launches"] == x["want"], label
            for other in ranks[1:]:
                assert json.loads(other)[label]["tokens"] == x["tokens"]
        eager = [read(r, "eager.json") for r in range(n)]
        if r0 and all(eager):
            same = json.loads(eager[0])["tokens"] == r0["paged"]["tokens"]
            log(f"[tp-cards] paged, eager rerun: finished on every rank; "
                f"tokens equal to the captured run's: {same}")
        if hung or not (r0 and all(eager)):
            for r in range(n):
                prog = (read(r, "progress") or "(none)").splitlines()
                log(f"[tp-cards] rank {r} progress (host clock; last 6 "
                    f"of {len(prog)} lines): {prog[:1] + prog[-6:]}")
                log(f"[tp-cards] rank {r} stacks (last dump):\n"
                    + (read(r, "trace") or "(none)")[-3000:])
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode and not hung:
                log(f"[tp-cards] rank {r} exited {p.returncode}:\n"
                    f"{text[-4000:]}")
        assert r0 and all(eager) and not hung, \
            f"[tp-cards] FAILED (hung: {hung})"
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


def _kernel_entry(name, source, replaces, launches, res, by_path=None):
    """One kernel's entry of the kernels line: ``launches`` on the main
    path; ``by_path`` the launches of each path that runs the kernel at
    the timed shape, the main path's included."""
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": res["max_abs_err"], "ms": res["ms"],
           "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
           "bound_by": res["bound_by"],
           "library_ms": res.get("library_ms")}
    if by_path is not None:
        out["launches_by_path"] = by_path
    return out


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
    cfg, params = phase("init", llama3_8b)
    launches, serve_rates, paged_run = phase("serve", serve_phase, smi, cfg,
                                             params)
    phase("kvmem", kvmem_phase, smi, cfg, params)
    spec_launches = phase("spec", spec_phase, smi, cfg, params, serve_rates)
    lora_launches = phase("lora", lora_phase, smi, cfg, params)
    fleet_launches = phase("fleet", fleet_phase, smi, cfg, params,
                           paged_run)
    # the tp phase frees the weights before its ranks build theirs
    holder = [params]
    del params
    tp_launches = phase("tp", tp_phase, smi, cfg, holder,
                        paged_run["tokens"])
    # kvmem's swap watchers tie engines (and through them the weights)
    # in reference cycles: collect them before the train phase measures
    # its peak memory
    gc.collect()
    torch.cuda.empty_cache()
    tlaunches, full = phase("train", train_phase, smi)
    slaunches = phase("sharded-train", sharded_train_phase, smi, full)
    llaunches = phase("lora-train", lora_train_phase, smi, full)
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
                      launches, kres[("bf16", 1, D)],
                      # the multi-LoRA path: engine (a)'s timed run; the
                      # fleet: colocated fleet (a), both replicas; tp:
                      # rank 0 of the tp=2 paged bf16 run (H 16 / KV 4)
                      {"serve": launches, "lora": lora_launches,
                       "fleet": fleet_launches,
                       "tp": tp_launches["serve"]}),
        # the speculative path: engine (a)'s launches, the verify pass's
        # shape (S = 5) timed
        _kernel_entry("paged_attention (speculative round, S=5 verify)",
                      "ray_tpu_torch/csrc/paged_attention.cu",
                      "ray_tpu/ops/paged_attention_kernel.py:104",
                      spec_launches, kres[("bf16", 5, D)]),
    ] + [
        # the sharded and the adapter-only train steps run the same
        # kernels and shapes; the tp step (rank 0) at H = 6
        _kernel_entry(name, sm90_src, f"{flash_py}:{line}", tlaunches[key],
                      main_flash[key], {"train": tlaunches[key],
                                        "sharded-train": slaunches[key],
                                        "lora-train": llaunches[key],
                                        "tp": tp_launches["train"][key]})
        for name, line, key in (("flash_fwd", 130, "fwd"),
                                ("flash_bwd_dq", 192, "dq"),
                                ("flash_bwd_dkv", 239, "dkv"))
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--tp-card-rank"]:
        tp_card_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--tp-cards"]:
        tp_cards_main(int(sys.argv[2]))
    else:
        main()
