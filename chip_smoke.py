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
 16. long-context — sequence parallelism on bench.py's flagship at full
               widths, one sequence of 32768 tokens. (a) A world of one
               NCCL rank, make_sharded_train_step over {"sp": 1} with
               batch_logical ("batch", "length"), 16 layers, bench.py's
               policy, adamw(3e-4): attn_impl "flash", "ring" and
               "ulysses", one warm-up and 3 timed steps each; ring and
               Ulysses must give flash's first loss within 1e-6
               relative, the loss must fall, the kernels launch as in
               the train phase and the plain attention never runs.
               Prints step ms, tokens/s, MFU at S = 32768 and peak
               memory. (b) The ring's own code looped over 4 blocks in
               this process (`LocalRing`: the same B1/B3 calls, masks
               and f32 merge) against whole-sequence flash: loss, grad
               norm and every gradient leaf within the parity limits;
               the per-block calls must match the schedule (causal on
               the diagonal block, non-causal on past blocks, future
               blocks skipped) and so must the kernels' launch counts;
               then Llama-3-8B's forward at its 8192-token context, bf16
               weights, through the same ring against flash (logits max
               error and argmax agreement). (c) Two rank processes
               (this script with --sp-rank) share the card in a gloo
               world, sp = 2: the flagship at 2 layers and 8192 tokens,
               ring and Ulysses, one step each through
               make_sharded_train_step; loss, grad norm and every
               gradient leaf against the one-rank flash step, and each
               planted fault of SP_FAULTS (a past block run causal, dk/dv
               not rotated home, positions left local, Ulysses's second
               all-to-all skipped) must fail that gate. Then B1, B3a and
               B3b (bf16 and f32 gradients) at the ring's block shapes
               [1, 12, 8192, 128], causal and non-causal, against their
               plain versions, timed beside their bounds and SDPA.
 17. moe     — Mixtral-8x7B's published widths (vocab 32000, dim 4096,
               32/8 heads, ffn 14336, 8 experts, top-2, capacity 1.25)
               cut to MOE_LAYERS of 32 layers, a seeded batch of 2 x 2048
               tokens (G = 4096, capacity 1280). (a) One step's loss and
               gradients with the kernels against the plain attention
               (the parity limits), the dropped-token share, then steps
               through make_sharded_train_step over {"dp": 1, "ep": 1} on
               one NCCL rank: launches, step ms, MFU on active params,
               peak memory. (b) Two rank processes (--moe-rank) on the
               card in a gloo world at 1 layer, each first computing the
               one-rank step itself: ep = 2 (4 experts a rank, the real
               step) and dp = 2 (the step's own plan without its
               optimizer: global capacity over the row shards) held to it
               by loss, norm and gradient cosine (MOE_*), and each
               planted fault of MOE_FAULTS (the combine's all-reduce
               skipped, the router's ep gradient summed twice, each row
               shard routed on its own) must fail that gate.
 18. pipeline — bench.py's flagship at 16 layers (full remat) as a GPipe
               pipeline (`make_pipelined_fn`, a stage a loop over its
               decoder layers; embedding, final norm, head and loss
               outside), batch 8 x 2048 in PP_MICRO microbatches. (a) pp =
               1 on one NCCL rank against make_train_step's loss and
               gradients (parity limits), then timed: launches, step ms,
               MFU. (b) pp = 2 as two gloo rank processes (--pp-rank, 8
               layers a stage) against the one-card step, and the planted
               faults of PP_FAULTS (a hand-off a tick late, the
               backward's hand-off dropped) must fail it; the stages'
               forward share of each step against GPipe's bubble.
 19. vit-t5-mlp — B1/B3 at the new shapes (ViT D = 32 bf16 and f32, T5's
               encoder, decoder and cross-attention, the pipeline's
               microbatch; the D = 32 fault of columns past 32 read as
               live must fail the check), then ViTConfig(), T5Config() and
               MLPConfig() at their defaults: kernels against the plain
               attention (the MLP against the CPU), steps over {"dp": 1}
               on one NCCL rank with their launches, and t5_generate's
               greedy tokens against an uncached argmax rollout through
               t5_forward (f32: equal; bf16: agreement printed).
 20. rllib   — f32, TF32 off, learner and runner on the card: (a) PPO
               learns CartPole; (b) one training_step of every ported
               algorithm (on-policy, imitation, DQN with and without
               PER, DDPG, TD3, SAC, CQL) on a fixed input, card against
               the CPU: first-update gradients and metrics (SAC and CQL
               in float64), weights and target weights, with three
               planted faults (TF32 on, PPO's advantages unstandardized,
               a target synced in place) that must fail; the V-trace
               loop timed; (c) ES's perturbed rollouts; (d) DQN learns
               GridWorld (rolling > 0.3, greedy > 0.9). Prints ms per
               update and env steps/s.
 21. train-data — the device pieces of Train, Data and channels: a
               seeded source's batches on the card through pinned
               memory (and 4 dp ranks' regions) equal to the source,
               TorchPredictor from a dict and an array checkpoint, and
               f32 / bf16 tensors through DeviceChannel over a host queue
               back bit-equal. Prints GB/s and ms.
 22. rllib-c — QMIX, AlphaZero and DreamerV3 on the card, f32, TF32 off:
               (a) one fixed update of each (DreamerV3: a whole train
               with seeded Gumbel draws), card against the CPU: float64
               gradients, metrics, weights, QMIX's target, DreamerV3's
               slow critic and return EMA; (b) three planted faults that
               must fail (QMIX's mixer without abs, DreamerV3's
               straight-through without its stop-gradient, AlphaZero's
               value head without tanh); (c) QMIX solves CoopPress,
               DreamerV3's world model learns CartPole, AlphaZero beats
               random at TicTacToe, at the JAX tests' settings. Prints
               ms per update, train call, predictor call and game, and
               env steps/s.
`--ep-cards N` and `--pp-cards N` run the moe and pipeline models over N
cards (NCCL, one rank process a card) beside one card's step.
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
# The other model families' shapes: ViT's default config (6 heads of
# head dim 32 over 65 tokens, batch 256), bf16 and f32, and T5's default
# config (8 heads of 64) at batch 32 with 512 source and 128 target
# tokens: the encoder, the causal decoder and the cross-attention (Sq
# 128 over Sk 512); the pipeline's microbatch of the flagship (2 of its 8
# rows). Mixtral's attention is b_llama3_8b's shape.
A13_FLASH_CASES = [
    ("vit_d32", 256, 6, 6, 65, 65, 32, "bf16", False),
    ("vit_d32_f32", 256, 6, 6, 65, 65, 32, "f32", False),
    ("t5_enc", 32, 8, 8, 512, 512, 64, "bf16", False),
    ("t5_dec", 32, 8, 8, 128, 128, 64, "bf16", True),
    ("t5_cross", 32, 8, 8, 128, 512, 64, "bf16", False),
    ("pp_micro", 2, 12, 12, 2048, 2048, 128, "bf16", True),
]
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


def _sanitized_rerun(label, eng, prompts, want, smi):
    """The engine, after its timed run, serves the prompts again with the
    runtime sanitizer armed (strict, sync debug mode "error"): no new
    dispatch key or capture, no unexpected transfer or sync, the same
    tokens. Then a stray ``.item()`` planted in its decode dispatch must
    raise `SanitizerError` (the engine is not used after it)."""
    from ray_tpu_torch._private.sanitize import SanitizerError

    def rerun():
        t0 = time.perf_counter()
        ids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        while eng.pending():
            eng.step()
        toks = [eng.pop_result(i) for i in ids]
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    plain, plain_wall = rerun()
    san = eng.arm_sanitizer()
    try:
        toks, wall = rerun()
    finally:
        eng.disarm_sanitizer()
    st = san.stats()
    log(f"[serve] {label}, sanitizer armed: new keys {st['retraces']}, "
        f"unexpected transfers {st['unexpected_transfers']}, unexpected "
        f"syncs {st['unexpected_syncs']} (sync debug mode "
        f"{'error' if st['sync_debug'] else 'off'}), expected pulls "
        f"{st['expected_pulls']}, async copies {st['expected_async']}; "
        f"tokens equal to the unsanitized run: {toks == want}; wall "
        f"{wall:.3f} s against {plain_wall:.3f} s unsanitized (both "
        f"warm); on {smi}")
    assert st["sync_debug"] and st["watched"], st
    assert san.total_retraces() == 0, st
    assert st["unexpected_transfers"] == st["unexpected_syncs"] == 0, st
    assert st["expected_pulls"] == st["expected_async"] > 0, st
    assert toks == want == plain, f"{label}: sanitized tokens differ"
    dispatch = eng._dispatch_decode

    def stray(*args, **kw):
        eng._last_logits[0, 0].item()
        return dispatch(*args, **kw)

    eng._dispatch_decode = stray
    eng.arm_sanitizer()
    try:
        eng.submit(prompts[0], NEW_TOKENS)
        raised = None
        try:
            while eng.pending():
                eng.step()
        except SanitizerError as e:
            raised = e
    finally:
        eng.disarm_sanitizer()
        del eng._dispatch_decode
    log(f"[serve] {label}, planted stray .item() in the decode dispatch: "
        f"{'raised SanitizerError' if raised else 'NOT caught'}")
    assert raised is not None, f"{label}: the planted pull was not caught"


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
    tokens, runs, rates, kept = {}, {}, {}, {}
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
        if depth == 2:
            kept[label] = eng
        del eng
        torch.cuda.empty_cache()
    for label, eng in kept.items():
        _sanitized_rerun(label, eng, prompts, tokens[label], smi)
    kept.clear()
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


def _flash_bound_ms(kernel, B, H, Hkv, Sq, Sk, D, causal, dtype,
                    grad_item=None):
    """Least time of one kernel on these inputs: each input read once and
    each output written once over the memory rate, or its products over
    the tensor rate (2 flop per multiply-add per unmasked pair and head
    dim: 2 products in the forward, s/dp/dq in dq, s/dp/dv/dk in dk/dv),
    whichever is larger. ``grad_item``: bytes per gradient element when
    the gradients are written in another dtype than the inputs (4 for
    f32 gradients of bf16 inputs). Returns (ms, bound_by)."""
    item = 2 if dtype == "bf16" else 4
    g_item = grad_item or item
    q_b, kv_b, rows = B * H * Sq * D * item, B * Hkv * Sk * D * item, \
        B * H * Sq * 4
    dq_b, dkv_b = B * H * Sq * D * g_item, B * Hkv * Sk * D * g_item
    products, nbytes = {
        "fwd": (2, 2 * q_b + 2 * kv_b + rows),     # q, k, v -> o, lse
        "dq": (3, 2 * q_b + dq_b + 2 * kv_b + 2 * rows),  # q, dO, k, v,
                                                   # lse, delta -> dq
        "dkv": (4, 2 * q_b + 2 * kv_b + 2 * dkv_b + 2 * rows),  # -> dk, dv
    }[kernel]
    flops = products * 2 * D * B * H * _flash_pairs(Sq, Sk, causal)
    rate = BF16_FLOPS_PER_S if dtype == "bf16" else F32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _time_flash(q, k, v, do, o, lse, scale, causal, gqa, f32_grads=False):
    """CUDA-event ms of each kernel, its plain version and torch's SDPA
    forward and backward on the same inputs; with ``f32_grads`` also the
    backward kernels and their plain version writing f32 gradients (no
    library call computes those)."""
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
    if f32_grads:
        f32 = torch.float32
        t.update({
            "dq_f32": _time_ms(lambda: fak.flash_bwd_dq_kernel(
                q, k, v, do, lse, delta, scale, causal, f32), 20),
            "dkv_f32": _time_ms(lambda: fak.flash_bwd_dkv_kernel(
                q, k, v, do, lse, delta, scale, causal, f32), 20),
            "plain_bwd_f32": _time_ms(lambda: fa._flash_bwd_reference(
                q, k, v, o, lse, do, scale, causal, delta=delta,
                grad_dtype=f32), 3)})
    sdpa = dict(is_causal=causal, scale=scale, enable_gqa=gqa)
    t["sdpa_fwd"] = _time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), 20)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, **sdpa)
    t["sdpa_bwd"] = _time_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 20)
    return t


def _rel(got, want):
    """||got - want|| / ||want||, in f64."""
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def _rel_family(key):
    if key in ("o", "lse"):
        return key
    return "f32_grads" if key.endswith("_f32") else "grads"


# the outputs each kernel writes, by the keys of flash_phase's pairs
_KERNEL_KEYS = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv"),
                "dq_f32": ("dq_f32",), "dkv_f32": ("dk_f32", "dv_f32")}


def _planted_flash(q, k, v, o, lse, do, scale, causal, fault, f32_grads):
    """The kernels' outputs under a planted fault, by flash_phase's keys,
    and the first q row to compare: "scale" runs them at 1.01 x the
    softmax scale; "tile" drops the first LC_FAULT_TILE keys (k and v
    without them; causal rows then see keys LC_FAULT_TILE..i, and the
    dropped keys' dk/dv are 0), compared from that row on."""
    from ray_tpu_torch.ops import flash_attention as fa

    t = LC_FAULT_TILE
    if fault == "scale":
        kk, vv, sc, row0 = k, v, scale * 1.01, 0
    else:
        assert fault == "tile", fault
        kk, vv, sc, row0 = (k[:, :, t:].contiguous(), v[:, :, t:].contiguous(),
                            scale, t)
    fo, flse = fa._flash_fwd(q, kk, vv, sc, causal, with_lse=True)
    out = {"o": fo, "lse": flse}
    for sfx, gd in (("", None),) + ((("_f32", torch.float32),)
                                     if f32_grads else ()):
        dq, dk, dv = fa._flash_bwd(q, kk, vv, o, lse, do, sc, causal,
                                   grad_dtype=gd)
        if fault == "tile":
            dk, dv = (torch.cat([x.new_zeros(x.shape[:2] + (t,) + x.shape[3:]),
                                 x], dim=2) for x in (dk, dv))
        out.update({f"dq{sfx}": dq, f"dk{sfx}": dk, f"dv{sfx}": dv})
    return out, row0


def _d32_fault_rejected(phase, name, q, k, v, do, scale, causal, pairs,
                        tol):
    """A planted D = 32 fault: the columns past 32 of a 64-column tile
    read as live (q, k, v and dO padded to 64 with random columns, the
    D = 64 kernels run at D = 32's scale, the outputs cut back to 32
    columns). The elementwise check against the plain versions must
    fail for every kernel."""
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(32)

    def pad(x):
        return torch.cat([x, torch.randn(x.shape, generator=g,
                                         device="cuda").to(x.dtype)], -1)

    qp, kp, vp, dop = (pad(x) for x in (q, k, v, do))
    fo, flse = fa._flash_fwd(qp, kp, vp, scale, causal, with_lse=True)
    fdq, fdk, fdv = fa._flash_bwd(qp, kp, vp, fo, flse, dop, scale, causal)
    got = {"o": fo[..., :32], "lse": flse, "dq": fdq[..., :32],
           "dk": fdk[..., :32], "dv": fdv[..., :32]}
    errs = {}
    for key, _, want in pairs:
        want = want.float()
        err = (got[key].float() - want).abs()
        errs[key] = (err.max().item(),
                     bool((err <= tol + tol * want.abs()).all()))
    log(f"[{phase}] {name}: planted fault (columns past 32 live): max_abs_err "
        + ", ".join(f"{k_} {e:.3e}" for k_, (e, _) in errs.items()))
    for kern, keys in (("fwd", ("o", "lse")), ("dq", ("dq",)),
                       ("dkv", ("dk", "dv"))):
        assert not all(errs[k_][1] for k_ in keys), \
            f"[{phase}] {name}: the D = 32 fault passed {kern}'s check"


def _rel_check(phase, name, pairs, planted, limits):
    """Each output's relative error against its plain version, sound and
    under each planted fault ({fault: (outputs, row0)}). Returns the log
    lines, the outputs whose sound reading is over its family's limit,
    and the (fault, kernel) pairs where the fault pushed no output of
    the kernel past its limit."""
    sound = {key: _rel(got, want) for key, got, want in pairs}
    faults = {}
    for fault, (outs, row0) in planted.items():
        faults[fault] = {}
        for key, _, want in pairs:
            rows = row0 if key in ("o", "lse") or key.startswith("dq") \
                else 0
            faults[fault][key] = _rel(outs[key][:, :, rows:],
                                      want[:, :, rows:])
    lines = [f"[{phase}] {name}: relative error ||got - want|| / ||want|| "
             "(limits " + ", ".join(f"{f} {v:g}" for f, v in limits.items())
             + "): sound " + ", ".join(f"{k_} {e:.3e}"
                                       for k_, e in sound.items())]
    lines += [f"[{phase}] {name}:   planted {fault}: "
              + ", ".join(f"{k_} {e:.3e}" for k_, e in got.items())
              for fault, got in faults.items()]
    bad = [k_ for k_, e in sound.items() if e > limits[_rel_family(k_)]]
    missed = [(fault, kern) for fault, got in faults.items()
              for kern, keys in _KERNEL_KEYS.items() if keys[0] in got
              and not any(got[k_] > limits[_rel_family(k_)] for k_ in keys)]
    return lines, bad, missed


def flash_phase(cases=FLASH_CASES, timed=FLASH_TIMED, phase="flash",
                f32_grads=False, rel=None):
    """Each case's kernels against their plain versions; the ``timed``
    cases timed beside their bounds, plain versions and SDPA. With
    ``f32_grads`` the backward kernels writing f32 gradients (the ring's
    partials) are checked and timed too, as "dq_f32" and "dkv_f32".
    With ``rel`` (limits by family, `_rel_family`) each output is also
    held to its plain version by its relative error, and two planted
    faults (`_planted_flash`) must each be rejected by every kernel."""
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
        pairs = [("o", o, ro), ("lse", lse, rlse), ("dq", dq, rdq),
                 ("dk", dk, rdk), ("dv", dv, rdv)]
        if f32_grads:
            f32 = torch.float32
            got32 = fa._flash_bwd(q, k, v, o, lse, do, scale, causal,
                                  grad_dtype=f32)
            want32 = fa._flash_bwd_reference(q, k, v, o, lse, do, scale,
                                             causal, grad_dtype=f32)
            assert all(x.dtype == f32 for x in got32)
            pairs += [(f"{n}_f32", a, b) for n, a, b in
                      zip(("dq", "dk", "dv"), got32, want32)]
        torch.cuda.synchronize()
        errs = {}
        for key, got, want in pairs:
            got, want = got.float(), want.float()
            assert torch.isfinite(got).all(), f"[{phase}] {name} {key}: inf/nan"
            err = (got - want).abs()
            errs[key] = err.max().item()
            assert bool((err <= tol + tol * want.abs()).all()), \
                f"[{phase}] {name} {key}: max_abs_err {errs[key]:.3e} FAILED"
        if D == 32 and dts == "bf16":
            _d32_fault_rejected(phase, name, q, k, v, do, scale, causal,
                                pairs, tol)
        dead = Sq - Sk if causal else 0
        if dead > 0:
            assert bool((o[:, :, :dead] == 0).all()), f"{name}: dead o"
            assert bool((dq[:, :, :dead] == 0).all()), f"{name}: dead dq"
        if rel is not None:
            planted = {f: _planted_flash(q, k, v, o, lse, do, scale, causal,
                                         f, f32_grads)
                       for f in ("scale", "tile")}
            lines, bad, missed = _rel_check(phase, name, pairs, planted, rel)
            for text in lines:
                log(text)
            assert not bad, f"[{phase}] {name}: relative error of {bad} " \
                "over the limit FAILED"
            assert not missed, f"[{phase}] {name}: planted faults not " \
                f"rejected (fault, kernel): {missed}"
            del planted
        line = (f"[{phase}] {name}: B={B} H={H}/{Hkv} Sq={Sq} Sk={Sk} D={D} "
                f"{dts} {'causal' if causal else 'non-causal'}: max_abs_err "
                + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
                + f" (atol = rtol = {tol})"
                + (f"; {dead} fully masked rows exactly 0 in o and dq"
                   if dead > 0 else ""))
        res = {"fwd": {"max_abs_err": max(errs["o"], errs["lse"])},
               "dq": {"max_abs_err": errs["dq"]},
               "dkv": {"max_abs_err": max(errs["dk"], errs["dv"])}}
        kerns = [("fwd", "plain_fwd", "sdpa_fwd", None),
                 ("dq", "plain_bwd", "sdpa_bwd", None),
                 ("dkv", "plain_bwd", "sdpa_bwd", None)]
        if f32_grads:
            res["dq_f32"] = {"max_abs_err": errs["dq_f32"]}
            res["dkv_f32"] = {"max_abs_err": max(errs["dk_f32"],
                                                 errs["dv_f32"])}
            kerns += [("dq_f32", "plain_bwd_f32", None, 4),
                      ("dkv_f32", "plain_bwd_f32", None, 4)]
        if name in timed:
            t = _time_flash(q, k, v, do, o, lse, scale, causal, H != Hkv,
                            f32_grads)
            for kern, plain, lib, g_item in kerns:
                bound, by = _flash_bound_ms(kern.split("_")[0], B, H, Hkv,
                                            Sq, Sk, D, causal, dts, g_item)
                lib_ms = t[lib] if lib else None
                res[kern].update(ms=t[kern], plain_ms=t[plain],
                                 library_ms=lib_ms, bound_ms=bound,
                                 bound_by=by)
                line += (f"\n[{phase}]   {kern}: kernel {t[kern]:.4f} ms, "
                         f"bound {bound:.4f} ms ({by}, {bound / t[kern]:.1%}"
                         f" of bound), plain {t[plain]:.4f} ms, "
                         + (f"SDPA {lib_ms:.4f} ms, kernel / SDPA "
                            f"{t[kern] / lib_ms:.2f}x" if lib else
                            "no library call computes it"))
            line += (f"\n[{phase}]   (the plain backward and SDPA's backward "
                     "each compute dq, dk and dv in one call)")
        log(line)
        results[name] = res
        del q, k, v, do, o, lse, dq, dk, dv, ro, rlse, rdq, rdk, rdv, pairs
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
# The paged engine's eager rerun must give the captured run's tokens,
# TP_CARDS_AGREE of them, free-running and on the fixed schedule (the
# prefill's filler rows are no longer written back, so replay and eager
# compute on the same bytes; ROADMAP C6b); the teacher-forced run (a
# fresh engine that prefills in KVMEM_CHUNK-token chunks and is fed the
# captured tokens, so its bf16 products have other shapes) keeps
# TP_AGREE.
TP_CARDS_LIMIT_S, TP_CARDS_TRACE_S = 300, 20
TP_CARDS_AGREE = 1.0


def _fixed_schedule_run(eng, prompts, snapshot):
    """Serve ``prompts`` on ``eng`` on one fixed schedule: every request
    submitted before the first step and every step at horizon 1, so the
    admissions, the prefill batches and the dispatches are the same
    whatever the host's timing. With ``snapshot`` the last logits are
    copied after every step. Returns the tokens and the snapshots."""
    ids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    logits = []
    while eng.pending():
        eng.step(horizon=1)
        if snapshot:
            logits.append(eng._last_logits.detach().float().clone())
    torch.cuda.synchronize()
    return [eng.pop_result(i) for i in ids], logits


def _first_diverging(a, b):
    """The first of the paired logit snapshots that differ bit for bit:
    its index, max abs difference and how many rows' argmax differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            return {"step": i, "of": len(a),
                    "max_diff": float((x - y).abs().max()),
                    "argmax_rows": int((x.argmax(-1) != y.argmax(-1)).sum())}
    return {"step": None, "of": len(a)}


def _capture_probes(cfg, tp, group):
    """Each op of a tp rank's decode layer at the serve shapes (8 rows,
    one token), run eagerly and from a captured CUDA graph on the same
    inputs: the number of output elements that differ bit for bit. The
    all-reduce is collective: every rank runs the probes in one order."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import _logits

    g = torch.Generator(device="cuda").manual_seed(1 + dist.get_rank())

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(cfg.dtype)

    d, hd = cfg.dim, cfg.head_dim
    h, kv = cfg.n_heads // tp, cfg.n_kv_heads // tp
    f, v = cfg.ffn_dim // tp, cfg.vocab_size // tp
    x, act, o = rand(8, 1, d), rand(8, 1, f), rand(8, 1, h, hd)

    def summed(a):
        a = a.clone()
        dist.all_reduce(a, group=group)
        return a

    probes = {
        "wq": (lambda a, w: torch.einsum("bsd,dhk->bshk", a, w),
               (x, rand(d, h, hd))),
        "wk": (lambda a, w: torch.einsum("bsd,dhk->bshk", a, w),
               (x, rand(d, kv, hd))),
        "wo": (lambda a, w: torch.einsum("bshk,hkd->bsd", a, w),
               (o, rand(h, hd, d))),
        "w_gate": (lambda a, w: torch.einsum("bsd,df->bsf", a, w),
                   (x, rand(d, f))),
        "w_down": (lambda a, w: torch.einsum("bsf,fd->bsd", a, w),
                   (act, rand(f, d))),
        "lm_head": (lambda a, w: _logits(a, w, cfg), (x, rand(d, v))),
        "all_reduce": (summed, (x,)),
    }
    out = {}
    for name, (fn, args) in probes.items():
        eager = fn(*args).clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn(*args)
        graph.replay()
        torch.cuda.synchronize()
        out[name] = int((got != eager).sum())
        del graph
    return out


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
    # C6b: the paged engine on one fixed schedule, captured (after a
    # warm-up run that captures the horizon-1 graph) and later eager
    eng = engines["paged"]
    _fixed_schedule_run(eng, prompts, False)
    fixed_graph, graph_logits = _fixed_schedule_run(eng, prompts, rank == 0)
    mark("fixed-schedule captured run done")
    # the paged engine again, eager, each step logged; stacks dumped
    # until the process group is gone
    eng.release_graphs()
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
    eng.step = step
    mark("eager rerun done")
    # the eager path held to the captured run's tokens, teacher-forced
    # (free-running streams part at the first near-tie and stay apart)
    picks, _ = _forced_picks(params, cfg, prompts, res["paged"]["tokens"],
                             None, mesh=mesh)
    mark("teacher-forced eager run done")
    fixed_eager, eager_logits = _fixed_schedule_run(eng, prompts, rank == 0)
    mark("fixed-schedule eager run done")
    probes = _capture_probes(cfg, job["tp"], mesh.get_group("tp"))
    mark("capture probes done")
    with open(f"{out}/rank{rank}.eager.json", "w") as f:
        json.dump({"tokens": toks, "forced": float(np.mean(
            picks == np.array(res["paged"]["tokens"]))),
            "fixed_graph": fixed_graph, "fixed_eager": fixed_eager,
            "fixed_logits": _first_diverging(graph_logits, eager_logits),
            "probes": probes}, f)
    dist.barrier()
    mark("barrier passed")
    # NCCL's teardown waits for every graph that captured the group's
    # collectives to be freed (ROADMAP C6)
    for e in engines.values():
        e.release_graphs()
    mark("graphs released")
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
        agree = None
        if r0 and all(eager):
            e0 = json.loads(eager[0])
            same = e0["tokens"] == r0["paged"]["tokens"]
            agree = (_agreement(e0["tokens"], r0["paged"]["tokens"]),
                     e0["forced"],
                     _agreement(e0["fixed_eager"], e0["fixed_graph"]))
            log(f"[tp-cards] paged, eager rerun: finished on every rank; "
                f"tokens equal to the captured run's: {same} ("
                f"{agree[0]:.4f} free-running, gate >= {TP_CARDS_AGREE});"
                f" teacher-forced agreement of a chunked-prefill eager "
                f"engine with the captured tokens {agree[1]:.4f} (gate >= "
                f"{TP_AGREE}); "
                f"NCCL_ALGO={os.environ.get('NCCL_ALGO')}, "
                f"NCCL_PROTO={os.environ.get('NCCL_PROTO')}")
            fixed_same = e0["fixed_eager"] == e0["fixed_graph"]
            log(f"[tp-cards] paged, fixed schedule (all submitted first, "
                f"horizon 1): eager tokens equal to the captured run's: "
                f"{fixed_same} ({agree[2]:.4f}, gate >= {TP_CARDS_AGREE}); "
                f"captured fixed run equal to the adaptive captured "
                f"run's tokens: {e0['fixed_graph'] == r0['paged']['tokens']}"
                f"; first logit snapshot that differs: {e0['fixed_logits']}"
                f"; graph-vs-eager elements differing per op, by rank: "
                f"{[json.loads(e)['probes'] for e in eager]}")
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
        assert min(agree[0], agree[2]) >= TP_CARDS_AGREE, agree
        assert agree[1] >= TP_AGREE, agree
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


# The long-context phase (sequence parallelism, ROADMAP A12):
# bench.py's flagship trained on one sequence of LC_SEQ tokens. (a) sp =
# 1 over one NCCL rank, attn_impl ring and ulysses against flash; (b)
# the ring's schedule looped over LC_SHARDS blocks in this process
# (`LocalRing`), against whole-sequence flash, and Llama-3-8B's forward
# at its 8192 context through the same local ring; (c) LC_RANKS rank
# processes sharing the card in a gloo world, sp = 2, the flagship at 2
# layers and LC_RANK_SEQ tokens, held to the one-rank step, with each
# fault of SP_FAULTS planted; the kernels at the ring's block shapes.
LC_SEQ, LC_STEPS = 32768, 3
LC_SHARDS = 4
LC_RANKS, LC_RANK_SEQ, LC_RANK_LAYERS = 2, 8192, 2
# (a): ring and Ulysses at sp = 1 against flash, first loss
LC_LOSS_RTOL = 1e-6
# (b): the 8B forward's argmax agreement through the ring may fall this
# far below the plain attention's (both against flash)
LC_FLOOR_MARGIN = 0.03
# (b), (c): the ring's (or Ulysses's) step against flash's: the relative
# loss and grad-norm limits and the gradients' min cosine, set between
# the sound readings and the planted faults' (SP_FAULTS) on an H100:
# loss 5.3e-6 / 1.8e-4 (dk/dv not home leaves the loss as it is), norm
# 7.5e-5 / 5.7e-3, cosine 0.99969 / 0.789
SP_LOSS_RTOL, SP_NORM_RTOL, SP_MIN_COS = 3e-5, 1e-3, 0.999
SP_FAULTS = ("past-causal", "dkv-not-home", "positions-local",
             "ulysses-out-skipped")
# The kernels at the ring's block shapes: at Sk = 8192 an output's
# typical size (~sqrt(e / 8192)) is FLASH_TOL's, so each output is also
# held by its relative error to its plain version, with limits by family
# (o; the f32 lse; bf16 gradients; f32 gradient partials) set near the
# geometric mean of the largest sound reading and the smallest planted
# fault's (the softmax scale 1% off, or the first LC_FAULT_TILE keys
# dropped), on an H100: o 2.4e-3 / 1.2e-2, lse 6.0e-8 / 1.1e-3, grads
# 3.1e-4 / 2.1e-2, f32 partials 4.6e-5 / 2.1e-2
LC_REL_TOL = {"o": 5e-3, "lse": 1e-5, "grads": 2.5e-3, "f32_grads": 1e-3}
LC_FAULT_TILE = 128
LC_FLASH_CASES = [
    ("ring_diag", 1, 12, 12, 8192, 8192, 128, "bf16", True),
    ("ring_past", 1, 12, 12, 8192, 8192, 128, "bf16", False),
]


def lc_batch(cfg, seq, seed=3):
    """{'tokens': [1, seq + 1]} from a numpy seed, on the card."""
    rng = np.random.RandomState(seed)
    return {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, size=(1, seq + 1))).cuda()}


def _lc_config(**kw):
    from ray_tpu_torch.profile_train import flagship_config

    return flagship_config(max_seq_len=LC_SEQ, **kw)


def _flash_counts():
    from ray_tpu_torch.ops import flash_attention_kernel as fak

    return {"fwd": fak.fwd_launches, "dq": fak.dq_launches,
            "dkv": fak.dkv_launches}


def _zero_flash_counts():
    from ray_tpu_torch.ops import flash_attention_kernel as fak

    fak.reset_launches()


def _lc_one_rank(smi):
    """(a): the flagship at LC_SEQ tokens through make_sharded_train_step
    over {"sp": 1} on a one-rank NCCL world, per attn_impl. Returns
    {impl: run}."""
    import torch.distributed as dist

    from ray_tpu_torch import adamw, llama_loss, make_sharded_train_step
    from ray_tpu_torch.models.llama import (llama_flops_per_token,
                                            llama_init, llama_param_specs)
    from ray_tpu_torch.parallel import create_mesh, initialize_distributed
    from ray_tpu_torch.parallel.sequence_parallel import sp_group

    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    runs = {}
    try:
        mesh = create_mesh({"sp": 1})
        sp = sp_group(mesh)
        assert sp.size == 1
        for impl in ("flash", "ring", "ulysses"):
            cfg = _lc_config(attn_impl=impl)
            batch = lc_batch(cfg, LC_SEQ)
            torch.cuda.reset_peak_memory_stats()
            init_fn, step_fn = make_sharded_train_step(
                lambda p, b, cfg=cfg: llama_loss(p, b, cfg, sp=sp),
                adamw(3e-4, weight_decay=0.0), mesh, llama_param_specs(cfg),
                batch_logical=("batch", "length"))
            params, state = init_fn(llama_init(cfg, seed=0, device="cuda"))
            with _plain_attention_forbidden():
                params, state, m = step_fn(params, state, batch)
                losses, norms = [m["loss"].item()], [m["grad_norm"].item()]
                _zero_flash_counts()
                times = []
                for _ in range(LC_STEPS):
                    t0 = time.perf_counter()
                    params, state, m = step_fn(params, state, batch)
                    losses.append(m["loss"].item())
                    norms.append(m["grad_norm"].item())
                    times.append(time.perf_counter() - t0)
                launches = _flash_counts()
            tok_s = LC_SEQ * LC_STEPS / sum(times)
            runs[impl] = {
                "losses": losses, "norms": norms, "launches": launches,
                "step_ms": np.mean(times) * 1e3, "tok_s": tok_s,
                "mfu": tok_s * llama_flops_per_token(cfg, LC_SEQ)
                / BF16_FLOPS_PER_S,
                "peak": torch.cuda.max_memory_allocated()}
            del params, state, step_fn
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    L = cfg.n_layers
    want = {"fwd": 2 * L * LC_STEPS, "dq": L * LC_STEPS,
            "dkv": L * LC_STEPS}
    flash = runs["flash"]
    for impl, r in runs.items():
        label = f"[long-context] (a) {impl}, sp=1"
        assert all(np.isfinite(r["losses"])) and all(np.isfinite(r["norms"]))
        assert r["losses"][-1] < r["losses"][0], (label, r["losses"])
        assert r["launches"] == want, (label, r["launches"], want)
        rel = abs(r["losses"][0] - flash["losses"][0]) / flash["losses"][0]
        equal = r["losses"][0] == flash["losses"][0]
        line = (f"{label}: losses {[round(x, 5) for x in r['losses']]}; "
                f"first loss {'bit-equal to' if equal else 'vs'} flash's "
                f"({r['losses'][0]!r} vs {flash['losses'][0]!r}, relative "
                f"{rel:.3e} <= {LC_LOSS_RTOL}); later steps vs flash "
                f"{[abs(a - b) / b for a, b in zip(r['losses'][1:], flash['losses'][1:])]}"
                f"; launches in {LC_STEPS} steps {r['launches']}; step "
                f"{r['step_ms']:.1f} ms, {r['tok_s']:.0f} tokens/s, MFU "
                f"{r['mfu']:.2%} of 989 TFLOP/s bf16 at S={LC_SEQ}, peak "
                f"{r['peak'] / 2**30:.2f} GiB; on {smi}")
        assert rel <= LC_LOSS_RTOL, line + " FAILED"
        log(line)
    return runs


def _mask_counts():
    """The flash kernels' launches by mask, as their wrappers count them:
    {"causal" / "non-causal": {"fwd", "dq", "dkv"}}."""
    from ray_tpu_torch.ops import flash_attention_kernel as fak

    return {m: dict(c) for m, c in fak.mask_launches.items()}


def _loss_grads(cfg, params, batch, sp=None):
    from ray_tpu_torch import llama_loss
    from ray_tpu_torch.models.training import _leaves, _tree_map

    tree = _tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = llama_loss(tree, batch, cfg, sp=sp)
    grads = torch.autograd.grad(loss, _leaves(tree))
    return loss.item(), torch.nn.utils.get_total_norm(grads).item(), grads


def _lc_local_ring(smi):
    """(b): the 4-block ring in this process against flash, and with the
    past-causal fault planted; returns the kernels' launches and their
    split by mask in the ring's one step."""
    from ray_tpu_torch.models.llama import LlamaConfig, llama_forward, \
        llama_init
    from ray_tpu_torch.ops.ring_attention import LocalRing

    ring = LocalRing(LC_SHARDS)
    cfg = _lc_config(attn_impl="flash")
    ring_cfg = dataclasses.replace(cfg, attn_impl="ring")
    params = llama_init(cfg, seed=0, device="cuda")
    batch = lc_batch(cfg, LC_SEQ)
    with _plain_attention_forbidden():
        want = _loss_grads(cfg, params, batch)
        _zero_flash_counts()
        t0 = time.perf_counter()
        got = _loss_grads(ring_cfg, params, batch, sp=ring)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches, masks = _flash_counts(), _mask_counts()
        with _sp_fault("past-causal"):
            fault = _loss_grads(ring_cfg, params, batch, sp=ring)
    names = [nm for nm, _ in _named_leaves(params)]
    gate, fgate = _sp_gate(got, want, names), _sp_gate(fault, want, names)
    n, L = LC_SHARDS, cfg.n_layers
    pairs = n * (n + 1) // 2          # blocks at or before each q block
    sched = {"causal": {"fwd": 2 * L * n, "dq": L * n, "dkv": L * n},
             "non-causal": {"fwd": 2 * L * (pairs - n), "dq": L * (pairs - n),
                            "dkv": L * (pairs - n)}}
    line = (f"[long-context] (b) the ring looped over {n} blocks of "
            f"{LC_SEQ // n} tokens in one process, flagship at S={LC_SEQ}, "
            f"{L} layers: loss {got[0]:.6f} vs whole-sequence flash "
            f"{want[0]:.6f} (relative {gate[0]:.3e} <= {SP_LOSS_RTOL}), grad "
            f"norm {got[1]:.6f} vs {want[1]:.6f} ({gate[1]:.3e} <= "
            f"{SP_NORM_RTOL}), min cosine over {len(names)} grad leaves "
            f"{gate[2]:.6f} ({gate[3]}; >= {SP_MIN_COS}); launches by mask, "
            f"counted by the kernels' wrappers, {masks} = the schedule "
            f"{sched} (causal on the diagonal, non-causal on past blocks, "
            f"future blocks skipped; forward twice under remat); kernel "
            f"launches {launches}; forward + backward {ms:.1f} ms")
    fline = (f"[long-context] (b) planted fault past-causal: loss "
             f"{fgate[0]:.3e}, norm {fgate[1]:.3e}, min cosine "
             f"{fgate[2]:.6f} ({fgate[3]})")
    log(line)
    log(fline)
    assert _sp_ok(gate), line + " FAILED"
    assert not _sp_ok(fgate), fline + " NOT REJECTED"
    assert masks == sched, line + " FAILED"
    assert launches == {k: masks["causal"][k] + masks["non-causal"][k]
                        for k in launches}, line + " FAILED"
    del params, want, got, fault
    gc.collect()
    torch.cuda.empty_cache()

    # Llama-3-8B's forward at its published context through the same
    # ring, against flash; the plain attention's distance from flash is
    # the floor (bf16 attention outputs rounded elsewhere, through 32
    # layers); the ring with the past-causal fault must fall below it
    cfg8 = LlamaConfig.llama3_8b()
    p8 = llama_init(cfg8, seed=0, device="cuda", dtype=cfg8.dtype)
    tokens = lc_batch(cfg8, cfg8.max_seq_len)["tokens"][:, :-1]
    runs = (("ring", "ring", contextlib.nullcontext),
            ("fault", "ring", lambda: _sp_fault("past-causal")),
            ("plain", "reference", contextlib.nullcontext))
    err, agree = {}, {}
    with torch.no_grad():
        with _plain_attention_forbidden():
            flash = llama_forward(p8, tokens, dataclasses.replace(
                cfg8, attn_impl="flash"))
        top, big = flash.argmax(-1), flash.abs().max().item()
        for label, impl, planted in runs:
            guard = _plain_attention_forbidden() if impl == "ring" else \
                contextlib.nullcontext()
            with guard, planted():
                x = llama_forward(p8, tokens, dataclasses.replace(
                    cfg8, attn_impl=impl), sp=ring if impl == "ring" else None)
            assert torch.isfinite(x).all(), label
            err[label] = (x - flash).abs().max().item()
            agree[label] = (x.argmax(-1) == top).float().mean().item()
            del x
    floor = agree["plain"] - LC_FLOOR_MARGIN
    line = (f"[long-context] (b) Llama-3-8B forward, B=1 x {cfg8.max_seq_len}"
            f" tokens, bf16 weights, ring over {n} blocks of "
            f"{cfg8.max_seq_len // n} (GQA 32/8) against flash: logits max "
            f"abs error {err['ring']:.4e} (of max |logit| {big:.3f}), argmax "
            f"agreement {agree['ring']:.4f}; the plain attention against "
            f"flash (the floor): {err['plain']:.4e}, {agree['plain']:.4f}; "
            f"the ring with the past-causal fault: {err['fault']:.4e}, "
            f"{agree['fault']:.4f}; gate: agreement >= {floor:.4f}; on {smi}")
    log(line)
    assert agree["ring"] >= floor, line + " FAILED"
    assert agree["fault"] < floor, line + " FAULT NOT REJECTED"
    del p8, flash, top
    gc.collect()
    torch.cuda.empty_cache()
    return launches, masks


def _sp_fault(fault):
    """A planted fault of the sp layer for a ``with`` block:
    "past-causal" runs the kernels causal on past blocks too;
    "dkv-not-home" leaves the dk/dv accumulators where the ring's last
    step left them (one rank on); "positions-local" gives every rank the
    positions 0..S/sp-1; "ulysses-out-skipped" skips Ulysses's second
    all-to-all (its [B, H/sp, S, D] input read as [B, H, S/sp, D])."""
    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.ops import ulysses as ul
    from ray_tpu_torch.parallel import sequence_parallel as seqp

    if fault == "past-causal":
        return mock.patch.object(
            ra, "shard_kind",
            lambda src, rank, causal: "diag" if src <= rank else None)
    if fault == "dkv-not-home":
        return mock.patch.object(ra, "_home", lambda acc, ring: acc)
    if fault == "positions-local":
        return mock.patch.object(
            seqp, "seq_positions", lambda b, n, sp, device: torch.arange(
                n, device=device).expand(b, n))
    assert fault == "ulysses-out-skipped", fault
    return mock.patch.object(
        ul, "swap_out", lambda x, sp: x.reshape(
            x.shape[0], x.shape[1] * sp.size, x.shape[2] // sp.size,
            x.shape[3]))


def _sp_step_grads(cfg, batch, mesh, sp):
    """One make_sharded_train_step over the sp mesh: (loss, grad norm,
    the gradients read back from AdamW's first moment, flash launches,
    ms)."""
    from ray_tpu_torch import adamw, llama_loss, make_sharded_train_step
    from ray_tpu_torch.models.llama import llama_init, llama_param_specs
    from ray_tpu_torch.models.training import _leaves

    opt = adamw(3e-4, weight_decay=0.0)
    init_fn, step_fn = make_sharded_train_step(
        lambda p, b: llama_loss(p, b, cfg, sp=sp), opt, mesh,
        llama_param_specs(cfg), batch_logical=("batch", "length"))
    params, state = init_fn(llama_init(cfg, seed=0, device="cuda"))
    _zero_flash_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m = step_fn(params, state, batch)
    loss, norm = m["loss"].item(), m["grad_norm"].item()
    ms = (time.perf_counter() - t0) * 1e3
    moments = opt.state_tree(state, params)["exp_avg"]
    grads = [g.detach() / (1 - opt.b1) for g in _leaves(moments)]
    return loss, norm, grads, _flash_counts(), ms


def _sp_gate(got, one, names):
    """(loss rel. error, norm rel. error, min cosine and its leaf's name)
    of an sp step against the one-rank step; every leaf is whole on a
    rank."""
    cos = min((torch.nn.functional.cosine_similarity(
        g.flatten().double(), w.flatten().double(), dim=0).item(), name)
        for name, g, w in zip(names, got[2], one[2]))
    return (abs(got[0] - one[0]) / abs(one[0]),
            abs(got[1] - one[1]) / abs(one[1]), cos[0], cos[1])


def _sp_ok(gate):
    return gate[0] <= SP_LOSS_RTOL and gate[1] <= SP_NORM_RTOL and \
        gate[2] >= SP_MIN_COS


def sp_rank_main(rank, job_path):
    """One rank of (c), started as ``python3 chip_smoke.py --sp-rank RANK
    JOB``: a gloo world of LC_RANKS processes on the one card. Writes
    what it saw to the job's ``out`` directory."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import llama_init, llama_param_specs
    from ray_tpu_torch.parallel import create_mesh
    from ray_tpu_torch.parallel.sequence_parallel import sp_group

    with open(job_path) as f:
        job = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo",
                            init_method=job["store"], world_size=LC_RANKS,
                            rank=rank)
    out = {"rank": rank}
    try:
        mesh = create_mesh({"sp": LC_RANKS})
        sp = sp_group(mesh)
        assert sp.size == LC_RANKS and not sp.nccl
        base = _lc_config(n_layers=LC_RANK_LAYERS)
        batch = lc_batch(base, LC_RANK_SEQ)
        runs = {impl: (impl, None) for impl in ("ring", "ulysses")}
        runs.update({f: ("ulysses" if f.startswith("ulysses") else "ring",
                         f) for f in SP_FAULTS})
        got = {}
        for name, (impl, fault) in runs.items():
            cfg = dataclasses.replace(base, attn_impl=impl)
            with _sp_fault(fault) if fault else contextlib.nullcontext():
                got[name] = _sp_step_grads(cfg, batch, mesh, sp)
        out["runs"] = {k: {"loss": v[0], "norm": v[1], "launches": v[3],
                           "ms": v[4]} for k, v in got.items()}
        if rank == 0:
            cfg = dataclasses.replace(base, attn_impl="flash")
            one = _loss_grads(cfg, llama_init(cfg, seed=0, device="cuda"),
                              batch)
            names = [n for n, _ in _named_leaves(llama_param_specs(cfg))]
            out["one"] = [one[0], one[1]]
            out["gates"] = {k: _sp_gate(v, one, names)
                            for k, v in got.items()}
        out["peak"] = torch.cuda.max_memory_allocated()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def _lc_world_two(smi):
    """(c): LC_RANKS rank processes on the one card; returns rank 0's
    launches of the sound ring step."""
    import os
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"store": f"tcp://127.0.0.1:{_free_port()}",
                       "out": tmp}, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sp-rank", str(r),
             job], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(LC_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0].decode())
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, \
                f"[long-context] rank {r} exited {p.returncode}:\n" \
                f"{text[-6000:]}"
        ranks = []
        for r in range(LC_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    first = ranks[0]
    for other in ranks[1:]:
        for name, run in other["runs"].items():
            assert run["loss"] == first["runs"][name]["loss"], name
    lo, no = first["one"]
    L = LC_RANK_LAYERS
    checks = []
    for impl in ("ring", "ulysses"):
        le, ne, cos, leaf = first["gates"][impl]
        launches = [r["runs"][impl]["launches"] for r in ranks]
        # ring: rank r runs r + 1 blocks a layer; Ulysses: one whole-
        # sequence call on its heads
        want = [{"fwd": 2 * L * (r + 1 if impl == "ring" else 1),
                 "dq": L * (r + 1 if impl == "ring" else 1),
                 "dkv": L * (r + 1 if impl == "ring" else 1)}
                for r in range(LC_RANKS)]
        line = (f"[long-context] (c) {LC_RANKS} rank processes on one card "
                f"(gloo, cpu:gloo,cuda:gloo), sp={LC_RANKS}, {impl}: "
                f"flagship at {L} layers, S={LC_RANK_SEQ}: loss "
                f"{first['runs'][impl]['loss']:.6f} vs the one-rank flash "
                f"step's {lo:.6f} (relative {le:.3e} <= {SP_LOSS_RTOL}), grad"
                f" norm {first['runs'][impl]['norm']:.6f} vs {no:.6f} "
                f"({ne:.3e} <= {SP_NORM_RTOL}), min cosine {cos:.6f} ("
                f"{leaf}; >= {SP_MIN_COS}); launches per rank {launches}; "
                f"step {first['runs'][impl]['ms']:.1f} ms, peak "
                + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks)
                + " GiB a rank (two processes on one card, gloo through the"
                f" host: not a speed); on {smi}")
        log(line)
        checks += [(_sp_ok(first["gates"][impl]), line + " FAILED"),
                   (launches == want, line + f" FAILED (want {want})")]
    for fault in SP_FAULTS:
        gate = first["gates"][fault]
        line = (f"[long-context] (c) planted fault {fault}: loss "
                f"{gate[0]:.3e}, norm {gate[1]:.3e}, min cosine "
                f"{gate[2]:.6f} ({gate[3]})")
        rejected = not _sp_ok(gate)
        log(line + (": rejected" if rejected else ": NOT REJECTED"))
        checks.append((rejected, line + " NOT REJECTED"))
    for ok, text in checks:
        assert ok, text
    return first["runs"]["ring"]["launches"]


def long_context_phase(smi):
    """(a), (b), (c) and the kernels at the ring's block shapes. Returns
    (b)'s launches, their split by mask and the kernel results."""
    _lc_one_rank(smi)
    launches, masks = _lc_local_ring(smi)
    _lc_world_two(smi)
    fres = flash_phase(LC_FLASH_CASES, [c[0] for c in LC_FLASH_CASES],
                       phase="long-context", f32_grads=True, rel=LC_REL_TOL)
    return launches, masks, fres


# --sp-cards N: the flagship at LC_SEQ tokens over sp = N over NCCL, one
# rank a card, against one card in the same call.
SP_CARDS_LIMIT_S = 420


def _overlap(prof):
    """(ms of NCCL kernels, ms of them that ran while a flash kernel ran,
    ms of flash kernels) in a profiled window, from the device-side
    intervals of the kernels."""
    nccl, flash = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "nccl" in e.name.lower():
            nccl.append(span)
        elif "flash" in e.name.lower():
            flash.append(span)
    flash.sort()
    both = 0.0
    for a, b in nccl:
        for c, d in flash:
            if c >= b:
                break
            both += max(0.0, min(b, d) - max(a, c))
    return (sum(b - a for a, b in nccl) / 1e3, both / 1e3,
            sum(b - a for a, b in flash) / 1e3)


def sp_card_rank_main(rank, job_path):
    """One rank of ``--sp-cards``: card ``rank`` of an NCCL world. Rank 0
    first trains the flagship on one card (flash, make_train_step) while
    the others wait; then every rank takes 1 warm-up and LC_STEPS timed
    steps over {"sp": N} per attn_impl, and one more ring step under the
    profiler. Results go to ``rank<k>.json``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import adamw, llama_loss, make_sharded_train_step
    from ray_tpu_torch import make_train_step
    from ray_tpu_torch.models.llama import llama_init, llama_param_specs
    from ray_tpu_torch.parallel import create_mesh, initialize_distributed
    from ray_tpu_torch.parallel.sequence_parallel import sp_group

    with open(job_path) as f:
        job = json.load(f)
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(job["store"], job["sp"], rank)
    res = {"rank": rank}

    def timed(step_fn, params, state, batch):
        params, state, m = step_fn(params, state, batch)
        losses = [m["loss"].item()]
        times = []
        for _ in range(LC_STEPS):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch)
            losses.append(m["loss"].item())
            times.append(time.perf_counter() - t0)
        return params, state, {"losses": losses, "step_ms":
                               np.mean(times) * 1e3,
                               "tok_s": LC_SEQ * LC_STEPS / sum(times),
                               "peak": torch.cuda.max_memory_allocated()}

    if rank == 0:
        cfg = _lc_config(attn_impl="flash")
        init_fn, step_fn = make_train_step(
            lambda p, b: llama_loss(p, b, cfg), adamw(3e-4, weight_decay=0.0))
        params, state = init_fn(llama_init(cfg, seed=0, device="cuda"))
        _, _, res["one"] = timed(step_fn, params, state,
                                 lc_batch(cfg, LC_SEQ))
        del params, state
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = create_mesh({"sp": job["sp"]})
    sp = sp_group(mesh)
    for impl in ("ring", "ulysses"):
        cfg = _lc_config(attn_impl=impl)
        torch.cuda.reset_peak_memory_stats()
        init_fn, step_fn = make_sharded_train_step(
            lambda p, b, cfg=cfg: llama_loss(p, b, cfg, sp=sp),
            adamw(3e-4, weight_decay=0.0), mesh, llama_param_specs(cfg),
            batch_logical=("batch", "length"))
        params, state = init_fn(llama_init(cfg, seed=0, device="cuda"))
        batch = lc_batch(cfg, LC_SEQ)
        params, state, res[impl] = timed(step_fn, params, state, batch)
        if impl == "ring":
            # one more step, profiled on every rank
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step_fn(params, state, batch)
                torch.cuda.synchronize()
            res["overlap"] = _overlap(prof)
        del params, state, step_fn
        torch.cuda.empty_cache()
    dist.barrier()
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def sp_cards_main(n):
    """``python3 chip_smoke.py --sp-cards N``: the flagship at LC_SEQ
    tokens over sp = N over NCCL, one rank process a card, ring and
    Ulysses, against one card in the same call; prints tokens/s, step
    ms, peak memory, the losses beside one card's and, per rank, how
    much of the NCCL kernels' time ran under the flash kernels in one
    more profiled ring step (a rank with fewer blocks to compute spends
    most of its NCCL time waiting for its neighbours)."""
    import os
    import sys
    import tempfile

    name, count, smi = device_phase()
    if count < n:
        raise SystemExit(f"--sp-cards {n} needs {n} cards, {count} seen")
    build_phase()
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"store": f"tcp://127.0.0.1:{_free_port()}",
                       "sp": n, "out": tmp}, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sp-card-rank",
             str(r), job], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]
        deadline, logs = time.monotonic() + SP_CARDS_LIMIT_S, []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1, deadline - time.monotonic()))[0].decode())
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, \
                f"[sp-cards] rank {r} exited {p.returncode}:\n{text[-6000:]}"
        ranks = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    one = ranks[0]["one"]
    log(f"[sp-cards] one card, flash, S={LC_SEQ}: losses "
        f"{[round(x, 5) for x in one['losses']]}; step {one['step_ms']:.1f}"
        f" ms, {one['tok_s']:.0f} tokens/s, peak {one['peak'] / 2**30:.2f} "
        f"GiB; on {smi}")
    for impl in ("ring", "ulysses"):
        r0 = ranks[0][impl]
        for other in ranks[1:]:
            assert other[impl]["losses"] == r0["losses"], impl
        rel = abs(r0["losses"][0] - one["losses"][0]) / one["losses"][0]
        line = (f"[sp-cards] {impl}, sp={n} over NCCL: losses "
                f"{[round(x, 5) for x in r0['losses']]} (first vs one "
                f"card's: relative {rel:.3e} <= {PARITY_LOSS_RTOL}); step "
                f"{r0['step_ms']:.1f} ms, {r0['tok_s']:.0f} tokens/s "
                f"({r0['tok_s'] / one['tok_s']:.2f}x one card), peak "
                + ", ".join(f"{x[impl]['peak'] / 2**30:.2f}" for x in ranks)
                + f" GiB a rank; on {smi}")
        assert all(np.isfinite(r0["losses"])), line + " FAILED"
        assert rel <= PARITY_LOSS_RTOL, line + " FAILED"
        log(line)
    for r, x in enumerate(ranks):
        nccl, both, flash = x["overlap"]
        log(f"[sp-cards] ring, one profiled step, rank {r} ({r + 1} blocks "
            f"a layer): NCCL kernels {nccl:.1f} ms on the card, {both:.1f} "
            f"ms of it while a flash kernel ran "
            f"({both / max(nccl, 1e-9):.1%}); flash kernels {flash:.1f} ms")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


# ---------------------------------------------------------------------------
# The other model families and the last two mesh axes (ROADMAP A13): the
# moe, pipeline and vit-t5-mlp phases.
# ---------------------------------------------------------------------------

# moe: Mixtral-8x7B's published widths cut to MOE_LAYERS of 32 layers (f32
# master weights and AdamW fit one card), one seeded batch of MOE_BATCH x
# MOE_SEQ tokens (G = 4096, capacity 1280); (b) MOE_RANKS gloo processes on
# the card at MOE_RANK_LAYERS layer(s).
MOE_LAYERS, MOE_BATCH, MOE_SEQ, MOE_STEPS = 2, 2, 2048, 3
MOE_RANKS, MOE_RANK_LAYERS = 2, 1
# The gates of (a) (kernels against the plain attention) and (b) (the ep
# = 2 and dp = 2 steps against the one-rank step on the same weights):
# loss and grad norm relative, the min cosine of the checked gradients
# but the router's, and the router's own. Routing is discrete: rounding
# that moves a token's gates past a tie, or an earlier token past an
# expert's capacity, reroutes it, and the router's gradient (a sum over
# the routed tokens) turns with each rerouted token. So the router gets
# its own floor, with the share of rerouted choices printed beside; each
# planted fault of MOE_FAULTS must fail one of the gates.
MOE_LOSS_RTOL, MOE_NORM_RTOL, MOE_MIN_COS = 2e-3, 2e-2, 0.999
MOE_ROUTER_MIN_COS = 0.95
MOE_FAULTS = {"ep": ("combine-unsummed", "router-twice"),
              "dp": ("local-capacity",)}
# pipeline: bench.py's flagship widths at 16 layers, batch 8 x 2048 in
# PP_MICRO microbatches; (b) PP_RANKS gloo processes, 8 layers each.
PP_MICRO, PP_STEPS, PP_RANKS = 4, 3, 2
PP_FAULTS = ("handoff-late", "backward-dropped")
# vit-t5-mlp: ViTConfig() at batch 256, T5Config() at batch 32 x (512
# source, 128 target), MLPConfig() at batch 256; A13_STEPS timed steps
# after a warm-up; T5_NEW greedy tokens for T5_SOURCES sources.
A13_STEPS, T5_NEW, T5_SOURCES = 3, 64, 8


def _chunked_cos(a, b, chunk=1 << 26):
    """Cosine of two same-shaped tensors in f64, a chunk at a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    dot = na = nb = 0.0
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
        dot += (x * y).sum().item()
        na += (x * x).sum().item()
        nb += (y * y).sum().item()
    return dot / max(np.sqrt(na * nb), 1e-300)


def _gate(loss, norm, pairs, one_loss, one_norm):
    """(loss rel. error, norm rel. error, min cosine and its leaf) of
    (name, got, want) gradient pairs against a one-rank reference."""
    cos = min((_chunked_cos(g, w), name) for name, g, w in pairs)
    return (abs(loss - one_loss) / abs(one_loss),
            abs(norm - one_norm) / abs(one_norm), cos[0], cos[1])


def _gate_ok(gate, limits):
    return gate[0] <= limits[0] and gate[1] <= limits[1] and \
        gate[2] >= limits[2]


def _gate_text(gate):
    return (f"loss {gate[0]:.3e}, norm {gate[1]:.3e}, min cosine "
            f"{gate[2]:.6f} ({gate[3]})")


def _moe_gate(loss, norm, pairs, one_loss, one_norm):
    """`_gate` over every checked gradient but the router's, and the
    router's cosine (the last entry)."""
    router = [(n, g, w) for n, g, w in pairs if n.endswith("w_router")]
    gate = _gate(loss, norm, [x for x in pairs if x not in router],
                 one_loss, one_norm)
    return gate + (min(_chunked_cos(g, w) for _, g, w in router),)


def _moe_ok(gate):
    return _gate_ok(gate, (MOE_LOSS_RTOL, MOE_NORM_RTOL, MOE_MIN_COS)) \
        and gate[4] >= MOE_ROUTER_MIN_COS


def _moe_text(gate):
    return _gate_text(gate) + f", router cosine {gate[4]:.6f}"


def _moe_cfg(**kw):
    from ray_tpu_torch.models.moe import MoeConfig

    return dataclasses.replace(MoeConfig.mixtral_8x7b(),
                               **{"n_layers": MOE_LAYERS, **kw})


def moe_batch(cfg, seed=5):
    rng = np.random.RandomState(seed)
    return {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ + 1))).cuda()}


@contextlib.contextmanager
def _moe_routes():
    """Every `_route` call's positions while the block runs (a layer's
    recompute under remat repeats its call)."""
    from ray_tpu_torch.models import moe as mm

    real, seen = mm._route, []

    def route(*args):
        out = real(*args)
        seen.append((out[2].detach(), out[3].detach()))
        return out

    with mock.patch.object(mm, "_route", route):
        yield seen


@contextlib.contextmanager
def _moe_replayed(seen):
    """`_route` takes the expert choices and capacity positions of the
    recorded calls ``seen``, in order, and its own gates (so the router's
    gradient flows as ever): a run with the same routing as the recorded
    one."""
    import torch.nn.functional as F

    from ray_tpu_torch.models import moe as mm

    calls = iter(seen)

    def route(xf, w_router, cfg, split=None):
        idx, pos = next(calls)
        gates = F.softmax(xf.float() @ w_router.float(), dim=-1)
        weights = gates.gather(1, idx)
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
        return gates, weights, idx, pos

    with mock.patch.object(mm, "_route", route):
        yield


def _drop_share(cfg, positions, tokens):
    capacity = max(1, int(cfg.capacity_factor * tokens * cfg.top_k
                          / cfg.n_experts))
    first = [p for _, p in positions[:cfg.n_layers]]
    return float(np.mean([(p >= capacity).float().mean().item()
                          for p in first])), capacity


def _moe_loss_grads(cfg, params, batch, wanted=None, ep=None):
    """(loss, grad norm, [(name, grad)]) of `moe_loss` on ``params``
    by plain autograd (the step's loss without the optimizer); ``wanted``
    limits the gradients to the named leaves."""
    from ray_tpu_torch.models.moe import moe_loss
    from ray_tpu_torch.models.training import _tree_map

    tree = _tree_map(lambda p: p.detach().requires_grad_(), params)
    named = [(n, p) for n, p in _named_leaves(tree)
             if wanted is None or n in wanted]
    loss = moe_loss(tree, batch, cfg, ep=ep)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    norm = torch.nn.utils.get_total_norm(grads).item()
    return loss.item(), norm, [(n, g) for (n, _), g in zip(named, grads)]


def _tp1_same(label, first, ms, plain_first, plain_ms, smi):
    """The step with a tp group of one rank against the same step with
    no tp group: one rank runs no collective and the tp layer runs the
    ops it runs without a mesh, so the first step's loss and grad norm
    are equal bit for bit."""
    log(f"{label} (a) the step with the tp = 1 group against it without "
        f"one: first step's loss {first[0]!r} / {plain_first[0]!r}, grad "
        f"norm {first[1]!r} / {plain_first[1]!r} (must be equal); step "
        f"{ms:.1f} / {plain_ms:.1f} ms; on {smi}")
    assert tuple(first) == tuple(plain_first), \
        f"{label} (a) tp = 1 step differs from the step without tp FAILED"


def _one_step(loss_fn, params, specs, batch, mesh, lr):
    """((loss, grad norm) of a first step, ms of a second one) through
    make_sharded_train_step on a copy of ``params``."""
    from ray_tpu_torch import adamw, make_sharded_train_step

    init_fn, step_fn = make_sharded_train_step(loss_fn, adamw(lr), mesh,
                                               specs)
    p, s = init_fn(params)
    p, s, m = step_fn(p, s, batch)
    first = (m["loss"].item(), m["grad_norm"].item())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, s, m = step_fn(p, s, batch)
    m["loss"].item()
    ms = (time.perf_counter() - t0) * 1e3
    del p, s
    torch.cuda.empty_cache()
    return first, ms


def _moe_one_rank(smi):
    """(a): the cut model's step kernel vs plain attention, then steps
    over {"dp": 1, "ep": 1, "tp": 1} on one NCCL rank, the tp = 1 step
    against the step without a tp group. Returns the flash launches of
    the timed steps."""
    import torch.distributed as dist

    from ray_tpu_torch import adamw, make_sharded_train_step
    from ray_tpu_torch.models.moe import (moe_flops_per_token, moe_init,
                                          moe_loss, moe_param_specs)
    from ray_tpu_torch.parallel import (create_mesh, initialize_distributed,
                                        tp_group)

    cfg = _moe_cfg()
    params = moe_init(cfg, seed=0, device="cuda")
    batch = moe_batch(cfg)
    G = MOE_BATCH * MOE_SEQ
    with _plain_attention_forbidden(), _moe_routes() as seen:
        lk, nk, gk = _moe_loss_grads(cfg, params, batch)
    drop, capacity = _drop_share(cfg, seen, G)
    plain = dataclasses.replace(cfg, attn_impl="reference")
    with _moe_routes() as plain_seen:
        lr, nr, gr = _moe_loss_grads(plain, params, batch)
    moved = float(np.mean([(a[0] != b[0]).float().mean().item() for a, b in
                           zip(seen[:cfg.n_layers],
                               plain_seen[:cfg.n_layers])]))
    free = _moe_gate(lk, nk, [(n, a, b) for (n, a), (_, b) in zip(gk, gr)],
                     lr, nr)
    del gr
    # the gate: the plain run on the kernel run's routing, so that the
    # comparison sees the attention and not rerouted tokens
    with _moe_replayed(seen):
        lr, nr, gr = _moe_loss_grads(plain, params, batch)
    gate = _moe_gate(lk, nk, [(n, a, b) for (n, a), (_, b) in zip(gk, gr)],
                     lr, nr)
    del gk, gr
    torch.cuda.empty_cache()
    log(f"[moe] (a) Mixtral-8x7B widths (vocab {cfg.vocab_size}, dim "
        f"{cfg.dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads, ffn "
        f"{cfg.ffn_dim}, {cfg.n_experts} experts, top-{cfg.top_k}, "
        f"capacity factor {cfg.capacity_factor}) at {cfg.n_layers} of 32 "
        f"layers, {cfg.num_params() / 1e9:.3f} G params ("
        f"{cfg.active_params() / 1e9:.3f} G active), batch {MOE_BATCH} x "
        f"{MOE_SEQ}: G = {G}, capacity {capacity}, dropped-token share "
        f"{drop:.4f}; one step's loss and gradients, kernels vs plain "
        f"attention on the kernels' routing: {_moe_text(gate)} (limits "
        f"{MOE_LOSS_RTOL} / {MOE_NORM_RTOL} / {MOE_MIN_COS}, router "
        f"{MOE_ROUTER_MIN_COS}); each routing its own (printed): "
        f"{_moe_text(free)}, expert choices that differ {moved:.4f}")
    assert _moe_ok(gate), f"[moe] (a) parity FAILED {gate}"
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = create_mesh({"dp": 1, "ep": 1, "tp": 1})
        ep, tp = tp_group(mesh, "ep"), tp_group(mesh)
        with _plain_attention_forbidden():
            plain_first, plain_ms = _one_step(
                lambda p, b: moe_loss(p, b, cfg, ep=ep), params,
                moe_param_specs(cfg), batch, mesh, 3e-4)
        init_fn, step_fn = make_sharded_train_step(
            lambda p, b: moe_loss(p, b, cfg, ep=ep, tp=tp),
            adamw(3e-4, weight_decay=0.0), mesh, moe_param_specs(cfg))
        torch.cuda.reset_peak_memory_stats()
        params, state = init_fn(params)
        with _plain_attention_forbidden():
            params, state, m = step_fn(params, state, batch)
            losses = [m["loss"].item()]
            first = (losses[0], m["grad_norm"].item())
            _zero_flash_counts()
            times = []
            for _ in range(MOE_STEPS):
                t0 = time.perf_counter()
                params, state, m = step_fn(params, state, batch)
                losses.append(m["loss"].item())
                times.append(time.perf_counter() - t0)
            launches = _flash_counts()
        peak = torch.cuda.max_memory_allocated()
        _tp1_same("[moe]", first, np.mean(times) * 1e3, plain_first,
                  plain_ms, smi)
        assert np.isclose(losses[0], lk, rtol=1e-5), (losses[0], lk)
        assert losses[-1] < losses[0], f"[moe] loss did not fall {losses}"
        L = cfg.n_layers
        want = {"fwd": 2 * L * MOE_STEPS, "dq": L * MOE_STEPS,
                "dkv": L * MOE_STEPS}
        assert launches == want, f"[moe] launches {launches} != {want}"
        tok_s = G * MOE_STEPS / sum(times)
        mfu = tok_s * moe_flops_per_token(cfg, MOE_SEQ) / BF16_FLOPS_PER_S
        log(f"[moe] (a) make_sharded_train_step over {{'dp': 1, 'ep': 1, "
            f"'tp': 1}} on "
            f"one NCCL rank, adamw(3e-4): losses "
            f"{[round(x, 4) for x in losses]} (the first = the parity "
            f"step's); launches in {MOE_STEPS} steps {launches}; step "
            f"{np.mean(times) * 1e3:.1f} ms mean; {tok_s:.0f} tokens/s; MFU "
            f"on active params {mfu:.2%} of 989 TFLOP/s bf16; peak memory "
            f"{peak / 2**30:.2f} GiB; the one-hot dispatch and combine "
            f"einsums {4 * G * cfg.n_experts * capacity * cfg.dim / 1e9:.0f}"
            f" GFLOP a layer forward against the experts' "
            f"{6 * cfg.n_experts * capacity * cfg.dim * cfg.ffn_dim / 1e12:.2f}"
            f" TFLOP; on {smi}")
        del params, state, step_fn
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _moe_fault(fault):
    """A planted fault of the MoE layer's parallel forms."""
    from ray_tpu_torch.models import moe as mm
    from ray_tpu_torch.parallel import data_parallel as dpm

    if fault == "combine-unsummed":      # g after the combine skipped
        with mock.patch.object(mm, "reduce_from_tp", lambda x, ep: x):
            yield
    elif fault == "router-twice":        # the combine weights' f twice
        real = mm.copy_to_tp

        def twice(x, ep):
            if x.dim() == 2 and x.shape[1] == 2:         # keep [G, k]
                return real(real(x, ep), ep)
            return real(x, ep)

        with mock.patch.object(mm, "copy_to_tp", twice):
            yield
    else:                                # each rank's rows on their own
        assert fault == "local-capacity", fault
        with mock.patch.object(dpm, "current", lambda: None):
            yield


def _moe_dp_grads(cfg, params, batch, mesh, wanted):
    """The {"dp": 2} step's loss, norm and gradients without its
    optimizer (the step's own plan: this rank's rows, the batch split,
    the weight, the reduction), for the ``wanted`` leaves."""
    from ray_tpu_torch.models import training
    from ray_tpu_torch.models.moe import moe_loss, moe_param_specs
    from ray_tpu_torch.parallel.data_parallel import batch_split

    specs = [s for n, s in _named_leaves(moe_param_specs(cfg))
             if n in wanted]
    named = [(n, p.detach().requires_grad_()) for n, p in
             _named_leaves(params) if n in wanted]
    plan = training._Mesh(mesh, {n: s for (n, _), s in zip(named, specs)},
                          ("batch", None), None)
    tree = training._tree_map(lambda p: p.detach(), params)
    for n, p in named:
        layer = n.split("/")
        node = tree
        for k in layer[:-1]:
            node = node[k]
        node[layer[-1]] = p
    b = plan.batch(batch)
    with batch_split(plan.batch_view()) as split:
        loss = moe_loss(tree, b, cfg)
        weight = plan.weight(b, split.count)
        grads = torch.autograd.grad(loss * weight, [p for _, p in named])
        grads = plan.reduce(list(grads))
    total = plan.total((loss * weight).detach()).item()
    norm = torch.nn.utils.get_total_norm(grads).item()
    return total, norm, [(n, g) for (n, _), g in zip(named, grads)]


def _moe_ep_step(cfg, params, batch, mesh):
    """One make_sharded_train_step over {"ep": 2}: loss, norm and the
    rank's gradient shards (AdamW's first moment / (1 - b1))."""
    from ray_tpu_torch import adamw, make_sharded_train_step
    from ray_tpu_torch.models.moe import moe_loss, moe_param_specs
    from ray_tpu_torch.parallel import tp_group

    opt = adamw(3e-4, weight_decay=0.0)
    ep = tp_group(mesh, "ep")
    init_fn, step_fn = make_sharded_train_step(
        lambda p, b: moe_loss(p, b, cfg, ep=ep), opt, mesh,
        moe_param_specs(cfg))
    p, s = init_fn(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m = step_fn(p, s, batch)
    loss, norm = m["loss"].item(), m["grad_norm"].item()
    ms = (time.perf_counter() - t0) * 1e3
    moments = opt.state_tree(s, p)["exp_avg"]
    grads = [(n, g.detach() / (1 - opt.b1))
             for n, g in _named_leaves(moments)]
    return loss, norm, grads, ms


def moe_rank_main(rank, job_path):
    """One rank of the moe phase's (b), started as ``python3
    chip_smoke.py --moe-rank RANK JOB``: a gloo world of MOE_RANKS
    processes on the one card, each first computing the one-rank step's
    loss and gradients itself on the same weights."""
    import torch.distributed as dist

    from ray_tpu_torch.models.moe import moe_init, moe_param_specs
    from ray_tpu_torch.parallel import create_mesh
    from ray_tpu_torch.parallel.sharding import local_region

    with open(job_path) as f:
        job = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo", init_method=job["store"],
                            world_size=MOE_RANKS, rank=rank)
    out = {"rank": rank, "gates": {}, "ms": {}}
    try:
        cfg = _moe_cfg(n_layers=MOE_RANK_LAYERS)
        params = moe_init(cfg, seed=0, device="cuda")
        batch = moe_batch(cfg)
        # dp = 2: the router, attention and we_gate gradients (the leaves
        # whose gradient routing moves), all-reduced over gloo
        wanted = {n for n, _ in _named_leaves(params)
                  if not n.startswith(("tok_embed", "lm_head"))
                  and not n.endswith(("we_up", "we_down"))}
        one = _moe_loss_grads(cfg, params, batch, wanted)
        dp_mesh = create_mesh({"dp": MOE_RANKS})
        for fault in (None,) + MOE_FAULTS["dp"]:
            with _moe_fault(fault) if fault else contextlib.nullcontext():
                got = _moe_dp_grads(cfg, params, batch, dp_mesh, wanted)
            out["gates"][f"dp:{fault or 'sound'}"] = _moe_gate(
                got[0], got[1], [(n, g, w) for (n, g), (_, w) in
                                 zip(got[2], one[2])], one[0], one[1])
            del got
        del one
        torch.cuda.empty_cache()
        # ep = 2: every leaf, each rank's shard against its region of
        # the one-rank gradient (kept alone)
        ep_mesh = create_mesh({"ep": MOE_RANKS})
        specs = dict(_named_leaves(moe_param_specs(cfg)))
        loss1, norm1, full = _moe_loss_grads(cfg, params, batch)
        mine = [(n, w[local_region(w.shape, specs[n], ep_mesh)].clone())
                for n, w in full]
        del full
        torch.cuda.empty_cache()
        for fault in (None,) + MOE_FAULTS["ep"]:
            with _moe_fault(fault) if fault else contextlib.nullcontext():
                loss, norm, grads, ms = _moe_ep_step(cfg, params, batch,
                                                     ep_mesh)
            pairs = [(n, g, w) for (n, g), (_, w) in zip(grads, mine)]
            out["gates"][f"ep:{fault or 'sound'}"] = _moe_gate(
                loss, norm, pairs, loss1, norm1)
            out["ms"][fault or "sound"] = ms
            del grads, pairs
            torch.cuda.empty_cache()
        out["peak"] = torch.cuda.max_memory_allocated()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def _rank_world(flag, n, label, limit_s=300):
    """``n`` rank processes of this script (``--<flag> RANK JOB``), the
    job naming a TCP store, ``n`` and an output directory; returns what
    each wrote."""
    import os
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"store": f"tcp://127.0.0.1:{_free_port()}",
                       "n": n, "out": tmp}, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), f"--{flag}", str(r),
             job], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=limit_s)[0].decode())
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, \
                f"[{label}] rank {r} exited {p.returncode}:\n{text[-6000:]}"
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def moe_phase(smi):
    """Mixtral-style MoE: (a) one NCCL rank, (b) ep = 2 and dp = 2 as
    gloo processes on the card with planted faults. Returns (a)'s flash
    launches."""
    launches = _moe_one_rank(smi)
    ranks = _rank_world("moe-rank", MOE_RANKS, "moe")
    limits = (MOE_LOSS_RTOL, MOE_NORM_RTOL, MOE_MIN_COS, MOE_ROUTER_MIN_COS)
    r0 = ranks[0]
    for r in ranks:
        for key, gate in r["gates"].items():
            log(f"[moe] (b) rank {r['rank']} {key}: {_moe_text(gate)}")
    for axis, faults in MOE_FAULTS.items():
        for r in ranks:
            assert _moe_ok(r["gates"][f"{axis}:sound"]), \
                f"[moe] (b) {axis} = {MOE_RANKS} FAILED on rank {r['rank']}"
        for fault in faults:
            assert not all(_moe_ok(r["gates"][f"{axis}:{fault}"])
                           for r in ranks), \
                f"[moe] (b) planted fault {fault} passed the gate"
    log(f"[moe] (b) {MOE_RANKS} rank processes on one card (gloo), Mixtral "
        f"widths at {MOE_RANK_LAYERS} layer: ep = {MOE_RANKS} (4 experts a "
        f"rank, make_sharded_train_step) and dp = {MOE_RANKS} (global "
        f"capacity over the two row shards) against the one-rank step: "
        f"sound within {limits}; planted faults "
        f"{sum(MOE_FAULTS.values(), ())} each rejected; ep step "
        f"{r0['ms']['sound']:.1f} ms (gloo through the host: not a speed); "
        f"peak " + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks)
        + f" GiB a rank; on {smi}")
    return launches


# ------------------------------------------------------------- pipeline

def _pp_cfg(**kw):
    from ray_tpu_torch.profile_train import flagship_config

    return flagship_config(**{"remat_policy": "full", **kw})


def pp_params(cfg, stages):
    """The flagship's weights (`llama_init`, seed 0) as the pipeline's
    tree: the layers stacked per stage, [stages, L / stages, ...]."""
    from ray_tpu_torch.models.llama import llama_init

    p = llama_init(cfg, seed=0, device="cuda")
    layers = p.pop("layers")
    p["stages"] = {k: v.reshape((stages, cfg.n_layers // stages)
                                + v.shape[1:]) for k, v in layers.items()}
    return p


def pp_specs(params):
    return {k: ({n: ("pp",) + (None,) * (v.dim() - 1)
                 for n, v in params["stages"].items()} if k == "stages"
                else (None,) * params[k].dim()) for k in params}


def pp_stage_fn(cfg):
    """One stage: its decoder layers in turn, each under a checkpoint."""
    from torch.utils.checkpoint import checkpoint

    from ray_tpu_torch.models.llama import _decoder_layer

    def stage(p, x):
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[0], x.shape[1])
        per = {n: torch.unbind(w) for n, w in p.items()}
        for i in range(len(next(iter(per.values())))):
            layer = {n: ws[i] for n, ws in per.items()}
            x = checkpoint(_decoder_layer, x, layer, positions, cfg,
                           use_reentrant=False)
        return x

    return stage


def pp_loss_fn(cfg, pipelined):
    """Embedding, final norm, head and loss outside the pipeline."""
    from ray_tpu_torch.models.llama import _nll, _rmsnorm

    def loss_fn(p, b):
        inputs, targets = b["tokens"][:, :-1], b["tokens"][:, 1:]
        h = p["tok_embed"][inputs.long()].to(cfg.dtype)
        h = pipelined(p["stages"], h)
        h = _rmsnorm(h, p["final_norm"], cfg.norm_eps)
        return _nll(h, targets, p["lm_head"], cfg).mean()

    return loss_fn


def _pp_reference(cfg, batch):
    """The flagship's one-card loss and gradients (llama_loss, as
    make_train_step computes them) in the pipeline tree's names."""
    from ray_tpu_torch.models.llama import llama_init

    params = llama_init(cfg, seed=0, device="cuda")
    loss, norm, grads = _loss_grads(cfg, params, batch)
    named = dict(zip([n for n, _ in _named_leaves(params)], grads))
    out = {(f"stages/{n[len('layers/'):]}" if n.startswith("layers/")
            else n): g for n, g in named.items()}
    return loss, norm, out


@contextlib.contextmanager
def _pp_fault(fault):
    """A planted fault of the pipeline's hand-offs."""
    from ray_tpu_torch.parallel import pipeline as pl
    from ray_tpu_torch.parallel.sequence_parallel import Pending

    real = pl._hand_off
    if fault == "handoff-late":          # a stage takes the previous tick's
        held = []

        def late(pp, send, dst, like, src):
            pending = real(pp, send, dst, like, src)
            if like is None or not torch.is_grad_enabled():
                return pending
            got = pending.wait()[0]
            held.append(got)
            return Pending([], [held[-2] if len(held) > 1
                                else torch.zeros_like(got)], None)

        with mock.patch.object(pl, "_hand_off", late):
            yield
    else:                                # the backward sends zeros
        assert fault == "backward-dropped", fault

        def dropped(pp, send, dst, like, src):
            if send is not None and not torch.is_grad_enabled():
                send = torch.zeros_like(send)
            return real(pp, send, dst, like, src)

        with mock.patch.object(pl, "_hand_off", dropped):
            yield


def _pp_step(cfg, batch, mesh, stages, steps=0):
    """make_sharded_train_step of the pipelined loss over ``mesh``: the
    first step's loss, norm and the rank's gradients (AdamW's first
    moment / (1 - b1)), then ``steps`` timed steps (their ms, the share
    of each step the rank's stages spend in their forward, and the
    flash launches)."""
    from ray_tpu_torch import adamw, make_sharded_train_step
    from ray_tpu_torch.parallel import make_pipelined_fn

    stage = pp_stage_fn(cfg)
    busy = [0.0]

    def timed_stage(p, x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = stage(p, x)
        torch.cuda.synchronize()
        busy[0] += time.perf_counter() - t0
        return y

    opt = adamw(3e-4, weight_decay=0.0)
    params = pp_params(cfg, stages)
    init_fn, step_fn = make_sharded_train_step(
        pp_loss_fn(cfg, make_pipelined_fn(timed_stage, mesh, PP_MICRO)), opt,
        mesh, pp_specs(params))
    p, s = init_fn(params)
    del params
    _, _, m = step_fn(p, s, batch)
    loss, norm = m["loss"].item(), m["grad_norm"].item()
    grads = [(n, g.detach() / (1 - opt.b1)) for n, g in
             _named_leaves(opt.state_tree(s, p)["exp_avg"])]
    times, shares, losses = [], [], [loss]
    _zero_flash_counts()
    for _ in range(steps):
        busy[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_fn(p, s, batch)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
        shares.append(busy[0] / times[-1])
    return {"loss": loss, "norm": norm, "grads": grads, "times": times,
            "busy": shares, "losses": losses, "launches": _flash_counts()}


def _pp_gate(got, ref, mesh):
    from ray_tpu_torch.parallel.sharding import local_region

    pairs = []
    for n, g in got["grads"]:
        w = ref[2][n]
        if n.startswith("stages/"):
            w = w.reshape(g.shape[:0] + (mesh.mesh.shape[
                list(mesh.mesh_dim_names).index("pp")], -1) + w.shape[1:])
            w = w[local_region(w.shape, ("pp",) + (None,) * (w.dim() - 1),
                               mesh)]
        pairs.append((n, g, w))
    return _gate(got["loss"], got["norm"], pairs, ref[0], ref[1])


def pp_rank_main(rank, job_path):
    """One rank of the pipeline phase's (b), started as ``python3
    chip_smoke.py --pp-rank RANK JOB``: a gloo world of PP_RANKS
    processes on the one card, pp = PP_RANKS, each rank first computing
    the one-card step's loss and gradients itself."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import create_mesh
    from ray_tpu_torch.profile_train import train_batch

    with open(job_path) as f:
        job = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo", init_method=job["store"],
                            world_size=PP_RANKS, rank=rank)
    out = {"rank": rank, "gates": {}}
    try:
        cfg = _pp_cfg()
        batch = train_batch(cfg)
        ref = _pp_reference(cfg, batch)
        mesh = create_mesh({"pp": PP_RANKS})
        for fault in (None,) + PP_FAULTS:
            with _pp_fault(fault) if fault else contextlib.nullcontext():
                got = _pp_step(cfg, batch, mesh, PP_RANKS,
                               steps=0 if fault else 1)
            out["gates"][fault or "sound"] = _pp_gate(got, ref, mesh)
            if not fault:
                out["ms"], out["busy"] = got["times"][0], got["busy"][0]
            del got
            torch.cuda.empty_cache()
        out["peak"] = torch.cuda.max_memory_allocated()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def pipeline_phase(smi):
    """The GPipe pipeline on bench.py's flagship: (a) pp = 1 on one NCCL
    rank against make_train_step's loss and gradients, timed; (b) pp =
    PP_RANKS as gloo processes on the card with planted faults. Returns
    (a)'s flash launches in its timed steps."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import create_mesh, initialize_distributed
    from ray_tpu_torch.profile_train import BATCH, SEQ, train_batch
    from ray_tpu_torch.models.llama import llama_flops_per_token

    cfg = _pp_cfg()
    batch = train_batch(cfg)
    with _plain_attention_forbidden():
        ref = _pp_reference(cfg, batch)
    torch.cuda.empty_cache()
    limits = (PARITY_LOSS_RTOL, PARITY_NORM_RTOL, PARITY_MIN_COS)
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = create_mesh({"pp": 1})
        torch.cuda.reset_peak_memory_stats()
        with _plain_attention_forbidden():
            got = _pp_step(cfg, batch, mesh, 1, steps=PP_STEPS)
        peak = torch.cuda.max_memory_allocated()
        gate = _pp_gate(got, ref, mesh)
    finally:
        dist.destroy_process_group()
    del ref
    torch.cuda.empty_cache()
    L = cfg.n_layers
    # every layer runs once per microbatch (twice forward: remat)
    want = {"fwd": 2 * L * PP_MICRO * PP_STEPS,
            "dq": L * PP_MICRO * PP_STEPS, "dkv": L * PP_MICRO * PP_STEPS}
    tok_s = BATCH * SEQ * PP_STEPS / sum(got["times"])
    mfu = tok_s * llama_flops_per_token(cfg, SEQ) / BF16_FLOPS_PER_S
    log(f"[pipeline] (a) bench.py's flagship ({L} layers, full remat) as "
        f"one stage over {{'pp': 1}} on one NCCL rank, batch {BATCH} x {SEQ}"
        f" in {PP_MICRO} microbatches, embedding/final norm/head outside: "
        f"first step against make_train_step's llama_loss: "
        f"{_gate_text(gate)} (limits {limits}); losses "
        f"{[round(x, 4) for x in got['losses']]}; launches in {PP_STEPS} "
        f"steps {got['launches']}; step {np.mean(got['times']) * 1e3:.1f} "
        f"ms mean, {tok_s:.0f} tokens/s, MFU {mfu:.2%}; stage compute "
        f"{np.mean(got['busy']):.1%} of the step; peak {peak / 2**30:.2f} "
        f"GiB; on {smi}")
    assert _gate_ok(gate, limits), f"[pipeline] (a) FAILED {gate}"
    assert got["launches"] == want, (got["launches"], want)
    assert got["losses"][-1] < got["losses"][0], got["losses"]
    launches = got["launches"]
    del got
    torch.cuda.empty_cache()
    ranks = _rank_world("pp-rank", PP_RANKS, "pipeline")
    S, T = PP_RANKS, PP_MICRO
    for r in ranks:
        for key, g in r["gates"].items():
            log(f"[pipeline] (b) rank {r['rank']} {key}: {_gate_text(g)}")
        assert _gate_ok(r["gates"]["sound"], limits), \
            f"[pipeline] (b) pp = {S} FAILED on rank {r['rank']}"
    for fault in PP_FAULTS:
        assert not all(_gate_ok(r["gates"][fault], limits) for r in ranks), \
            f"[pipeline] (b) planted fault {fault} passed the gate"
    log(f"[pipeline] (b) {S} rank processes on one card (gloo), pp = {S}, "
        f"{L // S} layers a stage, {T} microbatches: every rank's loss, "
        f"norm and gradient shards within {limits} of the one-card step; "
        f"planted faults {PP_FAULTS} each rejected; step "
        + ", ".join(f"{r['ms'] * 1e3:.1f}" for r in ranks)
        + " ms, stage compute "
        + ", ".join(f"{r['busy']:.1%}" for r in ranks)
        + f" of it by rank against GPipe's bubble (S - 1) / (T + S - 1) = "
        f"{(S - 1) / (T + S - 1):.1%} (two processes share the card and "
        f"gloo hands off through the host: not a speed); peak "
        + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks)
        + f" GiB a rank; on {smi}")
    return launches


# ------------------------------------------------------------ vit-t5-mlp

def _a13_steps(label, loss_fn, params, specs, batch, mesh, lr):
    """Warm-up and A13_STEPS timed steps through make_sharded_train_step;
    returns (losses, ms per step, flash launches, peak bytes, the trained
    params, the warm-up step's (loss, grad norm))."""
    from ray_tpu_torch import adamw, make_sharded_train_step

    init_fn, step_fn = make_sharded_train_step(loss_fn, adamw(lr), mesh,
                                               specs)
    torch.cuda.reset_peak_memory_stats()
    p, s = init_fn(params)
    p, s, m = step_fn(p, s, batch)
    losses, times = [m["loss"].item()], []
    first = (losses[0], m["grad_norm"].item())
    _zero_flash_counts()
    for _ in range(A13_STEPS):
        t0 = time.perf_counter()
        p, s, m = step_fn(p, s, batch)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
    assert all(np.isfinite(losses)), (label, losses)
    assert losses[-1] < losses[0], f"{label}: loss did not fall {losses}"
    return losses, np.mean(times) * 1e3, _flash_counts(), \
        torch.cuda.max_memory_allocated(), p, first


def _parity(label, loss_fn, cfg, params, batch):
    """One step's loss and gradients with the kernels against the plain
    attention, from the same weights and batch."""
    from ray_tpu_torch.models.training import _tree_map

    out = []
    for c in (cfg, dataclasses.replace(cfg, attn_impl="reference")):
        tree = _tree_map(lambda p: p.detach().requires_grad_(), params)
        named = _named_leaves(tree)
        loss = loss_fn(tree, batch, c)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        out.append((loss.item(), torch.nn.utils.get_total_norm(grads).item(),
                    [(n, g) for (n, _), g in zip(named, grads)]))
    gate = _gate(out[0][0], out[0][1], [(n, a, b) for (n, a), (_, b) in
                                        zip(out[0][2], out[1][2])],
                 out[1][0], out[1][1])
    limits = (PARITY_LOSS_RTOL, PARITY_NORM_RTOL, PARITY_MIN_COS)
    log(f"{label}: one step's loss and gradients, kernels vs plain "
        f"attention: {_gate_text(gate)} (limits {limits})")
    assert _gate_ok(gate, limits), f"{label}: parity FAILED {gate}"


def _t5_generation(cfg, params, src):
    """t5_generate's greedy tokens against an uncached argmax rollout
    through t5_forward, in f32 (equal token for token) and in the
    trained config's bf16 (agreement printed)."""
    from ray_tpu_torch.models.t5 import t5_forward, t5_generate

    out = {}
    for name, c in (("f32", dataclasses.replace(cfg, dtype=torch.float32)),
                    ("bf16", cfg)):
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = t5_generate(params, src, c, max_new_tokens=T5_NEW)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            tgt = torch.ones((src.shape[0], 1), dtype=torch.long,
                             device="cuda")
            for _ in range(T5_NEW):
                nxt = t5_forward(params, src, tgt, c)[:, -1].argmax(-1)
                tgt = torch.cat([tgt, nxt[:, None]], dim=1)
        out[name] = (float((gen.long() == tgt[:, 1:]).float().mean()), ms)
    return out


def vit_t5_mlp_phase(smi):
    """ViT, T5 and the MLP at their default configs: parity with the
    plain attention, steps over {"dp": 1, "tp": 1} on one NCCL rank (the
    tp = 1 step against the step without a tp group), T5's greedy
    generation against its uncached rollout, and the flash kernels at
    the new shapes. Returns the flash launches per model and the flash
    results."""
    import torch.distributed as dist

    from ray_tpu_torch.models import mlp, t5, vit
    from ray_tpu_torch.parallel import (create_mesh, initialize_distributed,
                                        tp_group)

    fres = flash_phase(A13_FLASH_CASES,
                       tuple(c[0] for c in A13_FLASH_CASES),
                       phase="vit-t5-mlp")
    rng = np.random.RandomState(7)
    vc, tc, mc = vit.ViTConfig(), t5.T5Config(), mlp.MLPConfig()
    vb = {"images": torch.from_numpy(rng.rand(256, 32, 32, 3).astype(
        np.float32)).cuda(), "labels": torch.from_numpy(
        rng.randint(0, 10, 256)).cuda()}
    tb = {"src": torch.from_numpy(rng.randint(1, tc.vocab_size, (32, 512))
                                  ).cuda(),
          "tgt": torch.from_numpy(rng.randint(1, tc.vocab_size, (32, 129))
                                  ).cuda()}
    mb = {"x": torch.from_numpy(rng.rand(256, 784).astype(np.float32)
                                ).cuda(),
          "y": torch.from_numpy(rng.randint(0, 10, 256)).cuda()}
    vp, tp, mp = (vit.vit_init(vc, device="cuda"),
                  t5.t5_init(tc, device="cuda"),
                  mlp.mlp_init(mc, device="cuda"))
    _parity("[vit-t5-mlp] ViTConfig() (dim 192, 6 layers, 6 heads of 32, "
            "65 tokens), batch 256", vit.vit_loss, vc, vp, vb)
    _parity("[vit-t5-mlp] T5Config() (vocab 32000, dim 512, 6 + 6 layers, 8 "
            "heads of 64, ffn 1024), batch 32 x (512 source, 128 target)",
            t5.t5_loss, tc, tp, tb)
    # the MLP on the card against the same step on the CPU (f32, TF32 off)
    from ray_tpu_torch.models.training import _tree_map

    cos = []
    for dev in ("cuda", "cpu"):
        tree = _tree_map(lambda p: p.detach().to(dev).requires_grad_(), mp)
        loss = mlp.mlp_loss(tree, {k: v.to(dev) for k, v in mb.items()}, mc)
        cos.append((loss.item(), torch.autograd.grad(
            loss, [p for _, p in _named_leaves(tree)])))
    mgate = _gate(cos[0][0], torch.nn.utils.get_total_norm(cos[0][1]).item(),
                  [(str(i), a.cpu(), b) for i, (a, b) in
                   enumerate(zip(cos[0][1], cos[1][1]))], cos[1][0],
                  torch.nn.utils.get_total_norm(cos[1][1]).item())
    log(f"[vit-t5-mlp] MLPConfig() (784-512-512-10, f32): one step on the "
        f"card against the CPU: {_gate_text(mgate)}")
    assert _gate_ok(mgate, (1e-5, 1e-5, 0.99999)), mgate
    del cos
    launches, res = {}, {}
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = create_mesh({"dp": 1, "tp": 1})
        group = tp_group(mesh)
        from ray_tpu_torch.ops import flash_attention_kernel as fak

        with _plain_attention_forbidden():
            for name, loss_fn, cfg, params, specs, batch, lr in (
                    ("vit", vit.vit_loss, vc, vp, vit.vit_param_specs(vc), vb,
                     2e-5),
                    ("t5", t5.t5_loss, tc, tp, t5.t5_param_specs(tc), tb,
                     1e-4),
                    ("mlp", mlp.mlp_loss, mc, mp,
                     _tree_map(lambda _: (), mp), mb, 1e-4)):
                # the MLP names no logical axis: it takes no tp group
                kw = {} if name == "mlp" else {"tp": group}
                plain_first, plain_ms = _one_step(
                    lambda p, b, c=cfg, f=loss_fn: f(p, b, c), params,
                    specs, batch, mesh, lr)
                losses, ms, counts, peak, trained, first = _a13_steps(
                    f"[vit-t5-mlp] {name}",
                    lambda p, b, c=cfg, f=loss_fn, kw=kw: f(p, b, c, **kw),
                    params, specs, batch, mesh, lr)
                _tp1_same(f"[vit-t5-mlp] {name}", first, ms, plain_first,
                          plain_ms, smi)
                masks = {m: dict(c) for m, c in fak.mask_launches.items()}
                launches[name] = (counts, masks)
                res[name] = trained
                log(f"[vit-t5-mlp] {name}: make_sharded_train_step over "
                    f"{{'dp': 1, 'tp': 1}}, adamw({lr:g}): losses "
                    f"{[round(x, 4) for x in losses]}; step {ms:.1f} ms "
                    f"mean; flash launches in {A13_STEPS} steps {counts} "
                    f"(by mask {masks}); peak {peak / 2**30:.2f} GiB; on "
                    f"{smi}")
        L = vc.n_layers
        assert launches["vit"][0] == {"fwd": 2 * L * A13_STEPS,
                                      "dq": L * A13_STEPS,
                                      "dkv": L * A13_STEPS}, launches["vit"]
        L = 3 * tc.n_layers        # encoder, decoder self, cross
        assert launches["t5"][0] == {"fwd": 2 * L * A13_STEPS,
                                     "dq": L * A13_STEPS,
                                     "dkv": L * A13_STEPS}, launches["t5"]
        assert launches["mlp"][0] == {"fwd": 0, "dq": 0, "dkv": 0}
    finally:
        dist.destroy_process_group()
    gen = _t5_generation(tc, res["t5"], tb["src"][:T5_SOURCES])
    log(f"[vit-t5-mlp] t5_generate greedy, {T5_NEW} new tokens for "
        f"{T5_SOURCES} sources of 512 (the trained weights): against an "
        f"uncached argmax rollout through t5_forward, f32 agreement "
        f"{gen['f32'][0]:.4f} (must be 1), bf16 {gen['bf16'][0]:.4f} "
        f"(printed); generate {gen['f32'][1]:.1f} / {gen['bf16'][1]:.1f} "
        f"ms")
    assert gen["f32"][0] == 1.0, gen
    return launches, fres


# a13-tp (ROADMAP A13b, its tp half): (b) MoE, ViT, T5 and the MLP at
# nano widths in f32 (head dim 32, so the flash kernels run) over
# {"tp": 2}: A13_TP_RANKS gloo processes on the one card, three AdamW
# steps against the unsplit step that each rank runs itself on the card;
# the metrics within 1e-4 relative and the rank's block of the params
# within 1e-5 + lr / 10 (the CPU worlds' tolerances, with their AdamW
# eps of 1e-6: Adam's first steps move a weight by about lr · sign(g),
# and an eps far below a near-cancelling gradient lets the summation
# order flip a step). One planted fault each for ViT, MoE and T5
# (A13_TP_FAULTS) must fail the gate. The f32 widths take the exact f32
# flash kernels; then each rank makes two bf16 steps over {"tp": 2} of
# ViTConfig() and T5Config() at the vit-t5-mlp phase's batches and of
# Mixtral's widths at MOE_RANK_LAYERS layer(s) at the moe phase's batch
# (loss finite and falling), the flash counts zeroed just before the
# second: the wgmma kernels' launches per step at each shape are read
# from it. (c) B1, B3a and B3b at those shapes (A13_TP_FLASH_CASES: the
# tp = 2 ranks' head counts), timed beside their bounds, plain versions
# and SDPA; each row's launches are its own route's and shape's in that
# counted step.
A13_TP_RANKS, A13_TP_LR, A13_TP_EPS = 2, 1e-3, 1e-6
A13_TP_FAULTS = {"vit": "wqkv-contiguous", "moe": "we_down-unsummed",
                 "t5": "vocab-local-ce"}
A13_TP_FLASH_CASES = [
    ("vit_tp2", 256, 3, 3, 65, 65, 32, "bf16", False),
    ("t5_enc_tp2", 32, 4, 4, 512, 512, 64, "bf16", False),
    ("t5_dec_tp2", 32, 4, 4, 128, 128, 64, "bf16", True),
    ("t5_cross_tp2", 32, 4, 4, 128, 512, 64, "bf16", False),
    ("moe_tp2", 2, 16, 4, 2048, 2048, 128, "bf16", True),
]
# the cases each family's counted bf16 step runs, and its AdamW lr (the
# vit-t5-mlp and moe phases' own)
A13_TP_COUNTED = {"vit": (("vit_tp2",), 2e-5),
                  "t5": (("t5_enc_tp2", "t5_dec_tp2", "t5_cross_tp2"), 1e-4),
                  "moe": (("moe_tp2",), 3e-4)}


def _a13_tp_case_key(case):
    """`shape_launches`' key of an A13_TP_FLASH_CASES case (the wgmma
    route: the cases are bf16)."""
    from ray_tpu_torch.ops.flash_attention_kernel import shape_key

    _, B, H, Hkv, Sq, Sk, D, dtype, causal = next(
        c for c in A13_TP_FLASH_CASES if c[0] == case)
    assert dtype == "bf16", case
    return shape_key("sm90", causal, B, H, Hkv, Sq, Sk, D)


def _a13_tp_models():
    """[(name, loss_fn(params, batch, tp), params, specs, batch)]: the
    four families at nano widths in f32, seeded, on the card."""
    from ray_tpu_torch.models import mlp, moe, t5, vit
    from ray_tpu_torch.models.training import _tree_map

    rng = np.random.RandomState(11)

    def card(x):
        return torch.from_numpy(x).cuda()

    f32 = torch.float32
    mo = moe.MoeConfig.nano_moe(dim=128, dtype=f32)
    vi = vit.ViTConfig(image_size=8, patch_size=4, dim=64, n_layers=2,
                       n_heads=2, ffn_dim=96, dtype=f32)
    tf = t5.T5Config.nano(dim=128, dtype=f32)
    ml = mlp.MLPConfig(in_dim=20, hidden=(16, 12))
    mp = mlp.mlp_init(ml, seed=3, device="cuda")
    return [
        ("moe", lambda p, b, tp: moe.moe_loss(p, b, mo, tp=tp),
         moe.moe_init(mo, seed=0, device="cuda"), moe.moe_param_specs(mo),
         {"tokens": card(rng.randint(0, mo.vocab_size, (4, 33)))}),
        ("vit", lambda p, b, tp: vit.vit_loss(p, b, vi, tp=tp),
         vit.vit_init(vi, seed=1, device="cuda"), vit.vit_param_specs(vi),
         {"images": card(rng.rand(4, 8, 8, 3).astype(np.float32)),
          "labels": card(rng.randint(0, 10, (4,)))}),
        ("t5", lambda p, b, tp: t5.t5_loss(p, b, tf, tp=tp),
         t5.t5_init(tf, seed=2, device="cuda"), t5.t5_param_specs(tf),
         {"src": card(rng.randint(1, tf.vocab_size, (4, 24))),
          "tgt": card(rng.randint(0, tf.vocab_size, (4, 17)))}),
        ("mlp", lambda p, b, tp: mlp.mlp_loss(p, b, ml), mp,
         _tree_map(lambda _: (), mp),
         {"x": card(rng.rand(6, 20).astype(np.float32)),
          "y": card(rng.randint(0, 10, (6,)))}),
    ]


def _a13_tp_full(name):
    """(loss_fn(params, batch, tp), params, specs, batch) of ``name`` at
    the counted bf16 step's size, seeded, on the card."""
    from ray_tpu_torch.models import moe, t5, vit

    rng = np.random.RandomState(13)

    def card(x):
        return torch.from_numpy(x).cuda()

    if name == "vit":
        c = vit.ViTConfig()
        return (lambda p, b, tp: vit.vit_loss(p, b, c, tp=tp),
                vit.vit_init(c, device="cuda"), vit.vit_param_specs(c),
                {"images": card(rng.rand(256, 32, 32, 3).astype(np.float32)),
                 "labels": card(rng.randint(0, 10, 256))})
    if name == "t5":
        c = t5.T5Config()
        return (lambda p, b, tp: t5.t5_loss(p, b, c, tp=tp),
                t5.t5_init(c, device="cuda"), t5.t5_param_specs(c),
                {"src": card(rng.randint(1, c.vocab_size, (32, 512))),
                 "tgt": card(rng.randint(1, c.vocab_size, (32, 129)))})
    assert name == "moe", name
    c = _moe_cfg(n_layers=MOE_RANK_LAYERS)
    return (lambda p, b, tp: moe.moe_loss(p, b, c, tp=tp),
            moe.moe_init(c, seed=0, device="cuda"), moe.moe_param_specs(c),
            moe_batch(c))


def _a13_tp_counted(name, mesh, tp):
    """Two bf16 AdamW steps of ``name`` (`_a13_tp_full`) over the tp
    mesh, the flash counts zeroed just before the second: {"losses",
    "ms" (the second step), "shapes" (its `shape_launches`), "peak"}."""
    from ray_tpu_torch import adamw, make_sharded_train_step
    from ray_tpu_torch.ops import flash_attention_kernel as fak

    loss_fn, params, specs, batch = _a13_tp_full(name)
    init, step = make_sharded_train_step(
        lambda p, b: loss_fn(p, b, tp), adamw(A13_TP_COUNTED[name][1]),
        mesh, specs)
    p, s = init(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p, s, m = step(p, s, batch)
    losses = [m["loss"].item()]
    _zero_flash_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, s, m = step(p, s, batch)
    losses.append(m["loss"].item())
    ms = (time.perf_counter() - t0) * 1e3
    out = {"losses": losses, "ms": ms,
           "shapes": {k: dict(c) for k, c in fak.shape_launches.items()},
           "peak": torch.cuda.max_memory_allocated()}
    del p, s, m
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _a13_tp_fault(fault):
    """A planted fault of the tp layer of ViT, MoE or T5."""
    import torch.nn.functional as F

    from ray_tpu_torch.models import moe, vit
    from ray_tpu_torch.parallel import tensor_parallel

    if fault == "wqkv-contiguous":    # the shard used as if head-aligned
        patch = (vit, "fused_heads", lambda w, tp, width, n_heads: w)
    elif fault == "we_down-unsummed":  # no sum over tp after the combine
        patch = (moe, "_from_experts",
                 lambda x, ep, tp: moe.reduce_from_tp(x, ep))
    else:                              # the rank's vocab shard alone
        assert fault == "vocab-local-ce", fault

        def local(logits, targets, tp):
            n = logits.shape[-1]
            t = (targets.long() - tp.rank * n).clamp(0, n - 1)
            return F.cross_entropy(logits, t, reduction="none")

        patch = (tensor_parallel, "vocab_cross_entropy", local)
    with mock.patch.object(*patch):
        yield


def _a13_tp_steps(step_fn, params, state, batch):
    """A13_STEPS steps: ([[loss, grad norm]], params)."""
    metrics = []
    for _ in range(A13_STEPS):
        params, state, m = step_fn(params, state, batch)
        metrics.append([m["loss"].item(), m["grad_norm"].item()])
    return metrics, params


def _a13_tp_gate(metrics, params, one_metrics, one_params, specs, mesh):
    """(largest relative error of the metrics, largest excess of a param
    of this rank's block over 1e-5 |want| + lr / 10, its leaf): ok when
    the first is <= 1e-4 and the second <= 0."""
    from ray_tpu_torch.parallel.sharding import local_region

    got, want = np.asarray(metrics), np.asarray(one_metrics)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    excess = (-np.inf, "")
    for (name, p), (_, w), (_, spec) in zip(_named_leaves(params),
                                            _named_leaves(one_params),
                                            _named_leaves(specs)):
        w = w[local_region(w.shape, spec, mesh)]
        excess = max(excess, (((p - w).abs() - 1e-5 * w.abs()
                               - A13_TP_LR / 10).max().item(), name))
    return (rel,) + excess


def _a13_tp_ok(gate):
    return gate[0] <= 1e-4 and gate[1] <= 0


def a13_tp_rank_main(rank, job_path):
    """One rank of the a13-tp phase's (b), started as ``python3
    chip_smoke.py --a13-tp-rank RANK JOB``: a gloo world of A13_TP_RANKS
    processes on the one card."""
    import torch.distributed as dist

    from ray_tpu_torch import adamw, make_sharded_train_step
    from ray_tpu_torch.models.training import _tree_map, make_train_step
    from ray_tpu_torch.parallel import create_mesh, tp_group

    with open(job_path) as f:
        job = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("cpu:gloo,cuda:gloo", init_method=job["store"],
                            world_size=A13_TP_RANKS, rank=rank)
    out = {"rank": rank, "gates": {}, "launches": {}, "ms": {}}
    try:
        mesh = create_mesh({"tp": A13_TP_RANKS})
        tp = tp_group(mesh)
        for name, loss_fn, params, specs, batch in _a13_tp_models():
            opt = adamw(A13_TP_LR, eps=A13_TP_EPS)
            init, step = make_train_step(
                lambda p, b, f=loss_fn: f(p, b, None), opt)
            # the one-card step updates its leaves in place: a copy
            one_metrics, one_params = _a13_tp_steps(
                step, *init(_tree_map(torch.clone, params)), batch)
            # one step for the sound run and the fault's: a fault is
            # patched in where the model looks its function up
            init, step = make_sharded_train_step(
                lambda p, b, f=loss_fn: f(p, b, tp), opt, mesh, specs)
            faults = (A13_TP_FAULTS[name],) if name in A13_TP_FAULTS else ()
            for fault in (None,) + faults:
                p, s = init(params)
                with _a13_tp_fault(fault) if fault else \
                        contextlib.nullcontext():
                    _zero_flash_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    metrics, p = _a13_tp_steps(step, p, s, batch)
                    ms = (time.perf_counter() - t0) * 1e3 / A13_STEPS
                    counts = _flash_counts()
                key = f"{name}:{fault or 'sound'}"
                out["gates"][key] = _a13_tp_gate(metrics, p, one_metrics,
                                                 one_params, specs, mesh)
                if fault is None:
                    out["launches"][name] = counts
                    out["ms"][name] = ms
                del p, s
        out["counted"] = {name: _a13_tp_counted(name, mesh, tp)
                          for name in A13_TP_COUNTED}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def a13_tp_phase(smi):
    """(b) the four families over {"tp": 2} in gloo processes on the card
    with planted faults; (c) the flash kernels at the tp = 2 ranks'
    shapes. Returns ((b)'s launches in its counted bf16 step by case of
    A13_TP_FLASH_CASES, (c)'s flash results)."""
    t0 = time.perf_counter()
    ranks = _rank_world("a13-tp-rank", A13_TP_RANKS, "a13-tp")
    for r in ranks:
        for key, (rel, excess, leaf) in r["gates"].items():
            log(f"[a13-tp] (b) rank {r['rank']} {key}: metrics rel. error "
                f"{rel:.3e} (<= 1e-4), params excess over 1e-5 |want| + "
                f"lr / 10: {excess:.3e} (<= 0, {leaf})")
    for r in ranks:
        for name in ("moe", "vit", "t5", "mlp"):
            assert _a13_tp_ok(r["gates"][f"{name}:sound"]), \
                f"[a13-tp] (b) {name} tp = 2 FAILED on rank {r['rank']}"
    for name, fault in A13_TP_FAULTS.items():
        assert not all(_a13_tp_ok(r["gates"][f"{name}:{fault}"])
                       for r in ranks), \
            f"[a13-tp] (b) planted fault {fault} passed the gate"
    r0 = ranks[0]
    nano = {name: {k: v / A13_STEPS for k, v in counts.items()}
            for name, counts in r0["launches"].items()}
    assert all(n > 0 for name in ("moe", "vit", "t5")
               for n in nano[name].values()), \
        f"[a13-tp] (b) a flash kernel of the f32 tp = 2 steps never ran {nano}"
    log(f"[a13-tp] (b) {A13_TP_RANKS} rank processes on one card (gloo): "
        "MoE, ViT, T5 and the MLP over {'tp': 2} at nano widths in f32, "
        f"{A13_STEPS} AdamW steps against the unsplit step: sound on every "
        f"rank; planted faults {tuple(A13_TP_FAULTS.values())} each "
        "rejected; step ms (gloo through the host: not a speed) "
        + ", ".join(f"{k} {v:.1f}" for k, v in r0["ms"].items())
        + "; f32 flash launches per step on rank 0 (fwd/dq/dkv): "
        + ", ".join(f"{k} {tuple(c.values())}" for k, c in nano.items()
                    if k != "mlp") + f"; on {smi}")
    # the bf16 steps at the default widths: every launch of the counted
    # step on the wgmma route at the family's named shapes, the same on
    # every rank
    counted = {}
    for name, (cases, lr) in A13_TP_COUNTED.items():
        runs = [r["counted"][name] for r in ranks]
        for r, run in zip(ranks, runs):
            losses = run["losses"]
            assert np.all(np.isfinite(losses)) and losses[1] < losses[0], \
                f"[a13-tp] (b) {name} bf16 rank {r['rank']}: {losses}"
        keys = {case: _a13_tp_case_key(case) for case in cases}
        shapes = runs[0]["shapes"]
        assert all(run["shapes"] == shapes for run in runs), \
            f"[a13-tp] (b) {name} bf16: ranks launched differently"
        assert set(shapes) == set(keys.values()) and all(
            n > 0 for c in shapes.values() for n in c.values()), \
            f"[a13-tp] (b) {name} bf16: launches {shapes}, want {keys}"
        counted.update({case: shapes[key] for case, key in keys.items()})
        log(f"[a13-tp] (b) {name} bf16 over {{'tp': 2}}, adamw({lr:g}): "
            f"losses {[round(x, 4) for x in runs[0]['losses']]} on rank 0; "
            f"counted step {runs[0]['ms']:.1f} ms (gloo through the host: "
            f"not a speed); flash launches in it {shapes}; peak "
            + ", ".join(f"{run['peak'] / 2**30:.2f}" for run in runs)
            + f" GiB a rank; on {smi}")
    log(f"[a13-tp] (b) {time.perf_counter() - t0:.1f} s")
    fres = flash_phase(A13_TP_FLASH_CASES,
                       tuple(c[0] for c in A13_TP_FLASH_CASES),
                       phase="a13-tp")
    return counted, fres


# --ep-cards N / --pp-cards N: the moe and pipeline phases' models over N
# cards, one NCCL rank a card.
EP_CARDS_LAYERS = 8


def _timed_steps(step_fn, p, s, batch, steps):
    p, s, m = step_fn(p, s, batch)
    losses, times = [m["loss"].item()], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, m = step_fn(p, s, batch)
        losses.append(m["loss"].item())
        times.append(time.perf_counter() - t0)
    return losses, float(np.mean(times) * 1e3)


def ep_card_rank_main(rank, job_path):
    """One rank of ``--ep-cards``: Mixtral's widths at EP_CARDS_LAYERS
    layers over {"ep": n}, n / 8 of the experts a card; rank 0 then
    times the one-card step at MOE_LAYERS layers."""
    import torch.distributed as dist

    from ray_tpu_torch import adamw, make_sharded_train_step
    from ray_tpu_torch.models.moe import moe_init, moe_loss, moe_param_specs
    from ray_tpu_torch.parallel import (create_mesh, initialize_distributed,
                                        tp_group)

    with open(job_path) as f:
        job = json.load(f)
    n = job["n"]
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(job["store"], n, rank)
    out = {"rank": rank}
    try:
        cfg = _moe_cfg(n_layers=EP_CARDS_LAYERS)
        batch = moe_batch(cfg)
        mesh = create_mesh({"ep": n})
        ep = tp_group(mesh, "ep")
        init_fn, step_fn = make_sharded_train_step(
            lambda p, b: moe_loss(p, b, cfg, ep=ep),
            adamw(3e-4, weight_decay=0.0), mesh, moe_param_specs(cfg))
        torch.cuda.reset_peak_memory_stats()
        p, s = init_fn(moe_init(cfg, seed=0, device="cuda"))
        torch.cuda.empty_cache()
        out["losses"], out["ms"] = _timed_steps(step_fn, p, s, batch,
                                                MOE_STEPS)
        out["peak"] = torch.cuda.max_memory_allocated()
        del p, s, step_fn
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            from ray_tpu_torch import make_train_step

            one = _moe_cfg()
            init1, step1 = make_train_step(
                lambda p, b: moe_loss(p, b, one),
                adamw(3e-4, weight_decay=0.0))
            p, s = init1(moe_init(one, seed=0, device="cuda"))
            out["one_losses"], out["one_ms"] = _timed_steps(
                step1, p, s, batch, MOE_STEPS)
            del p, s
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def ep_cards_main(n):
    """``python3 chip_smoke.py --ep-cards N``: Mixtral's widths at
    EP_CARDS_LAYERS layers over ep = N cards (NCCL), against one card's
    step at MOE_LAYERS layers, per layer; the all-reduce bytes the ep
    layer moves."""
    name, count, smi = device_phase()
    if count < n:
        raise SystemExit(f"--ep-cards {n} needs {n} cards, {count} seen")
    build_phase()
    ranks = _rank_world("ep-card-rank", n, "ep-cards", limit_s=400)
    r0 = ranks[0]
    cfg = _moe_cfg(n_layers=EP_CARDS_LAYERS)
    G = MOE_BATCH * MOE_SEQ
    # per layer: g's forward all-reduce of out [G, d] and f's backward
    # all-reduces of xf's gradient [G, d] and the combine weights' [G, k]
    # (twice each under remat: the recompute reruns the forward's)
    fwd = G * cfg.dim * 2
    bwd = G * cfg.dim * 2 + G * cfg.top_k * 4
    for r in ranks:
        assert r["losses"] == r0["losses"], "ranks disagree"
    assert r0["losses"][-1] < r0["losses"][0], r0["losses"]
    log(f"[ep-cards] Mixtral widths at {EP_CARDS_LAYERS} layers over ep = "
        f"{n} cards (NCCL, {cfg.n_experts // n} experts a card), batch "
        f"{MOE_BATCH} x {MOE_SEQ}: losses "
        f"{[round(x, 4) for x in r0['losses']]}; step {r0['ms']:.1f} ms "
        f"({r0['ms'] / EP_CARDS_LAYERS:.1f} ms a layer) against one card "
        f"at {MOE_LAYERS} layers {r0['one_ms']:.1f} ms "
        f"({r0['one_ms'] / MOE_LAYERS:.1f} ms a layer, with the embedding "
        f"and head); all-reduce bytes a layer a step "
        f"{(2 * fwd + bwd) / 1e6:.1f}"
        f" MB (forward {fwd / 1e6:.1f} MB, run twice under remat; backward "
        f"{bwd / 1e6:.1f} MB); peak "
        + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks)
        + f" GiB a rank; on {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


def pp_card_rank_main(rank, job_path):
    """One rank of ``--pp-cards``: bench.py's flagship over {"pp": n},
    16 / n layers a card; rank 0 then times the one-card step."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import create_mesh, initialize_distributed
    from ray_tpu_torch.profile_train import train_batch

    with open(job_path) as f:
        job = json.load(f)
    n = job["n"]
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(job["store"], n, rank)
    out = {"rank": rank}
    try:
        cfg = _pp_cfg()
        batch = train_batch(cfg)
        torch.cuda.reset_peak_memory_stats()
        got = _pp_step(cfg, batch, create_mesh({"pp": n}), n,
                       steps=PP_STEPS)
        out.update(losses=got["losses"], ms=float(np.mean(got["times"])
                                                  * 1e3),
                   busy=float(np.mean(got["busy"])),
                   peak=torch.cuda.max_memory_allocated())
        del got
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            from ray_tpu_torch.profile_train import build_trainer

            p, s, step = build_trainer(cfg)
            out["one_losses"], out["one_ms"] = _timed_steps(step, p, s,
                                                            batch, PP_STEPS)
            del p, s
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def pp_cards_main(n):
    """``python3 chip_smoke.py --pp-cards N``: the flagship over pp = N
    cards (NCCL), batch 8 x 2048 in PP_MICRO microbatches, against one
    card's make_train_step; each stage's forward share of the step
    against GPipe's bubble."""
    name, count, smi = device_phase()
    if count < n:
        raise SystemExit(f"--pp-cards {n} needs {n} cards, {count} seen")
    build_phase()
    ranks = _rank_world("pp-card-rank", n, "pp-cards", limit_s=400)
    r0 = ranks[0]
    for r in ranks:
        assert r["losses"] == r0["losses"], "ranks disagree"
    assert r0["losses"][-1] < r0["losses"][0], r0["losses"]
    log(f"[pp-cards] bench.py's flagship (16 layers, full remat) over pp = "
        f"{n} cards (NCCL, {16 // n} layers a stage), batch 8 x 2048 in "
        f"{PP_MICRO} microbatches: losses "
        f"{[round(x, 4) for x in r0['losses']]}"
        f"; step {r0['ms']:.1f} ms against one card's make_train_step "
        f"{r0['one_ms']:.1f} ms (the same full remat); each rank's stage "
        f"forward " + ", ".join(f"{r['busy']:.1%}" for r in ranks)
        + f" of the step (GPipe's bubble (S - 1) / (T + S - 1) = "
        f"{(n - 1) / (PP_MICRO + n - 1):.1%}); peak "
        + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in ranks)
        + f" GiB a rank; on {smi}")
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


# The rllib phase (ROADMAP A14a), f32 with TF32 off: (a) PPO in local
# mode on CartPole with the JAX test's configuration and learning gate
# (tests/test_rllib.py test_ppo_learns_cartpole_local), learner and env
# runner on the card; (b) one training_step of each algorithm on a fixed
# seeded input (rollout, offline log or two-agent rollout), on the card
# against the port on the CPU: the first update's gradients and loss
# metrics (`compute_gradients` on the same minibatch and weights) within
# the CPU tests' tolerance against JAX (|card - CPU| <= RL_GRAD_ATOL +
# RL_GRAD_RTOL |CPU| elementwise), and the weights after the step within
# RL_STEP_ATOL x lr per optimizer update (Adam's first steps move a weight
# by about lr * sign(g), so this gate sees only sign flips); two planted
# faults must fail the gradient gate: TF32 left on, and PPO's advantages
# left unstandardized (which must fail the weight gate too). ES's step
# runs its perturbed greedy rollouts on the runner's device (c): the
# returns equal the CPU's, or the trajectories part only where the CPU's
# logit gap is below RL_NEAR_TIE; with equal returns the weights after
# its host update are within 1e-6 of the CPU's.
# The off-policy family (ROADMAP A14b) adds rows to (b): DQN (uniform and
# prioritized replay), DDPG, TD3, SAC and CQL, each on a fixed rollout
# (CQL: a fixed offline log) through its seeded replay buffer, every loss
# draw fed the same seeded numpy noise on both devices through the
# learner's noise seam; the target weights after the step are gated as
# the weights are. SAC's and CQL's gradient gate runs in float64 on both
# devices (`_rl_grads64`): their squashed log-prob log(1 - tanh^2 + 1e-6)
# cancels ~4 digits in f32 where a sample saturates, so two correct f32
# tanh implementations an ulp apart part there by ~1e-3 (the CPU tests
# see it between XLA and torch). A target made without a copy (the sync
# then writes the online weights in place) must fail the target gate.
# (d) DQN learns GridWorld at tests/test_rllib.py test_dqn_learns_
# gridworld's configuration, learner and runner on the card: 40
# iterations, the rolling return > 0.3 and 3 greedy episodes > 0.9.
RL_ITERS, RL_STEP_ATOL, RL_NEAR_TIE = 12, 0.01, 1e-4
RL_GRAD_RTOL, RL_GRAD_ATOL = 1e-5, 1e-6
RL_ALGOS = ("ppo", "a2c", "appo", "impala", "bc", "marwil",
            "multi_agent_ppo", "dqn", "dqn_per", "ddpg", "td3", "sac",
            "cql")
RL_GRADS64 = ("sac", "cql")
RL_DQN_ITERS = 40


def _rl_rollout(n=128, seed=7):
    """A fixed CartPole-shaped rollout (three episodes, one terminated)
    and its runner bootstraps."""
    from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

    rng = np.random.RandomState(seed)
    eps = np.repeat([0, 1, 2], [50, 40, 38]).astype(np.int64)
    terms = np.zeros(n, bool)
    terms[49] = True
    return SampleBatch({
        "obs": rng.randn(n, 4).astype(np.float32),
        "next_obs": rng.randn(n, 4).astype(np.float32),
        "actions": rng.randint(0, 2, n).astype(np.int64),
        "rewards": np.ones(n, np.float32),
        "terminateds": terms, "truncateds": np.zeros(n, bool),
        "eps_id": eps,
        "action_logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
        "vf_preds": rng.randn(n).astype(np.float32)}), {1: 0.25, 2: -0.5}


def _rl_offpolicy_rollout(discrete, n=256, seed=11):
    """A fixed rollout for the replay buffers: CartPole's spaces
    (discrete) or Pendulum's."""
    from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

    rng = np.random.RandomState(seed)
    dim = 4 if discrete else 3
    out = {"obs": rng.randn(n, dim).astype(np.float32),
           "next_obs": rng.randn(n, dim).astype(np.float32),
           "rewards": rng.randn(n).astype(np.float32),
           "terminateds": rng.rand(n) < 0.05,
           "truncateds": np.zeros(n, bool),
           "eps_id": np.repeat(np.arange(4), n // 4).astype(np.int64)}
    out["actions"] = (rng.randint(0, 2, n) if discrete else
                      rng.uniform(-2, 2, (n, 1)).astype(np.float32))
    return SampleBatch(out)


def _rl_noise(name, shape, kind, update):
    """The seeded draw ``name`` of update ``update``: the same numbers on
    every device."""
    import zlib

    rng = np.random.default_rng(zlib.crc32(f"{update}:{name}".encode()))
    return (rng.standard_normal(shape, np.float32) if kind == "normal"
            else rng.random(shape, np.float32))


def _rl_grads64(learner, batch):
    """The learner's loss metrics and gradients evaluated in float64 on
    its current weights and target, ``batch`` and its installed noise:
    (gradient tree, metrics) as `compute_gradients` gives them."""
    import copy

    from ray_tpu_torch.rllib.core.rl_module import _nest, tree_paths

    ref = copy.copy(learner)
    ref.module = copy.deepcopy(learner.module).double()
    ref.target_module = copy.deepcopy(learner.target_module).double()
    ref.noise = lambda name, shape, kind="normal": learner.noise(
        name, shape, kind).double()
    tb = {k: torch.as_tensor(np.asarray(v, np.float64)
                             if np.asarray(v).dtype.kind == "f"
                             else np.asarray(v), device=learner.device)
          for k, v in batch.items()}
    loss, metrics = ref.loss_fn(tb, None)
    paths = tree_paths(ref.module)
    grads = torch.autograd.grad(loss, [p for _, p in paths],
                                allow_unused=True, materialize_grads=True)
    metrics = dict(metrics, total_loss=loss)
    return (_nest([(path, g) for (path, _), g in zip(paths, grads)]),
            {k: v.detach().cpu().numpy() for k, v in metrics.items()})


def _rl_fixed_step(name, device):
    """One training_step of algorithm ``name`` on ``device`` with its
    input fixed: {"flat": the learners' weights after it as flat f32,
    "target": the target weights after it (off-policy), "n": updates
    taken, "lr", "grads": each learner's first-update gradients
    (`compute_gradients` before that update; float64 for RL_GRADS64) as
    flat f32, "metrics": their loss metrics, in sorted key order}."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.core.rl_module import ravel_tree, tree_leaves
    from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

    rng = np.random.RandomState(0)
    log_ = {"obs": rng.randn(512, 4).astype(np.float32),
            "actions": rng.randint(0, 2, 512),
            "rewards": np.ones(512, np.float32),
            "terminateds": rng.rand(512) < 0.05}
    box = _rl_offpolicy_rollout(False, n=1024, seed=12)
    learn = dict(num_steps_sampled_before_learning_starts=128)
    make = {
        "ppo": lambda: rllib.PPOConfig().training(
            train_batch_size=128, minibatch_size=64, num_epochs=2),
        "a2c": lambda: rllib.A2CConfig().training(train_batch_size=128),
        "appo": lambda: rllib.APPOConfig().training(train_batch_size=128),
        "impala": lambda: rllib.IMPALAConfig().training(
            train_batch_size=128),
        "bc": lambda: rllib.BCConfig().offline_data(dataset=log_).training(
            train_batch_size=128),
        "marwil": lambda: rllib.MARWILConfig().offline_data(
            dataset=log_).training(train_batch_size=128),
        "multi_agent_ppo": lambda: rllib.MultiAgentPPOConfig().environment(
            "TwoAgentGrid").training(train_batch_size=128,
                                     minibatch_size=64, num_epochs=2),
        "dqn": lambda: rllib.DQNConfig().training(
            target_network_update_freq=1, **learn),
        "dqn_per": lambda: rllib.DQNConfig().training(
            prioritized_replay=True, **learn),
        "ddpg": lambda: rllib.DDPGConfig().environment("Pendulum")
        .training(**learn),
        "td3": lambda: rllib.TD3Config().environment("Pendulum")
        .training(**learn),
        "sac": lambda: rllib.SACConfig().environment("Pendulum")
        .training(**learn),
        "cql": lambda: rllib.CQLConfig().environment("Pendulum")
        .offline_data(dataset={
            "obs": box["obs"], "actions": box["actions"],
            "rewards": box["rewards"], "next_obs": box["next_obs"],
            "terminateds": box["terminateds"]}),
    }[name]()
    if make.env is None:
        make = make.environment("CartPole-v1")
    algo = make.learners(device=device).debugging(seed=5).build_algo()
    batch, boot = _rl_rollout()
    group = algo.env_runner_group
    group.sample_with_bootstraps = \
        lambda n, epsilon=0.0: [(SampleBatch(batch), dict(boot))]
    fixed = _rl_offpolicy_rollout(name.startswith("dqn"))
    group.sample = lambda n, epsilon=0.0: SampleBatch(fixed)
    if name == "multi_agent_ppo":
        grid = _rl_grid_rollout()
        group.sample_multi = lambda n: [grid]
        learners = list(algo.learners.values())
    else:
        learners = [algo.learner_group.learner]
    count, first = [0], []
    for lr_ in learners:
        update, taken = lr_.update, []
        lr_.set_noise(lambda name, shape, kind, taken=taken: _rl_noise(
            name, shape, kind, len(taken)))

        def counted(b, lr_=lr_, update=update, taken=taken):
            if not taken:
                first.append(_rl_grads64(lr_, b) if name in RL_GRADS64
                             else lr_.compute_gradients(b))
            out = update(b)
            taken.append(1)
            count[0] += 1
            return out
        lr_.update = counted
    if name == "multi_agent_ppo":
        algo.step()
    else:
        algo.training_step()
    flat = np.concatenate([ravel_tree(lr_.get_weights())[0]
                           for lr_ in learners])
    grads = np.concatenate([g.detach().cpu().numpy().ravel()
                            for tree, _ in first for g in tree_leaves(tree)])
    metrics = np.concatenate([np.ravel(m[k]) for _, m in first
                              for k in sorted(m)]).astype(np.float64)
    out = {"flat": flat, "n": count[0], "lr": algo.config.lr,
           "grads": grads, "metrics": metrics}
    if hasattr(learners[0], "target_module"):
        out["target"] = ravel_tree(
            learners[0].get_state()["target_params"])[0]
    return out


def _rl_grid_rollout():
    """A fixed two-agent TwoAgentGrid rollout: ({module: {agent: batch}},
    {agent: bootstrap})."""
    from ray_tpu_torch.rllib.env.registry import make_env
    from ray_tpu_torch.rllib.utils.sample_batch import SampleBatch

    env = make_env("TwoAgentGrid")
    rng = np.random.RandomState(3)
    out = {}
    for j, aid in enumerate(env.agent_ids):
        n = 64
        dim = env.observation_space_of(aid).shape[0]
        out[aid] = {aid: SampleBatch({
            "obs": rng.rand(n, dim).astype(np.float32),
            "actions": rng.randint(0, env.action_space_of(aid).n, n),
            "rewards": rng.randn(n).astype(np.float32),
            "terminateds": np.arange(n) == 31,
            "eps_id": np.repeat([j * 10, j * 10 + 1], 32),
            "action_logp": np.log(rng.uniform(0.2, 0.6, n)).astype(
                np.float32),
            "vf_preds": rng.randn(n).astype(np.float32)})}
    return out, {aid: 0.5 for aid in env.agent_ids}


def _rl_tol_ratio(got, want):
    """The largest |got - want| / (RL_GRAD_ATOL + RL_GRAD_RTOL |want|):
    at most 1 passes the gradient gate."""
    return float(np.max(np.abs(got - want)
                        / (RL_GRAD_ATOL + RL_GRAD_RTOL * np.abs(want))))


def _rl_step_gates(card, cpu):
    """(weight difference, its tolerance, gradient ratio, metrics ratio,
    target weight difference: 0 without a target) of one fixed step on
    the card against the CPU."""
    target = (float(np.abs(card["target"] - cpu["target"]).max())
              if "target" in cpu else 0.0)
    return (float(np.abs(card["flat"] - cpu["flat"]).max()),
            RL_STEP_ATOL * card["lr"] * card["n"],
            _rl_tol_ratio(card["grads"], cpu["grads"]),
            _rl_tol_ratio(card["metrics"], cpu["metrics"]), target)


def _rl_es_step(device):
    """ES's training_step on ``device``: its perturbed greedy rollouts run
    the runner's module there, each greedy step recorded. Returns
    (weights after the step as flat f32, the step's metrics, the
    perturbations' returns, [(obs, actions, logit gap)] per policy step,
    the perturbations' seconds)."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib.core.rl_module import ravel_tree

    algo = (rllib.ESConfig().environment("CartPole-v1")
            .training(num_perturbations=3, es_stdev=0.1)
            .learners(device=device).debugging(seed=11).build_algo())
    group = algo.env_runner_group
    r = group._local_runner
    assert r.device.type == device
    infer, rec, out = r._infer_batch, [], {}

    def recorded(obs):
        got = infer(obs)
        with torch.no_grad():
            lg = r.module.forward_train(r._obs_tensor(obs))[
                "action_dist_inputs"].cpu().numpy()
        rec.append((obs.copy(), got["actions"].copy(),
                    float(np.abs(lg[:, 1] - lg[:, 0]).min())))
        return got

    evaluate = group.evaluate_perturbations

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["returns"] = evaluate(*args)
        torch.cuda.synchronize()
        out["secs"] = time.perf_counter() - t0
        return out["returns"]

    r._infer_batch, group.evaluate_perturbations = recorded, timed
    metrics = algo.training_step()
    return (ravel_tree(algo.learner_group.get_weights())[0], metrics,
            out["returns"], rec, out["secs"])


def _rl_dqn_gridworld(smi):
    """(d): DQN on GridWorld at the JAX test's configuration, learner and
    runner on the card."""
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig

    algo = (DQNConfig()
            .environment("GridWorld-v0", env_config={"size": 3})
            .training(train_batch_size=64, lr=5e-4, gamma=0.95,
                      num_steps_sampled_before_learning_starts=200,
                      target_network_update_freq=100,
                      epsilon_decay_steps=1500,
                      rollout_fragment_length=100)
            .debugging(seed=1).build_algo())
    learner = algo.learner_group.learner
    assert learner.device.type == "cuda"
    assert algo.env_runner_group._local_runner.device.type == "cuda"
    sample, update = algo.env_runner_group.sample, learner.update
    spent = {"sample": 0.0, "update": 0.0, "updates": 0}

    def timed_sample(*a, **kw):
        t0 = time.perf_counter()
        out = sample(*a, **kw)
        spent["sample"] += time.perf_counter() - t0
        return out

    def timed_update(b):
        t0 = time.perf_counter()
        out = update(b)              # ends on the metrics' host copy
        spent["update"] += time.perf_counter() - t0
        spent["updates"] += 1
        return out

    algo.env_runner_group.sample, learner.update = timed_sample, timed_update
    t0 = time.perf_counter()
    for _ in range(RL_DQN_ITERS):
        result = algo.step()
    wall = time.perf_counter() - t0
    ret = result.get("episode_return_mean", float("nan"))
    greedy = algo.evaluate(num_episodes=3)["evaluation"][
        "episode_return_mean"]
    steps = algo.env_runner_group.aggregate_metrics()["num_env_steps"]
    log(f"[rllib] (d) DQN, GridWorld 3x3, local mode, learner and runner "
        f"on the card: rolling return {ret:.4g} (gate > 0.3), greedy "
        f"{greedy:.4g} over 3 episodes (gate > 0.9); {spent['updates']} "
        f"updates, {spent['update'] / spent['updates'] * 1e3:.3f} ms each "
        f"(host clock, the metrics' copy included); {steps} env steps at "
        f"{steps / spent['sample']:.1f} steps/s while sampling; {wall:.2f} s "
        f"for {RL_DQN_ITERS} iterations; on {smi}")
    assert np.isfinite(ret) and ret > 0.3, result
    assert greedy > 0.9, greedy


def rllib_phase(smi):
    """The rllib phase (see RL_* above); at most ~60 s."""
    from ray_tpu_torch.rllib.algorithms import off_policy
    from ray_tpu_torch.rllib.algorithms import ppo as ppo_mod
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig

    t_phase = time.perf_counter()
    # (a) PPO learns CartPole on the card
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0)
            .training(train_batch_size=512, minibatch_size=128,
                      num_epochs=6, lr=3e-4)
            .debugging(seed=3).build_algo())
    assert algo.learner_group.learner.device.type == "cuda"
    assert algo.env_runner_group._local_runner.device.type == "cuda"
    sample, update = (algo.env_runner_group.sample_with_bootstraps,
                      algo.learner_group.update)
    spent = {"sample": 0.0, "update": 0.0, "updates": 0}

    def timed_sample(*a, **kw):
        t0 = time.perf_counter()
        out = sample(*a, **kw)
        spent["sample"] += time.perf_counter() - t0
        return out

    def timed_update(b):
        t0 = time.perf_counter()
        out = update(b)              # ends on the metrics' host copy
        spent["update"] += time.perf_counter() - t0
        spent["updates"] += 1
        return out

    algo.env_runner_group.sample_with_bootstraps = timed_sample
    algo.learner_group.update = timed_update
    returns = []
    t0 = time.perf_counter()
    for _ in range(RL_ITERS):
        returns.append(algo.train()["episode_return_mean"])
    wall = time.perf_counter() - t0
    finite = [r for r in returns if np.isfinite(r)]
    steps = algo.env_runner_group.aggregate_metrics()["num_env_steps"]
    log(f"[rllib] (a) PPO, CartPole, local mode, learner and runner on the "
        f"card: episode return mean by iteration "
        f"{[round(r, 2) for r in returns]} (gate: best > first + 20); "
        f"{spent['updates']} minibatch updates, "
        f"{spent['update'] / spent['updates'] * 1e3:.3f} ms each (host "
        f"clock, the metrics' copy included); {steps} env steps at "
        f"{steps / spent['sample']:.1f} steps/s while sampling; "
        f"{wall:.2f} s for {RL_ITERS} iterations; on {smi}")
    assert finite and max(finite) > finite[0] + 20, returns
    # (b) one training_step per algorithm, card against CPU
    rows, failed = [], []
    t_b = time.perf_counter()
    cpu = {name: _rl_fixed_step(name, "cpu") for name in RL_ALGOS}
    for name in RL_ALGOS:
        card = _rl_fixed_step(name, "cuda")
        err, tol, g, m, terr = _rl_step_gates(card, cpu[name])
        f64 = " (float64)" if name in RL_GRADS64 else ""
        target = f", target {terr:.3g}" if "target" in card else ""
        rows.append(f"{name} grads{f64} {g:.3g}, metrics {m:.3g} of the "
                    f"tolerance; weights {err:.3g}{target} (tol {tol:.3g}, "
                    f"{card['n']} updates)")
        if not (err <= tol and terr <= tol and g <= 1 and m <= 1):
            failed.append(name)
    faults = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        faults["TF32 on"] = _rl_step_gates(_rl_fixed_step("ppo", "cuda"),
                                           cpu["ppo"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with mock.patch.object(ppo_mod, "standardize", lambda x: x):
        faults["PPO advantages unstandardized"] = _rl_step_gates(
            _rl_fixed_step("ppo", "cuda"), cpu["ppo"])
    with mock.patch.object(off_policy.TargetNetworkLearner, "_make_target",
                           lambda self: self.module):
        faults["SAC target synced in place"] = _rl_step_gates(
            _rl_fixed_step("sac", "cuda"), cpu["sac"])
    frows = [f"{k}: grads {g:.3g} of the tolerance, weights {e:.3g}, "
             f"target {te:.3g} (tol {t:.3g})"
             for k, (e, t, g, _, te) in faults.items()]
    log(f"[rllib] (b) one training_step on a fixed input, the card against "
        f"the CPU (gradient gate |card - CPU| <= {RL_GRAD_ATOL:g} + "
        f"{RL_GRAD_RTOL:g} |CPU|): {'; '.join(rows)}; planted faults: "
        f"{'; '.join(frows)}; {time.perf_counter() - t_b:.1f} s; on {smi}")
    assert not failed, failed
    tf32 = faults["TF32 on"]
    assert tf32[2] > 1, f"TF32 on NOT rejected: {tf32}"
    unstd = faults["PPO advantages unstandardized"]
    assert unstd[2] > 1 and unstd[0] > unstd[1], \
        f"unstandardized advantages NOT rejected: {unstd}"
    in_place = faults["SAC target synced in place"]
    assert in_place[4] > in_place[1], \
        f"target synced in place NOT rejected: {in_place}"
    # the V-trace scan's loop (ROADMAP A17) at a 512-step rollout
    from ray_tpu_torch.rllib.algorithms.impala import vtrace_scan

    x = torch.rand(3, 512, device="cuda")
    vt_ms = _time_ms(lambda: vtrace_scan(x[0], x[1], x[2], 0.99), 5)
    log(f"[rllib] V-trace scan, T = 512, as a loop of small kernels: "
        f"{vt_ms:.3f} ms (CUDA events); on {smi}")
    # (b) ES and (c): ES's step, its perturbations on the card and the CPU
    card, cpu_es = _rl_es_step("cuda"), _rl_es_step("cpu")
    first, gap = None, None
    for i, (c, g) in enumerate(zip(card[3], cpu_es[3])):
        assert np.array_equal(c[0], g[0]) or first is not None, i
        if not np.array_equal(c[1], g[1]):
            first, gap = i, g[2]
            break
    same = card[2] == cpu_es[2]
    es_err = float(np.abs(card[0] - cpu_es[0]).max())
    log(f"[rllib] (c) ES evaluate_perturbations, 3 seeds x 2 signs: card "
        f"{card[2]}, CPU {cpu_es[2]}; first differing greedy action: "
        f"{'none' if first is None else f'step {first}, CPU logit gap {gap:.3g}'}"
        f"; card {card[4]:.3f} s for {len(card[3])} policy steps; (b) es: "
        f"weights after the step {es_err:.3g} from the CPU's (tol 1e-06)")
    if same:
        assert es_err <= 1e-6 and card[1] == cpu_es[1], (es_err, card[1])
    else:
        assert first is not None and gap < RL_NEAR_TIE, (first, gap)
    _rl_dqn_gridworld(smi)
    log(f"[time] rllib {time.perf_counter() - t_phase:.1f} s")


# The train-data phase (ROADMAP A14d): the device pieces of Train, Data
# and channels on the card. (a) `iter_device_batches` puts a seeded
# duck-typed source (CIFAR-scale rows: a [3, 32, 32] f32 image, a label,
# an id; TD_ROWS rows in batches of TD_BATCH) on the card through pinned
# memory, each batch equal to the source's rows, and each of 4 dp ranks'
# regions equal to its block of the batch; (b) `TorchPredictor` on the
# card from a dict checkpoint and from an array checkpoint (with a
# template), against the float64 product (1e-5 of its max); (c)
# `DeviceChannel` carries f32 and bf16 card tensors through a host
# channel (a `multiprocessing` queue: a pipe and its feeder thread) and
# back on the card, bit-equal. The HF piece is CPU-only: the card's
# machine has no transformers.
TD_ROWS, TD_BATCH, TD_RANKS = 16384, 256, 4


class _TDSource:
    """A duck-typed Data source: seeded columns, batched in order."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.cols = {"image": rng.random((n, 3, 32, 32), np.float32),
                     "label": rng.integers(0, 10, n),
                     "id": np.arange(n, dtype=np.int64)}
        self.n = n

    def iter_batches(self, *, batch_size=256, batch_format="numpy"):
        for i in range(0, self.n, batch_size):
            yield {k: v[i:i + batch_size] for k, v in self.cols.items()}


class _DictCheckpoint:
    """A checkpoint directory with `to_directory` / `to_dict`."""

    FILE = "_dict_checkpoint.pkl"

    def __init__(self, path):
        self.path = path

    def to_directory(self):
        return self.path

    def to_dict(self):
        import os
        import pickle

        with open(os.path.join(self.path, self.FILE), "rb") as f:
            return pickle.load(f)


class _QueueChannel:
    """A host channel over a `multiprocessing` queue."""

    def __init__(self):
        import multiprocessing

        self._q = multiprocessing.Queue()

    def write(self, value, timeout=None):
        self._q.put(value, timeout=timeout)

    def read(self, timeout=None):
        return self._q.get(timeout=timeout)

    def close(self):
        self._q.close()
        self._q.join_thread()


def train_data_phase(smi):
    """The train-data phase (see TD_* above); a few seconds."""
    import os
    import pickle
    import tempfile

    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.experimental.channel import DeviceChannel
    from ray_tpu_torch.train.array_checkpoint import save_pytree
    from ray_tpu_torch.train.predictor import TorchPredictor

    t_phase = time.perf_counter()
    # (a) ingest
    src = _TDSource(TD_ROWS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(iter_device_batches(src, batch_size=TD_BATCH))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nbytes = sum(v.nbytes for v in src.cols.values())
    for i, b in enumerate(got):
        for k, v in b.items():
            assert v.device.type == "cuda", k
            want = src.cols[k][i * TD_BATCH:(i + 1) * TD_BATCH]
            assert np.array_equal(v.cpu().numpy(), want), (i, k)
    block = TD_BATCH // TD_RANKS
    for r in range(TD_RANKS):
        for i, b in enumerate(iter_device_batches(
                src, batch_size=TD_BATCH, mesh={"dp": TD_RANKS},
                spec=("dp",), coordinate={"dp": r})):
            lo = i * TD_BATCH + r * block
            assert np.array_equal(b["id"].cpu().numpy(),
                                  np.arange(lo, lo + block)), (r, i)
            assert np.array_equal(b["image"].cpu().numpy(),
                                  src.cols["image"][lo:lo + block]), (r, i)
    log(f"[train-data] (a) iter_device_batches: {TD_ROWS} rows in "
        f"{len(got)} batches of {TD_BATCH} ({nbytes / 1e6:.1f} MB) on the "
        f"card in {secs * 1e3:.1f} ms ({nbytes / secs / 1e9:.2f} GB/s, "
        f"pinned + non-blocking, the source's slicing included), equal to "
        f"the source; {TD_RANKS} dp ranks' regions equal to their blocks; "
        f"on {smi}")
    # (b) the predictor from both checkpoint kinds
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((3 * 32 * 32, 10), np.float32),
              "b": rng.standard_normal(10, np.float32)}
    x = got[0]["image"].reshape(TD_BATCH, -1)
    want = (x.cpu().numpy().astype(np.float64) @ params["w"] + params["b"])

    def apply(p, batch):
        return batch["x"] @ p["w"] + p["b"]

    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "dict")
        os.makedirs(d)
        with open(os.path.join(d, _DictCheckpoint.FILE), "wb") as f:
            pickle.dump({"params": params}, f)
        a = os.path.join(tmp, "array")
        save_pytree(params, a)
        template = {k: torch.zeros(v.shape) for k, v in params.items()}
        for kind, pred in (
                ("dict", TorchPredictor.from_checkpoint(
                    _DictCheckpoint(d), apply_fn=apply)),
                ("array", TorchPredictor.from_checkpoint(
                    _DictCheckpoint(a), apply_fn=apply, template=template))):
            assert pred._params["w"].device.type == "cuda"
            out = pred.predict({"x": x.cpu().numpy()})["predictions"]
            errs[kind] = float(np.abs(out - want).max() / np.abs(want).max())
    log(f"[train-data] (b) TorchPredictor on the card, dict and array "
        f"checkpoints: max error {errs} of the float64 product's max "
        f"(gate 1e-5); on {smi}")
    assert max(errs.values()) <= 1e-5, errs
    # (c) the device channel
    host = _QueueChannel()
    chan = DeviceChannel(host)
    try:
        for shape, dtype in (((1024, 1024), torch.float32),
                             ((4096, 2048), torch.bfloat16)):
            t = torch.randn(shape, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(2)
                            ).to(dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chan.write(t)
            back = chan.read(timeout=60)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            assert back.device.type == "cuda" and back.dtype == dtype
            assert torch.equal(back, t), dtype
            log(f"[train-data] (c) DeviceChannel {list(shape)} {dtype}: "
                f"card -> host queue -> card bit-equal, {ms:.2f} ms "
                f"({t.numel() * t.element_size() / ms / 1e6:.2f} GB/s "
                f"round trip, host clock); on {smi}")
        chan.write({"step": 3})
        assert chan.read(timeout=10) == {"step": 3}
    finally:
        chan.close()
    log(f"[time] train-data {time.perf_counter() - t_phase:.1f} s")


# The rllib-c phase (ROADMAP A14c): QMIX, AlphaZero and DreamerV3 on the
# card, f32, TF32 off. (a) One fixed update of each, the card against the
# port on the CPU from the same weights: QMIX's update and soft target
# sync (its target moved off the online weights) on a seeded 128-row
# batch; AlphaZero's update on a seeded 128-row batch; DreamerV3's whole
# `train` (world-model step, imagination on the stepped model, actor and
# critic steps, slow-critic and return-normalization EMAs) on a seeded
# batch of RLC_DV3_BT sequences with the same seeded Gumbel draws
# installed on both devices (RLC_DV3_BT is cut from the default 16 x 16
# so that an f32 near-tie between the devices' samples, which would move
# a latent, stays unlikely among ~1,700 samples). Loss metrics (and
# ret_lo / ret_hi) within RL_GRAD_ATOL + RL_GRAD_RTOL |CPU|; weights,
# targets and the slow critic within RL_STEP_ATOL x lr; the first
# update's gradients in float64 on both devices (DreamerV3: the world
# model's, and the actor's and critic's on its posterior features),
# where the order of f32 products would decide, within the same
# tolerance. (b) Three planted faults must each be rejected: QMIX's
# mixer without abs (the monotonicity gate: every dQ_tot/dQ_a >= 0 on
# RLC_MONO_ROWS seeded rows), DreamerV3's straight-through sample without
# the stop-gradient on probs (the gradient gate), AlphaZero's value head
# without tanh (the metric and gradient gates). (c) Learning on the card
# at the JAX tests' own settings: QMIX solves CoopPress (greedy return >
# 6.5 after 40 steps, tests/test_rllib_qmix.py), DreamerV3's world-model
# loss falls below 0.7 of its first value in 30 steps on CartPole with
# its entropy in (0, ln 2] (tests/test_dreamerv3.py), AlphaZero after 25
# iterations loses <= 0.15 and wins >= 0.75 of 30 games against random
# (tests/test_rllib_alphazero.py). (d) Times: a QMIX update, an
# AlphaZero predictor call (one uncached state: a forward and one copy
# to the host) and self-play game, a DreamerV3 train call, and
# DreamerV3's env steps/s.
RLC_DV3_BT = (4, 8)
RLC_MONO_ROWS = 512
RLC_QMIX_STEPS, RLC_DV3_STEPS, RLC_AZ_ITERS = 40, 30, 25


def _rlc_noise(name, shape, kind):
    """The seeded draw ``name``: the same numbers on every device."""
    import zlib

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if kind == "normal":
        return rng.standard_normal(shape, np.float32)
    u = rng.random(shape, np.float32)
    if kind == "gumbel":
        return -np.log(-np.log(np.maximum(u, np.finfo(np.float32).tiny)))
    return u


def _rlc_f64(batch, device):
    """A numpy batch as float64 (float columns) tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float64)
                               if np.asarray(v).dtype.kind == "f"
                               else np.asarray(v), device=device)
            for k, v in batch.items()}


def _rlc_grads(loss, module):
    from ray_tpu_torch.rllib.core.rl_module import tree_paths

    grads = torch.autograd.grad(loss, [p for _, p in tree_paths(module)],
                                allow_unused=True, materialize_grads=True)
    return [g.detach().cpu().numpy().ravel() for g in grads]


def _rlc_flat(*modules):
    from ray_tpu_torch.rllib.core.rl_module import params_to_numpy, ravel_tree

    return np.concatenate([ravel_tree(params_to_numpy(m))[0]
                           for m in modules])


def _rlc_qmix(device):
    """QMIX's fixed update on ``device``: {"grads" (float64), "metrics",
    "flat": {part: flat weights}, "atol": {part: tolerance}}."""
    import copy

    from ray_tpu_torch.rllib.algorithms.qmix import QMIXConfig
    from ray_tpu_torch.rllib.env.multi_agent_env import CoopPress

    algo = (QMIXConfig().environment(CoopPress, env_config={"episode_len": 8})
            .learners(device=device).debugging(seed=4).build_algo())
    assert algo.device.type == device
    with torch.no_grad():
        for t in algo.target_module.parameters():
            t.copy_(t * 0.9 + 0.01)
    rng = np.random.RandomState(21)
    n = algo.config.train_batch_size
    batch = {"obs": rng.randn(n, 2, 2).astype(np.float32),
             "actions": rng.randint(0, 2, (n, 2)).astype(np.int32),
             "rewards": rng.randn(n).astype(np.float32),
             "next_obs": rng.randn(n, 2, 2).astype(np.float32),
             "dones": (rng.rand(n) < 0.2).astype(np.float32)}
    ref = copy.copy(algo)
    ref.module = copy.deepcopy(algo.module).double()
    ref.target_module = copy.deepcopy(algo.target_module).double()
    loss64, _ = ref._loss(_rlc_f64(batch, device))
    grads = np.concatenate(_rlc_grads(loss64, ref.module))
    m = algo._update(batch)
    algo._sync_target(algo.config.tau)
    atol = RL_STEP_ATOL * algo.config.lr
    return {"grads": grads,
            "metrics": np.array([float(m[k]) for k in sorted(m)]),
            "flat": {"weights": _rlc_flat(algo.module),
                     "target": _rlc_flat(algo.target_module)},
            "atol": {"weights": atol, "target": atol}}


def _rlc_az(device):
    """AlphaZero's fixed update on ``device`` (as `_rlc_qmix`)."""
    import copy

    from ray_tpu_torch.rllib.algorithms.alphazero import AlphaZeroConfig

    algo = AlphaZeroConfig().learners(device=device).debugging(
        seed=4).build_algo()
    assert algo.device.type == device
    rng = np.random.RandomState(22)
    n = algo.config.train_batch_size
    batch = {"obs": rng.randint(-1, 2, (n, 9)).astype(np.float32),
             "pi": rng.dirichlet(np.ones(9), n).astype(np.float32),
             "z": rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)}
    ref = copy.copy(algo)
    ref.module = copy.deepcopy(algo.module).double()
    loss64, _ = ref._loss(_rlc_f64(batch, device))
    grads = np.concatenate(_rlc_grads(loss64, ref.module))
    m = algo._update(batch)
    return {"grads": grads,
            "metrics": np.array([float(m[k]) for k in sorted(m)]),
            "flat": {"weights": _rlc_flat(algo.module)},
            "atol": {"weights": RL_STEP_ATOL * algo.config.lr}}


def _rlc_dv3_learner(device):
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import (DreamerV3Config,
                                                          DreamerV3Learner)

    cfg = (DreamerV3Config().environment("CartPole-v1")
           .learners(device=device).debugging(seed=4).to_dict())
    learner = DreamerV3Learner(4, 2, cfg)
    assert learner.device.type == device
    return learner


def _rlc_dv3_batch():
    b, t = RLC_DV3_BT
    rng = np.random.RandomState(23)
    first = np.zeros((b, t), np.float32)
    first[:, 0] = 1.0
    first[0, t // 2] = 1.0
    return {"obs": rng.randn(b, t, 4).astype(np.float32),
            "actions": rng.randint(0, 2, (b, t)).astype(np.int32),
            "rewards": rng.rand(b, t).astype(np.float32),
            "terminateds": (rng.rand(b, t) < 0.05).astype(np.float32),
            "is_first": first}


def _rlc_dv3(device):
    """DreamerV3's fixed train on ``device``: {"grads" (float64: world
    model, then actor and critic on its posterior features), "metrics"
    (ret_lo / ret_hi last), "flat": {wm, actor, critic, slow_critic},
    "atol": per part}."""
    import copy

    from ray_tpu_torch.rllib.core.learner import to_tensors

    learner = _rlc_dv3_learner(device)
    learner.set_noise(_rlc_noise)
    batch = _rlc_dv3_batch()
    ref = copy.copy(learner)
    for part in ("wm", "actor", "critic", "slow_critic"):
        setattr(ref, part, copy.deepcopy(getattr(learner, part)).double())
    wm_loss, feat, _ = ref._wm_loss(_rlc_f64(batch, device))
    grads = _rlc_grads(wm_loss, ref.wm)
    a_loss, c_loss, _, _, _ = ref._ac_losses(
        feat.detach().reshape(-1, feat.shape[-1]))
    grads += _rlc_grads(a_loss, ref.actor) + _rlc_grads(c_loss, ref.critic)
    m = learner.train_step(to_tensors(batch, learner.device))
    metrics = [float(m[k]) for k in sorted(m)]
    metrics += [float(learner.ret_lo), float(learner.ret_hi)]
    cfg = learner.cfg
    return {"grads": np.concatenate(grads), "metrics": np.array(metrics),
            "flat": {p: _rlc_flat(getattr(learner, p))
                     for p in ("wm", "actor", "critic", "slow_critic")},
            "atol": {"wm": RL_STEP_ATOL * cfg["model_lr"],
                     "actor": RL_STEP_ATOL * cfg["actor_lr"],
                     "critic": RL_STEP_ATOL * cfg["critic_lr"],
                     "slow_critic": RL_STEP_ATOL * cfg["critic_lr"]}}


def _rlc_gates(card, cpu):
    """{"grads": share of the gradient tolerance, "metrics": share of the
    metric tolerance, each weight part: its largest difference over its
    tolerance}: at most 1 passes."""
    out = {"grads": _rl_tol_ratio(card["grads"], cpu["grads"]),
           "metrics": _rl_tol_ratio(card["metrics"], cpu["metrics"])}
    for part, atol in card["atol"].items():
        out[part] = float(np.abs(card["flat"][part]
                                 - cpu["flat"][part]).max()) / atol
    return out


def _rlc_mix_no_abs(self, agent_q, state):
    """A planted fault: QMIX's mixer with its hypernetwork weights
    unconstrained (no abs)."""
    from ray_tpu_torch.rllib.core.rl_module import _mlp_apply

    w1 = _mlp_apply(self.hyper_w1, state).reshape(-1, self.n_agents,
                                                  self.embed)
    b1 = _mlp_apply(self.hyper_b1, state)
    hidden = torch.nn.functional.elu(
        torch.einsum("ba,bae->be", agent_q, w1) + b1)
    w2 = _mlp_apply(self.hyper_w2, state)
    b2 = _mlp_apply(self.hyper_b2, state)[..., 0]
    return torch.einsum("be,be->b", hidden, w2) + b2


def _rlc_latent_no_stop_gradient(self, logits, gumbel=None):
    """A planted fault: DreamerV3's straight-through sample without the
    stop-gradient on probs."""
    F = torch.nn.functional
    logits = logits.reshape(*logits.shape[:-1], self.G, self.C)
    probs = 0.99 * torch.softmax(logits, -1) + 0.01 / self.C
    logp = torch.log(probs)
    if gumbel is None:
        return None, logp
    onehot = F.one_hot(torch.argmax(logp + gumbel, -1), self.C).to(
        probs.dtype)
    st = onehot + probs - probs
    return st.reshape(*st.shape[:-2], self.G * self.C), logp


def _rlc_value_no_tanh(self, obs):
    """A planted fault: AlphaZero's value head without tanh."""
    from ray_tpu_torch.rllib.core.rl_module import _mlp_apply

    feat = _mlp_apply(self.torso, obs, final_activation=True)
    return _mlp_apply(self.pi, feat), _mlp_apply(self.v, feat)[..., 0]


def _rlc_negative_share(module):
    """The share of dQ_tot/dQ_a < 0 over RLC_MONO_ROWS seeded rows (the
    mixer's monotonicity; 0 passes)."""
    gen = torch.Generator("cuda").manual_seed(5)
    q = torch.randn((RLC_MONO_ROWS, module.n_agents), device="cuda",
                    generator=gen).requires_grad_(True)
    state = torch.randn((RLC_MONO_ROWS, module.hyper_w1[0].w.shape[0]),
                        device="cuda", generator=gen)
    d = torch.autograd.grad(module.mix(q, state).sum(), q)[0]
    return float((d < 0).float().mean())


def _rlc_fmt(gates):
    return ", ".join(f"{k} {v:.3g}" for k, v in gates.items())


def _rlc_learn_qmix(smi):
    from ray_tpu_torch.rllib.algorithms.qmix import QMIXConfig
    from ray_tpu_torch.rllib.env.multi_agent_env import CoopPress

    algo = (QMIXConfig().environment(CoopPress, env_config={"episode_len": 8})
            .debugging(seed=0).build_algo())
    assert algo.device.type == "cuda"
    t0 = time.perf_counter()
    for _ in range(RLC_QMIX_STEPS):
        result = algo.step()
    wall = time.perf_counter() - t0
    ev = algo.evaluate(num_episodes=10)["evaluation"]["episode_return_mean"]
    batch = dict(algo._replay.sample(algo.config.train_batch_size))
    upd_ms = _time_ms(lambda: algo._update(batch), 20)
    log(f"[rllib-c] (c) QMIX, CoopPress, {RLC_QMIX_STEPS} steps on the card "
        f"(TF32 off): td_loss {result['td_loss']:.4g}, greedy return "
        f"{ev:.4g} over 10 episodes (gate > 6.5; optimum 8.0); "
        f"{wall:.2f} s; (d) an update (128 rows, clip + Adam, the batch's "
        f"copy to the card included) {upd_ms:.3f} ms (CUDA events); on {smi}")
    assert np.isfinite(result["td_loss"]), result
    assert ev > 6.5, ev


def _rlc_learn_dv3(smi):
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3Config
    from ray_tpu_torch.rllib.core.learner import to_tensors

    algo = (DreamerV3Config().environment("CartPole-v1")
            .env_runners(num_envs_per_runner=4)
            .training(env_steps_per_iteration=32,
                      train_updates_per_iteration=2,
                      num_steps_before_learning=200)
            .debugging(seed=2).build_algo())
    assert algo.device.type == "cuda"
    learner, train_step = algo.learner, algo.learner.train_step
    spent = {"train": 0.0, "n": 0}

    def timed(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(batch)
        torch.cuda.synchronize()
        spent["train"] += time.perf_counter() - t0
        spent["n"] += 1
        return out

    learner.train_step = timed
    first = last = None
    t0 = time.perf_counter()
    for _ in range(RLC_DV3_STEPS):
        r = algo.step()
        if "wm_loss" in r:
            first = r["wm_loss"] if first is None else first
            last = r["wm_loss"]
    wall = time.perf_counter() - t0
    learner.train_step = train_step
    steps = algo._env_steps
    batch = to_tensors(algo.replay.sample(algo.config.batch_size_sequences,
                                          algo.config.sequence_length),
                       learner.device)
    train_ms = _time_ms(lambda: train_step(batch), 5)
    log(f"[rllib-c] (c) DreamerV3, CartPole, {RLC_DV3_STEPS} steps on the "
        f"card (TF32 off): world-model loss {first:.4g} -> {last:.4g} "
        f"({last / first:.3f} of the first; gate < 0.7), imagined return "
        f"{r['imagined_return']:.4g}, actor entropy "
        f"{r['actor_entropy']:.4g} (gate in (0, ln 2]); {wall:.2f} s; (d) "
        f"{steps} env steps at {steps / (wall - spent['train']):.1f} steps/s "
        f"(the wall less the {spent['n']} train calls); a train call "
        f"(16 x 16 sequences, horizon 10) {train_ms:.3f} ms (CUDA events); "
        f"on {smi}")
    assert first is not None and last < 0.7 * first, (first, last)
    assert np.isfinite(r["imagined_return"]), r
    assert 0.0 < r["actor_entropy"] <= np.log(2) + 1e-3, r


def _rlc_learn_az(smi):
    from ray_tpu_torch.rllib.algorithms.alphazero import AlphaZeroConfig

    algo = AlphaZeroConfig().debugging(seed=0).build_algo()
    assert algo.device.type == "cuda"
    pre_net = algo.play_vs_random(30, simulations=4)
    game, games = algo._self_play_game, []

    def timed_game():
        t0 = time.perf_counter()
        out = game()
        games.append(time.perf_counter() - t0)
        return out

    algo._self_play_game = timed_game
    t0 = time.perf_counter()
    for _ in range(RLC_AZ_ITERS):
        result = algo.step()
    wall = time.perf_counter() - t0
    post_full = algo.play_vs_random(30)
    post_net = algo.play_vs_random(30, simulations=4)
    # one uncached state per call: a forward and one copy to the host
    pred, boards = algo._predictor, []
    state = algo.game.initial_state()
    for a in (4, 0, 8, 2, 6):
        boards.append(state)
        state = algo.game.next_state(state, a)
    pred(boards[0])
    t1 = time.perf_counter()
    for i in range(200):
        pred.set_params(algo.module)
        pred(boards[i % len(boards)])
    pred_ms = (time.perf_counter() - t1) / 200 * 1e3
    log(f"[rllib-c] (c) AlphaZero, TicTacToe, {RLC_AZ_ITERS} iterations on "
        f"the card (TF32 off): policy_loss {result['policy_loss']:.4g}; "
        f"against random over 30 games {post_full} (gate: loss_rate <= "
        f"0.15, win_rate >= 0.75); at 4 simulations, untrained {pre_net}, "
        f"trained {post_net} (reported); {wall:.2f} s; (d) a self-play game "
        f"{np.mean(games) * 1e3:.1f} ms (mean of {len(games)}, host clock), "
        f"a predictor call on an uncached state {pred_ms:.4f} ms (host "
        f"clock, the copy to the host included); on {smi}")
    assert np.isfinite(result["policy_loss"]), result
    assert post_full["loss_rate"] <= 0.15, post_full
    assert post_full["win_rate"] >= 0.75, post_full


def rllib_c_phase(smi):
    """The rllib-c phase (see RLC_* above); at most ~45 s."""
    from ray_tpu_torch.rllib.algorithms import alphazero, dreamerv3, qmix

    t_phase = time.perf_counter()
    assert not torch.backends.cuda.matmul.allow_tf32
    # (a) card against CPU; (b) the planted faults
    rows, failed = [], []
    cpu = {"qmix": _rlc_qmix("cpu"), "alphazero": _rlc_az("cpu"),
           "dreamerv3": _rlc_dv3("cpu")}
    run = {"qmix": _rlc_qmix, "alphazero": _rlc_az, "dreamerv3": _rlc_dv3}
    for name, fn in run.items():
        gates = _rlc_gates(fn("cuda"), cpu[name])
        rows.append(f"{name}: {_rlc_fmt(gates)}")
        if max(gates.values()) > 1:
            failed.append(name)
    from ray_tpu_torch.rllib.env.multi_agent_env import CoopPress

    mixer = (qmix.QMIXConfig().environment(CoopPress).debugging(seed=4)
             .build_algo().module)
    neg = _rlc_negative_share(mixer)
    with mock.patch.object(qmix.QMIXModule, "mix", _rlc_mix_no_abs):
        neg_fault = _rlc_negative_share(mixer)
    with mock.patch.object(dreamerv3.DreamerV3Learner, "_latent",
                           _rlc_latent_no_stop_gradient):
        st_fault = _rlc_gates(_rlc_dv3("cuda"), cpu["dreamerv3"])
    with mock.patch.object(alphazero.AlphaZeroModule, "forward",
                           _rlc_value_no_tanh):
        tanh_fault = _rlc_gates(_rlc_az("cuda"), cpu["alphazero"])
    log(f"[rllib-c] (a) one fixed update each, the card against the CPU "
        f"(TF32 off; shares of each tolerance: gradients in float64 and "
        f"metrics within {RL_GRAD_ATOL:g} + {RL_GRAD_RTOL:g} |CPU|, weights "
        f"within {RL_STEP_ATOL:g} x lr; DreamerV3 a {RLC_DV3_BT[0]} x "
        f"{RLC_DV3_BT[1]} batch, seeded Gumbel draws, ret_lo / ret_hi among "
        f"its metrics): {'; '.join(rows)}; (b) planted faults: QMIX mixer "
        f"without abs, dQ_tot/dQ_a < 0 on {neg_fault:.3g} of "
        f"{RLC_MONO_ROWS} x 2 (the real mixer {neg:.3g}; gate 0); DreamerV3 "
        f"straight-through without the stop-gradient: {_rlc_fmt(st_fault)}; "
        f"AlphaZero value head without tanh: {_rlc_fmt(tanh_fault)}; "
        f"{time.perf_counter() - t_phase:.1f} s; on {smi}")
    assert not failed, failed
    assert neg == 0.0 and neg_fault > 0, (neg, neg_fault)
    assert st_fault["grads"] > 1, f"straight-through fault NOT rejected: " \
        f"{st_fault}"
    assert tanh_fault["grads"] > 1 and tanh_fault["metrics"] > 1, \
        f"value head fault NOT rejected: {tanh_fault}"
    # (c) learning and (d) times
    _rlc_learn_qmix(smi)
    _rlc_learn_dv3(smi)
    _rlc_learn_az(smi)
    log(f"[time] rllib-c {time.perf_counter() - t_phase:.1f} s")


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
    lc_launches, lc_masks, lc_res = phase("long-context",
                                          long_context_phase, smi)
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches = phase("moe", moe_phase, smi)
    pp_launches = phase("pipeline", pipeline_phase, smi)
    vtm_launches, vtm_res = phase("vit-t5-mlp", vit_t5_mlp_phase, smi)
    tp2_launches, tp2_res = phase("a13-tp", a13_tp_phase, smi)
    phase("rllib", rllib_phase, smi)
    phase("train-data", train_data_phase, smi)
    phase("rllib-c", rllib_c_phase, smi)
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
                                        "tp": tp_launches["train"][key],
                                        "long-context": lc_launches[key]})
        for name, line, key in (("flash_fwd", 130, "fwd"),
                                ("flash_bwd_dq", 192, "dq"),
                                ("flash_bwd_dkv", 239, "dkv"))
    ] + [
        # the long-context path's ring (b): each kernel at its block
        # shape, with its launches of that mask as its wrapper counted
        # them (causal on the diagonal block, non-causal on past
        # blocks); the backward writes f32 partials
        _kernel_entry(f"{name} (ring {kind} block, {mask} "
                      "[1,12,8192,128])", sm90_src, f"{flash_py}:{line}",
                      lc_masks[mask][count], lc_res[case][key])
        for case, kind, mask in (("ring_diag", "diagonal", "causal"),
                                 ("ring_past", "past", "non-causal"))
        for name, line, key, count in (
            ("flash_fwd", 130, "fwd", "fwd"),
            ("flash_bwd_dq, f32 grads", 192, "dq_f32", "dq"),
            ("flash_bwd_dkv, f32 grads", 239, "dkv_f32", "dkv"))
    ] + [
        # the other families' paths, each kernel at its path's shape with
        # that path's launches in its timed steps: MoE (Mixtral's
        # attention, b_llama3_8b's shape), the pipeline's microbatch, ViT
        # (D = 32), T5's encoder and cross-attention (non-causal; timed
        # at the encoder's shape) and its decoder (causal)
        _kernel_entry(f"{name} ({label})", sm90_src, f"{flash_py}:{line}",
                      launches[key], res[key])
        for label, launches, res in (
            ("moe, Mixtral [2,32/8,2048,128] causal", moe_launches,
             fres["b_llama3_8b"]),
            ("pipeline microbatch [2,12,2048,128] causal", pp_launches,
             vtm_res["pp_micro"]),
            ("vit, D=32 [256,6,65,32] non-causal", vtm_launches["vit"][0],
             vtm_res["vit_d32"]),
            ("t5 encoder and cross-attention, non-causal [32,8,512,64]",
             vtm_launches["t5"][1]["non-causal"], vtm_res["t5_enc"]),
            ("t5 decoder, causal [32,8,128,64]",
             vtm_launches["t5"][1]["causal"], vtm_res["t5_dec"]))
        for name, line, key in (("flash_fwd", 130, "fwd"),
                                ("flash_bwd_dq", 192, "dq"),
                                ("flash_bwd_dkv", 239, "dkv"))
    ] + [
        # the tp = 2 path (a13-tp): each kernel at a tp rank's shape of
        # the default configs, with its launches on the wgmma route at
        # that shape in (b)'s counted bf16 step on rank 0
        _kernel_entry(f"{name} (tp = 2 rank, {label})", sm90_src,
                      f"{flash_py}:{line}", tp2_launches[case][key],
                      tp2_res[case][key])
        for case, label in (
            ("vit_tp2", "vit [256,3,65,32] non-causal"),
            ("t5_enc_tp2", "t5 encoder [32,4,512,64] non-causal"),
            ("t5_dec_tp2", "t5 decoder [32,4,128,64] causal"),
            ("t5_cross_tp2", "t5 cross-attention [32,4,128 x 512,64] "
             "non-causal"),
            ("moe_tp2", f"moe, Mixtral's [2,16/4,2048,128] causal, "
             f"{MOE_RANK_LAYERS} layer"))
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
    elif sys.argv[1:2] == ["--sp-rank"]:
        sp_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--sp-card-rank"]:
        sp_card_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--sp-cards"]:
        sp_cards_main(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--a13-tp-rank"]:
        a13_tp_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--moe-rank"]:
        moe_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--pp-rank"]:
        pp_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--ep-card-rank"]:
        ep_card_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--ep-cards"]:
        ep_cards_main(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--pp-card-rank"]:
        pp_card_rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--pp-cards"]:
        pp_cards_main(int(sys.argv[2]))
    else:
        main()
