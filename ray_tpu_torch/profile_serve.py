"""Where the serving time goes: profile the DecodeEngine on the card.

    python3 -m ray_tpu_torch.profile_serve [--impl auto|reference] [--paged]
        [--kv-quant int8|fp8_e4m3]

Serves the same 8 requests as chip_smoke.py (Llama-3-8B at its
published widths, seeded random bf16 weights, prompts of 64-512 tokens,
32 new tokens each, greedy) through the engine's default construction
(dense cache, pipeline depth 2, the decode loop replayed as CUDA graphs)
or, with ``--paged``, the paged engine (``--kv-quant`` makes its pool
int8 or fp8-e4m3): once to warm up, then once more
under `torch.profiler` with CUDA activity. Prints the device time summed
by kernel family (the paged-attention kernels, matrix products, the
rest), the paged-attention kernels' and all kernels' device time per
decode iteration, the top kernels by device time, the device-busy share
of the run's wall time, and the card's name and power limit. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch


# B2's kernels: the split-KV pass (tensor-core or exact-f32) and the
# combine pass.
PAGED_KERNELS = ("paged_decode_mma_kernel", "paged_decode_fma_kernel",
                 "paged_decode_combine_kernel")


def _family(name: str) -> str:
    n = name.lower()
    for kernel in PAGED_KERNELS:
        if kernel in n:
            return f"{kernel} (hand-written)"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "sm90_xmma" in n \
            or "matmul" in n or "nvjet" in n:
        return "matrix products (cuBLAS)"
    if "index" in n or "gather" in n or "scatter" in n:
        return "index / gather / scatter"
    if "reduce" in n or "softmax" in n:
        return "reductions / softmax"
    return "elementwise and other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", default="auto",
                    choices=("auto", "kernel", "reference"))
    ap.add_argument("--paged", action="store_true",
                    help="profile the paged engine instead of the dense one")
    ap.add_argument("--kv-quant", choices=("int8", "fp8_e4m3"),
                    help="quantize the paged engine's KV pool")
    args = ap.parse_args()
    if args.kv_quant and not args.paged:
        ap.error("--kv-quant needs --paged")
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import DecodeEngine, LlamaConfig
    from ray_tpu_torch.models.llama import llama_init

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = LlamaConfig.llama3_8b(attn_impl=args.impl)
    params = llama_init(cfg, seed=0, device="cuda", dtype=cfg.dtype)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in rng.randint(64, 513, size=8)]

    def serve():
        eng = DecodeEngine(params, cfg, batch_slots=8, max_len=2048,
                           kv_block_tokens=32, greedy=True,
                           paged=args.paged, kv_quant=args.kv_quant)
        for p in prompts:
            eng.submit(p, 32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng

    serve()                     # warm-up (cuBLAS, B2's build)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, eng = serve()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in rows)
    fams = {}
    for e in rows:
        f = _family(e.key)
        us, n = fams.get(f, (0.0, 0))
        fams[f] = (us + e.self_device_time_total, n + e.count)
    s = eng.stats()
    layout = "paged" if args.paged else "dense"
    if args.kv_quant:
        layout += f" {args.kv_quant}"
    print(f"[profile] impl={args.impl}, {layout}"
          f" engine: wall {wall:.3f} s, device busy "
          f"{total_us / 1e6:.3f} s ({total_us / 1e6 / wall:.1%} of wall); "
          f"{eng.decode_iterations} decode iterations in "
          f"{eng.decode_dispatches} dispatches "
          f"({int(s['decode_graph_replays'])} replayed from "
          f"{int(s['decode_graphs'])} CUDA graphs), "
          f"{eng.prefill_dispatches} prefill dispatches; {smi}")
    for f, (us, n) in sorted(fams.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {f}: {us / 1e3:.2f} ms in {n} launches "
              f"({us / total_us:.1%} of device time)")
    b2_us = sum(us for f, (us, _) in fams.items()
                if f.split(" ")[0] in PAGED_KERNELS)
    print(f"[profile] B2 (split + combine) device time per decode "
          f"iteration: {b2_us / 1e3 / max(1, eng.decode_iterations):.4f} ms "
          f"over {eng.decode_iterations} iterations of {cfg.n_layers} "
          f"layers")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   top: {e.self_device_time_total / 1e3:9.2f} ms "
              f"x{e.count:6d}  {e.key[:90]}")
    # The decode loop alone: the served (now idle) engine's H=8 graph
    # replayed back to back, timed with CUDA events. Idle rows compute
    # the same work as live ones.
    graph = eng._graphs.graphs[(8, True)][0]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 80
    print(f"[profile] decode iteration on the card: {ms:.4f} ms (H=8 graph "
          f"replayed 10 times, CUDA events; 8 rows, {cfg.n_layers} layers) "
          f"= {8e3 / ms:.1f} tokens/s at 8 rows")


if __name__ == "__main__":
    main()
