"""Where the training time goes: profile one train step on the card.

    python3 -m ray_tpu_torch.profile_train [--layers N] [--steps N]

Builds the JAX package's flagship training configuration
(`bench.py:flagship_config()`: vocab 32000, dim 1536, 16 layers, 12/12
heads, ffn 4096, bf16 activations) with f32 master weights from
``llama_init(seed=0, dtype=torch.float32)``, on a fixed seeded batch of
8 x 2048 tokens, with ``adamw(3e-4, weight_decay=0.0)`` as bench.py's
training measurement uses. One change: ``remat_policy="full"`` where
bench.py saves the three FFN products, since the port runs full remat
only (ROADMAP A11b); the numbers are the same. Takes one warm-up step,
then profiles ``--steps`` steps under `torch.profiler` with CUDA
activity and prints the device time summed by kernel family (the three
flash-attention kernels, matrix products, the optimizer, the rest), the
top kernels, the device-busy share of the wall time and the card's name
and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

BATCH, SEQ = 8, 2048
BENCH_REMAT_POLICY = "save:ffn_gate+ffn_up+ffn_down"  # bench.py's choice


def flagship_config(**kw):
    """bench.py:flagship_config()'s widths, with remat_policy="full"."""
    from ray_tpu_torch.models.llama import LlamaConfig

    fields = dict(vocab_size=32000, dim=1536, n_layers=16, n_heads=12,
                  n_kv_heads=12, ffn_dim=4096, max_seq_len=2048, remat=True,
                  remat_policy="full", attn_impl="kernel",
                  flash_block_q=1024, flash_block_k=1024)
    fields.update(kw)
    return LlamaConfig(**fields)


def train_batch(cfg, seed: int = 1):
    """The fixed numpy-seeded batch {'tokens': [8, 2049]} on the card."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, size=(BATCH, SEQ + 1))
    return {"tokens": torch.from_numpy(tokens).cuda()}


def build_trainer(cfg):
    """(params, opt_state, step_fn) at f32 master weights on the card."""
    from ray_tpu_torch import adamw, llama_loss, make_train_step
    from ray_tpu_torch.models.llama import llama_init

    params = llama_init(cfg, seed=0, device="cuda", dtype=torch.float32)
    init_fn, step_fn = make_train_step(
        lambda p, b: llama_loss(p, b, cfg), adamw(3e-4, weight_decay=0.0))
    params, opt_state = init_fn(params)
    return params, opt_state, step_fn


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _family(name: str) -> str:
    n = name.lower()
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkv_kernel", "flash_fwd_sm90_kernel",
                   "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel"):
        if kernel in n:
            return f"{kernel} (hand-written)"
    if "gemm" in n or "cutlass" in n or "sm90_xmma" in n or "matmul" in n \
            or "nvjet" in n:
        return "matrix products (cuBLAS)"
    if "multi_tensor_apply" in n or "adam" in n:
        return "optimizer (multi-tensor)"
    if "cross_entropy" in n or "softmax" in n or "reduce" in n \
            or "norm" in n:
        return "reductions / softmax / norms"
    if "index" in n or "gather" in n or "scatter" in n or "embedding" in n:
        return "index / gather / scatter"
    return "elementwise and copies"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_config(n_layers=args.layers)
    params, opt_state, step_fn = build_trainer(cfg)
    batch = train_batch(cfg)
    params, opt_state, m = step_fn(params, opt_state, batch)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, opt_state, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: a user annotation (Optimizer.step#AdamW.step) also
    # carries device time, which its kernels already count
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    total_us = sum(e.self_device_time_total for e in rows)
    fams = {}
    for e in rows:
        f = _family(e.key)
        us, n = fams.get(f, (0.0, 0))
        fams[f] = (us + e.self_device_time_total, n + e.count)
    print(f"[profile] train step, {cfg.n_layers} layers, batch {BATCH} x "
          f"{SEQ}: {args.steps} steps, wall {wall:.3f} s "
          f"({wall / args.steps * 1e3:.1f} ms/step under the profiler), "
          f"device busy {total_us / 1e6:.3f} s ({total_us / 1e6 / wall:.1%}"
          f" of wall); loss {m['loss'].item():.4f}; {card()}")
    for f, (us, n) in sorted(fams.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {f}: {us / 1e3 / args.steps:.2f} ms/step in "
              f"{n // args.steps} launches/step ({us / total_us:.1%} of "
              f"device time)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   top: {e.self_device_time_total / 1e3:9.2f} ms "
              f"x{e.count:6d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
