"""Where torch's and XLA's float32 cos, sin and rsqrt differ, on the
inputs of Llama-3's RoPE and of an RMSNorm.

    JAX_PLATFORMS=cpu python3 tools/c4_f32_functions.py

Both `_rope` implementations (`ray_tpu/models/llama.py`,
`ray_tpu_torch/models/llama.py`) are the same text; this script feeds
each library's f32 functions the same f32 inputs and counts the results
that differ, and those that differ from the correctly rounded value
(the float64 result rounded to float32). RoPE: theta 500000, head dim
128, positions 0-2047 (131,072 angles). rsqrt: 100,000 values of
mean(x * x) + 1e-5 over seeded normal rows of width 4096. Prints the
versions and the counts; runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def main():
    theta, d, n_pos = 500000.0, 128, 2048
    half = d // 2
    tf = theta ** (-torch.arange(0, half, dtype=torch.float32) / half)
    jf = theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    freqs_same = np.array_equal(tf.numpy(), np.asarray(jf))
    ang = (torch.arange(n_pos, dtype=torch.float32)[:, None] * tf).numpy()
    exact = {"cos": np.cos(ang.astype(np.float64)).astype(np.float32),
             "sin": np.sin(ang.astype(np.float64)).astype(np.float32)}
    print(f"torch {torch.__version__}, jax {jax.__version__}; freqs "
          f"bit-identical: {freqs_same}; {ang.size} angles")
    for fn in ("cos", "sin"):
        t = getattr(torch, fn)(torch.from_numpy(ang)).numpy()
        j = np.asarray(getattr(jnp, fn)(jnp.asarray(ang)))
        print(f"{fn}: torch != XLA at {int((t != j).sum())}; off the "
              f"correctly rounded value: XLA {int((j != exact[fn]).sum())}, "
              f"torch {int((t != exact[fn]).sum())}; largest gap "
              f"{float(np.abs(t.astype(np.float64) - j).max()):.3e}")
    rng = np.random.RandomState(0)
    x = rng.standard_normal((100_000, 4096)).astype(np.float32)
    ms = (x * x).mean(axis=1, dtype=np.float32) + np.float32(1e-5)
    t = torch.rsqrt(torch.from_numpy(ms)).numpy()
    j = np.asarray(jax.lax.rsqrt(jnp.asarray(ms)))
    exact = (1.0 / np.sqrt(ms.astype(np.float64))).astype(np.float32)
    print(f"rsqrt: torch != XLA at {int((t != j).sum())} of {ms.size} "
          f"({(t != j).mean():.1%}); off the correctly rounded value: XLA "
          f"{int((j != exact).sum())}, torch {int((t != exact).sum())}")


if __name__ == "__main__":
    main()
