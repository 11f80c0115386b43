"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model paths.

The port mirrors the JAX package's module paths (`models/llama.py`,
`models/generate.py`, `models/engine.py`, `models/training.py`,
`ops/attention.py`, `ops/flash_attention.py`, ...) and imports nothing
of it. Today it serves Llama models through the `DecodeEngine` (a dense
per-slot cache by default, or a paged block pool; an async run-ahead
ring; on the card the decode loop replayed as CUDA graphs), with decode
attention on a hand-written Hopper kernel (`csrc/paged_attention.cu`),
and trains them on one card through
`make_train_step`, with attention forward and backward on hand-written
Hopper flash-attention kernels (`csrc/flash_attention.cu`). Entry
points run on CUDA unless the caller passes ``device="cpu"``.

Importing the package builds nothing and touches no device: each kernel
is compiled by `ray_tpu_torch._build` at its first launch.
"""

from ray_tpu_torch.models.engine import DecodeEngine
from ray_tpu_torch.models.llama import (LlamaConfig, llama_forward,
                                        llama_loss)
from ray_tpu_torch.models.training import adamw, make_train_step
from ray_tpu_torch.ops.attention import paged_attention

__all__ = ["DecodeEngine", "LlamaConfig", "adamw", "llama_forward",
           "llama_loss", "make_train_step", "paged_attention"]
