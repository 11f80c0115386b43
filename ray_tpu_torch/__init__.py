"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's serving path.

The port mirrors the JAX package's module paths (`models/llama.py`,
`models/generate.py`, `models/engine.py`, `ops/attention.py`, ...) and
imports nothing of it. Today it serves Llama models through the paged
`DecodeEngine`, with decode attention on a hand-written Hopper kernel
(`csrc/paged_attention.cu`). Entry points run on CUDA unless the
caller passes ``device="cpu"``.

Importing the package builds nothing and touches no device: the kernel
is compiled by `ray_tpu_torch._build` at its first launch.
"""

from ray_tpu_torch.models.engine import DecodeEngine
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops.attention import paged_attention

__all__ = ["DecodeEngine", "LlamaConfig", "paged_attention"]
