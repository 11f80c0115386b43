"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model paths.

The port mirrors the JAX package's module paths (`models/llama.py`,
`models/generate.py`, `models/engine.py`, `models/training.py`,
`ops/attention.py`, `ops/flash_attention.py`, ...) and imports nothing
of it. Today it serves Llama models through the `DecodeEngine` (a dense
per-slot cache by default, or a paged block pool; an async run-ahead
ring; on the card the decode loop replayed as CUDA graphs; many LoRA
adapters in one batch) and serves N engines as one system through
`LLMFleet` (routing, autoscaling, health and deterministic failover,
disaggregated prefill/decode with KV handoff), with decode
attention on a hand-written Hopper kernel (`csrc/paged_attention.cu`),
and trains them through `make_sharded_train_step` over a `DeviceMesh`
of dcn/dp/fsdp axes (`ray_tpu_torch.parallel`; NCCL on the card, gloo on
the CPU) or `make_train_step` on one card (adapters only:
`make_lora_train_step`), with attention forward and backward on
hand-written Hopper flash-attention kernels
(`csrc/flash_attention_sm90.cu`), and checkpoints the sharded state in
the JAX package's layout (`train/array_checkpoint.py`). Entry points run
on CUDA unless the caller passes ``device="cpu"``.

Importing the package builds nothing and touches no device: each kernel
is compiled by `ray_tpu_torch._build` at its first launch.
"""

from ray_tpu_torch.models.engine import DecodeEngine
from ray_tpu_torch.models.fault_injection import FaultInjector, InjectedFault
from ray_tpu_torch.models.fleet import (FleetAutoscalingConfig, FleetError,
                                        FleetHealthConfig, LLMFleet,
                                        ReplicaUnavailable, RetriesExhausted)
from ray_tpu_torch.models.llama import (LlamaConfig, llama_forward,
                                        llama_loss)
from ray_tpu_torch.models.lora import (LoraConfig, lora_init, lora_merge,
                                       make_lora_train_step)
from ray_tpu_torch.models.training import (adamw, make_sharded_train_step,
                                          make_train_step)
from ray_tpu_torch.ops.attention import paged_attention

__all__ = ["DecodeEngine", "FaultInjector", "FleetAutoscalingConfig",
           "FleetError", "FleetHealthConfig", "InjectedFault", "LLMFleet",
           "LlamaConfig", "LoraConfig", "ReplicaUnavailable",
           "RetriesExhausted", "adamw", "llama_forward", "llama_loss",
           "lora_init", "lora_merge", "make_lora_train_step",
           "make_sharded_train_step", "make_train_step", "paged_attention"]
