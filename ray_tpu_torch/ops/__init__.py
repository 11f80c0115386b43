"""Ops of the PyTorch/CUDA port: the attention dispatch, flash
attention, paged decode attention, KV quantization, and ring and
Ulysses attention over a sequence-parallel group."""
