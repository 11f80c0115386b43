"""Ops of the PyTorch/CUDA port: the attention dispatch, flash
attention, paged decode attention and KV quantization."""
