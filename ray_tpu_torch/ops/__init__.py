"""Ops of the PyTorch/CUDA port: paged decode attention and KV quantization."""
