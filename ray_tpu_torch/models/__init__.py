"""Models of the PyTorch/CUDA port: Llama, cached generation, the
DecodeEngine (dense or paged, speculative, multi-LoRA with its adapter
pool), LoRA and the train steps."""
