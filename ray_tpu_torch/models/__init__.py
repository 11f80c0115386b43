"""Models of the PyTorch/CUDA port: Llama, cached generation, the paged
DecodeEngine and the train step."""
