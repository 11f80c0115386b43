"""Serving-plane state API of the PyTorch/CUDA port (`serving.py`)."""
