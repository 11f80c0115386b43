"""ray_tpu_torch.experimental — experimental pieces (device channels)."""
