"""ray_tpu_torch.train — training support: sharded array checkpoints."""
