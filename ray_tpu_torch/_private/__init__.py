"""Private runtime helpers of the port (counterpart of `ray_tpu/_private`)."""
