"""Device channels over a host channel."""

from ray_tpu_torch.experimental.channel.device_channel import DeviceChannel

__all__ = ["DeviceChannel"]
