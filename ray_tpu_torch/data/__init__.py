"""ray_tpu_torch.data — the device piece of the Data library: batches of
any source with ``iter_batches`` put on a device (`iter_device_batches`).
"""

from ray_tpu_torch.data.dataset import iter_device_batches

__all__ = ["iter_device_batches"]
