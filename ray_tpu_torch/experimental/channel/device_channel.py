"""Device channel: tensor handoff between stages over a host channel.

Port of `ray_tpu/experimental/channel/device_channel.py` (reference:
python/ray/experimental/channel/torch_tensor_nccl_channel.py). The JAX
channel wraps the runtime's shared-memory ``Channel``; this one wraps
any object with ``write(value, timeout)``, ``read(timeout)`` and
``close()`` (that ``Channel`` included). A tensor crosses as host
numpy, in one device-to-host copy on write, and comes back on the
reader's ``device`` (the card unless the caller asks for the CPU) in
one host-to-device copy; dtypes numpy lacks (bfloat16, float8) cross
bit-cast to a same-width integer, with their name. Other values pass
through as they are.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ray_tpu_torch.data.dataset import to_device
from ray_tpu_torch.models.llama import resolve_device


def _to_host(x: torch.Tensor):
    """(numpy array, dtype name): one device-to-host copy."""
    x = x.detach().contiguous().cpu()
    name = str(x.dtype).rsplit(".", 1)[-1]
    try:
        return x.numpy(), name
    except TypeError:           # a dtype numpy lacks: its bits
        return x.view(getattr(torch, f"int{x.element_size() * 8}")
                      ).numpy(), name


class DeviceChannel:
    """Channel for torch tensors (other values pass through as-is)."""

    def __init__(self, channel, device="cuda"):
        self._chan = channel
        self._device = resolve_device(device)

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        if torch.is_tensor(value):
            self._chan.write(("torch",) + _to_host(value), timeout)
        else:
            self._chan.write(("raw", value), timeout)

    def read(self, timeout: Optional[float] = None) -> Any:
        msg = self._chan.read(timeout)
        if msg[0] != "torch":
            return msg[1]
        t = torch.from_numpy(msg[1])
        dtype = getattr(torch, msg[2])
        return to_device(t if t.dtype == dtype else t.view(dtype),
                         self._device)

    def close(self) -> None:
        self._chan.close()
