"""Device ingest: a source's numpy batches put on a device.

Port of `ray_tpu/data/dataset.py:Dataset.iter_jax_batches`. The port
has no Dataset (its blocks and executor run on the ``ray_tpu``
runtime); the counterpart is a function over any object with
``iter_batches(batch_size=, batch_format="numpy", ...)``, a Dataset of
the JAX package included. Each column goes to ``device`` through pinned
memory in one non-blocking copy on the card (a plain tensor on the
CPU). Given a ``mesh`` and a partition ``spec`` (JAX's
``NamedSharding(mesh, P("dp"))`` is ``spec=("dp",)``), a rank keeps
only its region of each column: along the batch dimension, block ``i``
of the spec's axes, as `parallel.sharding.local_region` lays it out.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch.models.llama import resolve_device
from ray_tpu_torch.parallel.sharding import PartitionSpec, local_region


def to_device(x, device: torch.device) -> torch.Tensor:
    """One host array or CPU tensor on ``device``: pinned and copied
    non-blocking on the card (the caching host allocator holds the
    pinned buffer until the copy is done)."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def iter_device_batches(source, *, batch_size: Optional[int] = 256,
                        device="cuda", mesh=None,
                        spec: Optional[PartitionSpec] = None,
                        coordinate: Optional[Mapping[str, int]] = None,
                        **kwargs) -> Iterator[Dict[str, torch.Tensor]]:
    """``source.iter_batches(batch_size=, batch_format="numpy",
    **kwargs)`` with every column on ``device``; with ``mesh`` (a
    `DeviceMesh`, or a mapping of axis sizes with this rank's
    ``coordinate``) and ``spec``, this rank's region of each column."""
    device = resolve_device(device)
    for batch in source.iter_batches(batch_size=batch_size,
                                     batch_format="numpy", **kwargs):
        out: Dict[str, Any] = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if mesh is not None and spec is not None:
                v = v[local_region(v.shape, tuple(spec)[:v.ndim], mesh,
                                   coordinate)]
            out[k] = to_device(v, device)
        yield out
