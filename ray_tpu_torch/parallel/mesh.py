"""Device-mesh construction.

Port of `ray_tpu/parallel/mesh.py`. The unit of parallelism is a
`torch.distributed.DeviceMesh` over named axes, with one rank (one
process) per device. Axis names follow the scaling-book convention:

- ``dcn``  the inter-slice axis, OUTERMOST: only the data-parallel
           gradient all-reduce crosses it (`create_hybrid_mesh`)
- ``dp``   pure data parallelism (params replicated)
- ``fsdp`` data parallelism with parameter sharding (ZeRO-3 analog)
- ``pp``   pipeline parallelism (stage axis)
- ``tp``   tensor (megatron) parallelism
- ``sp``   sequence/context parallelism (ring attention axis)
- ``ep``   expert parallelism (MoE)

Every mesh names all seven axes of `AXIS_ORDER`, size-1 axes included,
as `create_mesh` names them in JAX. Ranks fill the mesh in row-major
order, so the last axes (tp, sp) join neighbouring ranks. Building a
mesh creates its process groups: every rank of the world calls it with
the same arguments, after `bootstrap.initialize_distributed`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_ORDER = ("dcn", "dp", "pp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh: axis name -> size. -1 means 'absorb remaining'.

    Example::

        MeshSpec(dp=-1, tp=4)   # on 32 devices -> {"dp": 8, "tp": 4}
    """

    dcn: int = 1
    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wildcards = [a for a, s in sizes.items() if s == -1]
        if len(wildcards) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wildcards}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcards:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wildcards[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


def mesh_shape_for(n_devices: int,
                   tp: int = 1,
                   sp: int = 1,
                   fsdp: Optional[int] = None) -> Dict[str, int]:
    """Heuristic mesh for n_devices: tp/sp as asked, rest fsdp (or dp)."""
    rest = n_devices // (tp * sp)
    if rest * tp * sp != n_devices:
        raise ValueError(f"tp*sp={tp * sp} must divide n_devices={n_devices}")
    if fsdp is None:
        return {"dp": 1, "pp": 1, "fsdp": rest, "ep": 1, "sp": sp,
                "tp": tp}
    if rest % fsdp:
        raise ValueError(f"fsdp={fsdp} must divide {rest}")
    return {"dp": rest // fsdp, "pp": 1, "fsdp": fsdp, "ep": 1, "sp": sp,
            "tp": tp}


def _world(devices: Optional[Sequence[int]],
           device_type: Optional[str]) -> Tuple[list, str]:
    """(global ranks, device type): every rank of the world by default,
    on CUDA unless the caller asks for the CPU."""
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import resolve_device

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call ray_tpu_torch.parallel."
            "initialize_distributed() before building a mesh")
    device_type = resolve_device(device_type or "cuda").type
    if devices is None:
        devices = range(dist.get_world_size())
    return [int(d) for d in devices], device_type


def _device_mesh(device_type: str, ranks: np.ndarray,
                 names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.as_tensor(ranks, dtype=torch.int),
                      mesh_dim_names=names)


def create_mesh(axis_sizes: Dict[str, int],
                devices: Optional[Sequence[int]] = None,
                device_type: Optional[str] = None):
    """A `DeviceMesh` with AXIS_ORDER-ordered named axes over ``devices``
    (global ranks, default the whole world) in row-major order."""
    devices, device_type = _world(devices, device_type)
    names = tuple(a for a in AXIS_ORDER if axis_sizes.get(a, 1) >= 1)
    shape = tuple(axis_sizes.get(a, 1) for a in names)
    if math.prod(shape) != len(devices):
        raise ValueError(
            f"mesh shape {dict(zip(names, shape))} != {len(devices)} devices")
    return _device_mesh(device_type, np.asarray(devices).reshape(shape),
                        names)


def create_hybrid_mesh(axis_sizes: Dict[str, int],
                       devices: Optional[Sequence[int]] = None,
                       device_type: Optional[str] = None):
    """Multi-slice mesh: the outer ``dcn`` axis spans slices; every other
    axis stays within one slice. Consecutive ranks form a slice (the
    layout JAX's function falls back to off multi-slice TPUs), so a
    host's ranks share a slice when each host runs consecutive ranks:
    `create_mesh`'s row-major layout, ``dcn`` being its first axis."""
    return create_mesh(axis_sizes, devices, device_type)


def auto_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """Mesh from a MeshSpec (default: all devices on the fsdp axis)."""
    devices, device_type = _world(devices, device_type)
    if spec is None:
        spec = MeshSpec(fsdp=-1)
    return create_mesh(spec.resolve(len(devices)), devices, device_type)


def local_mesh(device_type: Optional[str] = None):
    """Mesh over this process's own devices, all on fsdp. A process
    drives one device, so it holds this rank alone. Every rank calls it:
    the one-rank groups are created over the whole world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    _, device_type = _world(None, device_type)
    own, _ = dist.new_subgroups(group_size=1)
    return DeviceMesh.from_group(
        [own] * len(AXIS_ORDER), device_type,
        mesh=torch.full((1,) * len(AXIS_ORDER), dist.get_rank(),
                        dtype=torch.int),
        mesh_dim_names=AXIS_ORDER)


def axis_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's coordinates
    on every axis of ``mesh`` outside ``axes`` (over all of ``axes`` at
    once). A group of several axes is a new one: every rank asks for
    the same ``axes`` in the same order."""
    import torch.distributed as dist

    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    ranks = mesh.mesh.permute(*rest, *keep).reshape(
        -1, math.prod(mesh.mesh.shape[i] for i in keep))
    group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return group
