"""Logical-axis sharding rules.

Port of `ray_tpu/parallel/sharding.py`: arrays carry logical axis names
("batch", "embed", "heads", ...) and a rule table maps logical axes to
mesh axes. A partition spec is a plain tuple with one entry per
dimension: None (replicated), a mesh-axis name, or a tuple of mesh-axis
names (split over their product, the first the most major), which is
what `jax.sharding.PartitionSpec` holds. There is no GSPMD to place a
tensor by its spec: `shard_tensor` / `shard_pytree` take each rank's
local region, and the train step (`models/training.py`) runs the
collectives the spec implies.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate)
LogicalAxisRules = Dict[str, Union[None, str, Tuple[str, ...]]]
PartitionSpec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Default rule table for transformer LMs. Batch is split over every
# data-ish axis; embed over fsdp (ZeRO-3 analog); heads/mlp over tp;
# sequence over sp (ring attention); experts over ep.
DEFAULT_RULES: LogicalAxisRules = {
    # batch splits over every data-ish axis; "dcn" is the inter-slice
    # axis, so the only cross-slice collective is the dp grad all-reduce.
    "batch": ("dcn", "dp", "fsdp"),
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "kv": None,
    "head_dim": None,
    "qkv": "tp",
    "vocab": "tp",
    "length": "sp",
    "expert": "ep",
    "layers": None,
    "stage": "pp",
    # Paged-KV pool axes ([layers, kv_blocks, block_tokens, kv,
    # head_dim]): block ids are row-LOCAL indirection — every shard
    # must hold every block so a row's block table resolves anywhere,
    # so the pool replicates over blocks/tokens and tp-shards only
    # over kv heads (the engine's pool sharding spec picks "kv" -> tp
    # when n_kv_heads divides; see DecodeEngine paged mode).
    "kv_blocks": None,
    "block_tokens": None,
}


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a `DeviceMesh`, or of a mapping of the same
    (what the rule functions read of a mesh)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def prune_rules_for_mesh(rules: LogicalAxisRules, mesh,
                         dim_sizes: Optional[Dict[str, int]] = None
                         ) -> LogicalAxisRules:
    """Restrict a rule table to what ``mesh`` can actually shard.

    For each logical axis, keep only the mesh axes that exist in the
    mesh with size > 1 AND — when ``dim_sizes`` knows the logical
    dimension — whose cumulative product divides it evenly. Axes that
    lose every mesh axis become None (replicate). ``mesh`` is a
    `DeviceMesh` or a mapping of axis sizes.

    This is what lets one rule table serve both training and serving
    meshes: on a pure ``{"tp": 4}`` inference mesh the training axes
    (dp/fsdp/sp/...) vanish, and a model whose ``n_kv_heads`` is not
    divisible by tp degrades to replicated KV while heads/mlp/vocab
    still shard.
    """
    sizes = mesh_axis_sizes(mesh)
    dim_sizes = dim_sizes or {}
    out: LogicalAxisRules = {}
    for logical, mesh_ax in rules.items():
        if mesh_ax is None:
            out[logical] = None
            continue
        axes = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
        size = dim_sizes.get(logical)
        kept = []
        prod = 1
        for a in axes:
            n = sizes.get(a, 1)
            if n <= 1:
                continue
            if size is not None and size % (prod * n):
                continue
            kept.append(a)
            prod *= n
        out[logical] = (None if not kept
                        else kept[0] if len(kept) == 1 else tuple(kept))
    return out


def logical_to_mesh(logical_axes: Sequence[Optional[str]],
                    rules: Optional[LogicalAxisRules] = None
                    ) -> PartitionSpec:
    """('batch','length','embed') -> (('dcn','dp','fsdp'), 'sp', None)."""
    rules = DEFAULT_RULES if rules is None else rules
    out = []
    used = set()
    for ax in logical_axes:
        mesh_ax = rules.get(ax) if ax is not None else None
        # A mesh axis may appear only once in a spec; later logical axes
        # that map to an already-used mesh axis replicate instead.
        if mesh_ax is None:
            out.append(None)
            continue
        axes = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)


def logical_tree_to_mesh(tree, rules: Optional[LogicalAxisRules] = None):
    """`logical_to_mesh` over every leaf of a nested dict of logical-axis
    tuples (a model's ``*_logical_specs``)."""
    if isinstance(tree, dict):
        return {k: logical_tree_to_mesh(v, rules) for k, v in tree.items()}
    return logical_to_mesh(tree, rules)


def spec_for(*logical_axes: Optional[str],
             rules: Optional[LogicalAxisRules] = None) -> PartitionSpec:
    return logical_to_mesh(logical_axes, rules)


def spec_axes(entry) -> Tuple[str, ...]:
    """One spec entry's mesh axes, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_region(shape: Sequence[int], spec: PartitionSpec, mesh,
                 coordinate: Optional[Mapping[str, int]] = None
                 ) -> Tuple[slice, ...]:
    """The region of a ``shape`` tensor that a rank holds under ``spec``:
    along each dimension, block ``i`` of ``n`` equal blocks, ``n`` the
    product of the entry's axis sizes and ``i`` the rank's index over
    them, the first axis the most major (as a `NamedSharding` lays it
    out). A spec shorter than the shape replicates the trailing
    dimensions. ``coordinate`` maps axis names to the rank's index
    (default: this rank's on the `DeviceMesh` ``mesh``; with a mapping
    of axis sizes for ``mesh`` it is required). Uneven splits raise:
    `prune_rules_for_mesh` with ``dim_sizes`` avoids them."""
    sizes = mesh_axis_sizes(mesh)
    if coordinate is None:
        coordinate = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    region = []
    for dim, n in enumerate(shape):
        axes = spec_axes(spec[dim]) if dim < len(spec) else ()
        parts = math.prod(sizes[a] for a in axes)
        if n % parts:
            raise ValueError(
                f"dimension {dim} of size {n} does not split over {axes} "
                f"({parts} shards)")
        index = 0
        for a in axes:
            index = index * sizes[a] + coordinate[a]
        block = n // parts
        region.append(slice(index * block, (index + 1) * block))
    return tuple(region)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current CUDA device of a
    "cuda" mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_tensor(x: torch.Tensor, spec: PartitionSpec, mesh,
                 device=None) -> torch.Tensor:
    """This rank's region of ``x`` under ``spec``, as a contiguous
    tensor of its own on ``device`` (default `mesh_device`)."""
    device = mesh_device(mesh) if device is None else device
    part = x[local_region(x.shape, spec, mesh)]
    return part.to(device=device, copy=True).contiguous()


def shard_pytree(tree, spec_tree, mesh, device=None):
    """Each rank's region of every leaf of a tree of dicts, by the
    matching tree of specs (the port's `jax.device_put` per
    `NamedSharding`)."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, spec_tree[k], mesh, device)
                for k, v in tree.items()}
    return shard_tensor(torch.as_tensor(tree), spec_tree, mesh, device)
