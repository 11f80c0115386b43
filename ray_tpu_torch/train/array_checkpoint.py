"""Sharded tensor checkpoints in the JAX package's on-disk layout.

Port of `ray_tpu/train/array_checkpoint.py`; a checkpoint written by
either package restores in the other:

- ``data/leafNNNNN.d<rank>.npy`` holds one rank's region of leaf NNNNN
  (the leaf's ordinal in key order) of a tree saved under a mesh, and
  ``data/leafNNNNN.p<k>.npy`` a whole leaf saved without one;
- ``array_index.p<k>.json`` is process k's index: each leaf's ``name``
  (its key path, e.g. ``layers/wq``), global ``shape``, logical
  ``dtype`` and ``shards``, each a ``file`` and the ``index`` of its
  region as [start, stop] per dimension. Each process publishes its own
  index atomically, after its data;
- bfloat16 and float8 leaves are stored bit-cast to a same-width
  unsigned integer (npy has no such dtypes); the index names the
  logical dtype.

Under a mesh every rank writes only its own region of each leaf, and a
region replicated over ranks is written once, by the rank at
coordinate 0 of every axis the leaf's spec does not name. Restore
merges every index, checks that each region it reads is covered (a
torn checkpoint raises, never returning uninitialized memory) and reads
only the region each rank holds under the mesh and specs it is given,
so a checkpoint saved under one mesh restores under another.

A checkpoint is complete once every participating process has
published its index; callers that need a commit point barrier after
`save_pytree` and then write their own marker.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.training import _leaves, _unflatten
from ray_tpu_torch.parallel.sharding import (local_region, mesh_device,
                                             spec_axes)

Pytree = Any

_INDEX_GLOB = "array_index.p*.json"


def _leaf_paths(tree: Pytree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) in `_leaves` order, the path as JAX writes it."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in _leaf_paths(tree[key], f"{prefix}{key}/")]
    return [(prefix[:-1], tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    """torch.bfloat16 -> "bfloat16": numpy's / ml_dtypes' name."""
    return str(dtype).rsplit(".", 1)[-1]


def _storable(x: torch.Tensor) -> np.ndarray:
    """The tensor as a numpy array npy can hold: dtypes numpy lacks are
    bit-cast to a same-width unsigned integer."""
    x = x.detach().cpu().contiguous()
    try:
        np.dtype(_dtype_name(x.dtype))
        return x.numpy()
    except TypeError:
        width = x.element_size() * 8
        return x.view(getattr(torch, f"int{width}")).numpy().view(
            np.dtype(f"uint{width}"))


def _from_stored(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """Inverse of `_storable` on a C-contiguous array: the logical
    dtype's view of npy data."""
    try:
        np.dtype(dtype_name)
        return torch.from_numpy(a)
    except TypeError:
        width = a.dtype.itemsize * 8
        return torch.from_numpy(a.view(np.dtype(f"int{width}"))).view(
            getattr(torch, dtype_name))


def _bounds(region: Tuple[slice, ...]) -> List[List[int]]:
    return [[int(s.start), int(s.stop)] for s in region]


def _full_shape(shape, spec, sizes) -> Tuple[int, ...]:
    """A local shard's global shape under ``spec``."""
    out = []
    for dim, n in enumerate(shape):
        axes = spec_axes(spec[dim]) if dim < len(spec) else ()
        for a in axes:
            n *= sizes[a]
        out.append(n)
    return tuple(out)


def save_pytree(tree: Pytree, path: str,
                process_index: Optional[int] = None, *, mesh=None,
                specs: Optional[Pytree] = None) -> None:
    """Write this process's part of every leaf of ``tree`` (a tree of
    dicts of tensors or arrays).

    With ``mesh`` and ``specs`` the leaves are this rank's regions (as
    `make_sharded_train_step`'s params are): each is written as
    ``.d<rank>`` unless another rank holds the same region. Without
    them every leaf is whole and written as ``.p<process_index>``.
    Every process calls this with the same (shared) path."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.sharding import mesh_axis_sizes

    rank = dist.get_rank() if dist.is_initialized() else 0
    if process_index is None:
        process_index = rank
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    if mesh is not None:
        spec_list = _leaves(specs)
        sizes = mesh_axis_sizes(mesh)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index: Dict[str, Any] = {"leaves": []}
    for ordinal, (name, leaf) in enumerate(_leaf_paths(tree)):
        x = torch.as_tensor(leaf)
        prefix = f"leaf{ordinal:05d}"
        if mesh is None:
            shape = tuple(x.shape)
            region = tuple(slice(0, d) for d in shape)
            fname, write = f"{prefix}.p{process_index}.npy", True
        else:
            spec = spec_list[ordinal]
            shape = _full_shape(x.shape, spec, sizes)
            region = local_region(shape, spec, mesh)
            named = {a for e in spec for a in spec_axes(e)}
            # one writer per replicated region (JAX's replica_id == 0)
            write = all(c == 0 for a, c in coord.items() if a not in named)
            fname = f"{prefix}.d{rank}.npy"
        entry = {"name": name, "shape": list(shape),
                 "dtype": _dtype_name(x.dtype), "shards": []}
        if write:
            np.save(os.path.join(data_dir, fname), _storable(x))
            entry["shards"].append({"file": fname,
                                    "index": _bounds(region)})
        index["leaves"].append(entry)
    # Publish this process's partial index atomically AFTER its data.
    final = os.path.join(path, f"array_index.p{process_index}.json")
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(index, f)
    os.replace(tmp, final)


def _merged_index(path: str) -> Dict[str, dict]:
    """name -> entry with shards merged across every process's index."""
    files = sorted(glob.glob(os.path.join(path, _INDEX_GLOB)))
    if not files:
        raise FileNotFoundError(
            f"no {_INDEX_GLOB} under {path!r} — not a checkpoint")
    merged: Dict[str, dict] = {}
    for fname in files:
        with open(fname) as f:
            index = json.load(f)
        for entry in index["leaves"]:
            cur = merged.get(entry["name"])
            if cur is None:
                merged[entry["name"]] = {
                    **entry, "shards": list(entry["shards"])}
            else:
                seen = {json.dumps(s["index"]) for s in cur["shards"]}
                for s in entry["shards"]:
                    if json.dumps(s["index"]) not in seen:
                        cur["shards"].append(s)
    return merged


def _read_region(data_dir: str, entry: dict,
                 want: Tuple[slice, ...]) -> torch.Tensor:
    """Assemble the requested region from overlapping shard files; every
    element must be covered."""
    want_bounds = _bounds(want)
    out_shape = [b - a for a, b in want_bounds]
    out = None
    covered = np.zeros(out_shape, dtype=bool)
    for shard in entry["shards"]:
        inter = []
        for (wa, wb), (sa, sb) in zip(want_bounds, shard["index"]):
            a, b = max(wa, sa), min(wb, sb)
            if a >= b:
                break
            inter.append((a, b, sa, wa))
        else:
            try:
                data = np.load(os.path.join(data_dir, shard["file"]))
            except OSError:
                continue  # missing/torn file -> the coverage check says so
            if out is None:
                out = np.empty(out_shape, dtype=data.dtype)
            src = tuple(slice(a - sa, b - sa) for a, b, sa, _ in inter)
            dst = tuple(slice(a - wa, b - wa) for a, b, _, wa in inter)
            out[dst] = data[src]
            covered[dst] = True
    if out is None or not covered.all():
        raise ValueError(
            f"checkpoint region {want_bounds} of {entry['name']} is "
            "incomplete (missing shard files — every process's shards and "
            "indexes must be visible at restore)")
    return _from_stored(out, entry["dtype"])


def restore_pytree(template: Pytree, path: str, *, mesh=None,
                   specs: Optional[Pytree] = None) -> Pytree:
    """Restore into the structure of ``template`` (a tree of dicts; its
    leaves are not read).

    With ``mesh`` and ``specs`` (a tree of partition specs matching the
    template) each rank reads exactly the region it holds, onto the
    mesh's device: the layout `make_sharded_train_step` keeps. Without
    them every leaf comes back whole, as a CPU tensor."""
    by_name = _merged_index(path)
    data_dir = os.path.join(path, "data")
    spec_list = None if mesh is None else _leaves(specs)
    device = None if mesh is None else mesh_device(mesh)
    out = []
    for i, (name, _) in enumerate(_leaf_paths(template)):
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"leaf {name!r} not in checkpoint")
        shape = tuple(entry["shape"])
        if mesh is None:
            region = tuple(slice(0, d) for d in shape)
        else:
            region = local_region(shape, spec_list[i], mesh)
        x = _read_region(data_dir, entry, region)
        out.append(x if device is None else x.to(device))
    return _unflatten(template, out)
