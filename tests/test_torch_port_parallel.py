"""PyTorch port, the parallel layer: `MeshSpec`, `mesh_shape_for`, the
logical-axis rules (`prune_rules_for_mesh`, `logical_to_mesh`,
`spec_for`), `llama_param_specs` and each rank's region of a leaf,
against the JAX package. These are exact: specs, sizes and slices are
compared for equality. The meshes are given to the port as mappings of
axis sizes (a `DeviceMesh` needs a process group; the gloo worlds of
`test_torch_port_sharded.py` build real ones and hold their names,
sizes and rank layout to JAX's).
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding

# meshes over at most the 8 virtual CPU devices; nano's dims: 4 heads, 2
# kv heads, dim 64 — tp=4 does not divide the kv heads, tp=8 not the heads
MESHES = {
    "dp2": {"dp": 2},
    "fsdp4": {"fsdp": 4},
    "tp4": {"tp": 4},
    "tp8": {"tp": 8},
    "dp2_tp4": {"dp": 2, "tp": 4},
    "fsdp2_sp2_tp2": {"fsdp": 2, "sp": 2, "tp": 2},
    "dcn2_fsdp2_tp2": {"dcn": 2, "fsdp": 2, "tp": 2},
    "ep2_tp2_pp2": {"ep": 2, "tp": 2, "pp": 2},
}
NANO_DIMS = {"heads": 4, "kv": 2, "embed": 64, "mlp": 128, "vocab": 256,
             "batch": 6, "length": 33}


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.create_mesh(axes, jax.devices()[:n])


def _sizes(axes):
    return {a: axes.get(a, 1) for a in tmesh.AXIS_ORDER}


@pytest.mark.parametrize("kw,n", [({}, 1), ({"dp": -1, "tp": 4}, 32),
                                  ({"fsdp": -1}, 8), ({"dcn": 2, "tp": 2}, 4),
                                  ({"dp": 2, "fsdp": 2, "sp": 2}, 8)])
def test_mesh_spec_resolve_matches_jax(kw, n):
    assert tmesh.MeshSpec(**kw).resolve(n) == jmesh.MeshSpec(**kw).resolve(n)


@pytest.mark.parametrize("kw,n", [({"dp": -1, "tp": -1}, 8),
                                  ({"tp": 3, "dp": -1}, 8),
                                  ({"dp": 2}, 8)])
def test_mesh_spec_errors_match_jax(kw, n):
    for mod in (jmesh, tmesh):
        with pytest.raises(ValueError):
            mod.MeshSpec(**kw).resolve(n)


@pytest.mark.parametrize("args", [(8,), (8, 2), (8, 2, 2), (8, 1, 1, 2),
                                  (16, 4, 1, 2)])
def test_mesh_shape_for_matches_jax(args):
    assert tmesh.mesh_shape_for(*args) == jmesh.mesh_shape_for(*args)
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER


@pytest.mark.parametrize("args", [(8, 3), (8, 1, 1, 3)])
def test_mesh_shape_for_errors_match_jax(args):
    for mod in (jmesh, tmesh):
        with pytest.raises(ValueError):
            mod.mesh_shape_for(*args)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rules_and_specs_match_jax(name):
    """For DEFAULT_RULES on each mesh: the pruned table with and without
    the logical dim sizes (tp=4 does not divide nano's kv heads, tp=8
    not its heads), logical_to_mesh of every llama leaf and of batch and
    sequence axes under the default and the pruned tables, and
    llama_param_specs leaf for leaf."""
    axes = MESHES[name]
    jm = _jax_mesh(axes)
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    for dims in (None, NANO_DIMS):
        want = jsharding.prune_rules_for_mesh(jsharding.DEFAULT_RULES, jm,
                                              dims)
        got = tsharding.prune_rules_for_mesh(tsharding.DEFAULT_RULES,
                                             _sizes(axes), dims)
        assert got == want
        for rules in (None, got):
            for logical in (("batch", "length", "embed"), ("batch", None),
                            ("vocab", "embed"), ("embed", "vocab"),
                            ("layers", "mlp", "embed"), ("expert", "embed"),
                            ("stage", "layers"), ("embed", "embed"),
                            ("kv_blocks", "block_tokens", "kv")):
                assert tsharding.logical_to_mesh(logical, rules) == tuple(
                    jsharding.logical_to_mesh(logical, rules)), logical
                assert tsharding.spec_for(*logical, rules=rules) == tuple(
                    jsharding.spec_for(*logical, rules=rules))
            jcfg, tcfg = jllama.LlamaConfig.nano(), tllama.LlamaConfig.nano()
            want_specs = jax.tree_util.tree_leaves(
                jllama.llama_param_specs(jcfg, rules),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            got_specs = jax.tree_util.tree_leaves(
                tllama.llama_param_specs(tcfg, rules),
                is_leaf=lambda x: isinstance(x, tuple))
            assert got_specs == [tuple(s) for s in want_specs]
            assert tllama.llama_logical_specs(tcfg) == \
                jllama.llama_logical_specs(jcfg)


@pytest.mark.parametrize("name", ["dp2", "fsdp4", "tp4",
                                  "fsdp2_sp2_tp2", "dcn2_fsdp2_tp2"])
def test_local_region_matches_named_sharding(name):
    """Each rank's region of every nano leaf under the pruned default
    rules is the slice `NamedSharding.devices_indices_map` gives the
    device at the same mesh coordinate (multi-axis entries major
    first), and the regions tile each leaf."""
    axes = MESHES[name]
    jm = _jax_mesh(axes)
    jcfg, tcfg = jllama.LlamaConfig.nano(), tllama.LlamaConfig.nano()
    rules = tsharding.prune_rules_for_mesh(
        tsharding.DEFAULT_RULES, _sizes(axes),
        {"heads": 4, "kv": 2, "embed": 64, "mlp": 128, "vocab": 256})
    shapes = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x: x.shape, jax.eval_shape(
            lambda: jllama.llama_init(jax.random.PRNGKey(0), jcfg))),
        is_leaf=lambda x: isinstance(x, tuple))
    specs = jax.tree_util.tree_leaves(
        tllama.llama_param_specs(tcfg, rules),
        is_leaf=lambda x: isinstance(x, tuple))
    coords = {d.id: dict(zip(jm.axis_names, np.argwhere(
        np.vectorize(lambda x: x.id)(jm.devices) == d.id)[0]))
        for d in jm.devices.flat}
    for shape, spec in zip(shapes, specs):
        want = NamedSharding(jm, jax.sharding.PartitionSpec(*spec)) \
            .devices_indices_map(shape)
        cover = np.zeros(shape, np.int32)
        for dev, idx in want.items():
            got = tsharding.local_region(shape, spec, _sizes(axes),
                                         coords[dev.id])
            assert [(s.start or 0, shape[i] if s.stop is None else s.stop)
                    for i, s in enumerate(idx)] == \
                [(s.start, s.stop) for s in got], (shape, spec, dev)
            cover[got] += 1
        reps = len(want) // int(np.prod([
            _sizes(axes)[a] for e in spec for a in tsharding.spec_axes(e)]))
        assert (cover == reps).all()


def test_uneven_split_raises():
    with pytest.raises(ValueError, match="does not split"):
        tsharding.local_region((6, 4), ("tp",), {"tp": 4}, {"tp": 0})
