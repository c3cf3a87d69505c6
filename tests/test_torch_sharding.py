"""The port's HMP sharding rules, production meshes and input shapes
against the reference's: ``Rules.spec`` and ``make_rules``, and per
assigned arch the parameters' partition specs, ``abstract_params`` and
``input_specs`` on the 16 x 16 and 2 x 16 x 16 meshes.

The reference's rules read only ``mesh.shape``, so its side runs on a
stand-in mesh with no devices; the port's side lays ``DTensor``s over
``torch.distributed``'s fake process group of 256 or 512 ranks (nothing
is allocated), which a fixture tears down after this file."""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.launch.shapes as j_shapes  # noqa: E402
import repro.serving.kvcache as j_kvcache  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.params import abstract_params as j_abstract_params  # noqa: E402
from repro.models.params import partition_specs as j_partition_specs  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro.models.sharding import make_rules as j_make_rules  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.shapes import SHAPES, input_specs, shape_config  # noqa: E402
from repro_torch.models.params import _leaves, abstract_params, partition_specs  # noqa: E402
from repro_torch.models.sharding import Rules, make_rules, mesh_axis_sizes  # noqa: E402

MESHES = {"16x16": ((16, 16), False), "2x16x16": ((2, 16, 16), True)}
MODES = ("train", "prefill", "decode", "decode_long")


class FakeMesh:
    """The reference's rules read ``mesh.shape`` (a dict) alone."""

    def __init__(self, dims, multi_pod):
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        self.shape = dict(zip(names, dims))
        self.devices = np.empty(dims)


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    yield
    mesh_lib.destroy_fake_group()


def _port_mesh(name):
    dims, multi_pod = MESHES[name]
    return mesh_lib.make_production_mesh(multi_pod=multi_pod)


def _spec_tuple(p):
    return tuple(p)


# --- Rules and make_rules ------------------------------------------------------

def test_rules_dedup_mesh_axes():
    r, jr = Rules({"seq": "model", "vocab": "model"}), JRules({"seq": "model", "vocab": "model"})
    assert r.spec(("seq", "vocab")) == ("model", None) == _spec_tuple(jr.spec(("seq", "vocab")))


@pytest.mark.parametrize("names,shape", [
    (("kv_heads",), (8,)), (("kv_heads",), (32,)), (("kv_seq",), (8,)),
    (("kv_seq",), (128,)), (("kv_seq",), (4096,)), (("batch", "seq", "embed"), (256, 4096, 1024)),
    (("batch", "kv_seq", "kv_heads", None), (128, 32768, 8, 128)),
    (("kv_seq", "batch"), (64, 64)), ((None, "missing"), (4, 4)),
])
@pytest.mark.parametrize("mesh_shape", [{"data": 4, "model": 16}, {"pod": 2, "data": 16,
                                                                   "model": 16}])
def test_shape_aware_spec_equals_reference(names, shape, mesh_shape):
    """Mesh axes that do not divide a dim drop out; a tuple mapping keeps
    its dividing prefix; the same on both sides."""
    mapping = {"kv_heads": "model", "kv_seq": ("data", "model"), "batch": ("pod", "data"),
               "seq": "model", "embed": None}
    if "pod" not in mesh_shape:
        mapping["batch"] = ("data",)
    fake = types.SimpleNamespace(shape=mesh_shape, devices=np.empty(tuple(mesh_shape.values())))
    got = Rules(mapping, fake).spec(names, shape=shape)
    want = JRules(mapping, fake).spec(names, shape=shape)
    assert got == _spec_tuple(want)
    for name in mapping:
        assert Rules(mapping, fake).axis_size(name) == JRules(mapping, fake).axis_size(name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("batch_size", [0, 1, 256])
@pytest.mark.parametrize("sp", [True, False])
@pytest.mark.parametrize("model_only", [False, True])
def test_make_rules_equals_reference(mode, multi_pod, batch_size, sp, model_only):
    kw = dict(multi_pod=multi_pod, batch_size=batch_size, hmp_sequence_parallel=sp,
              serve_weights_model_only=model_only)
    assert make_rules(None, mode, **kw).mapping == j_make_rules(None, mode, **kw).mapping


def test_make_rules_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        make_rules(None, "serve")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _port_mesh("2x16x16")
    assert mesh_axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
    r = make_rules(mesh, "train", multi_pod=True)
    assert r.placements((("pod", "data"), "model", None)) == (Shard(0), Shard(0), Shard(1))
    assert r.placements((None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        r.placements((("data", "pod"),))


def test_production_meshes():
    m = _port_mesh("16x16")
    assert tuple(m.shape) == (16, 16) and m.mesh_dim_names == ("data", "model")
    m = _port_mesh("2x16x16")
    assert tuple(m.shape) == (2, 16, 16) and m.mesh_dim_names == ("pod", "data", "model")
    t = mesh_lib.make_test_mesh(model=4, data=2)
    assert tuple(t.shape) == (2, 4)


# --- parameters and inputs per arch ------------------------------------------------

def _j_rules(mesh_name, mode, batch):
    dims, multi_pod = MESHES[mesh_name]
    return j_make_rules(FakeMesh(dims, multi_pod), mode, multi_pod=multi_pod, batch_size=batch)


def _p_rules(mesh_name, mode, batch):
    dims, multi_pod = MESHES[mesh_name]
    return make_rules(_port_mesh(mesh_name), mode, multi_pod=multi_pod, batch_size=batch)


def _j_leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict of the reference's leaves."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _j_leaves(val, path + (key,))
        else:
            yield path + (key,), val


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_partition_specs_and_abstract_params_equal_reference(arch, mesh_name):
    """Every leaf's spec (a grouped leaf's stacking dim replicated), shape
    and dtype equal the reference's; each fake ``DTensor`` leaf is placed
    by its spec and holds its shard's shape."""
    from repro_torch.models.sharding import local_shape_offset

    cfg, jcfg = get_config(arch), j_get_config(arch)
    want_specs = dict(_j_leaves(j_partition_specs(jcfg, _j_rules(mesh_name, "train", 256))))
    rules = _p_rules(mesh_name, "train", 256)
    got_specs = dict(_leaves(partition_specs(cfg, rules)))
    assert set(got_specs) == set(want_specs)
    for path, spec in got_specs.items():
        assert spec == _spec_tuple(want_specs[path]), path

    want = dict(_j_leaves(j_abstract_params(jcfg)))
    got = dict(_leaves(abstract_params(cfg, rules)))
    assert set(got) == set(want)
    for path, t in got.items():
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert str(t.dtype).split(".")[-1] == str(want[path].dtype), path
        assert tuple(t.placements) == rules.placements(got_specs[path]), path
        local = local_shape_offset(t.shape, rules.mesh, t.placements)[0]
        assert tuple(t.to_local().shape) == local, path
    plain = dict(_leaves(abstract_params(cfg)))
    assert all(tuple(plain[k].shape) == tuple(want[k].shape) for k in want)


def _stub_jax_sharding(monkeypatch):
    """The reference's ``input_specs`` and ``make_cache`` build
    ``NamedSharding``s of a real mesh; with the stand-in mesh each
    becomes its (shape, dtype, spec) triple."""
    import jax
    import jax.numpy as jnp

    fake_jax = types.SimpleNamespace(
        sharding=types.SimpleNamespace(NamedSharding=lambda mesh, spec: spec),
        ShapeDtypeStruct=lambda shape, dtype, sharding=None: (
            tuple(shape), jnp.dtype(dtype).name, None if sharding is None else tuple(sharding)),
        tree=jax.tree, tree_util=jax.tree_util)
    monkeypatch.setattr(j_shapes, "jax", fake_jax)
    monkeypatch.setattr(j_kvcache, "jax", fake_jax)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_equal_reference(arch, shape, mesh_name, monkeypatch):
    """Tokens, embeddings, labels, image embeddings and the decode cache:
    shapes, dtypes and specs equal the reference's (the cache's write
    index is a host int here, a scalar there)."""
    _stub_jax_sharding(monkeypatch)
    info = SHAPES[shape]
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert shape_config(cfg, shape).window == j_shapes.shape_config(jcfg, shape).window
    jr = _j_rules(mesh_name, info["mode"], info["batch"])
    want = j_shapes.input_specs(jcfg, shape, jr)
    rules = _p_rules(mesh_name, info["mode"], info["batch"])
    got = input_specs(cfg, shape, rules)
    assert set(got) == set(want)
    if "cache_index" in want:
        assert want.pop("cache_index")[:2] == ((), "int32")
        assert got.pop("cache_index") == info["seq"] - 1
    got_leaves, want_leaves = dict(_leaves(got)), dict(_j_leaves(want))
    assert set(got_leaves) == set(want_leaves)
    for path, t in got_leaves.items():
        w_shape, w_dtype, w_spec = want_leaves[path]
        assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == (w_shape, w_dtype), path
        assert tuple(t.placements) == rules.placements(w_spec), path
