"""The port's sharding rules (``repro_torch.launch.specs``/``sharding``)
against the reference's, leaf for leaf, on the production meshes.

The reference's rules run on a ``jax.sharding.AbstractMesh`` (no devices),
the port's on a ``MeshShape`` of the same axes (no process group). Every
registered config at full width and at smoke size, on (16, 16) and
(2, 16, 16): params (train and serve), the train state (f32 and int8
moments), the decode caches (decode and long rules, 16 and 4 bits), the
batch specs and ``decode_specs``.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import REGISTRY, SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import sharding as ref_shlib
from repro.launch import specs as ref_sp
from repro.models import build_model as ref_build_model
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro.training.train_step import (
    init_train_state_shapes as ref_init_train_state_shapes,
)
from repro_torch.configs import get_config, get_shape
from repro_torch.device import cap_test_threads
from repro_torch.launch import sharding as shlib
from repro_torch.launch import specs as sp
from repro_torch.models import build_model
from repro_torch.training import tree as tree_lib
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state_shapes

cap_test_threads()

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {ref_sp._path_str(path): tuple(s.spec) for path, s in leaves}


def _port_specs(tree) -> dict:
    return {sp._path_str(path): tuple(s.spec)
            for path, s in tree_lib.flatten_with_paths(tree)}


def _spec_tuple(spec, ndim):
    """A jax spec padded to the leaf's rank (jax may drop trailing Nones)."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _ref_specs_padded(tree, shapes) -> dict:
    sh = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    shp = jax.tree_util.tree_leaves(shapes)
    return {ref_sp._path_str(path): _spec_tuple(s.spec, len(x.shape))
            for (path, s), x in zip(sh, shp)}


def _port_specs_padded(tree, shapes) -> dict:
    return {sp._path_str(path): _spec_tuple(s.spec, len(x.shape))
            for (path, s), x in zip(tree_lib.flatten_with_paths(tree),
                                    tree_lib.leaves(shapes))}


CASES = [(name, smoke, mesh) for name in REGISTRY for smoke in (False, True)
         for mesh in MESHES]


@pytest.mark.parametrize("name,smoke,mesh_name", CASES)
def test_specs_match_reference(name, smoke, mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_mesh = AbstractMesh(shape, axes)
    mesh = shlib.MeshShape(axes, shape)
    ref_model = ref_build_model(ref_get_config(name, smoke=smoke))
    model = build_model(get_config(name, smoke=smoke))
    cfg = model.cfg

    ref_params = ref_model.init_shapes()
    params = model.init_shapes()
    for mode in ("train", "serve"):
        want = _ref_specs_padded(
            ref_sp.param_shardings(ref_params, ref_mesh, mode), ref_params)
        got = _port_specs_padded(sp.param_shardings(params, mesh, mode),
                                 params)
        assert got == want, (mode, {k: (got.get(k), want.get(k))
                                    for k in set(got) | set(want)
                                    if got.get(k) != want.get(k)})

    for int8 in (False, True):
        ref_state = ref_init_train_state_shapes(
            ref_model, RefAdamWConfig(int8_state=int8))
        state = init_train_state_shapes(model, AdamWConfig(int8_state=int8))
        want = _ref_specs_padded(
            ref_sp.train_state_shardings(ref_state, ref_mesh), ref_state)
        got = _port_specs_padded(sp.train_state_shardings(state, mesh),
                                 state)
        assert got == want, ("state", int8)

    for shp in SHAPES:
        ref_in = ref_sp.input_specs(ref_model.cfg, ref_model, shp, ref_mesh)
        port_in = sp.input_specs(cfg, model, get_shape(shp.name), mesh)
        if shp.kind != "decode":
            (want_specs,), (want_sh,) = ref_in
            (got_specs,), (got_sh,) = port_in
            assert list(got_specs) == list(want_specs)
            for k in want_specs:
                assert tuple(got_specs[k].shape) == want_specs[k].shape
                assert got_specs[k].dtype == getattr(
                    torch, str(want_specs[k].dtype))
                assert _spec_tuple(got_sh[k].spec, got_specs[k].ndim) == \
                    _spec_tuple(want_sh[k].spec, got_specs[k].ndim), k
        for bits in (16, 4):
            (rc, ri, rt), (rcs, ris, rts) = ref_sp.decode_specs(
                ref_model.cfg, ref_model, shp, ref_mesh, kv_bits=bits)
            (pc, pi, pt), (pcs, pis, pts) = sp.decode_specs(
                cfg, model, get_shape(shp.name), mesh, kv_bits=bits)
            assert _port_specs_padded(pcs, pc) == _ref_specs_padded(rcs, rc)
            assert {sp._path_str(p): tuple(x.shape) for p, x in
                    tree_lib.flatten_with_paths(pc)} == {
                ref_sp._path_str(p): tuple(x.shape) for p, x in
                jax.tree_util.tree_flatten_with_path(rc)[0]}
            assert tuple(pt.shape) == rt.shape and pt.dtype == torch.int32
            assert pi.shape == () and tuple(pis.spec) == tuple(ris.spec)
            assert _spec_tuple(pts.spec, 2) == _spec_tuple(rts.spec, 2)
        for long_ctx in (False, True):
            rc = jax.eval_shape(lambda: ref_model.init_cache(
                batch=4, capacity=64, kv_bits=16))
            pc = model.init_cache(batch=4, capacity=64, device="meta")
            assert _port_specs_padded(
                sp.cache_shardings(pc, mesh, long_ctx), pc) == \
                _ref_specs_padded(
                    ref_sp.cache_shardings(rc, ref_mesh, long_ctx), rc)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_guard_and_named_sharding_match_reference(mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_mesh = AbstractMesh(shape, axes)
    mesh = shlib.MeshShape(axes, shape)
    for dims, logical in (((7, 16), ("data", "model")),
                          ((32, 8), ("data", "model")),
                          ((16, 48, 3), ("data", "model", None)),
                          ((512, 1), ("data", None))):
        want = ref_sp.sharding(ref_mesh, dims, *logical).spec
        got = sp.sharding(mesh, dims, *logical).spec
        assert _spec_tuple(got, len(dims)) == _spec_tuple(want, len(dims))
    # (7, 16) on data: 7 does not divide, data is dropped
    assert sp.sharding(mesh, (7, 16), "data", None).spec == (None, None)
    for logical in (("data", None, "model"), ("seq", "model")):
        want = ref_shlib.named_sharding(ref_mesh, *logical).spec
        got = shlib.named_sharding(mesh, *logical).spec
        assert tuple(got) == tuple(want)


def test_constrain_is_identity_without_mesh_and_on_plain_tensors():
    x = torch.ones(4, 4)
    assert shlib.constrain(x, ("data", None)) is x
    rules = {"mesh": shlib.MeshShape(("data", "model"), (2, 2)),
             "map": {"data": "data", "model": "model"}}
    shlib._state.rules = rules
    try:
        assert shlib.constrain(x, ("data", "model")) is x
    finally:
        shlib._state.rules = None


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = shlib.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert shlib.placements(mesh, shlib.P(("pod", "data"), None, "model")) \
        == (Shard(0), Shard(0), Shard(2))
    assert shlib.placements(mesh, shlib.P(None, "model")) == \
        (Replicate(), Replicate(), Shard(1))
