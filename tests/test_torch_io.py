"""Port parity, model I/O: the port's OBJ/MTL parser and its native
scanner, PNG encoder, the reference `.kd` reader and writer, the scene
caches (its own `.torch.kd.npz` and the JAX package's `.kd.npz`),
merge_scenes and load_models against the JAX package's on the same inputs.
The JAX side is numpy and host builds only (no frame, no Pallas call)."""

import os

import numpy as np
import pytest
import torch

from clpathtracer_tpu.accel import sah as jsah
from clpathtracer_tpu.scene import cache as jcache
from clpathtracer_tpu.scene import kdformat as jkd
from clpathtracer_tpu.scene import objparser as jobj
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu.utils import png as jpng
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import sah
from clpathtracer_tpu_torch.scene import cache, kdformat, native, objparser
from clpathtracer_tpu_torch.scene.scene import Scene
from clpathtracer_tpu_torch.utils import png

torch.set_num_threads(2)
CPU = torch.device("cpu")

CUBE_OBJ = """\
# unit cube
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
f 1 2 3 4
f 8 7 6 5
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f 5 1 4 8
"""
# tests/test_core.py's scanner fixture: every face form, an n-gon, negative
# indices, usemtl runs, a two-file mtllib, skipped o/g/s records
FORMS_OBJ = """
# comment
v 0 0 0
v 1.5 -2e-1 3.25
v 0 1 0
v 1 1 1
vn 0 0 1
vn 0 1 0
vt 0.5 0.5
vt 0.25 0.75
usemtl red
f 1 2 3
f 1/1 2/2 3/1
f 1//2 2//1 3//2
usemtl green
f 1/1/1 2/2/2 3/1/1 4/2/2
f -4 -3 -2
mtllib scene.mtl other.mtl
o object1
g group
s off
"""
MTL_OBJ = ("mtllib m.mtl\n"
           "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
           "usemtl red\nf 1 2 3\n"
           "usemtl lamp\nf 2 4 3\n")
MTL = ("newmtl red\nKd 0.8 0.1 0.1\n"
       "newmtl lamp\nKd 0.0 0.0 0.0\nKe 5.0 5.0 5.0\n")
MISSING_MTL_OBJ = "mtllib missing.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
TEXTS = {"cube": CUBE_OBJ, "forms": FORMS_OBJ, "mtl": MTL_OBJ,
         "missing_mtl": MISSING_MTL_OBJ}
MALFORMED = {
    "short_vertex": "v 0 0\n",
    "short_normal": "v 0 0 0\nvn 0 1\n",
    "short_texcoord": "vt 0\n",
    "two_corners": "v 0 0 0\nv 1 0 0\nf 1 2\n",
    "index_zero": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 0 1 2\n",
    "vertex_range": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 4\n",
    "normal_range": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//2\n",
}
GEO = ("verts", "normals", "texcoords", "faces")
ALL = GEO + ("albedo", "emission")


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _mtl_loader(name):
    if name == "m.mtl":
        return MTL
    raise OSError(name)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_obj_matches_jax(name):
    got = objparser.parse_obj(TEXTS[name], mtl_loader=_mtl_loader)
    ref = jobj.parse_obj(TEXTS[name], mtl_loader=_mtl_loader)
    for k in ALL:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_parse_errors_match_jax(tmp_path, name):
    """The Python parser's messages are the contract, on the parser and
    through load_obj's native scanner (which hands malformed input to
    it)."""
    with pytest.raises(jobj.ObjParseError) as ref:
        jobj.parse_obj(MALFORMED[name])
    with pytest.raises(objparser.ObjParseError) as got:
        objparser.parse_obj(MALFORMED[name])
    assert str(got.value) == str(ref.value)
    path = _write(tmp_path, "bad.obj", MALFORMED[name])
    with pytest.raises(objparser.ObjParseError) as via_load:
        objparser.load_obj(path)
    assert str(via_load.value) == str(ref.value)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_native_matches_python(name):
    py = objparser.parse_obj(TEXTS[name])
    geo, tri_mat, mats, libs = native.parse_obj_native(TEXTS[name])
    for k in GEO:
        assert geo[k].dtype == py[k].dtype, k
        np.testing.assert_array_equal(geo[k], py[k], err_msg=k)
    if name == "forms":
        assert mats == ["red", "green"]
        assert libs == ["scene.mtl", "other.mtl"]
        assert tri_mat.tolist() == [0, 0, 0, 1, 1, 1]


@pytest.mark.parametrize("name", ["mtl", "missing_mtl", "forms"])
def test_load_obj_matches_jax(tmp_path, name):
    (tmp_path / "m.mtl").write_text(MTL)
    path = _write(tmp_path, f"{name}.obj", TEXTS[name])
    ref = jobj.load_obj(path)
    for native_ in (True, False):
        got = objparser.load_obj(path, native=native_)
        for k in ALL:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    scene = Scene.from_obj(path, device=CPU)
    np.testing.assert_array_equal(scene.albedo.numpy(), ref["albedo"])
    np.testing.assert_array_equal(scene.emission.numpy(), ref["emission"])


def test_failing_gxx_raises(tmp_path, monkeypatch):
    """No g++ on PATH and an empty build directory: the scanner's build
    raises NativeBuildError, and load_obj does not fall back."""
    path = _write(tmp_path, "cube.obj", CUBE_OBJ)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(native.NativeBuildError, match="g\\+\\+"):
        objparser.load_obj(path)
    with pytest.raises(native.NativeBuildError):
        native.parse_obj_native(CUBE_OBJ)
    assert objparser.load_obj(path, native=False)["faces"].shape == (12, 3,
                                                                     3)


@pytest.mark.parametrize("kind", ["float_rgb", "uint8_rgba", "gray"])
def test_png_matches_jax(kind):
    rng = np.random.default_rng(0)
    if kind == "float_rgb":
        img = rng.uniform(-0.2, 1.2, (7, 5, 3)).astype(np.float32)
    elif kind == "uint8_rgba":
        img = rng.integers(0, 256, (4, 6, 4), dtype=np.uint8)
    else:
        img = rng.uniform(0, 1, (3, 9)).astype(np.float32)
    assert png.encode_png(img) == jpng.encode_png(img)
    hdr = rng.uniform(0, 20, (6, 4, 3)).astype(np.float32)
    for kw in ({}, {"exposure": 2.0, "gamma": 1.0}):
        np.testing.assert_array_equal(png.tonemap(hdr, **kw),
                                      jpng.tonemap(hdr, **kw))


@pytest.fixture(scope="module")
def ico_kd(tmp_path_factory):
    """icosphere(2)'s compact (tri_block 1) tree from the JAX package's
    Python builder, and the JAX package's `.kd` file of it."""
    d = tmp_path_factory.mktemp("kd")
    js = jproc.icosphere(2)
    jt = jsah.build_kd_tree(np.asarray(js.tri_corners()), tri_block=1)
    path = str(d / "ico.obj.kd")
    jkd.save_reference_kd(path, js, jt)
    return dict(js=js, jt=jt, path=path, dir=d)


def _jax_columns(jt):
    return {f: np.asarray(getattr(jt, f)) for f in (
        "node_min", "node_max", "is_leaf", "split_axis", "split_value",
        "child_lo", "child_hi", "leaf_start", "leaf_count", "ropes",
        "tri_indices")}


def test_reference_kd_loads_as_jax(ico_kd):
    assert kdformat._NODE_DTYPE.itemsize == 68   # include/kd_tree.h pack(1)
    js, jt = ico_kd["js"], ico_kd["jt"]
    scene, tree = kdformat.load_reference_kd(ico_kd["path"], device=CPU)
    js2, jt2 = jkd.load_reference_kd(ico_kd["path"])
    for f in ("verts", "faces", "normals"):
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(js2, f)), f)
    want = interop.kd_tree_from_numpy(**_jax_columns(jt2),
                                      tri_verts=np.asarray(js.tri_corners()),
                                      tri_block=1, device=CPU)
    assert tree.tri_block == 1
    for f in ("node_table", "tri_indices", "node_min", "node_max", "is_leaf",
              "leaf_start", "leaf_count", "tris"):
        np.testing.assert_array_equal(getattr(tree, f).numpy(),
                                      getattr(want, f).numpy(), f)
    assert tree.max_leaf_tris == jt2.max_leaf_tris


def test_reference_kd_writer_bytes_match_jax(ico_kd):
    """The port's writer, on the JAX tree carried over and on its own
    Python build of the same triangles, writes the JAX writer's bytes."""
    js, jt, d = ico_kd["js"], ico_kd["jt"], ico_kd["dir"]
    ref = open(ico_kd["path"], "rb").read()
    scene = interop.scene_from_numpy(
        js.verts, js.faces, js.normals, js.albedo, js.emission, device=CPU)
    carried = interop.kd_tree_from_numpy(
        **_jax_columns(jt), tri_verts=np.asarray(js.tri_corners()),
        tri_block=1, device=CPU)
    own = sah.build_kd_tree(scene.tri_corners(), tri_block=1, device=CPU)
    for name, tree in (("carried", carried), ("own", own)):
        p = str(d / f"{name}.kd")
        kdformat.save_reference_kd(p, scene, tree)
        assert open(p, "rb").read() == ref, name
    padded = sah.build_kd_tree(scene.tri_corners(), tri_block=4,
                               backend="python", device=CPU)
    with pytest.raises(ValueError, match="tri_block=1"):
        kdformat.save_reference_kd(str(d / "padded.kd"), scene, padded)


def test_load_model_dispatches_kd(ico_kd):
    s, t = cache.load_model(ico_kd["path"], device=CPU)
    js, jt = jcache.load_model(ico_kd["path"])
    np.testing.assert_array_equal(s.verts.numpy(), np.asarray(js.verts))
    np.testing.assert_array_equal(s.shade_rows.numpy(),
                                  np.asarray(js.shade_rows))
    np.testing.assert_array_equal(t.node_table.numpy(),
                                  np.asarray(jt.node_table))
    np.testing.assert_array_equal(t.tri_indices.numpy(),
                                  np.asarray(jt.tri_indices))


@pytest.fixture(scope="module")
def box():
    """The JAX Cornell box and its tri_block 4 tree (native builder) with
    the port's copies through interop."""
    js = jproc.cornell_box().bake_shading()
    jt = jsah.build_kd_tree(np.asarray(js.tri_corners()), tri_block=4)
    scene = interop.scene_from_numpy(
        js.verts, js.faces, js.normals, js.albedo, js.emission,
        shade_rows=js.shade_rows, device=CPU)
    tree = interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                   jt.chunk_start, jt.chunk_bnd, None,
                                   jt.max_leaf_tris, device=CPU)
    return dict(js=js, jt=jt, scene=scene, tree=tree)


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x.numpy(), y.numpy(), f)
        else:
            assert x == y, f


TREE_FIELDS = ("node_table", "tri_indices", "node_min", "node_max", "is_leaf",
               "leaf_start", "leaf_count", "tris", "chunk_start", "chunk_bnd",
               "so_base", "wide_table", "max_leaf_tris", "tri_block")
SCENE_FIELDS = ("verts", "faces", "normals", "albedo", "emission",
                "sphere_pos", "sphere_radius", "sphere_albedo",
                "sphere_emission", "shade_rows")


def test_jax_cache_loads(box, tmp_path):
    """A `.kd.npz` that the JAX package wrote loads into interop's
    conversion of the JAX scene and tree."""
    p = str(tmp_path / "box.kd.npz")
    jcache.save_scene_cache(p, box["js"], box["jt"],
                            build_params={"tri_block": 4})
    scene, tree = cache.load_scene_cache(p, device=CPU)
    _same(scene, box["scene"], SCENE_FIELDS)
    _same(tree, box["tree"], TREE_FIELDS)
    # a tri_block 1 JAX tree: its columns through kd_tree_from_numpy
    jt1 = jsah.build_kd_tree(np.asarray(box["js"].tri_corners()), tri_block=1)
    p1 = str(tmp_path / "box1.kd.npz")
    jcache.save_scene_cache(p1, box["js"], jt1, build_params={"tri_block": 1})
    _, tree1 = cache.load_scene_cache(p1, device=CPU)
    want = interop.kd_tree_from_numpy(
        **_jax_columns(jt1), tri_verts=box["scene"].tri_corners(),
        tri_block=1, device=CPU)
    _same(tree1, want, TREE_FIELDS)


def test_own_cache_round_trips(box, tmp_path):
    tree = sah.build_kd_tree(box["scene"].tri_corners(), leaf_size=8,
                             device=CPU)
    scene = box["scene"].replace(sphere_pos=torch.ones(1, 3),
                                 sphere_radius=torch.ones(1),
                                 sphere_albedo=torch.ones(1, 3),
                                 sphere_emission=torch.zeros(1, 3))
    assert tree.wide_table is not None and tree.chunk_bnd is not None
    p = str(tmp_path / "box.torch.kd.npz")
    cache.save_scene_cache(p, scene, tree, build_params={"leaf_size": 8})
    scene2, tree2 = cache.load_scene_cache(p, device=CPU)
    _same(scene2, scene, SCENE_FIELDS)
    _same(tree2, tree, TREE_FIELDS)
    assert cache.cache_build_params(p) == {"leaf_size": "8"}


def test_load_model_caches_and_invalidates(tmp_path):
    """An OBJ builds and writes <model>.torch.kd.npz (never the JAX
    package's <model>.kd.npz); a second load hits it; a changed leaf size
    builds again; the JAX cache of the same OBJ loads as the JAX tree."""
    from clpathtracer_tpu_torch.utils.profiling import StageTimer
    path = _write(tmp_path, "cube.obj", CUBE_OBJ)
    t1 = StageTimer()
    s1, tr1 = cache.load_model(path, device=CPU, timer=t1)
    assert sorted(os.listdir(tmp_path)) == ["cube.obj", "cube.torch.kd.npz"]
    assert {"parse", "kd build", "cache write"} <= set(t1.times)
    t2 = StageTimer()
    s2, tr2 = cache.load_model(path, device=CPU, timer=t2)
    assert set(t2.times) == {"cache load"}
    _same(s2, s1, SCENE_FIELDS)
    _same(tr2, tr1, TREE_FIELDS)
    t3 = StageTimer()
    _, tr3 = cache.load_model(path, leaf_size=1, device=CPU, timer=t3)
    assert "kd build" in t3.times
    assert cache.cache_build_params(
        str(tmp_path / "cube.torch.kd.npz"))["leaf_size"] == "1"
    assert not os.path.exists(tmp_path / "cube.kd.npz")
    js, jt = jcache.load_model(path, leaf_size=1)      # writes cube.kd.npz
    s4, tr4 = cache.load_model(str(tmp_path / "cube.kd.npz"), device=CPU)
    np.testing.assert_array_equal(s4.shade_rows.numpy(),
                                  np.asarray(js.shade_rows))
    np.testing.assert_array_equal(tr4.node_table.numpy(),
                                  tr3.node_table.numpy())
    np.testing.assert_array_equal(tr4.tris.numpy(), tr3.tris.numpy())


def test_merge_scenes_matches_jax():
    ja = jproc.cornell_box(light=False)
    jb = jproc.icosphere(1, radius=0.3, center=(0.0, 0.0, 1.0))
    jm = jcache.merge_scenes([ja, jb])
    parts = [interop.scene_from_numpy(s.verts, s.faces, s.normals, s.albedo,
                                      s.emission, device=CPU)
             for s in (ja, jb)]
    merged = cache.merge_scenes(parts)
    for f in SCENE_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(merged, f).numpy(),
                                      np.asarray(getattr(jm, f)), f)
    assert merged.shade_rows is None and jm.shade_rows is None
    assert cache.merge_scenes(parts[:1]) is parts[0]


def test_load_models_matches_jax(tmp_path):
    """The skip of a bad model, and the tree load_models returns: built
    again from the scene at depth 15, leaf 1, whatever --max-depth and
    --leaf-size say (the JAX package's choice, kept)."""
    good = _write(tmp_path, "cube.obj", CUBE_OBJ)
    (tmp_path / "m.mtl").write_text(MTL)
    lamp = _write(tmp_path, "lamp.obj", MTL_OBJ)
    bad = str(tmp_path / "missing.obj")
    kw = dict(max_depth=5, leaf_size=2, use_cache=False)
    js, jt, jskip = jcache.load_models([good, bad, lamp], **kw)
    s, t, skip = cache.load_models([good, bad, lamp], device=CPU, **kw)
    assert skip == jskip == [bad]
    for f in ("verts", "faces", "albedo", "emission"):
        np.testing.assert_array_equal(getattr(s, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    want = sah.build_kd_tree(s.tri_corners(), max_depth=sah.DEFAULT_DEPTH,
                             leaf_size=1, device=CPU)
    _same(t, want, TREE_FIELDS)
    np.testing.assert_array_equal(t.node_table.numpy(),
                                  np.asarray(jt.node_table))
    np.testing.assert_array_equal(t.tri_indices.numpy(),
                                  np.asarray(jt.tri_indices))
    with pytest.raises(ValueError, match="no loadable models"):
        cache.load_models([bad], device=CPU)


def test_unknown_extension_raises(tmp_path):
    bad = _write(tmp_path, "model.stl", "solid x")
    with pytest.raises(ValueError, match="supported") as ref:
        jcache.load_model(bad)
    with pytest.raises(ValueError, match="supported") as got:
        cache.load_model(bad, device=CPU)
    assert str(got.value).startswith(str(ref.value).split(".kd.npz")[0])
