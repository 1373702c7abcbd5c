"""Port parity, the kd-tree of the stream engine: the port's native build
(its own copy of the C++ builder, built with g++ into the port's _build/)
with its spatial leaf sort, records, window tables and SO tables against
the JAX package's build_kd_tree(tv, tri_block=4) on a 20k soup and a 20k
terrain; the node tables K3 reads against the JAX package's SMEM tables;
the strip prepass against the JAX package's _strip_masks on a 64x64
frame; tree_from_numpy; and the tree build's errors.

The tree, records and window tables must be array-equal (the same numpy
arithmetic); the SO tables agree within the tolerance of
tests/test_torch_windows.py::test_so_affine_tables_close (torch and XLA
round the cross products differently)."""

import numpy as np
import pytest
import torch

from clpathtracer_tpu.accel.sah import attach_so_tables as j_attach_so
from clpathtracer_tpu.accel.sah import build_kd_tree as j_build
from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.core.camera import cam_matrix as j_cam_matrix
from clpathtracer_tpu.core.camera import generate_rays as j_generate_rays
from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.scene.procedural import random_tri_soup, terrain_mesh
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import native, sah
from clpathtracer_tpu_torch.ops import packet as tpk

torch.set_num_threads(2)
CPU = torch.device("cpu")
SIZE = 64
FIELDS = ("node_table", "tri_indices", "node_min", "node_max", "is_leaf",
          "leaf_start", "leaf_count", "tris", "chunk_start", "chunk_bnd")


def _corners(scene):
    v0, v1, v2 = scene.tri_verts()
    return np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)


@pytest.fixture(scope="module")
def trees():
    """Both packages' trees of the two scenes (depth 10, leaf 512: fat
    leaves of several windows)."""
    out = {}
    for name, scene in (
            ("soup", random_tri_soup(20_000, seed=13, extent=10.0,
                                     tri_size=0.05)),
            ("terrain", terrain_mesh(20_000, seed=0, extent=10.0))):
        tv = _corners(scene)
        jt = j_attach_so(j_build(tv, max_depth=10, leaf_size=512,
                                 tri_block=4))
        pt = sah.attach_so_tables(sah.build_kd_tree(
            tv, max_depth=10, leaf_size=512, device=CPU))
        out[name] = (jt, pt)
    return out


@pytest.mark.parametrize("name", ["soup", "terrain"])
def test_native_tree_matches_jax(trees, name):
    jt, pt = trees[name]
    w = pt.num_windows
    jcb = np.asarray(jt.chunk_bnd).reshape(-1, 8)
    assert w > pt.stats()["leaves"]              # leaves of several windows
    np.testing.assert_array_equal(pt.node_table.numpy(),
                                  np.asarray(jt.node_table))
    np.testing.assert_array_equal(pt.tri_indices.numpy(),
                                  np.asarray(jt.tri_indices))
    np.testing.assert_array_equal(pt.tris.numpy(),
                                  np.asarray(jt.quads).reshape(-1, 16))
    np.testing.assert_array_equal(pt.chunk_start.numpy(),
                                  np.asarray(jt.chunk_start))
    np.testing.assert_array_equal(pt.chunk_bnd.numpy(), jcb[:w, :6])
    # the JAX table pads to rows of 16 windows with inverted boxes
    assert (jcb[w:, 0:3] == np.float32(3.4e38)).all()
    assert pt.max_leaf_tris == jt.max_leaf_tris
    for f, jf in (("is_leaf", "is_leaf"), ("leaf_start", "leaf_start"),
                  ("leaf_count", "leaf_count"), ("node_min", "node_min"),
                  ("node_max", "node_max")):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(jt, jf)))
    np.testing.assert_allclose(pt.so_base.numpy(),
                               np.asarray(jt.so_base).reshape(4, -1, 16),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["soup", "terrain"])
def test_stream_nodes_match_jax_tables(trees, name):
    """K3's node tables hold what the JAX package's SMEM tables pack:
    flags, children, a leaf's first record row, first window and window
    count, the root box and the split values."""
    jt, pt = trees[name]
    ni, nf = tpk.stream_nodes(pt)
    ji, jf = (np.asarray(x) for x in jpk._smem_nodes(jt))
    w0, w1 = ji[0::2], ji[1::2]
    ni = ni.numpy()
    leaf = (w0 & 7) >= 4
    np.testing.assert_array_equal(ni[:, 0], w0 & 7)
    np.testing.assert_array_equal(ni[leaf, 1], (w0[leaf] >> 3) // 2)
    np.testing.assert_array_equal(ni[~leaf, 1], w0[~leaf] >> 3)
    np.testing.assert_array_equal(ni[leaf, 2], w1[leaf] >> 6)
    np.testing.assert_array_equal(ni[leaf, 3], w1[leaf] & 63)
    np.testing.assert_array_equal(ni[~leaf, 2], w1[~leaf])
    np.testing.assert_array_equal(nf.numpy(), jf)
    # the windows of all leaves tile chunk_bnd
    assert ni[leaf, 3].sum() == pt.num_windows


@pytest.fixture(scope="module")
def frame():
    cam = JCamera.create(position=[0.0, 0.0, -25.0], forward=[0.0, 0.0, 1.0])
    return j_generate_rays(j_cam_matrix(cam, SIZE), SIZE, SIZE)


@pytest.mark.parametrize("tile", [256, 512])
def test_strip_masks_match_jax(trees, frame, tile):
    jt, pt = trees["soup"]
    orig, dirs = frame
    th, tw = tpk.tile_shape(tile)
    n_strips = tile // 128
    jd = jpk._blockify_strips(dirs, SIZE, SIZE, th, tw)
    jm, jten = (np.asarray(x) for x in jpk._strip_masks(
        jt.chunk_bnd, jd, orig[0], n_strips))
    w = pt.num_windows
    # JAX's [tiles, 8, Wc] rows hold window w at [w % 8, w // 8]
    jm = jm.transpose(0, 2, 1).reshape(jm.shape[0], -1)[:, :w]
    jten = jten.transpose(0, 2, 1).reshape(jten.shape[0], -1)[:, :w]
    td = tpk._blockify_strips(torch.as_tensor(np.array(dirs)), SIZE, SIZE,
                              th, tw)
    tm, tten = tpk._strip_masks(pt.chunk_bnd, td,
                                torch.as_tensor(np.array(orig[0])), n_strips)
    assert tm.shape == (SIZE * SIZE // tile, w) and tm.dtype == torch.int32
    assert 0 < (jm != 0).sum() < jm.size        # the prepass culls something
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tten.numpy(), jten)
    # the strip layout is a permutation that _unblockify_strips inverts
    back = tpk._unblockify_strips(td, SIZE, SIZE, th, tw)
    assert torch.equal(back, torch.as_tensor(np.array(dirs)))


def test_tree_from_numpy_round_trip(trees):
    jt, pt = trees["terrain"]
    rt = interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                 jt.chunk_start, jt.chunk_bnd, jt.so_base,
                                 jt.max_leaf_tris, device=CPU)
    for f in FIELDS:
        assert torch.equal(getattr(rt, f), getattr(pt, f)), f
    assert rt.max_leaf_tris == pt.max_leaf_tris
    np.testing.assert_array_equal(
        rt.so_base.numpy(), np.asarray(jt.so_base).reshape(4, -1, 16))


def test_morton10_and_leaf_sort():
    q = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1023] * 3],
                 np.uint32)
    np.testing.assert_array_equal(sah._morton10(q),
                                  [0, 1, 2, 4, (1 << 30) - 1])
    # one leaf of 300 slots (pads at its tail stay there), one of 4
    idx = np.concatenate([np.arange(298), [-1, -1], [298, 299, -1, -1]])
    cen = np.random.default_rng(0).uniform(0, 1, (300, 3))
    out = sah.sort_leaf_tris_spatial(
        idx, np.array([0, 300]), np.array([298, 2]), np.array([True, True]),
        np.zeros((2, 3)), np.ones((2, 3)), cen)
    assert sorted(out[:298]) == list(range(298))
    np.testing.assert_array_equal(out[298:], [-1, -1, 298, 299, -1, -1])


def test_tree_build_errors(monkeypatch, tmp_path):
    tv = np.zeros((4, 3, 3), np.float32)
    # tri_block 1 now builds with the Python builder; the native one
    # emits tri_block 4 only and raises for another
    tree = sah.build_kd_tree(tv, tri_block=1, device=CPU)
    assert tree.tri_block == 1 and tree.tris.shape == (4, 16)
    with pytest.raises(ValueError, match="tri_block"):
        sah.build_kd_tree(tv, tri_block=1, backend="native", device=CPU)
    with pytest.raises(ValueError, match="backend"):
        sah.build_kd_tree(tv, backend="numba", device=CPU)
    with pytest.raises(ValueError, match="tri_block"):
        native.build_kd_native(tv, 4, 1, tri_block=2)
    # no g++: the loader raises, it does not fall back
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native.load.cache_clear()
    try:
        with pytest.raises(native.NativeBuildError, match="g\\+\\+"):
            native.load()
    finally:
        native.load.cache_clear()
