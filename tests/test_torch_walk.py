"""Port parity, the per-ray rope walk (W1's plain version), the Python kd
builder and the shadow query: the port's traverse_fast, traverse, build
and _occluded against the JAX package's on the same trees (built by the
JAX package and carried over through interop), small scenes, plain XLA
walks on the JAX side (no Pallas kernel)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel import sah as jsah
from clpathtracer_tpu.ops import traverse as jtrav
from clpathtracer_tpu.ops import traverse_fast as jtf
from clpathtracer_tpu.render import integrator as jint
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import sah
from clpathtracer_tpu_torch.ops import intersect as tisx
from clpathtracer_tpu_torch.ops import traverse as ttrav
from clpathtracer_tpu_torch.ops import traverse_fast as ttf
from clpathtracer_tpu_torch.render import integrator as tint

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 4096
FORMS = ("nearest", "t_max", "any_hit", "active")


def _rays(tv, seed=0):
    """Random rays from above the terrain (a mix of downward and random
    directions), a quarter of them axis-aligned (origins off the grid's
    vertices), with the bounds and mask the walk's forms take."""
    rng = np.random.default_rng(seed)
    lo, hi = tv.min(axis=(0, 1)), tv.max(axis=(0, 1))
    o = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(hi[1], hi[1] + 3.0, N)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[: N // 2, 1] = -np.abs(d[: N // 2, 1]) - 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = N // 4
    d[:k] = 0.0
    d[: k // 2, 1] = -1.0                     # straight down
    d[k // 2: 3 * k // 4, 0] = 1.0            # along +x, -z
    d[3 * k // 4: k, 2] = -1.0
    o[k // 2: k, 1] = rng.uniform(lo[1], hi[1], k - k // 2)
    o += rng.uniform(-1e-3, 1e-3, o.shape).astype(np.float32)
    t_max = rng.uniform(0.5, 6.0, N).astype(np.float32)
    active = rng.uniform(size=N) < 0.7
    return o, d.astype(np.float32), t_max, active


@pytest.fixture(scope="module")
def terrain():
    js = jproc.terrain_mesh(20_000, seed=0, extent=10.0)
    tv = np.asarray(js.tri_corners())
    jt = jsah.build_kd_tree(tv, max_depth=11, leaf_size=64, tri_block=4)
    tt = interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                 jt.chunk_start, jt.chunk_bnd, None,
                                 jt.max_leaf_tris, device=CPU)
    return dict(js=js, tv=tv, jt=jt, tt=tt, rays=_rays(tv))


def _kw(form, t_max, active, lib):
    kw = {}
    if form in ("t_max", "any_hit"):
        kw["t_max"] = lib(t_max)
    if form == "any_hit":
        kw["any_hit"] = True
    if form == "active":
        kw["active"] = lib(active)
    return kw


def _same_record(rec, ref, tri_share=0.95, steps_share=0.99):
    """The walk's parity contract: hit masks equal, t allclose, tri equal
    on more than 95% of hits (exact-t ties are a documented freedom),
    steps equal on at least 99% of lanes."""
    rec = {k: v.numpy() for k, v in rec.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(rec["hit"], ref["hit"])
    h = ref["hit"]
    assert h.any()
    np.testing.assert_allclose(rec["t"][h], ref["t"][h], rtol=1e-5,
                               atol=1e-6)
    assert (rec["tri"][h] == ref["tri"][h]).mean() > tri_share
    if steps_share is not None:
        assert (rec["steps"] == ref["steps"]).mean() >= steps_share


@pytest.mark.parametrize("form", FORMS)
def test_traverse_fast_matches_jax(terrain, form):
    o, d, t_max, active = terrain["rays"]
    jt = terrain["jt"]
    ref = jtf.traverse_fast(jt, jt.quads, jnp.asarray(o), jnp.asarray(d),
                            compact=False, **_kw(form, t_max, active,
                                                 jnp.asarray))
    rec = ttf.traverse_fast(terrain["tt"], torch.as_tensor(o),
                            torch.as_tensor(d),
                            **_kw(form, t_max, active, torch.as_tensor))
    if form == "any_hit":       # the flags, and a hit's t below t_max
        np.testing.assert_array_equal(rec["hit"].numpy(),
                                      np.asarray(ref["hit"]))
        h = rec["hit"].numpy()
        assert h.any() and (rec["t"].numpy()[h] < t_max[h]).all()
        assert (rec["tri"].numpy()[h] == 0).all()
        assert (rec["steps"].numpy()
                == np.asarray(ref["steps"])).mean() >= 0.99
    else:
        _same_record(rec, ref)
    if form == "active":
        assert not rec["hit"].numpy()[~active].any()
        assert not rec["steps"].numpy()[~active].any()


def test_walk_matches_brute_force(terrain):
    """W1's plain version against W2's on the same rays: the nearest hit
    is the same, whatever the tree."""
    o, d, _, _ = terrain["rays"]
    o, d = torch.as_tensor(o[:1024]), torch.as_tensor(d[:1024])
    rec = ttf.traverse_fast(terrain["tt"], o, d)
    scene = interop.scene_from_numpy(
        terrain["js"].verts, terrain["js"].faces, terrain["js"].normals,
        terrain["js"].albedo, terrain["js"].emission, device=CPU)
    bf = tisx.nearest_hit_bruteforce(scene, o, d)
    assert torch.equal(rec["hit"], bf["hit"])
    assert torch.allclose(rec["t"][bf["hit"]], bf["t"][bf["hit"]], rtol=1e-6)


def test_ray_walk_rejects_bad_arguments(terrain):
    o = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="any_hit"):
        ttf.ray_walk(terrain["tt"], o, o, any_hit=True)
    with pytest.raises(ValueError, match="t_max"):
        ttf.ray_walk(terrain["tt"], o, o, t_max=torch.ones(7))
    with pytest.raises(ValueError, match="block"):
        ttf.ray_walk(terrain["tt"], o, o, block=0)
    with pytest.raises(ValueError, match="float32"):
        ttf.ray_walk(terrain["tt"], o.double(), o)


@pytest.fixture(scope="module")
def small_trees():
    """A 2k terrain's Python-built trees at tri_block 1 and 2, in both
    packages."""
    js = jproc.terrain_mesh(2_000, seed=1, extent=10.0)
    tv = np.asarray(js.tri_corners())
    out = {}
    for tb in (1, 2):
        jt = jsah.build_kd_tree(tv, max_depth=10, leaf_size=8, tri_block=tb,
                                backend="python")
        tt = interop.kd_tree_from_numpy(
            *(np.asarray(getattr(jt, f)) for f in (
                "node_min", "node_max", "is_leaf", "split_axis",
                "split_value", "child_lo", "child_hi", "leaf_start",
                "leaf_count", "ropes", "tri_indices")), tv, tb, device=CPU)
        out[tb] = (jt, tt)
    return js, tv, out


@pytest.mark.parametrize("tri_block", [1, 2])
def test_traverse_matches_jax(small_trees, tri_block):
    js, tv, trees = small_trees
    jt, tt = trees[tri_block]
    assert tt.tri_block == tri_block and jt.node_table is None
    o, d, _, _ = _rays(tv, seed=1)
    v0, v1, v2 = js.tri_verts()
    ref = jtrav.traverse(jt, jtrav.PackedTris.pack(jt, v0, v1, v2),
                         jnp.asarray(o), jnp.asarray(d), tri_block=tri_block)
    rec = ttrav.traverse(tt, torch.as_tensor(o), torch.as_tensor(d),
                         tri_block=tri_block)
    _same_record(rec, ref, steps_share=None)
    # the packet engines read tri_block 4 trees only
    with pytest.raises(ValueError, match="tri_block"):
        from clpathtracer_tpu_torch.ops.packet import traverse_packet
        traverse_packet(tt, torch.as_tensor(o), torch.as_tensor(d), tile=256)


BUILD_SCENES = {
    "cornell": (jproc.cornell_box, dict()),
    "icosphere": (lambda: jproc.icosphere(2), dict()),
    "soup": (lambda: jproc.random_tri_soup(2_000, seed=3, extent=10.0,
                                           tri_size=0.02),
             dict(max_depth=12, leaf_size=8)),
}


@pytest.mark.parametrize("tri_block", [1, 4])
@pytest.mark.parametrize("name", list(BUILD_SCENES))
def test_python_builder_matches_jax(name, tri_block):
    make, kw = BUILD_SCENES[name]
    tv = np.asarray(make().tri_corners())
    jt = jsah.build_kd_tree(tv, tri_block=tri_block, backend="python", **kw)
    arrays, tri_indices = sah.build_kd_arrays(tv, tri_block=tri_block, **kw)
    for f in ("node_min", "node_max", "is_leaf", "split_axis", "split_value",
              "child_lo", "child_hi", "leaf_start", "leaf_count", "ropes"):
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jt, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tri_indices, np.asarray(jt.tri_indices))
    tree = sah.build_kd_tree(tv, tri_block=tri_block, backend="python",
                             device=CPU, **kw)
    assert tree.tri_block == tri_block
    if tri_block == 4:       # the node table of the walk, as the JAX one
        np.testing.assert_array_equal(tree.node_table.numpy(),
                                      np.asarray(jt.node_table))
        np.testing.assert_array_equal(tree.tris.numpy(),
                                      np.asarray(jt.quads).reshape(-1, 16))
        assert tree.chunk_bnd is not None


@pytest.fixture(scope="module")
def shadow_pair():
    """The 20k terrain with its walk-tuned shadow tree in both packages
    (the JAX one attached, the port's carried over by interop)."""
    js = jproc.terrain_mesh(20_000, seed=2, extent=10.0)
    tv = np.asarray(js.tri_corners())
    jt = jsah.attach_shadow_tree(
        jsah.build_kd_tree(tv, max_depth=11, leaf_size=64, tri_block=4), tv)
    js_ = jt.shadow
    shadow = interop.tree_from_numpy(js_.node_table, js_.tri_indices,
                                     js_.quads, max_leaf_tris=js_.max_leaf_tris,
                                     device=CPU)
    scene = interop.scene_from_numpy(js.verts, js.faces, js.normals,
                                     js.albedo, js.emission, device=CPU)
    return dict(js=js, tv=tv, jt=jt, shadow=shadow, scene=scene)


def test_occluded_shadow_tree_matches_jax(shadow_pair):
    """The shadow query through the shadow tree: points above the terrain
    toward random targets, a quarter of the lanes dead; flags equal on at
    least 99.9% of the live lanes."""
    rng = np.random.default_rng(4)
    tv = shadow_pair["tv"]
    lo, hi = tv.min(axis=(0, 1)), tv.max(axis=(0, 1))
    a = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    a[:, 1] = hi[1] + 0.5
    b = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    b[:, 1] = rng.uniform(lo[1] - 1.0, hi[1], N)
    dist = np.linalg.norm(b - a, axis=1).astype(np.float32)
    d = ((b - a) / dist[:, None]).astype(np.float32)
    act = rng.uniform(size=N) < 0.75
    occ_j = np.asarray(jint._occluded(
        shadow_pair["js"], shadow_pair["jt"], jnp.asarray(a), jnp.asarray(d),
        jnp.asarray(dist), jint.RenderOptions(compact=False),
        active=jnp.asarray(act)))
    occ_t = tint._occluded(shadow_pair["scene"], torch.as_tensor(a),
                           torch.as_tensor(d), torch.as_tensor(dist),
                           tint.RenderOptions(), active=torch.as_tensor(act),
                           shadow=shadow_pair["shadow"]).numpy()
    assert (occ_t[act] == occ_j[act]).mean() >= 0.999
    assert occ_t[act].any() and not occ_t[act].all()
    assert not occ_t[~act].any()


def test_shadow_tree_build(shadow_pair):
    """build_shadow_tree is the JAX package's attach_shadow_tree build:
    the same node table and records."""
    tree = sah.build_shadow_tree(shadow_pair["tv"], device=CPU)
    js_ = shadow_pair["jt"].shadow
    np.testing.assert_array_equal(tree.node_table.numpy(),
                                  np.asarray(js_.node_table))
    np.testing.assert_array_equal(tree.tris.numpy(),
                                  np.asarray(js_.quads).reshape(-1, 16))
    assert tree.tri_block == 4 and tree.chunk_bnd is None
