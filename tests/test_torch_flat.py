"""Port parity, the routes that W1 and W2 carry: the flat scan's brute
force (W2's plain version) with spheres, and render_image against the JAX
package's on its default wavefront route (the rope walk), the flat scan,
scenes with spheres and a tri_block 1 tree, at 64x64 and 60x50; a NEE
path frame through the shadow tree against the JAX package's and against
the port's grid route, on the same draws. Small scenes; the JAX side runs
plain XLA (no Pallas kernel)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clpathtracer_tpu.accel import sah as jsah
from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.ops import intersect as jisx
from clpathtracer_tpu.render import integrator as jint
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu.scene.scene import Scene as JScene
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import sah
from clpathtracer_tpu_torch.accel.grid import build_grid
from clpathtracer_tpu_torch.core.camera import (Camera, cam_matrix,
                                                generate_rays)
from clpathtracer_tpu_torch.ops import intersect as tisx
from clpathtracer_tpu_torch.render import integrator as tint

torch.set_num_threads(2)
CPU = torch.device("cpu")
TERRAIN_CAM = ([0.0, 14.0, 0.0], [0.0, -1.0, 0.01])
BOX_CAM = ([0.0, 0.0, -1.5], [0.0, 0.0, 1.0])
SPHERES = dict(sphere_pos=[[-0.6, -0.5, 1.2], [0.6, 0.4, 0.9],
                           [0.0, 0.0, 1.0]],
               sphere_radius=[0.3, 0.25, 0.45],
               sphere_albedo=[[0.9, 0.2, 0.2], [0.2, 0.9, 0.2],
                              [0.5, 0.5, 0.9]],
               sphere_emission=[[0.0, 0.0, 0.0], [2.0, 2.0, 2.0],
                                [0.0, 0.0, 0.0]])


def _port_scene(js):
    return interop.scene_from_numpy(
        js.verts, js.faces, js.normals, js.albedo, js.emission,
        sphere_pos=js.sphere_pos, sphere_radius=js.sphere_radius,
        sphere_albedo=js.sphere_albedo, sphere_emission=js.sphere_emission,
        device=CPU)


def _port_tree(jt):
    return interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                   jt.chunk_start, jt.chunk_bnd, None,
                                   jt.max_leaf_tris, device=CPU)


def _spheres_scene():
    """icosphere(2) behind three spheres, one of them emissive and one
    around the mesh's centre (the mesh shows where the spheres leave it
    out)."""
    ico = jproc.icosphere(2, radius=0.8, center=(0.0, 0.0, 1.6))
    return JScene.create(ico.verts, ico.faces, ico.normals, **SPHERES)


@pytest.fixture(scope="module")
def scenes():
    terrain = jproc.terrain_mesh(20_000, seed=0, extent=10.0)
    tv = np.asarray(terrain.tri_corners())
    jt = jsah.build_kd_tree(tv, max_depth=11, leaf_size=64, tri_block=4)
    sph = _spheres_scene()
    sv = np.asarray(sph.tri_corners())
    sjt = jsah.build_kd_tree(sv, max_depth=10, leaf_size=16, tri_block=4)
    jt1 = jsah.build_kd_tree(tv, max_depth=11, leaf_size=64, tri_block=1,
                             backend="python")
    tt1 = interop.kd_tree_from_numpy(
        *(np.asarray(getattr(jt1, f)) for f in (
            "node_min", "node_max", "is_leaf", "split_axis", "split_value",
            "child_lo", "child_hi", "leaf_start", "leaf_count", "ropes",
            "tri_indices")), tv, 1, device=CPU)
    box = jproc.cornell_box()
    return {
        # name: (JAX scene, JAX tree, port scene, port tree, camera)
        "terrain": (terrain, jt, _port_scene(terrain), _port_tree(jt),
                    TERRAIN_CAM),
        "terrain_tb1": (terrain, jt1, _port_scene(terrain), tt1,
                        TERRAIN_CAM),
        "box_flat": (box, None, _port_scene(box), None, BOX_CAM),
        "spheres_flat": (sph, None, _port_scene(sph), None, BOX_CAM),
        "spheres_kd": (sph, sjt, _port_scene(sph), _port_tree(sjt),
                       BOX_CAM),
    }


def test_brute_force_matches_jax(scenes):
    """nearest_hit_bruteforce_reference with spheres against the JAX
    package's: hit equal, t rtol 1e-5, prim equal on more than 95% of
    hits; nearest_hit_bruteforce runs the same on the CPU."""
    js, _, ts, _, (pos, fwd) = scenes["spheres_flat"]
    rng = np.random.default_rng(0)
    o = np.tile(np.asarray(pos, np.float32), (2048, 1))
    d = rng.normal(size=(2048, 3)).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = jisx.nearest_hit_bruteforce(js, jnp.asarray(o), jnp.asarray(d))
    rec = tisx.nearest_hit_bruteforce_reference(ts, torch.as_tensor(o),
                                                torch.as_tensor(d))
    hit = np.asarray(ref["hit"])
    np.testing.assert_array_equal(rec["hit"].numpy(), hit)
    np.testing.assert_allclose(rec["t"].numpy()[hit],
                               np.asarray(ref["t"])[hit], rtol=1e-5)
    prim = rec["prim_id"].numpy()
    assert (prim[hit] == np.asarray(ref["prim_id"])[hit]).mean() > 0.95
    assert (prim[hit] >= ts.num_tris).any() and (prim[hit] < ts.num_tris).any()
    again = tisx.nearest_hit_bruteforce(ts, torch.as_tensor(o),
                                        torch.as_tensor(d))
    for k in rec:
        assert torch.equal(again[k], rec[k]), k


def test_brute_force_tie_and_eps():
    """W2's plain version: on equal t the last record wins (the JAX
    package's last argmin); t_min_eps drops hits at or below it."""
    # (v0, e1, e2, id): unit right triangles facing -z at z = 1, 1, 3
    rec = torch.tensor([[0, 0, 1, 0, 1, 0, 1, 0, 0, 0] + [0] * 6,
                        [0, 0, 1, 0, 1, 0, 1, 0, 0, 1] + [0] * 6,
                        [0, 0, 3, 0, 1, 0, 1, 0, 0, 2] + [0] * 6],
                       dtype=torch.float32)
    o = torch.tensor([[0.2, 0.2, 0.0]] * 2)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    hit, t, prim, u, v = tisx.brute_force_reference(rec, o, d, chunk=2)
    assert hit.tolist() == [True, False]
    assert prim.tolist() == [1, -1] and t[0] == 1.0 and t[1] == tisx.BIG
    hit, t, prim, _, _ = tisx.brute_force_reference(rec, o, d, 1.5)
    assert prim.tolist() == [2, -1] and t[0] == 3.0


CASES = [("terrain", "normal", 64, 64), ("terrain", "normal", 60, 50),
         ("terrain", "mirror", 64, 64), ("terrain", "mirror", 60, 50),
         ("box_flat", "normal", 64, 64), ("box_flat", "mirror", 60, 50),
         ("spheres_flat", "normal", 64, 64), ("spheres_kd", "mirror", 64, 64),
         ("terrain_tb1", "normal", 64, 64)]


@pytest.mark.parametrize("name,mode,w,h", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}x{c[3]}" for c in CASES])
def test_render_image_matches_jax(scenes, name, mode, w, h):
    js, jt, ts, tt, (pos, fwd) = scenes[name]
    tb = 1 if name == "terrain_tb1" else 4
    jopts = jint.RenderOptions(width=w, height=h, mode=mode, tri_block=tb,
                               compact=False)
    # the port's walk takes its block from the tree (tt.tri_block)
    assert tt is None or tt.tri_block == tb
    ref = np.asarray(jint.render_image(
        js, JCamera.create(position=pos, forward=fwd), jopts, tree=jt))
    img = tint.render_image(ts, Camera.create(pos, fwd, device=CPU),
                            tint.RenderOptions(width=w, height=h, mode=mode),
                            tree=tt).numpy()
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    # the same hits give the same image up to exact-t tie winners at
    # shared mesh edges (the tie budget of tests/test_torch_render.py)
    differ = (np.abs(img - ref).max(axis=-1) > 1e-5).mean()
    assert differ < 1.5e-2, differ
    assert (img < 1.0).any()


def test_render_use_tree_false_is_flat(scenes):
    """The JAX package's use_tree=False is the port's call with no
    structure: the flat scan, each pixel the shade of the oracle's record
    (nearest_hit_bruteforce, spheres merged); bad options raise."""
    js, _, ts, tt, (pos, fwd) = scenes["spheres_kd"]
    cam = Camera.create(pos, fwd, device=CPU)
    opts = tint.RenderOptions(width=32, height=32)
    flat = tint.render_image(ts, cam, opts)
    jref = np.asarray(jint.render_image(
        js, JCamera.create(position=pos, forward=fwd),
        jint.RenderOptions(width=32, height=32, use_tree=False),
        tree=scenes["spheres_kd"][1]))
    differ = (np.abs(flat.numpy() - jref).max(axis=-1) > 1e-5).mean()
    assert differ < 1.5e-2, differ
    o, d = generate_rays(cam_matrix(cam, 32), 32, 32)
    ref = tisx.nearest_hit_bruteforce(ts, o, d)
    rec = tint.intersect_scene(ts, None, o, d, opts)
    prim = torch.where(rec["sphere"] >= 0, ts.num_tris + rec["sphere"],
                       rec["tri"])
    assert torch.equal(prim, ref["prim_id"])
    for k in ("hit", "t", "u", "v"):
        assert torch.equal(rec[k], ref[k]), k
    hits = prim[rec["hit"]]
    assert (hits >= ts.num_tris).any() and (hits < ts.num_tris).any()
    with pytest.raises(ValueError, match="intersector"):
        tint.render_image(ts, cam, tint.RenderOptions(
            width=32, height=32, intersector="queue"), tree=tt)
    with pytest.raises(ValueError, match="f32"):
        tint.render_image(ts, cam, tint.RenderOptions(
            width=32, height=32, precision="bf16"), tree=tt)


def _light_draws(key, m):
    kf, kb = jax.random.split(key)
    return np.concatenate([np.asarray(jax.random.uniform(kf, (m,)))[:, None],
                           np.asarray(jax.random.uniform(kb, (m, 2)))],
                          axis=1)


def _jax_nee_draws(bounces, n):
    """The draws of JAX's render_image (path, NEE, spp 1) from
    PRNGKey(0): per bounce (key, kl) = split(key), the light uniforms
    from kl, (key, sub) = split(key), the bounce uniforms from sub."""
    ks = jax.random.PRNGKey(0)
    b_draws, l_draws = [], []
    for _ in range(bounces):
        ks, kl = jax.random.split(ks)
        l_draws.append(_light_draws(kl, n))
        ks, sub = jax.random.split(ks)
        b_draws.append(np.asarray(jax.random.uniform(sub, (n, 2))))
    return (torch.as_tensor(np.stack(b_draws))[None],
            torch.as_tensor(np.stack(l_draws))[None])


def test_nee_shadow_tree_frame(scenes):
    """A NEE path frame on cornell_box(light=True) with the shadow tree
    (bounce and shadow waves through W1): against the JAX package's with
    tree.shadow, and against the port's grid route, on the same draws,
    within the NEE image budgets of tests/test_torch_nee.py."""
    js = jproc.cornell_box()
    tv = np.asarray(js.tri_corners())
    jt = jsah.attach_shadow_tree(
        jsah.build_kd_tree(tv, max_depth=12, leaf_size=4, tri_block=4), tv)
    jopts = jint.RenderOptions(width=64, height=64, mode="path", bounces=2,
                               nee=True, background=0.0, compact=False)
    pos, fwd = BOX_CAM
    ref = np.asarray(jint.render_image(
        js, JCamera.create(position=pos, forward=fwd), jopts, tree=jt))
    ts = _port_scene(js)
    tree = sah.build_kd_tree(ts.tri_corners(), max_depth=12, leaf_size=4,
                             device=CPU)
    shadow = sah.build_shadow_tree(ts.tri_corners(), device=CPU)
    bounce, light = _jax_nee_draws(2, 64 * 64)
    opts = tint.RenderOptions(width=64, height=64, mode="path", bounces=2,
                              nee=True, background=0.0)
    cam = Camera.create(pos, fwd, device=CPU)
    img = tint.render_image(ts, cam, opts, tree=tree, shadow=shadow,
                            bounce=bounce, light=light).numpy()
    grid = tint.render_image(ts, cam, opts, tree=tree,
                             grid=build_grid(ts.tri_corners(), device=CPU),
                             bounce=bounce, light=light).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0
    for other in (ref, grid):
        differ = (np.abs(img - other).max(axis=-1) > 1e-4).mean()
        mad = np.abs(img - other).mean()
        assert differ <= 2e-2, differ
        assert mad <= 2e-3, mad
