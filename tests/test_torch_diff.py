"""Port parity, differentiable rendering and the inverse-rendering train
step: the port's gradients (camera position, vertices, normals-as-color
and path shading with NEE, the edge-aware estimator, intersect_diff's
vector-Jacobian product, three SGD steps of make_train_step) against
jax.grad / jax.vjp of the JAX package on the same inputs and draws, on
the flat scan and on kd-trees carried over from the JAX build (the rope
walk W1's plain version). No JAX Pallas call: the port's packet (K3) and
grid (G1) routes are held to its own rope-walk gradients, and its
gradients to its own fd_grad. Tolerances: rtol 1e-4, atol 1e-6 against
JAX; rtol 0.05, atol 2e-4 against finite differences (tests/test_grad.py's);
hit and tri exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clpathtracer_tpu.accel import sah as jsah
from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.diff import grad as jgrad
from clpathtracer_tpu.render import integrator as jint
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu.scene.scene import Scene as JScene
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import sah
from clpathtracer_tpu_torch.accel.grid import build_grid
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.diff.checkpoint import (restore_train_state,
                                                    save_train_state)
from clpathtracer_tpu_torch.diff.edges import render_edgeaware
from clpathtracer_tpu_torch.diff.fd import fd_grad
from clpathtracer_tpu_torch.diff.grad import intersect_diff
from clpathtracer_tpu_torch.ops import intersect as tisx
from clpathtracer_tpu_torch.ops import traverse_fast as ttf
from clpathtracer_tpu_torch.parallel.train import make_train_step
from clpathtracer_tpu_torch.parallel.treelet import build_sharded_tree
from clpathtracer_tpu_torch.render import integrator as tint
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      render_image)
from torch_jax_draws import jax_nee_draws, light_draws

torch.set_num_threads(2)
CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-6
FD_RTOL, FD_ATOL = 0.05, 2e-4
FWD = [0.0, 0.0, 1.0]
EDGE_POS = [0.011, 0.007, -1.0]   # off the occluder fixture's symmetry


def _port_scene(js):
    return interop.scene_from_numpy(js.verts, js.faces, js.normals,
                                    js.albedo, js.emission, device=CPU)


def _trees(js):
    """The JAX kd-tree (tri_block 4, tests/test_grad.py's _tree_for) and
    the same tree carried over to the port."""
    tv = np.asarray(js.tri_corners())
    jt = jsah.build_kd_tree(tv, tri_block=4)
    tt = interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                 jt.chunk_start, jt.chunk_bnd, None,
                                 jt.max_leaf_tris, device=CPU)
    return jt, tt


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _leaf(x):
    return x.detach().clone().requires_grad_(True)


@pytest.fixture(scope="module")
def ico():
    js = jproc.icosphere(2)
    jt, tt = _trees(js)
    return dict(js=js, jt=jt, ts=_port_scene(js), tt=tt)


@pytest.fixture(scope="module")
def cornell():
    js = jproc.cornell_box(light=True)
    jt, tt = _trees(js)
    return dict(js=js, jt=jt, ts=_port_scene(js), tt=tt)


# --- camera position and vertices, normal mode -----------------------------

NORMAL = dict(width=24, height=24, mode="normal", differentiable=True)
POS0 = [0.0, 0.0, -1.0]
# off the axis, whose pixel ray meets icosphere(2)'s vertex (0, 0, 0.5):
# six triangles tie there, and an ulp of the ray picks another winner
# with another normal gradient
ICO_POS = [0.0131, -0.0097, -1.0]


@pytest.fixture(scope="module")
def jax_normal(ico):
    """jax.grad of tests/test_grad.py's central-crop loss with respect to
    the camera position and the vertices, and the image, on the JAX flat
    scan: the oracle of both port routes (the JAX kd route gives the same
    winners and so the same image and gradients, bit for bit here)."""
    opts = jint.RenderOptions(use_tree=False, compact=False, **NORMAL)
    js = ico["js"]

    def loss(pos, verts):
        cam = JCamera.create(position=pos, forward=FWD)
        img = jint.render_image(js.with_verts(verts), cam, opts)
        return jnp.mean(img[9:15, 9:15]), img
    (_, img), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ICO_POS, jnp.float32), js.verts)
    return np.asarray(img), [np.asarray(x) for x in g]


@pytest.mark.parametrize("route", ["flat", "kd"])
def test_camera_vertex_grads_match_jax(ico, jax_normal, route):
    img_j, (gpos_j, gverts_j) = jax_normal
    pos, verts = _leaf(torch.tensor(ICO_POS)), _leaf(ico["ts"].verts)
    cam = Camera.create(ICO_POS, FWD, device=CPU).replace(position=pos)
    img = render_image(ico["ts"].with_verts(verts), cam,
                       RenderOptions(**NORMAL),
                       tree=ico["tt"] if route == "kd" else None)
    img[9:15, 9:15].mean().backward()
    _close(img, img_j)
    assert np.abs(gverts_j).max() > 1e-3      # the loss sees the vertices
    _close(pos.grad, gpos_j)
    _close(verts.grad, gverts_j)


# --- path mode with NEE, spp 2 ----------------------------------------------

PATH = dict(width=16, height=16, mode="path", bounces=2, spp=2, nee=True,
            background=0.0, differentiable=True)


@pytest.fixture(scope="module")
def jax_path(cornell):
    """jax.grad of the mean radiance of the Cornell box's path frame (the
    flat scan, NEE, spp 2, PRNGKey(0)) with respect to albedo and
    emission, and the image. The path frames' vertex gradients (the kd
    route) are test_train_step_matches_jax's."""
    js = cornell["js"]
    opts = jint.RenderOptions(use_tree=False, **PATH)
    cam = JCamera.create(position=POS0, forward=FWD)

    def loss(albedo, emission):
        s = js.replace(albedo=albedo, emission=emission)
        img = jint.render_image(s, cam, opts, key=jax.random.PRNGKey(0))
        return jnp.mean(img), img
    (_, img), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        js.albedo, js.emission)
    return np.asarray(img), [np.asarray(x) for x in g]


def test_path_nee_grads_match_jax(cornell, jax_path):
    img_j, grads_j = jax_path
    ts = cornell["ts"]
    leaves = [_leaf(ts.albedo), _leaf(ts.emission)]
    jitter, bounce, light = jax_nee_draws(2, 2, 16 * 16, 1)
    img = render_image(
        ts.replace(albedo=leaves[0], emission=leaves[1]),
        Camera.create(POS0, FWD, device=CPU), RenderOptions(**PATH),
        jitter=jitter, bounce=bounce, light=light)
    img.mean().backward()
    _close(img, img_j)
    for leaf, want in zip(leaves, grads_j):
        assert bool(torch.isfinite(leaf.grad).all())
        assert np.abs(want).max() > 1e-4
        _close(leaf.grad, want)


# --- the edge-aware estimator -----------------------------------------------

def _occluder_arrays():
    """tests/test_grad.py::TestSilhouetteGrad._scene(0) with the occluder
    0.62 high instead of 0.70: a tilted backdrop quad and an occluder quad
    in front of it, with contrasting normals. On the square occluder the
    diagonal runs at 45 degrees through the pixel grid, so a pixel on it
    has two neighbours at equal distance from it; which one sets the
    band's maximum turns on an ulp of the rays, and the two carry
    different vertex gradients (the JAX package's jitted and op-by-op
    runs part beyond rtol 1e-4 there)."""
    verts = np.array([[-4.0, -4.0, 2.0], [4.0, -4.0, 2.0], [4.0, 4.0, 3.0],
                      [-4.0, 4.0, 3.0], [-0.35, -0.31, 1.0],
                      [0.35, -0.31, 1.0], [0.35, 0.31, 1.0],
                      [-0.35, 0.31, 1.0]], np.float32)
    tris = [[3, 2, 1], [3, 1, 0], [7, 6, 5], [7, 5, 4]]
    faces = np.array([[[i, 0 if k < 2 else 1, 0] for i in tri]
                      for k, tri in enumerate(tris)], np.int32)
    normals = np.array([[0.0, 0.124, -0.992], [0.0, 0.0, -1.0]], np.float32)
    return verts, faces, normals


EDGE = dict(width=32, height=32, mode="normal", background=1.0)


@pytest.fixture(scope="module")
def silhouette():
    """The JAX edge-aware normal image of the occluder fixture (flat scan)
    and jax.grad of its silhouette-straddling crop's mean with respect to
    the vertices."""
    verts, faces, normals = _occluder_arrays()
    js = JScene.create(verts, faces, normals=normals)
    opts = jint.RenderOptions(use_tree=False, differentiable=True,
                              edge_aware=True, **EDGE)
    cam = JCamera.create(position=EDGE_POS, forward=FWD)

    def loss(v):
        img = jint.render_image(js.with_verts(v), cam, opts)
        return jnp.mean(img[8:24, 12:28]), img
    (_, img), g = jax.value_and_grad(loss, has_aux=True)(js.verts)
    return (verts, faces, normals), np.asarray(img), np.asarray(g)


def test_edgeaware_matches_jax(silhouette):
    (verts, faces, normals), img_j, g_j = silhouette
    ts = interop.scene_from_numpy(verts, faces, normals, None, None,
                                  device=CPU)
    v = _leaf(ts.verts)
    cam = Camera.create(EDGE_POS, FWD, device=CPU)
    img = render_edgeaware(ts.with_verts(v), cam, RenderOptions(**EDGE))
    img[8:24, 12:28].mean().backward()
    _close(img, img_j)
    # the silhouette term moves the occluder (vertices 4-7) along z
    assert np.abs(g_j[4:, 2]).max() > 1e-3
    _close(v.grad, g_j)
    # away from every triangle boundary the blend leaves the hard image
    hard = render_image(ts, cam, RenderOptions(**EDGE))
    far = (img - hard).abs().amax(dim=-1) > 1e-6
    assert 0.0 < float(far.float().mean()) < 0.30


# --- intersect_diff's vector-Jacobian product -------------------------------

def _vjp_rays(n=512, seed=1):
    """Rays from a sphere of radius 2 about icosphere(2)'s centre (0, 0, 1)
    toward points within 0.25 of it, which hit the sphere (radius 0.5)
    at most 60 degrees from its normal, the last eighth turned away (they
    miss). Grazing hits are left out: the reference is jitted, and XLA's
    fusion rounds their u and v (a small determinant's inverse) beyond
    atol 1e-6 apart from the same function op by op, which the port
    matches."""
    rng = np.random.default_rng(seed)
    c = np.array([0.0, 0.0, 1.0])
    o = rng.normal(size=(n, 3))
    o = c + 2.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    aim = c + rng.uniform(-0.25, 0.25, (n, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[-n // 8:] *= -1.0
    ct = rng.normal(size=(3, n)) / n      # a mean's cotangents
    return o.astype(np.float32), d.astype(np.float32), ct.astype(np.float32)


@pytest.fixture(scope="module")
def jax_vjp(ico):
    """JAX intersect_diff's record on _vjp_rays through the kd-tree and its
    VJP with respect to orig, dir and the vertices for random cotangents
    of t, u, v (one jitted function). The flat scan's gradients are
    test_camera_vertex_grads_match_jax's."""
    o, d, ct = _vjp_rays()
    js, jt = ico["js"], ico["jt"]

    def run(orig, dir, verts, cts):
        def tuv(orig, dir, verts):
            r = jgrad.intersect_diff(js.with_verts(verts), jt, orig, dir)
            return (r["t"] * r["hit"], r["u"], r["v"]), r
        _, pull, rec = jax.vjp(tuv, orig, dir, verts, has_aux=True)
        return rec, pull(cts)
    rec, grads = jax.jit(run)(jnp.asarray(o), jnp.asarray(d), js.verts,
                              tuple(jnp.asarray(c) for c in ct))
    return ({k: np.array(x) for k, x in rec.items()},
            [np.asarray(x) for x in grads])


def test_intersect_diff_vjp_matches_jax(ico, jax_vjp):
    rec_j, grads_j = jax_vjp
    o, d, ct = _vjp_rays()
    leaves = [_leaf(torch.as_tensor(o)), _leaf(torch.as_tensor(d)),
              _leaf(ico["ts"].verts)]
    rec = intersect_diff(ico["ts"].with_verts(leaves[2]), ico["tt"],
                         leaves[0], leaves[1])
    assert torch.equal(rec["hit"], torch.as_tensor(rec_j["hit"]))
    assert torch.equal(rec["tri"], torch.as_tensor(rec_j["tri"]))
    hit = rec["hit"]
    assert float(hit.float().mean()) == 0.875
    for k in ("t", "u", "v"):
        assert rec[k].grad_fn is not None
        _close(rec[k], rec_j[k])
    outs = (rec["t"] * hit, rec["u"], rec["v"])
    grads = torch.autograd.grad(outs, leaves,
                                [torch.as_tensor(c) for c in ct])
    for g, want in zip(grads, grads_j):
        assert bool(torch.isfinite(g).all())
        _close(g, want)


# --- three SGD steps of the train step --------------------------------------

# one bounce: the kd route's path frame with NEE (test_path_nee_grads_
# match_jax holds two bounces on the flat scan), at half the JAX compile
TRAIN = dict(width=16, height=16, mode="path", bounces=1, nee=True,
             background=0.0, differentiable=True)
LR = 0.01   # the vertices move ~1e-3 in the three steps (at 0.1 they diverge)
# off the axis: on it the back wall's diagonal runs through pixel centres,
# where the quad's two triangles tie and an ulp of the ray picks the
# winner (the JAX package's jitted and op-by-op rays part there); the
# emission gradient is per triangle, so it would see which
TRAIN_POS = ICO_POS


def _train_scenes(cornell):
    """The Cornell box with up to 5e-5 more emission on every channel of
    every face, random (the JAX scene and the port's): at equal channels
    (0 on the walls) the luminance max ties, and an ulp of the gradient
    picks the channel it follows (the port and the JAX package parted
    there after two steps, their vertices 1e-12 apart). The walls' go
    below 0 in the steps."""
    e = np.asarray(cornell["js"].emission) + np.random.default_rng(2).uniform(
        0.0, 5e-5, cornell["js"].emission.shape).astype(np.float32)
    return (cornell["js"].replace(emission=jnp.asarray(e)),
            cornell["ts"].replace(emission=torch.as_tensor(e)))


def _target(ts, tree):
    """The frame of the scene with 80% of its albedo, on the port's kd
    route with the JAX draws of PRNGKey(0)."""
    _, bounce, light = jax_nee_draws(1, 1, 16 * 16, 1)
    with torch.no_grad():
        return render_image(ts.replace(albedo=ts.albedo * 0.8),
                            Camera.create(TRAIN_POS, FWD, device=CPU),
                            RenderOptions(**TRAIN), tree=tree,
                            bounce=bounce, light=light).numpy()


@pytest.fixture(scope="module")
def jax_train(cornell):
    """Three steps of the JAX make_train_step on a one-device mesh with
    optax.sgd: the initial params, each step's loss and the params after
    the last."""
    import optax

    from clpathtracer_tpu.parallel.mesh import default_mesh
    from clpathtracer_tpu.parallel.train import make_train_step as jmake
    js, ts = _train_scenes(cornell)
    target = _target(ts, cornell["tt"])
    step, init = jmake(js, jint.RenderOptions(compact=False,
                                                         **TRAIN),
                       default_mesh(jax.devices()[:1]), optax.sgd(LR),
                       tree=cornell["jt"])
    state = init()
    params0 = {k: np.asarray(v) for k, v in state.params.items()}
    cam = JCamera.create(position=TRAIN_POS, forward=FWD)
    losses = []
    for _ in range(3):
        state, loss = step(state, cam, jnp.asarray(target),
                           jax.random.PRNGKey(0))
        losses.append(float(loss))
    return ts, target, params0, losses, {k: np.asarray(v)
                                         for k, v in state.params.items()}


def test_train_step_matches_jax(cornell, jax_train):
    ts, target, params0, losses_j, params_j = jax_train
    step, init = make_train_step(
        ts, RenderOptions(**TRAIN),
        lambda p: torch.optim.SGD(p.values(), lr=LR), tree=cornell["tt"])
    state = init(interop.params_from_numpy(params0, device=CPU))
    draws = jax_nee_draws(1, 1, 16 * 16, 1)
    losses = []
    for _ in range(3):
        state, loss = step(state, Camera.create(TRAIN_POS, FWD, device=CPU),
                           torch.as_tensor(target), draws)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, losses_j, rtol=RTOL)
    for k, want in params_j.items():
        _close(state.params[k], want)
        assert np.abs(want - params0[k]).max() > 0.0, k
    # emission went below 0 (the target is darker), so the light cdf is
    # not sorted. On such a table, one far from sorted (emission in
    # [-1.5, 0.5)), the port's light samples are the JAX _sample_light's,
    # whose face search torch.searchsorted does not reproduce (44 of these
    # 256 draws)
    assert params_j["emission"].min() < 0.0
    e = np.random.default_rng(4).uniform(-1.5, 0.5, params0["emission"].shape)
    js_e = cornell["js"].replace(emission=jnp.asarray(e, jnp.float32))
    ts_e = ts.replace(emission=torch.as_tensor(e, dtype=torch.float32))
    key = jax.random.PRNGKey(1)
    want = jax.jit(jint._sample_light, static_argnums=2)(js_e, key, 256)
    lights = tint.light_cdf(ts_e)
    assert not lights["sorted"]
    u = torch.as_tensor(light_draws(key, 256))
    got = tint._sample_light(ts_e, u, 256, lights=lights)
    for g, w in zip(got, want):
        _close(g, w)
    cdf = lights["cdf"]
    assert bool((torch.searchsorted(cdf, u[:, 0] * cdf[-1]) != tint.
                 searchsorted_scan(cdf, u[:, 0] * cdf[-1])).any())


# --- the port's own routes and finite differences ---------------------------

@pytest.mark.parametrize("route", ["packet", "grid"])
def test_packet_grid_routes_match_walk_grads(route):
    """The packet engine (K3's plain version: coherent primaries and
    sorted bounce waves) and the grid DDA (G1's plain version: the bounce
    waves) give the rope walk's gradients (tests/test_grad.py::
    test_packet_forward_matches_wavefront_grads: no NEE, whose shading of
    a bounce hit on a wall corner depends on which wall wins an exact-t
    tie; per-quad sums, whose diagonal ties are gradient-neutral)."""
    ts = _port_scene(jproc.cornell_box(light=True))
    tv = ts.tri_corners()
    tree = sah.build_kd_tree(tv, tri_block=4, backend="python", device=CPU)
    cam = Camera.create(POS0, FWD, device=CPU)
    base = RenderOptions(32, 32, mode="path", bounces=2, background=0.0,
                         differentiable=True)
    gen = torch.Generator().manual_seed(3)
    _, bounce, light = tint.path_draws(base, gen, CPU)

    def albedo_grad(opts, **structures):
        a = _leaf(ts.albedo)
        img = render_image(ts.replace(albedo=a), cam, opts, tree=tree,
                           bounce=bounce, light=light, **structures)
        img[4:28, 4:28].mean().backward()
        return a.grad.reshape(-1, 2, 3).sum(dim=1)
    walk = albedo_grad(base)
    if route == "packet":
        got = albedo_grad(dataclasses.replace(base, intersector="packet",
                                              packet_tile=256))
    else:
        got = albedo_grad(base, grid=build_grid(tv, device=CPU))
    assert float(walk.abs().max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), walk.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_grads_match_fd():
    """Vertex 0 (the back wall's corner) and the camera position against
    fd_grad on an interior crop of the Cornell box's back wall, kd route
    (tests/test_grad.py::TestVertexGrad's loss)."""
    ts = _port_scene(jproc.cornell_box(light=False))
    tree = sah.build_kd_tree(ts.tri_corners(), tri_block=4,
                             backend="python", device=CPU)
    opts = RenderOptions(24, 24, mode="normal", differentiable=True)

    def loss(x):
        verts = torch.cat([x["v0"][None], ts.verts[1:]])
        cam = Camera.create(POS0, FWD, device=CPU).replace(position=x["pos"])
        img = render_image(ts.with_verts(verts), cam, opts, tree=tree)
        return img[10:13, 10:13].mean()
    x = {"v0": _leaf(ts.verts[0]), "pos": _leaf(torch.tensor(POS0))}
    loss(x).backward()
    fd = fd_grad(loss, x, eps=1e-3)
    assert float(fd["v0"].abs().max()) > 1e-4
    for k in x:
        assert fd[k].dtype == torch.float64
        np.testing.assert_allclose(x[k].grad.numpy(), fd[k].numpy(),
                                   rtol=FD_RTOL, atol=FD_ATOL)


def test_checkpoint_roundtrip(tmp_path):
    """save/restore of {step, params, optimizer state}: max_to_keep drops
    the oldest, restore takes the latest by default, and an Adam run
    resumed from a checkpoint takes the uninterrupted run's next step."""
    def run(params, opt, steps):
        for _ in range(steps):
            opt.zero_grad()
            (params["w"] ** 2).sum().backward()
            opt.step()

    params = {"w": torch.arange(6.0).reshape(2, 3).requires_grad_(True)}
    opt = torch.optim.Adam(params.values(), lr=0.1)
    path = str(tmp_path / "ckpt")
    for s in range(5):
        run(params, opt, 1)
        save_train_state(path, s, params, opt.state_dict(), max_to_keep=2)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "3.pt", "4.pt"]
    step, saved = restore_train_state(path)
    assert step == 4 and torch.equal(saved["params"]["w"], params["w"])
    assert restore_train_state(path, 3)[0] == 3
    resumed = {"w": saved["params"]["w"].clone().requires_grad_(True)}
    opt2 = torch.optim.Adam(resumed.values(), lr=0.1)
    opt2.load_state_dict(saved["opt_state"])
    run(params, opt, 1)
    run(resumed, opt2, 1)
    assert torch.equal(resumed["w"], params["w"])
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "none"))


def test_differentiable_options_raise(cornell):
    """What the differentiable route refuses: a light table built before
    the call, the bf16 preview, edge-aware mirror frames, training
    without differentiable, and a treelet tree on the packet route."""
    ts, tree = cornell["ts"], cornell["tt"]
    cam = Camera.create(POS0, FWD, device=CPU)
    opts = RenderOptions(16, 16, mode="path", nee=True, differentiable=True)
    with pytest.raises(ValueError, match="lights"):
        render_image(ts, cam, opts, tree=tree, lights=tint.light_cdf(ts))
    with pytest.raises(ValueError, match="f32"):
        render_image(ts, cam, dataclasses.replace(
            opts, intersector="packet", precision="bf16"), tree=tree)
    with pytest.raises(ValueError, match="mirror"):
        render_image(ts, cam, RenderOptions(16, 16, mode="mirror",
                                            edge_aware=True), tree=tree)
    sgd = lambda p: torch.optim.SGD(p.values(), lr=0.1)  # noqa: E731
    with pytest.raises(ValueError, match="differentiable"):
        make_train_step(ts, RenderOptions(16, 16), sgd, tree=tree)
    stree = build_sharded_tree(ts.tri_corners(), 2, device=CPU)
    with pytest.raises(ValueError, match="ShardedTree"):
        make_train_step(ts, dataclasses.replace(opts, intersector="packet"),
                        sgd, tree=stree)


@pytest.mark.parametrize("route", ["kd", "flat"])
def test_walks_see_no_graph(cornell, monkeypatch, route):
    """No walk, scan or W2 record table of a differentiable path frame
    (NEE, edge-aware) is built on tensors that carry a graph or with
    autograd on, and NEE's light table is built from the live scene."""
    seen = {"walks": 0, "lights": []}

    def no_graph(fn):
        def wrapped(*args, **kwargs):
            seen["walks"] += 1
            assert not torch.is_grad_enabled()
            for a in (*args, *kwargs.values()):
                assert not (isinstance(a, torch.Tensor) and a.requires_grad)
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(ttf, "ray_walk_reference",
                        no_graph(ttf.ray_walk_reference))
    monkeypatch.setattr(tisx, "brute_force_reference",
                        no_graph(tisx.brute_force_reference))
    light_cdf = tint.light_cdf

    def live_cdf(scene):
        seen["lights"].append(scene.verts.requires_grad)
        return light_cdf(scene)
    monkeypatch.setattr(tint, "light_cdf", live_cdf)
    ts = cornell["ts"]
    verts, emission = _leaf(ts.verts), _leaf(ts.emission)
    opts = RenderOptions(16, 16, mode="path", nee=True, background=0.0,
                         differentiable=True, edge_aware=True)
    img = render_image(ts.replace(verts=verts, emission=emission),
                       Camera.create(POS0, FWD, device=CPU), opts,
                       tree=cornell["tt"] if route == "kd" else None)
    img.mean().backward()
    assert seen["walks"] >= 4 and seen["lights"] == [True]
    for g in (verts.grad, emission.grad):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
