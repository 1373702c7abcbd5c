"""Port parity, mirror and path shading: jittered rays, the hemisphere
sampler, the procedural soup, dilated gate keys, and the port's
render_image in mirror and path mode (64x64, bounces 2, ~16k-triangle
terrain with emitters, windows from the port's own builder) against the
JAX package's render_image on its per-ray wavefront route over a kd-tree
(plain XLA walks, no Pallas kernel). tests/test_plist.py holds the JAX
bundle route equal to that walk. Random numbers: the path test replays
JAX's key splits into explicit draws for the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clpathtracer_tpu.accel.sah import build_kd_tree
from clpathtracer_tpu.core import camera as jcam
from clpathtracer_tpu.ops import plist as jpl
from clpathtracer_tpu.render import integrator as jint
from clpathtracer_tpu.render import shading as jsh
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch.core import camera as tcam
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre
from clpathtracer_tpu_torch.render import integrator as tint
from clpathtracer_tpu_torch.render.shading import cosine_sample_hemisphere
from clpathtracer_tpu_torch.scene import procedural as tproc

torch.set_num_threads(2)
CPU = torch.device("cpu")
POS, FWD = [0.0, 14.0, 0.0], [0.0, -1.0, 0.01]
H = W = 64
N = H * W


@pytest.fixture(scope="module")
def scenes():
    """The same emissive terrain in both packages: the JAX one with a
    kd-tree, the port's with its windows."""
    js = jproc.terrain_mesh(16_000, seed=0, extent=10.0,
                            emissive_frac=0.02).bake_shading()
    tv = np.asarray(js.tri_corners())
    tree = build_kd_tree(tv, max_depth=12, leaf_size=64, tri_block=4)
    ts = tproc.terrain_mesh(16_000, seed=0, extent=10.0, emissive_frac=0.02,
                            device=CPU).bake_shading()
    mwin = tpl.build_morton_windows(ts.tri_corners(), 16, device=CPU)
    mwin = tpl.attach_resolve(tpl.attach_so(mwin), ts.shade_rows)
    return dict(js=js, tree=tree, ts=ts, mwin=mwin, tv=tv,
                jcam=jcam.Camera.create(position=POS, forward=FWD),
                tcam=tcam.Camera.create(POS, FWD, device=CPU))


def test_generate_rays_jittered_matches_jax():
    jc = jcam.Camera.create(position=POS, forward=FWD)
    m = np.array(jcam.cam_matrix(jc, H))
    jitter = np.random.default_rng(0).uniform(size=(2, N, 2)) \
        .astype(np.float32)
    jo, jd = jcam.generate_rays_jittered(jnp.asarray(m), W, H,
                                         jnp.asarray(jitter))
    to, td = tcam.generate_rays_jittered(torch.as_tensor(m), W, H,
                                         torch.as_tensor(jitter))
    assert td.shape == (2, N, 3) and to.shape == (2, N, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_cosine_sample_hemisphere_matches_jax():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    u1, u2 = rng.uniform(size=(2, 4096)).astype(np.float32)
    j = np.asarray(jsh.cosine_sample_hemisphere(jnp.asarray(n),
                                                jnp.asarray(u1),
                                                jnp.asarray(u2)))
    t = cosine_sample_hemisphere(torch.as_tensor(n), torch.as_tensor(u1),
                                 torch.as_tensor(u2)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert ((t * n).sum(-1) >= -1e-6).all()     # the normal's hemisphere


def test_random_tri_soup_bit_exact():
    js = jproc.random_tri_soup(20_000, seed=11, extent=10.0, tri_size=0.05,
                               emissive_frac=0.01).bake_shading()
    ts = tproc.random_tri_soup(20_000, seed=11, extent=10.0, tri_size=0.05,
                               emissive_frac=0.01, device=CPU).bake_shading()
    for name in ("verts", "faces", "normals", "albedo", "emission",
                 "shade_rows"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert (ts.emission.numpy()[:, 0] == 5.0).sum() == 200


def _bruteforce(tv, orig, dirs, chunk=4096):
    v0 = torch.as_tensor(tv[:, 0])[None]
    e1 = torch.as_tensor(tv[:, 1] - tv[:, 0])[None]
    e2 = torch.as_tensor(tv[:, 2] - tv[:, 0])[None]
    best = torch.full((orig.shape[0],), float("inf"))
    for c in range(0, tv.shape[0], chunk):
        ok, t, _, _ = _mt_pre(v0[:, c:c + chunk], e1[:, c:c + chunk],
                              e2[:, c:c + chunk], orig[:, None],
                              dirs[:, None])
        best = torch.minimum(best, torch.where(ok, t, float("inf"))
                             .amin(dim=1))
    return torch.isfinite(best), best


def test_dilated_win_keys_conservative(scenes):
    """Jittered samples with hulls dilated by 3 px (the spp > 1 route):
    the prepass keys equal JAX's, and the traced hits equal a brute force
    over all triangles (edge-flip budget of the SO route); without the
    dilation the corner-hull cull drops jittered edge samples, as in
    tests/test_plist.py::test_plist_jitter_dilated_hulls."""
    cam_inv = tcam.cam_matrix(scenes["tcam"], H)
    dropped = 0
    for seed in range(3):
        jitter = torch.as_tensor(np.random.default_rng(seed).uniform(
            size=(1, N, 2)).astype(np.float32))
        o, d = tcam.generate_rays_jittered(cam_inv, W, H, jitter)
        o, d = o[0], d[0]
        dir_b = tpl._blockify(d, H, W, tpl.GH, tpl.GW)
        db = dir_b.reshape(-1, tpl.GATE, 3)
        tk = tpl._win_keys(scenes["mwin"].win_bnd, db, o[0], tpl.GH, tpl.GW,
                           dilate_px=3.0).numpy()
        jw_bnd = jnp.asarray(np.pad(scenes["mwin"].win_bnd.numpy(),
                                    ((0, 0), (0, 2))))
        jk = np.asarray(jpl._win_keys(jw_bnd, jnp.asarray(db.numpy()),
                                      o[0].numpy(), tpl.GH, tpl.GW,
                                      dilate_px=3.0))
        assert (np.isfinite(jk) != np.isfinite(tk)).mean() <= 1e-3
        both = np.isfinite(jk) & np.isfinite(tk)
        np.testing.assert_array_equal(tk[both], jk[both])
        rec = tpl.traverse_plist(scenes["mwin"], o, d, (H, W), dilate_px=3.0)
        hit, t = _bruteforce(scenes["tv"], o, d)
        assert (rec["hit"] != hit).float().mean() < 2e-3
        both = (rec["hit"] & hit).numpy()
        np.testing.assert_allclose(rec["t"].numpy()[both], t.numpy()[both],
                                   rtol=1e-4, atol=1e-5)
        rec0 = tpl.traverse_plist(scenes["mwin"], o, d, (H, W))
        dropped += int((rec0["hit"] != hit).sum())
    assert dropped > 0, "undilated hulls dropped nothing"


def _differ(a, b, tol):
    return (np.abs(a - b).max(axis=-1) > tol).mean()


def test_mirror_image_matches_jax(scenes):
    jopts = jint.RenderOptions(width=W, height=H, mode="mirror", bounces=2)
    ref = np.asarray(jint.render_image(scenes["js"], scenes["jcam"], jopts,
                                       tree=scenes["tree"]))
    img = tint.render_image(scenes["ts"], scenes["tcam"],
                            tint.RenderOptions(W, H, mode="mirror",
                                               bounces=2),
                            scenes["mwin"]).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    # exact-t tie winners at shared mesh edges carry other normals and
    # reflect elsewhere: the tie budget of the normal-mode image
    differ = _differ(img, ref, 1e-5)
    print(f"mirror: {differ:.5f} of pixels differ by more than 1e-5, mean "
          f"abs difference {np.abs(img - ref).mean():.3g}")
    assert differ < 1.5e-2, differ


def _jax_path_draws(spp, bounces, n):
    """The draws of JAX's render_image (path, spp > 1) from PRNGKey(0):
    split(key, spp); per sample (kj, ks) = split; jitter from kj; per
    bounce (ks, sub) = split(ks), uniforms from sub."""
    jit, bnc = [], []
    for k in jax.random.split(jax.random.PRNGKey(0), spp):
        kj, ks = jax.random.split(k)
        jit.append(np.asarray(jax.random.uniform(kj, (1, n, 2)))[0])
        draws = []
        for _ in range(bounces):
            ks, sub = jax.random.split(ks)
            draws.append(np.asarray(jax.random.uniform(sub, (n, 2))))
        bnc.append(np.stack(draws))
    return torch.as_tensor(np.stack(jit)), torch.as_tensor(np.stack(bnc))


def test_path_image_matches_jax(scenes):
    jopts = jint.RenderOptions(width=W, height=H, mode="path", spp=2,
                               bounces=2)
    ref = np.asarray(jint.render_image(scenes["js"], scenes["jcam"], jopts,
                                       tree=scenes["tree"]))
    jitter, bounce = _jax_path_draws(2, 2, N)
    opts = tint.RenderOptions(W, H, mode="path", spp=2, bounces=2)
    img = tint.render_image(scenes["ts"], scenes["tcam"], opts,
                            scenes["mwin"], jitter=jitter,
                            bounce=bounce).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.max() > 1.0      # emitters seen directly or via a bounce
    # an edge flip or a tie changes a path's next vertex
    differ = _differ(img, ref, 1e-4)
    mad = np.abs(img - ref).mean()
    print(f"path: {differ:.5f} of pixels differ by more than 1e-4, "
          f"mean abs difference {mad:.3g}")
    assert differ < 2e-2, differ
    assert mad < 2e-3, mad


def test_path_draws_from_generator(scenes):
    """Without draws, path mode draws them from a generator (default:
    seeded 0) with path_draws; explicit draws give the same image."""
    opts = tint.RenderOptions(32, 16, mode="path", spp=2, bounces=2)
    a = tint.render_image(scenes["ts"], scenes["tcam"], opts, scenes["mwin"])
    jitter, bounce, light = tint.path_draws(
        opts, torch.Generator(device=CPU).manual_seed(0), CPU)
    assert jitter.shape == (2, 512, 2) and bounce.shape == (2, 2, 512, 2)
    assert light is None
    b = tint.render_image(scenes["ts"], scenes["tcam"], opts, scenes["mwin"],
                          jitter=jitter, bounce=bounce)
    assert torch.equal(a, b)
    c = tint.render_image(scenes["ts"], scenes["tcam"], opts, scenes["mwin"],
                          generator=torch.Generator().manual_seed(1))
    assert not torch.equal(a, c) and bool(torch.isfinite(c).all())
    with pytest.raises(ValueError):
        tint.render_image(scenes["ts"], scenes["tcam"], opts, scenes["mwin"],
                          bounce=bounce[:, :1])


def test_normal_mode_ignores_spp(scenes):
    """Normal mode renders one pixel-grid sample whatever spp is, as
    JAX's render_image does (it reads spp only in path mode)."""
    one = tint.render_image(scenes["ts"], scenes["tcam"],
                            tint.RenderOptions(W, H), scenes["mwin"])
    four = tint.render_image(scenes["ts"], scenes["tcam"],
                             tint.RenderOptions(W, H, spp=4), scenes["mwin"])
    assert torch.equal(one, four)


@pytest.mark.parametrize("opts", [
    dict(mode="path", nee=True), dict(mode="path", nee=True, spp=2)])
def test_nee_raises(scenes, opts):
    with pytest.raises(NotImplementedError):
        tint.render_image(scenes["ts"], scenes["tcam"],
                          tint.RenderOptions(W, H, **opts), scenes["mwin"])
