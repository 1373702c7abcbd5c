"""The plain reference against the port at tiny sizes on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.reference import brute, camera, inputs

CPU = torch.device("cpu")


def _full_scan(verts, faces, orig, dir, t_max=None):
    """Every triangle against every ray, float64, no cull."""
    c = torch.as_tensor(verts, dtype=torch.float64)[
        torch.as_tensor(faces, dtype=torch.int64)]
    ok, t = brute.moller_trumbore(c[None, :, 0], (c[:, 1] - c[:, 0])[None],
                                  (c[:, 2] - c[:, 0])[None], orig[:, None],
                                  dir[:, None])
    if t_max is not None:
        ok = ok & (t < t_max[:, None])
    t = torch.where(ok, t, float("inf"))
    return t.min(dim=1)


@pytest.mark.parametrize("kind", ["terrain", "soup"])
def test_generators_match_the_port(kind):
    from clpathtracer_tpu_torch.scene import procedural
    spec = ({"kind": "terrain", "num_tris": 3000, "extent": 10.0,
             "relief": 2.5, "emissive_frac": 0.01} if kind == "terrain" else
            {"kind": "soup", "num_tris": 3000, "extent": 10.0,
             "tri_size": 0.01, "emissive_frac": 0.01})
    a = inputs.make_scene(spec, 2**31 + 7)
    kw = {k: v for k, v in spec.items() if k not in ("kind", "num_tris")}
    gen = (procedural.terrain_mesh if kind == "terrain"
           else procedural.random_tri_soup)
    s = gen(spec["num_tris"], seed=2**31 + 7, device=CPU, **kw)
    np.testing.assert_array_equal(a["verts"], s.verts.numpy())
    np.testing.assert_array_equal(a["faces"], s.faces[:, :, 0].numpy())
    np.testing.assert_array_equal(a["emission"], s.emission.numpy())


@pytest.mark.parametrize("kind", ["terrain", "soup"])
def test_culled_brute_force_equals_the_full_scan(kind):
    spec = ({"kind": "terrain", "num_tris": 4000, "extent": 10.0,
             "relief": 2.5} if kind == "terrain" else
            {"kind": "soup", "num_tris": 4000, "extent": 10.0,
             "tri_size": 0.01})
    a = inputs.make_scene(spec, 11)
    tris = brute.Triangles(a["verts"], a["faces"], CPU)
    g = torch.Generator().manual_seed(3)
    n = 600
    orig = (torch.rand((n, 3), generator=g, dtype=torch.float64) - 0.5) * 24
    dir = torch.randn((n, 3), generator=g, dtype=torch.float64)
    # half the rays aimed at a triangle's centroid, some near its corners
    c = torch.as_tensor(a["verts"], dtype=torch.float64)[
        torch.as_tensor(a["faces"], dtype=torch.int64)]
    pick = torch.randint(0, c.shape[0], (n // 2,), generator=g)
    w = torch.rand((n // 2, 3), generator=g, dtype=torch.float64) ** 4
    aim = (c[pick] * (w / w.sum(dim=1, keepdim=True))[:, :, None]).sum(1)
    dir[n // 2:] = aim - orig[n // 2:]
    dir[: n // 6, 1:] = 0.0                 # axis-aligned: zero components
    dir[n // 6: n // 3, 0] = 0.0
    dir = dir / dir.norm(dim=1, keepdim=True)
    t_ref, _ = _full_scan(a["verts"], a["faces"], orig, dir)
    hit, t, tri = tris.nearest(orig, dir)
    assert hit.sum() > n // 20
    assert torch.equal(hit, torch.isfinite(t_ref))
    assert torch.equal(t[hit], t_ref[hit])
    c = torch.as_tensor(a["verts"], dtype=torch.float64)[
        torch.as_tensor(a["faces"], dtype=torch.int64)[tri[hit]]]
    ok, t_w = brute.moller_trumbore(c[:, 0], c[:, 1] - c[:, 0],
                                    c[:, 2] - c[:, 0], orig[hit], dir[hit])
    assert ok.all() and torch.equal(t_w, t[hit])
    t_max = torch.rand((n,), generator=g, dtype=torch.float64) * 20
    occ = tris.occluded(orig, dir, t_max)
    t_sh, _ = _full_scan(a["verts"], a["faces"], orig, dir, t_max)
    assert torch.equal(occ, torch.isfinite(t_sh))


def test_pixel_rays_match_the_port():
    from clpathtracer_tpu_torch import Camera
    from clpathtracer_tpu_torch.core.camera import (cam_matrix,
                                                    generate_rays,
                                                    generate_rays_jittered)
    cam = {"kind": "orbit", "poses": 64, "radius": 6.0, "height": 14.0,
           "target": [0.0, 0.0, 0.0], "fov": 1.0471975511965976}
    pos, fwd = inputs.pose(cam, 99, 5)
    w, h = 96, 48
    m = cam_matrix(Camera.create(pos, fwd, device=CPU), h)
    o, d = generate_rays(m, w, h)
    pix = np.arange(w * h)[::7]
    ref_inv = camera.cam_inverse(pos, fwd, h, cam["fov"])
    ro, rd = camera.pixel_rays(ref_inv, w, h, pix)
    torch.testing.assert_close(ro.float(), o[pix], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rd.float(), d[pix], rtol=1e-5, atol=1e-5)
    jit = torch.rand((1, w * h, 2), generator=torch.Generator().manual_seed(1))
    oj, dj = generate_rays_jittered(m, w, h, jit)
    _, rdj = camera.pixel_rays(ref_inv, w, h, pix, jit[0, pix])
    torch.testing.assert_close(rdj.float(), dj[0, pix], rtol=1e-5, atol=1e-5)


def test_inputs_repeat_for_a_seed_and_keep_their_sizes():
    cam = {"kind": "orbit", "poses": 64, "radius": 25.0, "height": 0.0,
           "target": [0.0, 0.0, 0.0]}
    spec = {"kind": "soup", "num_tris": 500, "extent": 10.0,
            "tri_size": 0.01, "emissive_frac": 0.01}
    traffic = {"mode": "path", "width": 32, "height": 16, "spp": 4,
               "bounces": 2, "nee": True, "draw_sets": 3}
    for seed in (0, 2**31 + 5, 2**40 + 1):
        a, b = inputs.make_scene(spec, seed), inputs.make_scene(spec, seed)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        assert a["faces"].shape == (500, 3)
        assert int((a["emission"] > 0).any(axis=1).sum()) == 5
        pa = inputs.draws_pool(traffic, seed, CPU)
        pb = inputs.draws_pool(traffic, seed, CPU)
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
        assert pa["light"].shape == (3, 4, 2, 512, 3)
        np.testing.assert_array_equal(inputs.pose(cam, seed, 70)[0],
                                      inputs.pose(cam, seed, 6)[0])
    assert not np.array_equal(inputs.pose(cam, 1, 0)[0],
                              inputs.pose(cam, 2, 0)[0])
