"""Port parity, path tracing with next-event estimation over the uniform
grid: the light sampler, the grid's shadow query and the port's NEE
images (64x64, bounces 2) against the JAX package's, on a small emissive
soup and on the Cornell box. The JAX package renders on its per-ray
wavefront route over a kd-tree with the grid attached (plain XLA walks,
no Pallas kernel): primaries through traverse_fast, bounce and shadow
waves through traverse_grid. The port renders on its windows route
(K1's plain version for the primaries) with the grid passed in. Random
numbers: JAX's key splits replayed into explicit draws for the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clpathtracer_tpu.accel.sah import attach_grid, build_kd_tree
from clpathtracer_tpu.core import camera as jcam
from clpathtracer_tpu.render import integrator as jint
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch.accel.grid import build_grid
from clpathtracer_tpu_torch.core import camera as tcam
from clpathtracer_tpu_torch.ops import intersect as tisx
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.render import integrator as tint
from clpathtracer_tpu_torch.scene import procedural as tproc
from torch_jax_draws import jax_nee_draws as _jax_nee_draws
from torch_jax_draws import light_draws as _light_draws

torch.set_num_threads(2)
CPU = torch.device("cpu")
H = W = 64
N = H * W
SCENES = {
    # name: (JAX scene, port scene, camera position, forward)
    "soup": (lambda: jproc.random_tri_soup(20_000, seed=5, extent=10.0,
                                           tri_size=0.02,
                                           emissive_frac=0.01),
             lambda: tproc.random_tri_soup(20_000, seed=5, extent=10.0,
                                           tri_size=0.02, emissive_frac=0.01,
                                           device=CPU),
             [0.0, 0.0, -25.0], [0.0, 0.0, 1.0]),
    "cornell": (jproc.cornell_box, lambda: tproc.cornell_box(device=CPU),
                [0.0, 0.0, -1.5], [0.0, 0.0, 1.0]),
}


@pytest.fixture(scope="module", params=list(SCENES))
def pair(request):
    """One scene in both packages: the JAX one with a kd-tree and its grid
    attached, the port's with its windows and its own grid."""
    jmake, tmake, pos, fwd = SCENES[request.param]
    js = jmake().bake_shading()
    tv = np.asarray(js.tri_corners())
    tree = attach_grid(build_kd_tree(tv, max_depth=12, leaf_size=64,
                                     tri_block=4), tv)
    ts = tmake().bake_shading()
    mwin = tpl.build_morton_windows(ts.tri_corners(), 16, device=CPU)
    mwin = tpl.attach_resolve(tpl.attach_so(mwin), ts.shade_rows)
    return dict(name=request.param, js=js, tree=tree, ts=ts, mwin=mwin,
                grid=build_grid(ts.tri_corners(), device=CPU), tv=tv,
                jcam=jcam.Camera.create(position=pos, forward=fwd),
                tcam=tcam.Camera.create(pos, fwd, device=CPU))


@pytest.mark.parametrize("stride", [1, 4])
def test_sample_light_matches_jax(pair, stride):
    n = 4096
    key = jax.random.PRNGKey(7)
    jp, jn, je, jpdf, jany = jint._sample_light(pair["js"], key, n,
                                                stride=stride)
    u = torch.as_tensor(_light_draws(key, -(-n // stride)))
    lights = tint.light_cdf(pair["ts"])
    tp, tn, te, tpdf = tint._sample_light(pair["ts"], u, n, stride, lights)
    assert lights["any"] == bool(jany)
    # the face: equal but where a uniform sits on a CDF step that
    # torch.cumsum and jnp.cumsum round apart
    same = (te.numpy() == np.asarray(je)).all(axis=1) \
        & np.isclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-5)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(tp.numpy()[same], np.asarray(jp)[same],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tn.numpy()[same], np.asarray(jn)[same],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tpdf.numpy()[same], np.asarray(jpdf)[same],
                               rtol=1e-5)
    if stride > 1:       # one sample shared by each run of `stride` lanes
        assert torch.equal(tp[:stride], tp[:1].expand(stride, 3))


def test_occluded_matches_jax(pair):
    """The shadow query on the grid route: flags equal to JAX's, from
    random points inside the scene's box toward random targets in a box
    twice its size (the Cornell box's walls occlude only segments that
    leave it), a quarter of the lanes dead."""
    rng = np.random.default_rng(3)
    lo, hi = pair["tv"].min(axis=(0, 1)), pair["tv"].max(axis=(0, 1))
    a = rng.uniform(lo, hi, (N, 3)).astype(np.float32)
    b = rng.uniform(1.5 * lo - 0.5 * hi, 1.5 * hi - 0.5 * lo,
                    (N, 3)).astype(np.float32)
    dist = np.linalg.norm(b - a, axis=1).astype(np.float32)
    d = ((b - a) / dist[:, None]).astype(np.float32)
    act = rng.uniform(size=N) < 0.75
    occ_j = np.asarray(jint._occluded(
        pair["js"], pair["tree"], jnp.asarray(a), jnp.asarray(d),
        jnp.asarray(dist), jint.RenderOptions(compact=False),
        active=jnp.asarray(act)))
    occ_t = tint._occluded(pair["ts"], torch.as_tensor(a),
                           torch.as_tensor(d), torch.as_tensor(dist),
                           tint.RenderOptions(), active=torch.as_tensor(act),
                           grid=pair["grid"]).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert occ_t.any() and not occ_t[~act].any()


@pytest.mark.parametrize("spp", [1, 2])
def test_nee_image_matches_jax(pair, spp):
    # compact=False: the JAX walks without their wind-down rounds (the
    # same results, fewer loops to compile)
    jopts = jint.RenderOptions(width=W, height=H, mode="path", spp=spp,
                               bounces=2, nee=True, background=0.0,
                               compact=False)
    ref = np.asarray(jint.render_image(pair["js"], pair["jcam"], jopts,
                                       tree=pair["tree"]))
    jitter, bounce, light = _jax_nee_draws(spp, 2, N, 1)
    opts = tint.RenderOptions(W, H, mode="path", spp=spp, bounces=2,
                              nee=True, background=0.0)
    img = tint.render_image(pair["ts"], pair["tcam"], opts, pair["mwin"],
                            grid=pair["grid"], jitter=jitter, bounce=bounce,
                            light=light).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0
    # an edge flip, a tie or a light face on a CDF step changes a path
    differ = (np.abs(img - ref).max(axis=-1) > 1e-4).mean()
    mad = np.abs(img - ref).mean()
    print(f"{pair['name']} spp {spp}: {differ:.5f} of pixels differ by more "
          f"than 1e-4, mean abs difference {mad:.3g}")
    assert differ <= 2e-2, differ
    assert mad <= 2e-3, mad


def test_nee_draws_from_generator(pair):
    """path_draws adds the light uniforms with NEE; drawn from a generator
    or passed in, the image is the same; the shadow waves skip a scene
    without lit emitters."""
    opts = tint.RenderOptions(32, 16, mode="path", spp=2, bounces=2,
                              nee=True, nee_light_stride=4)
    jitter, bounce, light = tint.path_draws(
        opts, torch.Generator(device=CPU).manual_seed(0), CPU)
    assert light.shape == (2, 2, 128, 3)
    a = tint.render_image(pair["ts"], pair["tcam"], opts, pair["mwin"],
                          grid=pair["grid"])
    b = tint.render_image(pair["ts"], pair["tcam"], opts, pair["mwin"],
                          grid=pair["grid"], jitter=jitter, bounce=bounce,
                          light=light)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    with pytest.raises(ValueError):
        tint.render_image(pair["ts"], pair["tcam"], opts, pair["mwin"],
                          grid=pair["grid"], jitter=jitter, bounce=bounce)
    dark = pair["ts"].replace(emission=torch.zeros_like(pair["ts"].emission))
    assert not tint.light_cdf(dark)["any"]


def test_nee_bounce_grid_off(pair):
    """bounce_grid=False: the bounce waves take the sorted bundles (K1'),
    the shadow waves still the grid; the image agrees with the grid bounce
    route's within the NEE image budgets (the two walks differ only at
    exact-t ties)."""
    opts = tint.RenderOptions(32, 16, mode="path", bounces=2, nee=True,
                              background=0.0)
    lights = tint.light_cdf(pair["ts"])
    a = tint.render_image(pair["ts"], pair["tcam"], opts, pair["mwin"],
                          grid=pair["grid"], lights=lights)
    off = tint.render_image(pair["ts"], pair["tcam"],
                            tint.RenderOptions(32, 16, mode="path",
                                               bounces=2, nee=True,
                                               background=0.0,
                                               bounce_grid=False),
                            pair["mwin"], grid=pair["grid"], lights=lights)
    assert bool(torch.isfinite(off).all()) and float(off.mean()) > 0.0
    differ = float(((off - a).abs().amax(dim=-1) > 1e-4).float().mean())
    assert differ <= 2e-2, differ
    assert float((off - a).abs().mean()) <= 2e-3


@pytest.mark.parametrize("spp", [1, 2])
def test_nee_without_grid_raises(pair, spp):
    """NEE without a grid now renders: the shadow waves of the windows
    route go through the sorted bundles (K1'), within the NEE image
    budgets of the grid route's frame on the same draws; with no
    structure at all the shadow query is the flat scan's (W2), equal to
    the brute force's hits below the bound."""
    opts = tint.RenderOptions(32, 16, mode="path", nee=True, spp=spp,
                              bounces=2, background=0.0)
    lights = tint.light_cdf(pair["ts"])
    img = tint.render_image(pair["ts"], pair["tcam"], opts, pair["mwin"],
                            lights=lights)
    ref = tint.render_image(pair["ts"], pair["tcam"], opts, pair["mwin"],
                            grid=pair["grid"], lights=lights)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    differ = float(((img - ref).abs().amax(dim=-1) > 1e-4).float().mean())
    assert differ <= 2e-2, differ
    assert float((img - ref).abs().mean()) <= 2e-3
    rng = np.random.default_rng(spp)
    lo, hi = pair["tv"].min(axis=(0, 1)), pair["tv"].max(axis=(0, 1))
    o = torch.as_tensor(rng.uniform(lo, hi, (256, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(
        rng.normal(size=(256, 3)).astype(np.float32)), dim=1)
    dist = torch.full((256,), float(np.linalg.norm(hi - lo)) / 2)
    occ = tint._occluded(pair["ts"], o, d, dist, tint.RenderOptions())
    bf = tisx.nearest_hit_bruteforce(pair["ts"], o, d)
    assert torch.equal(occ, bf["hit"] & (bf["t"] < dist - 1e-3))
    assert bool(occ.any())
