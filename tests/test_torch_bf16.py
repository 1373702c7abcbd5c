"""Port parity, the bf16 preview K4: the port's traverse_packet(
precision="bf16") (K4 in its plain torch version on the CPU: the stream
walk in f32, the dense Moller-Trumbore test op by op on bf16 tensors)
against the JAX package's (_kernel_stream with compute_dtype=bfloat16 in
interpret mode) and against the f32 traverse, on the "active" fixture of
tests/test_torch_packet.py; render_image(precision="bf16") on the kd route
against the JAX package's, on its 16k terrain.

The preview is not exact against f32: bf16's 8 significant bits make the
o - v0 cancellation lose triangles much smaller than the scene, and add
false hits (a bf16 winner is a hit; its t, u, v re-resolve in f32). So the
contract is one of agreement, each bound stated where it applies; XLA may
keep f32 between bf16 operations on the CPU, so the JAX and port previews
need not be bit-equal."""

import numpy as np
import pytest
import torch

from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.render import integrator as jint
from clpathtracer_tpu.scene.procedural import random_tri_soup
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops import packet as tpk
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      render_image)
from test_torch_packet import POS, FWD, _active, _scene_fixture
from test_torch_packet import terrain  # noqa: F401 (the fixture)

torch.set_num_threads(2)
CPU = torch.device("cpu")
TILE = 256


@pytest.fixture(scope="module")
def active_fx():
    """TestStreamEngine.test_active_mask's scene (3000-triangle soup,
    extent 2, tri_size 0.05, leaf 16) at 32x32, with the JAX package's
    bf16 preview of it (all lanes active)."""
    fx = _scene_fixture(random_tri_soup(3000, seed=1, extent=2.0,
                                        tri_size=0.05), 32, (0.0, 0.0, -4.0),
                        None, 16)
    rec = jpk.traverse_packet(fx["jt"], fx["jt"].quads, fx["orig"],
                              fx["dirs"], image_shape=(32, 32), tile=TILE,
                              precision="bf16")
    fx["jax_bf16"] = {k: np.asarray(v) for k, v in rec.items()}
    return fx


def _port(fx, **kw):
    return tpk.traverse_packet(fx["pt"], fx["o"], fx["d"],
                               image_shape=(32, 32), tile=TILE, **kw)


def test_plain_k4_agrees_with_f32(active_fx):
    """JAX's own bound (tests/test_packet.py::TestStreamEngine::
    test_bf16_preview): hit agreement above 0.88 with the f32 traverse.
    Measured 0.9287 (493 bf16 hits against 462 f32 hits)."""
    bf = _port(active_fx, precision="bf16")
    f32 = _port(active_fx)
    agree = float((bf["hit"] == f32["hit"]).float().mean())
    assert agree > 0.88, agree
    assert bf["hit"].sum() != f32["hit"].sum()      # the preview is lossy
    both = bf["hit"] & f32["hit"] & (bf["tri"] == f32["tri"])
    assert torch.equal(bf["t"][both], f32["t"][both])   # f32 re-resolve
    st = bf["tile_stats"]
    assert (st[:, 4] == 0).all() and int(st[:, 1].sum()) > 0


def test_plain_k4_agrees_with_jax_bf16(active_fx):
    """Hit agreement with the JAX package's bf16 preview of at least 0.95.
    Measured 1.0: 493 hits on both, equal tile_stats."""
    bf = _port(active_fx, precision="bf16")
    ref = active_fx["jax_bf16"]
    agree = float((bf["hit"].numpy() == ref["hit"]).mean())
    assert agree >= 0.95, agree


def test_plain_k4_honours_the_active_mask(active_fx):
    act = torch.as_tensor(_active(active_fx))
    bf = _port(active_fx, precision="bf16", active=act)
    assert bf["hit"].any() and not bf["hit"][~act].any()
    assert int(bf["tile_stats"][:, 2].sum()) == int(act.sum())


def _bf16(x):
    """f32 -> the nearest bf16 value (ties to even), as f32."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


def test_mt_pairs_bf16_rounds_every_operation():
    """The plain K4's pair test against numpy: every operation computed in
    f32 and rounded to bf16, in _mt_chunk_math's order. This is the
    rounding ops/csrc/pair_tests.cuh::mt_hit_bf16 reproduces on the card."""
    rng = np.random.default_rng(3)
    k, n = 256, 64
    r = np.zeros((k, 1, 16), np.float32)
    r[:, 0, 0:3] = rng.uniform(-1, 1, (k, 3))
    r[:, 0, 3:9] = rng.uniform(-0.5, 0.5, (k, 6))
    r[:, 0, 9] = np.arange(k) - 3                  # three pad records
    o = rng.uniform(-0.2, 0.2, (3, 1, n)).astype(np.float32)
    o[2] -= 3.0
    d = rng.normal(size=(3, 1, n)).astype(np.float32)
    d[2] = np.abs(d[2]) + 1.0
    ok, t = tpk.mt_pairs(torch.as_tensor(r), *map(torch.as_tensor, o),
                         *map(torch.as_tensor, d), dtype=torch.bfloat16)

    c = [_bf16(r[..., j]) for j in range(10)]
    ox, oy, oz, dx, dy, dz = (_bf16(a) for a in (*o, *d))

    def mul(a, b):
        return _bf16(a * b)

    def add(a, b):
        return _bf16(a + b)

    def sub(a, b):
        return _bf16(a - b)
    px = sub(mul(dy, c[8]), mul(dz, c[7]))
    py = sub(mul(dz, c[6]), mul(dx, c[8]))
    pz = sub(mul(dx, c[7]), mul(dy, c[6]))
    det = add(add(mul(c[3], px), mul(c[4], py)), mul(c[5], pz))
    with np.errstate(divide="ignore"):
        invd = _bf16(np.float32(1.0) / np.where(det == 0, 1, det)
                     .astype(np.float32))
    tx, ty, tz = sub(ox, c[0]), sub(oy, c[1]), sub(oz, c[2])
    u = mul(add(add(mul(tx, px), mul(ty, py)), mul(tz, pz)), invd)
    qx = sub(mul(ty, c[5]), mul(tz, c[4]))
    qy = sub(mul(tz, c[3]), mul(tx, c[5]))
    qz = sub(mul(tx, c[4]), mul(ty, c[3]))
    v = mul(add(add(mul(dx, qx), mul(dy, qy)), mul(dz, qz)), invd)
    tt = mul(add(add(mul(c[6], qx), mul(c[7], qy)), mul(c[8], qz)), invd)
    want = ((det > 0) & (u >= 0) & (u <= 1) & (v >= 0) & (add(u, v) <= 1)
            & (tt > 0) & (c[9] >= 0) & (tt < np.float32(3.0e38)))
    np.testing.assert_array_equal(ok.numpy(), want)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(t.numpy()[want], tt[want])
    assert (t.numpy()[~want] == np.float32(tpk.BIG)).all()


def test_render_image_bf16_kd_route_matches_jax(terrain):  # noqa: F811
    """The bf16 frame on the kd route against the JAX package's: the share
    of equal pixels (allclose, rtol 1e-5, atol 1e-6) is at least the share
    between the JAX package's own bf16 and f32 images."""
    cam = JCamera.create(position=POS, forward=FWD)

    def jax_image(precision):
        opts = jint.RenderOptions(width=64, height=64, intersector="packet",
                                  packet_tile=1024, precision=precision)
        return np.asarray(jint.render_image(terrain["js"], cam, opts,
                                            tree=terrain["jt"]))
    ref_bf, ref_f32 = jax_image("bf16"), jax_image("f32")
    img = render_image(terrain["scene"], Camera.create(POS, FWD, device=CPU),
                       RenderOptions(width=64, height=64, packet_tile=1024,
                                     precision="bf16"),
                       tree=terrain["tree"]).numpy()
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()

    def same(a, b):
        return float(np.isclose(a, b, rtol=1e-5, atol=1e-6).all(axis=-1)
                     .mean())
    assert same(img, ref_bf) >= same(ref_bf, ref_f32), (
        same(img, ref_bf), same(ref_bf, ref_f32))


def test_windows_route_ignores_precision(terrain):  # noqa: F811
    cam = Camera.create(POS, FWD, device=CPU)
    imgs = [render_image(terrain["scene"], cam,
                         RenderOptions(width=64, height=64, precision=p),
                         terrain["mwin"]) for p in ("f32", "bf16")]
    assert torch.equal(imgs[0], imgs[1])


@pytest.mark.parametrize("where", ["render_image", "traverse_packet",
                                   "packet_stream"])
def test_unknown_precision_raises(terrain, where):  # noqa: F811
    o = torch.zeros((4096, 3))
    d = torch.ones((4096, 3))
    if where == "render_image":
        with pytest.raises(ValueError, match="precision"):
            render_image(terrain["scene"], Camera.create(POS, FWD,
                                                         device=CPU),
                         RenderOptions(width=64, height=64, precision="fp16"),
                         tree=terrain["tree"])
    elif where == "traverse_packet":
        with pytest.raises(ValueError, match="precision"):
            tpk.traverse_packet(terrain["tree"], o, d, precision="fp16")
    else:   # the preview takes no SO rows
        args, kw, _ = tpk.stream_kernel_args(terrain["tree"], o, d,
                                             shared_origin=True)
        with pytest.raises(ValueError, match="bf16 preview"):
            tpk.packet_stream(*args, precision="bf16", **kw)
