"""Port parity, the command line and its utilities: cli/main.py (render,
orbit, fly, view, info) on the CPU against the port's render_image and
the JAX package's info, the fly camera against the JAX package's,
render/debug.py against W1 and K3 (their plain versions), and
utils/errors.py, utils/profiling.py, utils/device.py. The JAX side is numpy
and host builds only (no frame, no walk, no Pallas call)."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel import sah as jsah
from clpathtracer_tpu.cli import main as jmain
from clpathtracer_tpu.core import camera as jcam
from clpathtracer_tpu.core import physics as jphys
from clpathtracer_tpu.render import debug as jdebug
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu.utils import profiling as jprof
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import sah
from clpathtracer_tpu_torch.accel.grid import build_grid
from clpathtracer_tpu_torch.cli.main import main
from clpathtracer_tpu_torch.core import physics
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops import plist
from clpathtracer_tpu_torch.ops.packet import traverse_packet
from clpathtracer_tpu_torch.ops.traverse_fast import traverse_fast
from clpathtracer_tpu_torch.render import debug
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      light_cdf, render_image)
from clpathtracer_tpu_torch.scene.cache import load_models
from clpathtracer_tpu_torch.utils import device as tdevice
from clpathtracer_tpu_torch.utils import errors, profiling
from clpathtracer_tpu_torch.utils.png import encode_png, tonemap

torch.set_num_threads(2)
CPU = torch.device("cpu")

CUBE_OBJ = """\
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
# a lit box: the cube's faces with an emissive top, for path mode and NEE
LAMP_MTL = "newmtl lamp\nKd 0.2 0.2 0.2\nKe 4.0 4.0 4.0\n"
VIEW = ["--position", "0.5", "0.5", "-1.5", "--forward", "0", "0", "1"]
SCRIPT = [{"duration": 0.25, "move": [0, 0, 1], "walk": True},
          {"duration": 0.25, "look": [1.0, 0.0], "zoom": 1.0},
          {"duration": 0.25, "move": [1, 1, 0], "sprint": True,
           "look": [0.0, -0.5]}]


@pytest.fixture
def cube_obj(tmp_path):
    p = tmp_path / "cube.obj"
    p.write_text(CUBE_OBJ)
    return str(p)


@pytest.fixture
def lamp_obj(tmp_path):
    (tmp_path / "lamp.mtl").write_text(LAMP_MTL)
    lines = CUBE_OBJ.splitlines()
    # the top face (f 3 7 8 4) emits
    text = "\n".join(["mtllib lamp.mtl"] + lines[:12] + ["usemtl lamp"]
                     + lines[12:13] + ["usemtl none"] + lines[13:]) + "\n"
    p = tmp_path / "lamp.obj"
    p.write_text(text)
    return str(p)


def _png(img, gamma=1.0):
    return encode_png(tonemap(img.numpy(), gamma=gamma))


def test_info_json_matches_jax(cube_obj, capsys):
    main(["info", cube_obj, "--json", "--cpu", "--no-cache"])
    got = json.loads(capsys.readouterr().out)
    jmain.main(["info", cube_obj, "--json", "--no-cache"])
    ref = json.loads(capsys.readouterr().out)
    assert got.keys() == ref.keys()
    for k in ("bounds_lo", "bounds_hi"):
        np.testing.assert_allclose(got.pop(k), ref.pop(k), atol=1e-6)
    assert got == ref


@pytest.mark.parametrize("route", ["wavefront", "packet", "no_tree"])
def test_render_writes_render_image_png(cube_obj, tmp_path, route):
    """render --cpu writes the bytes of write_png(tonemap(render_image()))
    with the structures the JAX package's _load builds: the tree (W1's
    plain version), windows with SO tables and resolve rows (K1's), or
    none (--no-tree: the flat scan W2's)."""
    out = str(tmp_path / f"{route}.png")
    flags = (["--no-tree"] if route == "no_tree"
             else ["--intersector", route])
    s = main(["render", cube_obj, "--cpu", "--width", "32", "--height", "32",
              "--sphere", "0.5", "0.5", "-0.5", "0.2", "--out", out,
              *VIEW, *flags])
    assert s.intersector == ("wavefront" if route == "no_tree" else route)
    scene, tree, _ = load_models([cube_obj], device=CPU)
    sp = torch.tensor([[0.5, 0.5, -0.5]])
    scene = scene.replace(sphere_pos=sp, sphere_radius=torch.tensor([0.2]),
                          sphere_albedo=torch.full((1, 3), 0.75),
                          sphere_emission=torch.zeros(1, 3))
    kw = {}
    if route != "no_tree":
        kw["tree"] = tree
    if route == "packet":
        assert s.win_rows == 16
        mwin = plist.build_morton_windows(scene.tri_corners(), 16,
                                          device=CPU)
        kw["mwin"] = plist.attach_resolve(plist.attach_so(mwin),
                                          scene.shade_rows)
    assert {k for k, v in s.structures.items() if v is not None} == set(kw)
    cam = Camera.create([0.5, 0.5, -1.5], [0, 0, 1.0], device=CPU)
    opts = RenderOptions(width=32, height=32, intersector=s.intersector)
    img = render_image(scene, cam, opts, **kw)
    assert torch.equal(s.image, img)
    assert open(out, "rb").read() == _png(img)
    assert (img < 1.0).any()


def test_render_path_nee_structures(lamp_obj, tmp_path):
    """Path mode builds the shadow tree on a surface mesh (a grid on a
    fog-like one) and NEE's light table, and draws from one generator
    seeded with --seed."""
    out = str(tmp_path / "p.png")
    args = ["render", lamp_obj, "--cpu", "--width", "16", "--height", "16",
            "--mode", "path", "--nee", "--background", "0", "--seed", "3",
            "--out", out, *VIEW]
    s = main(args)
    assert s.structures["grid"] is None and s.structures["shadow"] is not None
    scene, tree, _ = load_models([lamp_obj], device=CPU)
    shadow = sah.build_shadow_tree(scene.tri_corners(), device=CPU)
    cam = Camera.create([0.5, 0.5, -1.5], [0, 0, 1.0], device=CPU)
    opts = RenderOptions(width=16, height=16, mode="path", nee=True,
                         background=0.0)
    img = render_image(scene, cam, opts, tree=tree, shadow=shadow,
                       lights=light_cdf(scene),
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(s.image, img)
    assert open(out, "rb").read() == _png(img, gamma=2.2)
    assert float(img.mean()) > 0.0
    # a fog-like scene takes the grid instead
    soup = jproc.random_tri_soup(12_000, seed=1, extent=1.0, tri_size=0.05)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}"
             for x, y, z in np.asarray(soup.verts)]
    lines += [f"f {a + 1} {b + 1} {c + 1}"
              for a, b, c in np.asarray(soup.faces)[:, :, 0]]
    fog = tmp_path / "fog.obj"
    fog.write_text("\n".join(lines) + "\n")
    s2 = main(["render", str(fog), "--cpu", "--width", "32", "--height", "16",
               "--mode", "path", "--out", str(tmp_path / "f.png"),
               "--intersector", "packet", "--position", "0", "0", "-3"])
    assert s2.structures["shadow"] is None and s2.win_rows == 8
    want = build_grid(s2.scene.tri_corners(), device=CPU)
    assert torch.equal(s2.structures["grid"].table, want.table)


def test_orbit_and_fly_write_frames(cube_obj, tmp_path):
    d = str(tmp_path / "orbit")
    s = main(["orbit", cube_obj, "--cpu", "--width", "16", "--height", "16",
              "--frames", "2", "--out-dir", d])
    assert sorted(os.listdir(d)) == ["frame_0000.png", "frame_0001.png"]
    assert s.outputs == [os.path.join(d, f) for f in sorted(os.listdir(d))]
    script = tmp_path / "script.json"
    script.write_text(json.dumps(SCRIPT[:2]))
    d = str(tmp_path / "fly")
    main(["fly", cube_obj, "--cpu", "--script", str(script), "--fps", "8",
          "--width", "16", "--height", "16", "--out-dir", d,
          "--position", "0.5", "0.5", "-2.0"])
    assert len(os.listdir(d)) == 4  # 2 segments x 0.25 s x 8 fps


def test_sharded_raises_naming_the_queue_item(cube_obj, tmp_path):
    """--sharded no longer raises: on its own the command forms a world of
    1 (gloo with --cpu), renders through make_sharded_renderer and writes
    the unsharded command's PNG bytes, then ends the group it formed."""
    out = {}
    for flag in ((), ("--sharded",)):
        out[flag] = str(tmp_path / f"s{len(flag)}.png")
        s = main(["render", cube_obj, "--cpu", "--width", "32", "--height",
                  "16", *flag, "--out", out[flag]])
        assert (s.renderer is not None) == bool(flag)
    with open(out[()], "rb") as a, open(out[("--sharded",)], "rb") as b:
        assert a.read() == b.read()
    assert not torch.distributed.is_initialized()


def test_without_cuda_exits_naming_cuda(cube_obj, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run on it")
    for cmd in (["render", cube_obj, "--out", str(tmp_path / "x.png")],
                ["info", cube_obj]):
        with pytest.raises(SystemExit) as e:
            main(cmd)
        assert e.value.code not in (0, None) and "CUDA" in str(e.value.code)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.pick_device("gpu")
    assert not os.path.exists(tmp_path / "x.png")


def _viewer(cube_obj, monkeypatch):
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    from clpathtracer_tpu_torch.cli.viewer import run_viewer
    scene, tree, _ = load_models([cube_obj], device=CPU)
    fc = run_viewer(scene, RenderOptions(width=16, height=16),
                    position=(0.5, 0.5, -2.0), tree=tree)
    return fc, plt


def test_viewer_headless(cube_obj, monkeypatch):
    """The viewer builds, renders a frame and moves under the Agg backend
    (tests/test_cli.py's test, on the port)."""
    fc, plt = _viewer(cube_obj, monkeypatch)
    fig = plt.gcf()
    from matplotlib.backend_bases import KeyEvent
    p0 = fc.position.copy()
    KeyEvent("key_press_event", fig.canvas, "w")._process()
    assert fc.position[2] > p0[2]
    fc.move = np.array([0.0, 0.0, 1.0])
    fc.step(0.1)
    assert fc.position[2] > p0[2] + 0.5
    plt.close(fig)


def test_viewer_mouse_look(cube_obj, monkeypatch):
    fc, plt = _viewer(cube_obj, monkeypatch)
    from matplotlib.backend_bases import MouseEvent
    fig = plt.gcf()
    yaw0, pitch0 = fc.yaw, fc.pitch
    (x0, y0), (x1, y1) = fig.axes[0].bbox.get_points()
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    MouseEvent("button_press_event", fig.canvas, cx, cy, button=1)._process()
    MouseEvent("motion_notify_event", fig.canvas, cx + 40, cy + 25)._process()
    MouseEvent("button_release_event", fig.canvas, cx + 40, cy + 25,
               button=1)._process()
    assert fc.yaw > yaw0 and fc.pitch > pitch0      # drag up pitches up
    yaw1 = fc.yaw
    MouseEvent("motion_notify_event", fig.canvas, cx + 80, cy)._process()
    assert fc.yaw == yaw1
    plt.close(fig)


def test_fly_camera_matches_jax():
    """A script of moves, sprint, walk, looks and zooms: the same
    positions, forward vectors and FOV as the JAX FlyCamera (within
    1e-12), and the same Camera fields."""
    fcs = [physics.FlyCamera(position=np.array([0.5, 0.5, -2.0])),
           jphys.FlyCamera(position=np.array([0.5, 0.5, -2.0]))]
    dt = 1.0 / 8.0
    for seg in SCRIPT * 2:
        for fc in fcs:
            fc.move = np.asarray(seg.get("move", [0, 0, 0]), np.float64)
            fc.sprint = bool(seg.get("sprint", False))
            fc.walk = bool(seg.get("walk", False))
        for _ in range(3):
            for fc in fcs:
                fc.look(*(np.asarray(seg.get("look", [0.0, 0.0])) * dt))
                if seg.get("zoom"):
                    fc.zoom(seg["zoom"] * dt)
                fc.step(dt)
            got, ref = fcs
            np.testing.assert_allclose(got.position, np.asarray(ref.position),
                                       rtol=0, atol=1e-12)
            np.testing.assert_allclose(got.forward, ref.forward, rtol=0,
                                       atol=1e-12)
            assert got.fov == ref.fov and got.pitch == ref.pitch
    cam, jc = fcs[0].camera(device=CPU), fcs[1].camera()
    for f in ("position", "forward", "fov", "near", "far"):
        np.testing.assert_array_equal(getattr(cam, f).numpy(),
                                      np.asarray(getattr(jc, f)), f)
    np.testing.assert_array_equal(
        physics.phys_step({"p": np.ones(3)}, {"p": np.arange(3.0)}, 0.5)["p"],
        np.asarray(jphys.phys_step(jnp.ones(3), jnp.arange(3.0), 0.5)))


@pytest.fixture(scope="module")
def terrain():
    js = jproc.terrain_mesh(4_000, seed=0, extent=10.0)
    tv = np.asarray(js.tri_corners())
    jt = jsah.build_kd_tree(tv, max_depth=10, leaf_size=32, tri_block=4)
    tt = interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                 jt.chunk_start, jt.chunk_bnd, None,
                                 jt.max_leaf_tris, device=CPU)
    pos, fwd = [0.0, 14.0, 0.0], [0.3, -1.0, 0.2]
    jc = jcam.Camera.create(position=pos, forward=fwd)
    cam = interop.camera_from_numpy(jc.position, jc.forward, jc.fov, jc.near,
                                    jc.far, device=CPU)
    return dict(js=js, jt=jt, tt=tt, jc=jc, cam=cam)



def test_traversal_steps_are_w1_steps(terrain):
    """The steps image is W1's rec["steps"] on the primaries (whose steps
    test_torch_walk.py holds to the JAX walk's); the report's stats are
    the tree's, the heatmap's colors the JAX package's."""
    opts = RenderOptions(width=32, height=32)
    tt = terrain["tt"]
    img = debug.traversal_steps_image(None, terrain["cam"], opts, tt)
    from clpathtracer_tpu_torch.core.camera import cam_matrix, generate_rays
    o, d = generate_rays(cam_matrix(terrain["cam"], 32), 32, 32)
    rec = traverse_fast(tt, o, d)
    assert torch.equal(img, rec["steps"].reshape(32, 32))
    jt = terrain["jt"]
    rep = debug.traversal_report(None, terrain["cam"], opts, tt)
    assert rep["max_steps_per_ray"] == int(img.max())
    assert rep["mean_steps_per_ray"] == float(img.float().numpy().mean())
    assert rep["tree_nodes"] == tt.stats()["nodes"] == jt.stats()["nodes"]
    np.testing.assert_array_equal(debug.colorize_heatmap(img),
                                  jdebug.colorize_heatmap(img.numpy()))


def test_packet_tile_image_is_k3_tile_stats(terrain):
    opts = RenderOptions(width=32, height=16, packet_tile=256)
    tt = terrain["tt"]
    chunks = debug.packet_tile_image(None, terrain["cam"], opts, tt)
    from clpathtracer_tpu_torch.core.camera import cam_matrix, generate_rays
    o, d = generate_rays(cam_matrix(terrain["cam"], 16), 32, 16)
    rec = traverse_packet(tt, o, d, (16, 32), tile=256)
    assert chunks.shape == (1, 2)
    assert torch.equal(chunks.reshape(-1), rec["tile_stats"][:, 1])
    assert float(chunks.sum()) > 0 and (rec["tile_stats"][:, 2] == 256).all()
    with pytest.raises(ValueError, match="square"):
        debug.packet_tile_image(None, terrain["cam"], RenderOptions(
            64, 64, packet_tile=512), tt)


def test_checked_and_validate_image():
    f = errors.checked(lambda x: {"img": torch.log(x), "n": 3})
    f(torch.ones(4))
    with pytest.raises(FloatingPointError, match=r"output\['img'\]"):
        f(-torch.ones(4))
    errors.validate_image(torch.ones(4, 4, 3))
    for bad, msg in ((np.array([[np.nan]]), "non-finite"),
                     (np.array([[-0.5]]), "negative")):
        with pytest.raises(FloatingPointError, match=msg):
            errors.validate_image(bad)
    prev = torch.is_anomaly_enabled()
    with errors.debug_nans(True):
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == prev


def test_profiling_matches_jax_format():
    for mod in (profiling, jprof):
        t = mod.StageTimer()
        with t.stage("a"):
            pass
        with t.stage("a"):
            pass
        assert list(t.report()) == ["a"] and t.report()["a"] >= 0
    inv = tdevice.device_inventory()
    assert inv[-1]["platform"] == "cpu"
    assert tdevice.pick_device("cpu") == tdevice.host_cpu() == CPU
