"""The port's parallel layer (parallel/multihost.py, mesh.py, elastic.py,
train.py's mesh step, the CLI's --sharded) on the host: the process-group
set-up with init_process_group monkeypatched; in a spawned world of 4
gloo ranks (rows 4, tests/torch_dist_worker.py) the mesh, the row-sharded
frames bit-equal to render_image, three rows train steps against the
one-device step and the CLI's --sharded PNGs; one JAX call,
render_image_sharded of the Cornell box; the chunked frames in this
process."""

from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.parallel.mesh import render_image_sharded as j_sharded
from clpathtracer_tpu.render.integrator import RenderOptions as JOptions
from clpathtracer_tpu.scene.procedural import cornell_box as j_cornell_box
from clpathtracer_tpu_torch.accel.native import NativeBuildError
from clpathtracer_tpu_torch.accel.sah import build_kd_tree
from clpathtracer_tpu_torch.cli.main import main as cli
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops import plist
from clpathtracer_tpu_torch.ops._cuda import KernelBuildError
from clpathtracer_tpu_torch.parallel import multihost
from clpathtracer_tpu_torch.parallel.elastic import render_frame_chunked
from clpathtracer_tpu_torch.parallel.mesh import default_mesh
from clpathtracer_tpu_torch.parallel.train import make_train_step
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      path_draws,
                                                      render_image)
from clpathtracer_tpu_torch.scene.procedural import cornell_box, icosphere
from torch_dist_worker import WORLD, cli_args, run_world

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_world")
    return tmp, run_world(tmp, "parallel")


@pytest.fixture(scope="module")
def ico():
    scene = icosphere(2, device=CPU).bake_shading()
    mwin = plist.attach_resolve(plist.attach_so(plist.build_morton_windows(
        scene.tri_corners(), device=CPU)), scene.shade_rows)
    cam = Camera.create([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], device=CPU)
    return scene, mwin, cam


@pytest.fixture(scope="module")
def box():
    scene = cornell_box(device=CPU)
    cam = Camera.create([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], device=CPU)
    return scene, build_kd_tree(scene.tri_corners(), device=CPU), cam


@pytest.fixture
def no_group(monkeypatch):
    """torch.distributed with no group formed, init_process_group
    recording its keyword arguments, and no torchrun variables."""
    seen = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return seen


def test_init_reads_torchrun_variables_and_passes_timeout(no_group,
                                                         monkeypatch):
    for k, v in (("RANK", "2"), ("WORLD_SIZE", "4"),
                 ("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234")):
        monkeypatch.setenv(k, v)
    out = multihost.init_distributed(initialization_timeout=17, device="cpu")
    assert no_group == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                        "rank": 2, "world_size": 4,
                        "timeout": timedelta(seconds=17)}
    assert out == {"process_index": 0, "process_count": 1,
                   "local_devices": 1, "global_devices": 1}
    no_group.clear()   # the arguments win over the variables
    multihost.init_distributed("10.0.0.9:99", 8, 5, device="cpu")
    assert (no_group["init_method"], no_group["rank"],
            no_group["world_size"]) == ("tcp://10.0.0.9:99", 5, 8)
    assert no_group["timeout"] == timedelta(seconds=300)


def test_init_forms_a_world_of_one_and_refuses_half_a_world(no_group,
                                                           monkeypatch):
    multihost.init_distributed(device="cpu")
    assert isinstance(no_group["store"], dist.FileStore)
    assert (no_group["backend"], no_group["rank"],
            no_group["world_size"]) == ("gloo", 0, 1)
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="torchrun"):
        multihost.init_distributed(device="cpu")
    if not torch.cuda.is_available():   # the card unless the CPU is asked
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.init_distributed()


def test_init_failure_raises_immediately(no_group, monkeypatch):
    def fail(backend, **kw):
        raise TimeoutError("rendezvous timed out")
    monkeypatch.setattr(dist, "init_process_group", fail)
    with pytest.raises(TimeoutError):
        multihost.init_distributed("10.0.0.1:1", 2, 0, 1, device="cpu")


def test_init_is_idempotent(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("init_process_group on a formed group")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert multihost.init_distributed() == {
        "process_index": 3, "process_count": 4, "local_devices": 1,
        "global_devices": 4}


def test_default_mesh_shapes_and_raises(world):
    _, ranks = world
    for w in ranks:
        np.testing.assert_array_equal(w["shapes"], [[4, 1], [2, 2], [1, 4]])
        assert w["raises3"] == 1 and w["raises_rows"] == 1
    with pytest.raises(RuntimeError, match="init_distributed"):
        default_mesh(device_type="cpu")


@pytest.mark.parametrize("mode", ["normal", "mirror"])
def test_row_sharded_frame_bit_equal(ico, world, mode):
    """Four blocks of 16 rows, one gate each (K1's plain version, K1' on
    the mirror bounce's bundles), gathered on every rank: render_image's
    frame bit for bit."""
    scene, mwin, cam = ico
    ref = render_image(scene, cam, RenderOptions(32, 64, mode=mode),
                       mwin).numpy()
    for w in world[1]:
        np.testing.assert_array_equal(w[mode], ref)


def test_row_sharded_path_frame(world):
    """Path mode: the frame finite and the same on every rank, each block
    drawn from its own stream."""
    ranks = world[1]
    for w in ranks:
        assert np.isfinite(w["path"]).all() and w["path"].mean() > 0.0
        np.testing.assert_array_equal(w["path"], ranks[0]["path"])
    streams = np.stack([w["path_stream"] for w in ranks])
    assert len({s.tobytes() for s in streams}) == WORLD


def test_matches_jax_render_image_sharded(world):
    """The one JAX call: the Cornell box's flat-scan frame, JAX's row-
    sharded render on its 8-device mesh against the port's world of 4,
    within the tie budget of JAX frames (tests/test_torch_render.py)."""
    ref = np.asarray(j_sharded(
        j_cornell_box(), JCamera.create(position=[0.0, 0.0, -1.0],
                                        forward=[0.0, 0.0, 1.0]),
        JOptions(width=16, height=16), key=jax.random.PRNGKey(0)))
    for w in world[1]:
        img = w["box"]
        assert img.shape == ref.shape and np.isfinite(img).all()
        assert (np.abs(img - ref).max(axis=-1) > 1e-5).mean() < 1.5e-2


def test_rows_train_step_matches_one_device(box, world):
    """Three SGD steps on the albedo over 4 row blocks with the full
    frame's draws: each loss within 1e-6 relative of the one-device
    step's, the parameters equal on every rank."""
    scene, tree, cam = box
    ranks = world[1]
    opts = RenderOptions(16, 16, mode="path", bounces=2, background=0.0,
                         differentiable=True)
    draws = path_draws(opts, torch.Generator().manual_seed(3), CPU)
    target = torch.as_tensor(ranks[0]["target"])
    step, init = make_train_step(
        scene, opts, lambda p: torch.optim.SGD(p.values(), lr=0.5),
        tree=tree)
    state = init({"albedo": scene.albedo})
    want = []
    for _ in range(3):
        state, loss = step(state, cam, target, draws)
        want.append(float(loss))
    for w in ranks:
        np.testing.assert_allclose(w["losses"], want, rtol=1e-6, atol=0.0)
        np.testing.assert_array_equal(w["albedo"], ranks[0]["albedo"])
    np.testing.assert_allclose(ranks[0]["albedo"],
                               state.params["albedo"].detach().numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["normal", "mirror"])
def test_cli_sharded_png_equal(world, tmp_path, capsys, mode):
    """render --sharded --cpu in the world of 4: rank 0 wrote a PNG whose
    bytes are the unsharded command's; a height the rows do not divide
    exits naming the flag."""
    tmp, ranks = world
    obj = str(tmp_path / "cube.obj")
    with open(tmp / "cube.obj") as f, open(obj, "w") as g:
        g.write(f.read())
    out = str(tmp_path / "one.png")
    cli(["render", *cli_args(obj, mode), "--out", out])
    with open(out, "rb") as f, open(tmp / f"sharded_{mode}.png", "rb") as g:
        assert f.read() == g.read()
    for w in ranks:
        assert str(w["cli_exit"]) == \
            "--height must be divisible by 4 with --sharded"


def test_chunked_frame_bit_equal(ico):
    scene, mwin, cam = ico
    for mode in ("normal", "mirror"):
        opts = RenderOptions(32, 64, mode=mode)
        img, rep = render_frame_chunked(scene, cam, opts, mwin)
        assert torch.equal(img, render_image(scene, cam, opts, mwin))
        assert rep == {"attempts": {0: 1, 1: 1, 2: 1, 3: 1}, "failed": []}
    with pytest.raises(ValueError, match="row_chunks"):
        render_frame_chunked(scene, cam, RenderOptions(32, 62), mwin)
    # chunks of 15 rows are not whole gates: the windows alone raise
    with pytest.raises(ValueError, match="whole gates"):
        render_frame_chunked(scene, cam, RenderOptions(32, 60), mwin)


def test_chunked_frame_retries_and_fills(ico, capsys):
    """A RuntimeError on chunk 1's first attempt is retried (the same
    image); one on every attempt of chunk 2 exhausts its retries and
    fills it; non-finite pixels count as a failure."""
    scene, mwin, cam = ico
    opts = RenderOptions(32, 64)
    ref = render_image(scene, cam, opts, mwin)

    def once(c, attempt):
        if c == 1 and attempt == 0:
            raise RuntimeError("CUDA error: launch failure (injected)")
    img, rep = render_frame_chunked(scene, cam, opts, mwin, fault_hook=once)
    assert torch.equal(img, ref) and rep["attempts"][1] == 2
    assert rep["failed"] == []

    def always(c, attempt):
        if c == 2:
            raise FloatingPointError("chunk 2: non-finite pixels")
    img, rep = render_frame_chunked(scene, cam, opts, mwin, max_retries=1,
                                    fill_value=-1.0, fault_hook=always)
    assert rep["attempts"][2] == 2 and rep["failed"] == [2]
    assert bool((img[32:48] == -1.0).all())
    assert torch.equal(img[:32], ref[:32]) and torch.equal(img[48:],
                                                           ref[48:])
    assert "chunk 2 attempt 2 failed" in capsys.readouterr().err


@pytest.mark.parametrize("error", [
    ValueError("a caller's error"), KernelBuildError("nvcc failed"),
    NativeBuildError("g++ failed"), NotImplementedError("no route")])
def test_chunked_frame_reraises_at_once(ico, error):
    scene, mwin, cam = ico
    calls = []

    def hook(c, attempt):
        calls.append((c, attempt))
        raise error
    with pytest.raises(type(error)):
        render_frame_chunked(scene, cam, RenderOptions(32, 64), mwin,
                             fault_hook=hook)
    assert calls == [(0, 0)]


def test_chunked_path_frame_is_reproducible(box):
    """Path mode: a retried chunk renders the same pixels (its generator
    is made again from the frame's seed)."""
    scene, tree, cam = box
    opts = RenderOptions(16, 16, mode="path", bounces=2)

    def once(c, attempt):
        if c == 3 and attempt == 0:
            raise RuntimeError("injected")
    a, _ = render_frame_chunked(scene, cam, opts, tree=tree,
                                generator=torch.Generator().manual_seed(7))
    b, rep = render_frame_chunked(scene, cam, opts, tree=tree,
                                  generator=torch.Generator().manual_seed(7),
                                  fault_hook=once)
    assert torch.equal(a, b) and rep["attempts"][3] == 2
    assert bool(torch.isfinite(a).all()) and float(a.mean()) > 0.0
