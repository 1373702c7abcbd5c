"""The port stands alone: it imports and renders (windows and kd-tree
routes; the legacy, wide, stream2 and mxu engines, accel/wide.py and
ops/packet_mxu.py; the window, gathered and sub-gate schedules; path
tracing with NEE over the uniform grid, the two-phase primaries,
differentiable rendering and a train step) with jax
and flax blocked, no file of it or of
chip_smoke.py
imports either or the JAX package, and its kernel loader fails clearly
where there is no CUDA toolkit."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from clpathtracer_tpu_torch.ops import _cuda

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "clpathtracer_tpu_torch"

_RENDER_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
torch.set_num_threads(2)
import clpathtracer_tpu_torch
from clpathtracer_tpu_torch.ops import plist
from clpathtracer_tpu_torch.render.integrator import RenderOptions, render_image
from clpathtracer_tpu_torch.scene.procedural import two_triangles
cpu = torch.device("cpu")
scene = two_triangles(device=cpu).bake_shading()
mwin = plist.build_morton_windows(scene.tri_corners(), device=cpu)
mwin = plist.attach_resolve(plist.attach_so(mwin), scene.shade_rows)
cam = clpathtracer_tpu_torch.Camera.create([0.0, 0.0, -1.5], [0.0, 0.0, 1.0],
                                           device=cpu)
img = render_image(scene, cam, RenderOptions(width=32, height=32), mwin)
assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
hit = (img < 1.0).any(dim=-1)
assert 0 < int(hit.sum()) < 32 * 32
mirror = render_image(scene, cam,
                      RenderOptions(width=32, height=32, mode="mirror"), mwin)
assert bool(torch.isfinite(mirror).all())
# a mirror bounce off the near triangle leaves the scene (white blend)
assert bool((mirror[hit] != img[hit]).any())
assert torch.equal(mirror[~hit], img[~hit])
# the kd-tree route: the port's native builder and K3's plain version
from clpathtracer_tpu_torch.accel import sah
tree = sah.attach_so_tables(sah.build_kd_tree(scene.tri_corners(),
                                              device=cpu))
for mode, ref in (("normal", img), ("mirror", mirror)):
    kd = render_image(scene, cam, RenderOptions(width=32, height=32,
                                                intersector="packet",
                                                mode=mode, packet_tile=256),
                      tree=tree)
    assert torch.allclose(kd, ref, atol=1e-6), mode
# the legacy and wide engines (K6a, K9 plain) on a tree with a wide table
from clpathtracer_tpu_torch.accel import wide
from clpathtracer_tpu_torch.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu_torch.ops import packet
wtree = sah.build_kd_tree(scene.tri_corners(), leaf_size=8, device=cpu)
assert wtree.wide_table is not None
assert torch.equal(wtree.wide_table, torch.as_tensor(
    wide.build_wide_table(wtree)))
o, d = generate_rays(cam_matrix(cam, 32), 32, 32)
from clpathtracer_tpu_torch.ops import packet_mxu
hits = [packet.traverse_packet(wtree, o, d, (32, 32), 256,
                               engine=e)["hit"].reshape(32, 32)
        for e in ("auto", "legacy", "wide", "stream2", "mxu")]
assert all(torch.equal(h, hit) for h in hits)
# the windows route's other schedules: K2, K10 and K11 (plain versions)
recs = [plist.traverse_plist(mwin, o, d, (32, 32), supers=False),
        plist.traverse_plist(mwin, o, d, (32, 32), gathered=True),
        plist.traverse_plist4(mwin, o, d, (32, 32))]
assert all(torch.equal(r["hit"].reshape(32, 32), hit) for r in recs)
# path tracing with NEE over the uniform grid (G1's plain version) on the
# Cornell box, and the two-phase primaries (K1's kcap form, then G1)
from clpathtracer_tpu_torch.accel.grid import build_grid
from clpathtracer_tpu_torch.scene.procedural import cornell_box
box = cornell_box(device=cpu).bake_shading()
bwin = plist.attach_resolve(plist.attach_so(plist.build_morton_windows(
    box.tri_corners(), device=cpu)), box.shade_rows)
grid = build_grid(box.tri_corners(), device=cpu)
nee = render_image(box, cam, RenderOptions(width=32, height=32, mode="path",
                                           nee=True, background=0.0),
                   bwin, grid=grid)
assert bool(torch.isfinite(nee).all()) and float(nee.mean()) > 0.0
two = plist.traverse_plist(bwin, o, d, (32, 32), kcap=1, grid=grid)
assert torch.equal(two["hit"], plist.traverse_plist(bwin, o, d,
                                                    (32, 32))["hit"])
assert packet_mxu.mxu_rows_from_quads(wtree.tris).shape[1] == 512
# a differentiable edge-aware frame's gradient and a train step on the tree
from clpathtracer_tpu_torch.parallel.train import make_train_step
d_opts = RenderOptions(width=32, height=32, differentiable=True,
                       edge_aware=True)
verts = scene.verts.clone().requires_grad_(True)
render_image(scene.with_verts(verts), cam, d_opts,
             tree=tree).mean().backward()
assert bool(torch.isfinite(verts.grad).all()) and bool(verts.grad.any())
step, init = make_train_step(scene, d_opts, lambda p: torch.optim.SGD(
    p.values(), lr=1e-3), tree=tree)
state, loss = step(init(), cam, img)
assert float(loss) > 0.0
assert not any(m.split(".")[0] in ("jax", "jaxlib", "flax",
                                   "clpathtracer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("rendered", int(hit.sum()))
"""


def test_imports_and_renders_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _RENDER_WITHOUT_JAX],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("rendered")


def test_no_file_imports_jax_or_flax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b", re.M)
    # _build/ holds build outputs, not the package's sources
    files = sorted(f for f in PKG.rglob("*.py")
                   if "_build" not in f.relative_to(PKG).parts)
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert offenders == []


def test_no_file_imports_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+clpathtracer_tpu(\.|\s|$)", re.M)
    files = sorted(f for f in PKG.rglob("*.py")
                   if "_build" not in f.relative_to(PKG).parts)
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())
                 or re.search(r"^\s*(import|from)\s+(jax|flax)\b",
                              f.read_text(), re.M)]
    assert offenders == []


def test_loader_raises_without_nvcc():
    if _cuda.find_nvcc() is not None:
        pytest.skip("a CUDA toolkit is installed: the loader would build")
    with pytest.raises(_cuda.KernelBuildError, match="nvcc not found"):
        _cuda.load_kernels()
