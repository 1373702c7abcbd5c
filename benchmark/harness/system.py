"""The system under test: clpathtracer_tpu_torch's render_image on the
structures that its command line's load rule (cli/main.py::_load) gives
the scene and mode, and a frame as its viewer makes one (cli/viewer.py):
render_image, then the image copied to the host.

The rule: Morton windows with shared-origin tables and fused resolve
rows, at win_rows 8 on a fog-like scene (fog_likeness > 0.5), else 16;
in path mode the uniform grid on a fog-like scene, else the shadow tree
(leaf 16, depth 26); with NEE the light table. The depth-15 kd tree that
the command line's model loader always builds is not built: no
whole-gate frame reads it."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import inputs


class System:
    """Built once a run from the scene arrays; frame(k) renders frame k.
    builds: the set-up stages' seconds (host clock, the device synchronised
    at each stage's end)."""

    def __init__(self, arrays: dict, cell, seed: int, device, timer):
        from clpathtracer_tpu_torch import Camera
        from clpathtracer_tpu_torch.accel.grid import build_grid, fog_likeness
        from clpathtracer_tpu_torch.accel.sah import build_shadow_tree
        from clpathtracer_tpu_torch.ops import plist
        from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                              light_cdf)
        from clpathtracer_tpu_torch.scene.scene import Scene

        tr, cam = cell.traffic, cell.config["camera"]
        self.device = device
        with timer.stage("scene", device):
            faces = np.full((len(arrays["faces"]), 3, 3), -1, np.int32)
            faces[:, :, 0] = arrays["faces"]
            scene = Scene.create(arrays["verts"], faces,
                                 emission=arrays["emission"], device=device)
            scene = scene.bake_shading()
        tv = scene.tri_corners()
        fog = fog_likeness(tv) > 0.5
        self.win_rows = 8 if fog else 16
        self.structures = dict(grid=None, shadow=None, lights=None)
        with timer.stage("windows", device):
            mwin = plist.build_morton_windows(tv, win_rows=self.win_rows,
                                              device=device)
            self.mwin = plist.attach_resolve(plist.attach_so(mwin),
                                             scene.shade_rows)
        if tr["mode"] == "path":
            if fog:
                with timer.stage("grid", device):
                    self.structures["grid"] = build_grid(tv, device=device)
            else:
                with timer.stage("shadow_tree", device):
                    self.structures["shadow"] = build_shadow_tree(
                        tv, device=device)
            if tr["nee"]:
                with timer.stage("light_table", device):
                    self.structures["lights"] = light_cdf(scene)
        self.scene = scene
        self.opts = RenderOptions(
            width=tr["width"], height=tr["height"], mode=tr["mode"],
            bounces=tr["bounces"], spp=tr["spp"], background=tr["background"],
            nee=tr["nee"], intersector="packet")
        self.cameras = [Camera.create(*inputs.pose(cam, seed, j),
                                      fov=cam["fov"],
                                      device=device)
                        for j in range(int(cam["poses"]))]
        with timer.stage("draws", device):
            self.draws = inputs.draws_pool(tr, seed, device)

    def render(self, k: int):
        """Frame k's render_image call: the image on the device."""
        from clpathtracer_tpu_torch.render.integrator import render_image
        d = inputs.frame_draws(self.draws, k)
        return render_image(self.scene, self.cameras[k % len(self.cameras)],
                            self.opts, self.mwin, **self.structures,
                            jitter=d.get("jitter"), bounce=d.get("bounce"),
                            light=d.get("light"))

    def free(self):
        """Drop the program's state (scene, structures), keeping the draws,
        which are the benchmark's inputs."""
        self.scene = self.mwin = self.cameras = None
        self.structures = {}
