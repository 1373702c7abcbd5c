"""Edge-aware (silhouette) gradients for primary visibility (port of
clpathtracer_tpu/diff/edges.py).

The estimator lives in render/integrator.py::shade_edgeaware (reachable
through RenderOptions.edge_aware); the rationale is the JAX package's
diff/edges.py docstring. The detached-topology decomposition
(diff/grad.py) gives exact interior gradients and none where the image
changes because a silhouette moves; blending a one-pixel band at the
winners' triangle boundaries toward the continuation ray's shading, with
a weight that moves with the scene, adds that boundary term.
"""

from __future__ import annotations

import dataclasses

from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      render_image)


def render_edgeaware(scene, camera, opts: RenderOptions, mwin=None,
                     **kwargs):
    """[H, W, 3] render whose backward() carries silhouette terms (to
    scene.verts, normals, materials and the camera): render_image with
    differentiable=True and edge_aware=True; the other arguments are
    render_image's."""
    opts_d = dataclasses.replace(opts, differentiable=True, edge_aware=True)
    return render_image(scene, camera, opts_d, mwin, **kwargs)
