"""clpathtracer_tpu_torch: the PyTorch + CUDA port of clpathtracer_tpu.

The port keeps the JAX package's module paths and function names, so each
function's counterpart is found at the same place in `clpathtracer_tpu/`.
It imports torch and numpy, never jax or flax. Every function takes its
device from its tensor arguments or from an explicit `device` argument;
nothing picks a device on its own.

It covers normal, mirror and path (no NEE) rendering on the window
engine: pinhole or jittered primary rays through the gate prepass and the
super-list kernel's shared-origin form, Morton-sorted bounce bundles
through the bundle prepass and its general Moller-Trumbore form
(ops/csrc/plist_super.cu on the GPU, the plain torch versions on the
CPU), fused winner resolution and the modes' shading.
"""

from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.scene.scene import Scene

__all__ = ["Camera", "Scene"]
