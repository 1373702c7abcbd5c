"""clpathtracer_tpu_torch: the PyTorch + CUDA port of clpathtracer_tpu.

The port keeps the JAX package's module paths and function names, so each
function's counterpart is found at the same place in `clpathtracer_tpu/`.
It imports torch and numpy, never jax or flax. Every function takes its
device from its tensor arguments or from an explicit `device` argument;
nothing picks a device on its own.

This first slice covers the primary-ray frame: pinhole rays, the window
prepass, the super-list kernel (ops/csrc/plist_super.cu on the GPU, its
plain torch version on the CPU), fused winner resolution and
normals-as-color shading.
"""

from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.scene.scene import Scene

__all__ = ["Camera", "Scene"]
