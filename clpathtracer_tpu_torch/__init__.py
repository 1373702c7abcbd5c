"""clpathtracer_tpu_torch: the PyTorch + CUDA port of clpathtracer_tpu.

The port keeps the JAX package's module paths and function names, so each
function's counterpart is found at the same place in `clpathtracer_tpu/`.
It imports torch and numpy, never jax or flax. Every function takes its
device from its tensor arguments or from an explicit `device` argument;
nothing picks a device on its own.

It covers normal, mirror and path (no NEE) rendering on two routes. The
window engine: pinhole or jittered primary rays through the gate prepass
and the super-list kernel's shared-origin form, Morton-sorted bounce
bundles through the bundle prepass and its general Moller-Trumbore form
(ops/csrc/plist_super.cu), fused winner resolution. The kd-tree stream
engine: the native SAH builder (accel/native, accel/sah.py), packet tiles
through the strip prepass or window AABB culls and the stream kernel
(ops/csrc/packet_stream.cu), resolve_tri_hits. ops/packet.py::
traverse_packet also runs the JAX package's other packet engines, which no
frame takes: the bf16 preview, the queue, the v1 legacy and wide walks,
the half-split stream2 walk (ops/csrc/packet_stream2.cu) and the
plane-form mxu walk (ops/packet_mxu.py, ops/csrc/packet_mxu.cu). The
kernels run as CUDA on the GPU and as their plain torch versions on the
CPU.
"""

from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.scene.scene import Scene

__all__ = ["Camera", "Scene"]
