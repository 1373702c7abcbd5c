"""clpathtracer_tpu_torch: the PyTorch + CUDA port of clpathtracer_tpu.

The port keeps the JAX package's module paths and function names, so each
function's counterpart is found at the same place in `clpathtracer_tpu/`.
It imports torch and numpy, never jax or flax. Every function takes its
device from its tensor arguments or from an explicit `device` argument;
nothing picks a device on its own.

It covers normal, mirror and path rendering (next-event estimation through
a uniform grid, a shadow tree, the windows or the flat scan), triangles
and spheres, on three routes and the flat scan. The window engine:
pinhole or jittered primary rays through the gate prepass and the
super-list kernel's shared-origin form, Morton-sorted bounce bundles
through the bundle prepass and its general Moller-Trumbore form
(ops/csrc/plist_super.cu), fused winner resolution; the primary gates'
other stream schedules, one sorted entry per window and gathered per-gate
tables (the same source; RenderOptions.plist_schedule), and four 128-ray
sub-gates per gate (ops/csrc/plist_subgate.cu, ops/plist.py::
traverse_plist4). The kd-tree (the native SAH builder, accel/native, or
the Python builder of any tri_block, accel/sah.py): by default the JAX
package's per-ray stackless rope walk (ops/traverse_fast.py,
ops/traverse.py, ops/csrc/ray_walk.cu), with intersector="packet" the
stream packet engine: packet tiles through the strip prepass or window
AABB culls and the stream kernel (ops/csrc/packet_stream.cu),
resolve_tri_hits. ops/packet.py::traverse_packet also runs the JAX
package's other packet engines, which no frame takes: the bf16 preview,
the queue, the v1 legacy and wide walks, the half-split stream2 walk
(ops/csrc/packet_stream2.cu) and the plane-form mxu walk
(ops/packet_mxu.py, ops/csrc/packet_mxu.cu). A uniform grid
(accel/grid.py) passed to render_image carries NEE's shadow rays and the
bounce waves through the per-ray grid DDA (ops/grid_walk.py,
ops/csrc/grid_dda.cu), and with plist_kcap the primary gates' two-phase
engine (K1's kcap form, then the DDA); a walk-tuned shadow tree
(accel/sah.py::build_shadow_tree) passed as shadow= carries them through
the rope walk. Without a structure the flat scan (ops/intersect.py,
ops/csrc/brute_force.cu) traces every wave. The kernels run as CUDA on
the GPU and as their plain torch versions on the CPU.

Differentiable rendering (RenderOptions.differentiable; diff/grad.py):
the same kernels find each wave's hits with no autograd graph, on the
tree, the grid or the flat scan, and one differentiable Moller-Trumbore
per ray against the winner carries gradients to the camera, the vertices,
normals and materials; RenderOptions.edge_aware adds the silhouette term
(diff/edges.py). diff/fd.py checks gradients by finite differences,
diff/checkpoint.py saves and restores a run, and parallel/train.py's
make_train_step takes inverse-rendering steps, on one device or over a
mesh.

The parallel layer (parallel/): one process per device in a
torch.distributed group (multihost.py: NCCL on the cards, gloo on the
host; torchrun's variables or a world of 1) and a DeviceMesh with the
axes ("rows", "scene"); mesh.py splits a frame's rows over the ranks
(render_image_sharded, each block render_image's rows, all-gathered);
elastic.py renders a frame as row chunks with retry; treelet.py splits
the triangles into Morton treelets whose kd-trees a ring of ranks
rotates (send/recv) while each rank walks its rays through the block it
holds (W1 with the running best t as its bound), or one device walks
in turn; a ShardedTree passed as tree= carries every wave.

Model I/O and the command line: scene/objparser.py parses Wavefront OBJ
and MTL files (the native scanner scene/native/obj_native.cpp, built with
g++ at first use); scene/cache.py loads models by extension (.obj, the
reference's .kd through scene/kdformat.py, the port's .torch.kd.npz cache
and the JAX package's .kd.npz) and merges several; utils/png.py writes
frames; core/physics.py steps the fly camera; render/debug.py draws the
walks' step and tile-cost heatmaps; cli/main.py is the command line
(python -m clpathtracer_tpu_torch.cli.main render|orbit|fly|view|info),
on the CUDA device, or the host with --cpu; --sharded over the ranks.
"""

from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.scene.scene import Scene

__all__ = ["Camera", "Scene"]
