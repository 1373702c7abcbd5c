"""Device mesh and row-sharded rendering (port of clpathtracer_tpu/
parallel/mesh.py).

The JAX package lifts the per-pixel data parallelism across chips with a
jax.sharding.Mesh and GSPMD. The port runs one process per device in a
torch.distributed process group (parallel/multihost.py::
init_distributed) and names the same two axes on a torch.distributed.
device_mesh.DeviceMesh:

  "rows":  image rows, pure data parallelism over pixels;
  "scene": treelet sharding of the triangles (parallel/treelet.py).

Every rank renders its own block of rows, render_image's frame cut to
those rows (render/integrator.py::render_rows), and the blocks are
gathered (all_gather_into_tensor) into the frame on every rank. The JAX
package's `replicated` and `row_sharded` sharding objects have no
counterpart: a tensor here lives on its rank and is replicated by
construction.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from clpathtracer_tpu_torch.render.integrator import render_lanes

AXES = ("rows", "scene")
# all_gather_single is newer torch's name for all_gather_into_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def default_mesh(scene_parallel: int = 1, *, device_type: str = None):
    """A DeviceMesh of shape (world // scene_parallel, scene_parallel) named
    ("rows", "scene") over the initialised world, rank = rows_idx *
    scene_parallel + scene_idx. device_type: "cuda" by default (CUDA must
    be present), "cpu" when asked for (gloo). Raises RuntimeError without
    a process group (init_distributed) and ValueError when scene_parallel
    does not divide the world."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("default_mesh: no process group; call parallel."
                           "multihost.init_distributed() first")
    world = dist.get_world_size()
    if scene_parallel < 1 or world % scene_parallel:
        raise ValueError(f"scene_parallel {scene_parallel} does not divide "
                         f"the world of {world} ranks")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("default_mesh: no CUDA device; pass "
                               "device_type='cpu' for a host mesh")
        device_type = "cuda"
    ranks = torch.arange(world).reshape(world // scene_parallel,
                                        scene_parallel)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def axis_size(mesh, name: str) -> int:
    """The number of ranks along the mesh axis `name`."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def _check_rows(opts, n_blocks: int, what: str):
    if opts.height % n_blocks:
        raise ValueError(f"height {opts.height} is not divisible by "
                         f"{n_blocks}, {what}")


def _check_lanes(opts, n_blocks: int, what: str):
    n = opts.width * opts.height
    if n % n_blocks:
        raise ValueError(f"a {opts.width}x{opts.height} frame's {n} pixels "
                         f"are not divisible by {n_blocks}, {what} (the "
                         "JAX package asks the same of its rays' split over "
                         "both mesh axes)")


def block_generator(generator, index: int, device) -> torch.Generator:
    """The generator of block `index`: seeded from one draw of the
    caller's generator (a generator seeded 0 when None) and the index, as
    the JAX package folds the shard index into the key. Every rank draws
    the same base seed from equal generators, so the blocks draw distinct
    streams, and the caller's generator moves on by one draw a frame."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=device).manual_seed(
        (base * 1_000_003 + index) % 2 ** 63)


def render_block(scene, camera, opts, index: int, n_blocks: int,
                 mwin=None, *, tree=None, grid=None, shadow=None,
                 lights=None, generator=None, rays=None):
    """Block `index` of n_blocks equal ranges of render_image's pixels in
    row-major order, [H * W / n_blocks, 3], shaded by render_lanes: whole
    rows (render_rows' block) when n_blocks divides H, else the JAX
    package's flat split of a frame's rays over both mesh axes
    (P(("rows", "scene"))). Path mode draws from block_generator. rays: as
    render_rows'."""
    n = opts.width * opts.height // n_blocks
    gen = (block_generator(generator, index, camera.position.device)
           if opts.mode == "path" else None)
    return render_lanes(scene, camera, opts, index * n, n, mwin, tree=tree,
                        grid=grid, shadow=shadow, lights=lights,
                        generator=gen, rays=rays)


def gather_blocks(block, mesh, over_scene: bool = False):
    """The frame from every rank's block, on every rank: all_gather
    over "scene" (over_scene: the blocks differ along it) and then over
    "rows", in rank order."""
    for axis in (("scene", "rows") if over_scene else ("rows",)):
        size = axis_size(mesh, axis)
        if size > 1:
            out = block.new_empty((size * block.shape[0], *block.shape[1:]))
            _all_gather(out, block.contiguous(), group=mesh.get_group(axis))
            block = out
    return block


def make_sharded_renderer(opts, mesh):
    """Data-parallel renderer: the frame's rows split over the mesh's
    "rows" axis (R ranks), scene and structures replicated.

    Returns render(scene, camera, mwin=None, *, tree=None, grid=None,
    shadow=None, lights=None, generator=None) -> [H, W, 3] on every rank,
    in render_image's terms. The rank at index r on "rows" shades rows
    [r H / R, (r + 1) H / R) of the full frame's rays (render_rows under
    height H / R) and the blocks are gathered over "rows". Normal and
    mirror frames are bit-equal to render_image's. On the windows route a
    block whose height is a multiple of the gate height (ops/plist.py::
    GH) runs exactly the full frame's gates (K1 once a block); a block of
    another height takes the tree route, as render_image would at that
    height (the windows alone raise there). edge_aware's band wraps at
    the block's borders, as in the JAX package's shard_map renderer. Path
    mode draws each block from its own generator (block_generator): the
    image differs from render_image's and has the same distribution.
    H % R raises ValueError. Ranks on the "scene" axis render their
    row's block alike."""
    n_rows = axis_size(mesh, "rows")
    _check_rows(opts, n_rows, "the mesh's 'rows' axis")
    r = mesh.get_local_rank("rows")

    def render(scene, camera, mwin=None, *, tree=None, grid=None,
               shadow=None, lights=None, generator=None):
        blk = render_block(scene, camera, opts, r, n_rows, mwin, tree=tree,
                           grid=grid, shadow=shadow, lights=lights,
                           generator=generator)
        return gather_blocks(blk, mesh).reshape(opts.height, opts.width, 3)

    return render


def make_sharded_packet_renderer(opts, mesh):
    """The JAX package's shard_map form for Pallas calls, which GSPMD
    cannot split. Here every rank already runs its kernels on its own row
    block, so the two renderers are one: make_sharded_renderer."""
    return make_sharded_renderer(opts, mesh)


def render_image_sharded(scene, camera, opts, mwin=None, *, tree=None,
                         grid=None, shadow=None, lights=None, mesh=None,
                         generator=None):
    """One-shot row-sharded render (make_sharded_renderer; mesh None:
    default_mesh())."""
    if mesh is None:
        mesh = default_mesh()
    return make_sharded_renderer(opts, mesh)(
        scene, camera, mwin, tree=tree, grid=grid, shadow=shadow,
        lights=lights, generator=generator)
