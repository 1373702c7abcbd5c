"""Elastic frame submission: chunked rendering with per-chunk retry (port
of clpathtracer_tpu/parallel/elastic.py).

The reference exits on every OpenCL error, so a transient device fault
costs the whole frame. Here a frame is rendered as `row_chunks`
independent row blocks (render/integrator.py::render_rows); a chunk that
raises a RuntimeError (a CUDA launch failure, a torch.cuda error) or
returns non-finite pixels (FloatingPointError) is rendered again, up to
`max_retries` times; a chunk that exhausts its retries is filled with
`fill_value` and reported, and the good chunks are never rendered again.

Unlike the JAX package, which retries any exception, every other error
reaches the caller on its first attempt: a ValueError or TypeError is the
caller's, and a failed kernel or native build (ops/_cuda.py::
KernelBuildError, accel/native::NativeBuildError, both RuntimeErrors),
NotImplementedError and RecursionError are not transient.

A `fault_hook(chunk_index, attempt)` injection point lets tests simulate
a lost device deterministically.
"""

from __future__ import annotations

import sys

import torch

from clpathtracer_tpu_torch.accel.native import NativeBuildError
from clpathtracer_tpu_torch.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu_torch.ops._cuda import KernelBuildError
from clpathtracer_tpu_torch.parallel.mesh import _check_rows, render_block

RETRIED = (RuntimeError, FloatingPointError)
NOT_TRANSIENT = (KernelBuildError, NativeBuildError, NotImplementedError,
                 RecursionError)


class ChunkReport(dict):
    """attempts: {chunk: attempts made}; failed: the chunks that exhausted
    their retries (filled)."""


def render_frame_chunked(scene, camera, opts, mwin=None, *, tree=None,
                         grid=None, shadow=None, generator=None,
                         row_chunks: int = 4, max_retries: int = 2,
                         fill_value: float = 0.0, fault_hook=None):
    """Render the [H, W, 3] frame as `row_chunks` blocks of H / row_chunks
    rows, each through render_rows as the row-sharded renderer renders a
    block (structures as render_image's). Returns (image, ChunkReport).

    Normal and mirror frames are bit-equal to render_image's (on the
    windows route when H / row_chunks is a multiple of the gate height;
    else, as render_image at that height, the tree route). Path mode draws
    chunk c from a generator seeded from one draw of `generator` and c
    (parallel/mesh.py::block_generator), made again for each attempt, so
    a retry renders the same pixels. H % row_chunks raises ValueError."""
    _check_rows(opts, row_chunks, "row_chunks")
    rows = opts.height // row_chunks
    device = camera.position.device
    # the frame's pixel-grid rays, once for every chunk (as the JAX function)
    rays = generate_rays(cam_matrix(camera, opts.height), opts.width,
                         opts.height)
    out = torch.empty((opts.height, opts.width, 3), device=device)
    report = ChunkReport(attempts={}, failed=[])
    if opts.mode == "path":   # one draw of the caller's generator a frame
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device))
    for c in range(row_chunks):
        done = False
        for attempt in range(max_retries + 1):
            report["attempts"][c] = attempt + 1
            gen = (torch.Generator(device=device).manual_seed(seed)
                   if opts.mode == "path" else None)
            try:
                if fault_hook is not None:
                    fault_hook(c, attempt)
                img = render_block(scene, camera, opts, c, row_chunks, mwin,
                                   tree=tree, grid=grid, shadow=shadow,
                                   generator=gen, rays=rays)
                if not bool(torch.isfinite(img).all()):
                    raise FloatingPointError(f"chunk {c}: non-finite pixels")
            except NOT_TRANSIENT:
                raise
            except RETRIED as e:
                print(f"warning: chunk {c} attempt {attempt + 1} failed: "
                      f"{e}", file=sys.stderr)
                continue
            out[c * rows:(c + 1) * rows] = img.reshape(rows, opts.width, 3)
            done = True
            break
        if not done:
            out[c * rows:(c + 1) * rows] = fill_value
            report["failed"].append(c)
    return out, report
