"""torch_ops_ms: device time a frame of the kernels that are not the
port's own (every __global__ of its CUDA sources is): the layers without
a hand-written kernel, rays, gate prepass, bounce sort, light sampling,
resolve and shading, a traced frame's mean. Copies and sets are not
kernels and not counted."""


def read(r):
    if r.trace is None or not r.traced_frames:
        return None
    sec = sum(s for name, (_, s) in r.trace.ops.items()
              if not name.startswith(("Memcpy", "Memset"))
              and not r.trace.is_port_kernel(name))
    return 1000.0 * sec / r.traced_frames if sec > 0 else None
