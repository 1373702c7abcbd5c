"""w1_ms: device time a frame of W1, ray_walk_kernel (ops/csrc/
ray_walk.cu), launched by ops/traverse_fast.py::ray_walk."""

PATTERN = r"ray_walk_kernel"
COUNTER = "clpathtracer_tpu_torch.ops.traverse_fast:ray_walk.launches"


def read(r):
    return r.device_ms(PATTERN)
