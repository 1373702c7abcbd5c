"""g1_ms: device time a frame of G1, grid_dda_kernel (ops/csrc/
grid_dda.cu), launched by ops/grid_walk.py::traverse_grid."""

PATTERN = r"grid_dda_kernel"
COUNTER = "clpathtracer_tpu_torch.ops.grid_walk:traverse_grid.launches"


def read(r):
    return r.device_ms(PATTERN)
