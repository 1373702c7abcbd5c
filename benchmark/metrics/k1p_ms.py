"""k1p_ms: device time a frame of K1', the Moller-Trumbore form of
plist_super_kernel (template kMT = true) on sorted bounce bundles,
launched by ops/plist.py::plist_super_mt."""

PATTERN = r"plist_super_kernel<true"
COUNTER = "clpathtracer_tpu_torch.ops.plist:plist_super_mt.launches"


def read(r):
    return r.device_ms(PATTERN)
