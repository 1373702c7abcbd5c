"""k1_ms: device time a frame of K1, the shared-origin form of
plist_super_kernel (ops/csrc/plist_super.cu, template kMT = false),
launched by ops/plist.py::plist_super."""

PATTERN = r"plist_super_kernel<false"
COUNTER = "clpathtracer_tpu_torch.ops.plist:plist_super.launches"


def read(r):
    return r.device_ms(PATTERN)
