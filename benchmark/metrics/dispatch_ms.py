"""dispatch_ms: the host time of render_image from its call to its return
(its own syncs included, the image's copy to the host not), a frame's
mean over the untraced window (with --trace 1 the window's first half,
before the profiler starts); the harness's own host clock around the
call."""


def read(r):
    return 1000.0 * sum(r.dispatch_s) / len(r.dispatch_s) if r.dispatch_s \
        else None
