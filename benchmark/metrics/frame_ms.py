"""frame_ms: the window's length over the frames completed in it (every
frame dispatched when the previous one's image is on the host)."""


def read(r):
    return 1000.0 * r.window_s / r.frames if r.frames else None
