"""setup_s: process start to the first timed frame."""


def read(r):
    return r.setup_s
