"""build_s: the host builds of set-up (the scene and its baked shading
rows, the windows, the grid or shadow tree, the light table), each a span
of the harness that synchronises the device at its end."""

STAGES = ("scene", "windows", "grid", "shadow_tree", "light_table")


def read(r):
    got = [r.builds[s] for s in STAGES if s in r.builds]
    return sum(got) if got else None
