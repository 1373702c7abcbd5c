"""Interactive viewer: the reference's GLFW window + fly camera, recast
(the port's counterpart of clpathtracer_tpu/cli/viewer.py).

The reference opens an OpenGL window, captures raw mouse for look, WASD
for movement, scroll for FOV zoom, and re-renders every frame
(src/game.c:219-280, src/GLState.c:91-111). The viewer is a matplotlib
window: same control scheme, re-rendering on input instead of per-vsync,
frames through render_image on the scene's device.

Controls (reference bindings, src/game.c:108-171):
  W/A/S/D   move forward/left/back/right      Space/C  up/down
  Shift     sprint (x3)      Ctrl+move        walk (x0.3)
  arrows    look             +/-              FOV zoom
  mouse     drag to look (the reference's raw-mouse capture,
            src/GLState.c:130-133 / src/game.c:181-202, recast as
            motion_notify deltas while a button is held)
  q         quit

Requires matplotlib, imported when the viewer starts, so the library never
needs it; without it run_viewer raises ImportError saying so.
"""

from __future__ import annotations

import time

import numpy as np


def run_viewer(scene, opts, position=(0.0, 0.1, -0.2), fps_cap=30.0,
               generator=None, **structures):
    """Open the viewer window on `scene` and re-render on input. opts:
    RenderOptions; structures: render_image's keyword arguments (mwin,
    tree, grid, shadow, lights); generator: path mode's torch.Generator.
    Returns the FlyCamera when the window closes."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("the viewer needs matplotlib, which is not "
                          "installed; render frames with the render, orbit "
                          "or fly subcommands instead") from e

    from clpathtracer_tpu_torch.core.physics import FlyCamera
    from clpathtracer_tpu_torch.render.integrator import render_image
    from clpathtracer_tpu_torch.utils.png import tonemap

    device = scene.verts.device
    fc = FlyCamera(position=np.asarray(position, np.float64))

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.set_axis_off()
    state = {"dirty": True, "quit": False, "last": time.time()}

    def render_frame():
        img = render_image(scene, fc.camera(device=device), opts,
                           generator=generator, **structures).cpu().numpy()
        gamma = 2.2 if opts.mode == "path" else 1.0
        return tonemap(img, gamma=gamma)

    im = ax.imshow(render_frame(), origin="lower")
    move_keys = {"w": (2, 1), "s": (2, -1), "a": (0, 1), "d": (0, -1),
                 " ": (1, 1), "c": (1, -1)}
    look_keys = {"left": (-0.1, 0), "right": (0.1, 0),
                 "up": (0, -0.1), "down": (0, 0.1)}

    def on_key(event):
        k = (event.key or "").lower()
        base = k.split("+")[-1]
        fc.sprint = "shift" in k
        fc.walk = "ctrl" in k or "control" in k
        if base == "q":
            state["quit"] = True
            plt.close(fig)
            return
        if base in move_keys:
            axis, sgn = move_keys[base]
            fc.move = np.zeros(3)
            fc.move[axis] = sgn
            fc.step(1.0 / 10.0)
            fc.move = np.zeros(3)
            state["dirty"] = True
        elif base in look_keys:
            dx, dy = look_keys[base]
            fc.look(dx, dy)
            state["dirty"] = True
        elif base in ("+", "="):
            fc.zoom(1.0)
            state["dirty"] = True
        elif base == "-":
            fc.zoom(-1.0)
            state["dirty"] = True

    fig.canvas.mpl_connect("key_press_event", on_key)

    # mouse-look: continuous pixel deltas while a button is held — the
    # viewer analogue of the reference's raw mouse capture. Sensitivity
    # matches FlyCamera.look's radians-per-unit scaled by FOV (the
    # reference rescales sensitivity with zoom; fc.look already does).
    drag = {"xy": None}

    def on_press(event):
        if event.button == 1 and event.inaxes is ax:
            drag["xy"] = (event.x, event.y)

    def on_release(event):
        drag["xy"] = None

    def on_motion(event):
        if drag["xy"] is None or event.x is None:
            return
        px, py = drag["xy"]
        drag["xy"] = (event.x, event.y)
        # matplotlib y grows upward; fc.look's dy is pitch-down, so an
        # upward drag (dy > 0) must pass negative dy to look UP (the
        # reference's non-inverted mouse look)
        fc.look((event.x - px) * 0.005, -(event.y - py) * 0.005)
        state["dirty"] = True

    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_motion)

    def on_timer(_=None):
        if state["quit"]:
            return
        if state["dirty"] and time.time() - state["last"] > 1.0 / fps_cap:
            state["dirty"] = False
            state["last"] = time.time()
            im.set_data(render_frame())
            fig.canvas.draw_idle()

    timer = fig.canvas.new_timer(interval=50)
    timer.add_callback(on_timer)
    timer.start()
    plt.show()
    return fc
