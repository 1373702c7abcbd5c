"""Euler physics stepper and fly-camera controller (the port's
counterpart of clpathtracer_tpu/core/physics.py).

The reference integrates camera motion with a tiny forward-Euler stepper
over registered (position, velocity) pairs (src/physics.c:49-64; the
camera is the only registered object, src/game.c:278) driven by a
WASD/mouse input state machine (src/game.c:108-244). Both are host numpy:

* `phys_step`: pos' = pos + vel * dt over matching nests of arrays or
  tensors (single vectors or batched [N, 3]).
* `FlyCamera`: the game layer's camera state machine as data: move flags
  -> velocity in the camera frame (speed 20, sprint x3, walk x0.3,
  src/game.c:18-29), mouse-look -> spherical forward with pitch clamped
  to +-(pi/2 - eps) (src/game.c:181-202), scroll -> FOV zoom that also
  rescales sensitivity (src/game.c:162-171). The position steps in
  float32, as the JAX package's jnp step rounds it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from clpathtracer_tpu_torch.core.camera import Camera


def phys_step(pos, vel, dt):
    """Forward-Euler integration (reference PhysStep,
    src/physics.c:49-64). pos/vel: matching arrays or tensors, or tuples,
    lists or dicts of them; dt: scalar. Returns the new pos."""
    if isinstance(pos, dict):
        return {k: phys_step(pos[k], vel[k], dt) for k in pos}
    if isinstance(pos, (tuple, list)):
        return type(pos)(phys_step(p, v, dt) for p, v in zip(pos, vel))
    return pos + vel * dt


# --- game-layer constants (reference GameProperties, src/game.c:18-29) ---
SENSITIVITY = 2.0
MOVE_SPEED = 20.0
SPRINT_MODIFIER = 3.0
WALK_MODIFIER = 0.3
PITCH_LIMIT = np.pi / 2 - 1e-4  # reference clamps at +-pi/2 (src/game.c:194)


@dataclasses.dataclass
class FlyCamera:
    """Mutable host-side fly-camera state (the game loop's State struct,
    src/game.c:31-46, reduced to what drives rendering)."""

    position: np.ndarray
    yaw: float = 0.0       # radians; 0 -> +z (the reference's spherical
    pitch: float = 0.0     # mapping, src/game.c:196-200)
    fov: float = np.pi / 3
    near: float = 0.1
    far: float = 1.0
    move: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))  # (right, up, fwd) in {-1,0,1}
    sprint: bool = False
    walk: bool = False

    @property
    def forward(self) -> np.ndarray:
        cp = np.cos(self.pitch)
        return np.array([cp * np.sin(self.yaw), np.sin(self.pitch),
                         cp * np.cos(self.yaw)])

    def look(self, dx: float, dy: float) -> None:
        """Mouse-look: deltas in normalized screen units (reference
        mouse_handler, src/game.c:181-202; sensitivity scales with FOV so
        zooming in slows the look around)."""
        scale = SENSITIVITY * self.fov / (np.pi / 3)
        self.yaw += dx * scale
        self.pitch = float(np.clip(self.pitch - dy * scale,
                                   -PITCH_LIMIT, PITCH_LIMIT))

    def zoom(self, scroll: float) -> None:
        """Scroll-to-zoom (reference scroll_handler, src/game.c:162-171)."""
        self.fov = float(np.clip(self.fov * (0.9 ** scroll), 0.01,
                                 np.pi - 0.01))

    def velocity(self) -> np.ndarray:
        """World-space velocity from the move flags (reference move-key ->
        camVel block, src/game.c:224-238): forward/right in the horizontal
        plane, up along world +y."""
        f = self.forward
        fwd_flat = np.array([f[0], 0.0, f[2]])
        n = np.linalg.norm(fwd_flat)
        fwd_flat = fwd_flat / n if n > 0 else np.array([0.0, 0.0, 1.0])
        right = np.array([fwd_flat[2], 0.0, -fwd_flat[0]])
        up = np.array([0.0, 1.0, 0.0])
        speed = MOVE_SPEED
        if self.sprint:
            speed *= SPRINT_MODIFIER
        if self.walk:
            speed *= WALK_MODIFIER
        v = (self.move[0] * right + self.move[1] * up
             + self.move[2] * fwd_flat)
        n = np.linalg.norm(v)
        return (v / n * speed) if n > 0 else np.zeros(3)

    def step(self, dt: float) -> None:
        """Advance the position by one physics tick (src/game.c:242 ->
        src/physics.c:49-64), in float32."""
        self.position = phys_step(np.asarray(self.position, np.float32),
                                  self.velocity().astype(np.float32), dt)

    def camera(self, *, device) -> Camera:
        """The port's Camera at this state, on `device`."""
        return Camera.create(self.position, self.forward, device=device,
                             fov=self.fov, near=self.near, far=self.far)
