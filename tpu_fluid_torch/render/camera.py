"""Camera math — pure host-side linear algebra (`tpu_fluid.render.camera`,
copied: NumPy only).

Replaces the reference's Vulkan-framework Camera + GLM projection
(`main.cpp:128-133`): camera at {10,10,-10} looking along +z with up {0,-1,0}
(+y is down in the scene), 45-degree perspective, near 0.1 / far 200, and the
Vulkan y-flip folded into the projection.  WASD/interactive motion becomes
explicit `move`/`orbit` calls — there is no window; frames are rendered
headlessly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def look_at(position, direction, up) -> np.ndarray:
    """View matrix from position + view direction + up vector."""
    f = np.asarray(direction, dtype=np.float64)
    f = f / np.linalg.norm(f)
    upn = np.asarray(up, dtype=np.float64)
    s = np.cross(f, upn)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    pos = np.asarray(position, dtype=np.float64)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, pos)
    m[1, 3] = -np.dot(u, pos)
    m[2, 3] = np.dot(f, pos)
    return m


def perspective(fov_y_deg: float, aspect: float, near: float,
                far: float, flip_y: bool = True) -> np.ndarray:
    """GL-style perspective; flip_y folds in the reference's invert_y_mat
    (`main.cpp:130-132`)."""
    f = 1.0 / np.tan(np.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f * (-1.0 if flip_y else 1.0)
    m[2, 2] = far / (near - far)
    m[2, 3] = far * near / (near - far)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class Camera:
    """Default pose is the reference's (`main.cpp:128`)."""
    position: tuple = (10.0, 10.0, -10.0)
    direction: tuple = (0.0, 0.0, 1.0)
    up: tuple = (0.0, -1.0, 0.0)
    fov_y_deg: float = 45.0
    aspect: float = 1.0
    near: float = 0.1
    far: float = 200.0

    def view(self) -> np.ndarray:
        return look_at(self.position, self.direction, self.up)

    def projection(self) -> np.ndarray:
        return perspective(self.fov_y_deg, self.aspect, self.near, self.far)

    def mvp(self) -> np.ndarray:
        """projection @ view, float32 — the push-constant MVP of
        `main.cpp:195`."""
        return (self.projection() @ self.view()).astype(np.float32)

    @staticmethod
    def for_scene(grid_size) -> "Camera":
        """Reference pose scaled to an arbitrary grid (the reference's pose
        assumes the 20^3 box)."""
        s = max(grid_size) / 20.0
        return Camera(position=(10.0 * s, 10.0 * s, -10.0 * s),
                      far=max(200.0, 20.0 * s * 10))

    def move(self, delta) -> "Camera":
        p = tuple(np.asarray(self.position) + np.asarray(delta))
        return dataclasses.replace(self, position=p)

    def look_at_point(self, center) -> "Camera":
        """Aim the camera at a world-space point."""
        d = np.asarray(center, dtype=np.float64) - np.asarray(self.position)
        return dataclasses.replace(self, direction=tuple(d))

    def orbit(self, angle_deg: float, center) -> "Camera":
        """Rotate the camera about the scene's vertical (y) axis around
        `center`, re-aiming at it — the headless counterpart of the
        reference's interactive WASD fly camera (`Camera::update`,
        `main.cpp:160`).  The scene's up is -y, so positive angles orbit
        clockwise seen from above."""
        c = np.asarray(center, dtype=np.float64)
        p = np.asarray(self.position, dtype=np.float64) - c
        a = np.radians(angle_deg)
        rot = np.array([[np.cos(a), 0.0, np.sin(a)],
                        [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]])
        p = rot @ p
        return dataclasses.replace(
            self, position=tuple(c + p)).look_at_point(center)
