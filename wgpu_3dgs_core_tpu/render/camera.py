"""Camera model for the renderer extension.

The reference core crate has no camera (projection lives downstream in
wgpu-3dgs-viewer); this implements the standard 3DGS pinhole convention the
renderer extension needs (SURVEY.md §7, BASELINE.json north star): world ->
camera via a rigid view matrix (+z forward), camera -> pixels via focal
lengths with the principal point at the image center.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class Camera:
    """Pinhole camera.

    - ``view``: 4x4 world->camera matrix (row-major, applied as ``view @ p``)
    - ``fx, fy``: focal lengths in pixels
    - ``width, height``: image size in pixels
    - ``near, far``: clip depths for frustum culling
    """

    view: tuple  # 4x4 nested tuple so the dataclass stays hashable/static
    fx: float
    fy: float
    width: int
    height: int
    near: float = 0.01
    far: float = 1000.0

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0

    def view_matrix(self) -> jnp.ndarray:
        return jnp.asarray(self.view, jnp.float32).reshape(4, 4)

    def position(self) -> np.ndarray:
        """Camera centre in world space (-R^T t of the view), as a host
        f32 constant."""
        v = np.asarray(self.view, np.float64).reshape(4, 4)
        return (-v[:3, :3].T @ v[:3, 3]).astype(np.float32)

    @property
    def tan_half_fov_x(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tan_half_fov_y(self) -> float:
        return self.height / (2.0 * self.fy)

    @classmethod
    def from_fov(cls, width: int, height: int, fov_y: float, view=None,
                 **kw) -> "Camera":
        """fov_y in radians; fx = fy (square pixels)."""
        fy = height / (2.0 * np.tan(fov_y / 2.0))
        if view is None:
            view = np.eye(4, dtype=np.float32)
        return cls(
            view=tuple(map(tuple, np.asarray(view, np.float32))),
            fx=float(fy),
            fy=float(fy),
            width=width,
            height=height,
            **kw,
        )

    @classmethod
    def look_at(cls, eye, target, up=(0.0, 1.0, 0.0), *, width: int,
                height: int, fov_y: float = 0.9, **kw) -> "Camera":
        """Right-handed look-at with +z pointing from eye toward target
        (camera-space z is depth)."""
        eye = np.asarray(eye, np.float64)
        fwd = np.asarray(target, np.float64) - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        r = np.stack([right, down, fwd])  # world->camera rotation
        t = -r @ eye
        view = np.eye(4)
        view[:3, :3] = r
        view[:3, 3] = t
        return cls.from_fov(width, height, fov_y, view=view, **kw)
