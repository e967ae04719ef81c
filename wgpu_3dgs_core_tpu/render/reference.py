"""Brute-force reference renderer: per-pixel blend over all gaussians.

Pure jnp, O(N * pixels), differentiable by autodiff. This is the semantic
spec for the tiled Pallas renderer — the analog of the reference's
"CPU glam result vs device kernel result" verification idiom (SURVEY.md
§3.5): the Pallas path must match this within epsilon, and its hand-derived
VJP must match this renderer's autodiff gradients.

Blending semantics (shared with the tiled path):
- alpha_i = min(0.99, opacity_i * exp(-0.5 q_i)), q = conic quadratic form
- fragment contributes iff q <= RADIUS_CUTOFF^2 and alpha >= 1/255
- front-to-back by camera depth; transmittance T_{i+1} = T_i (1 - alpha_i),
  updated only while T_i > 1e-4 (fragments arriving after are skipped)
- image = sum_i alpha_i T_i c_i + T_final * background
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.projection import project
from ..ops.sh import gaussian_color, view_directions
from .camera import Camera

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4


def blend_weights(alpha_sorted: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Front-to-back weights from depth-sorted alphas.

    ``alpha_sorted``: [N, P] per-(gaussian, pixel) alphas in blend order.
    Returns (weights [N, P], T_final [P]).
    """
    one_minus = 1.0 - alpha_sorted
    # Exclusive cumprod: T_i = prod_{j<i} (1 - alpha_j).
    t = jnp.concatenate(
        [jnp.ones_like(alpha_sorted[:1]), jnp.cumprod(one_minus[:-1], axis=0)],
        axis=0,
    )
    blend = t > T_MIN
    w = alpha_sorted * t * blend
    # T stops updating at the first fragment seeing T <= T_MIN, so T_final is
    # the inclusive cumprod after the last blended fragment (index = number
    # of blended fragments, t is monotone so blended fragments are a prefix).
    k = jnp.sum(blend, axis=0)
    t_all = jnp.concatenate([jnp.ones_like(t[:1]), t * one_minus], axis=0)
    t_final = jnp.take_along_axis(t_all, k[None, :], axis=0)[0]
    return w, t_final


def render_reference(
    means: jnp.ndarray,
    cov3d_sigma6: jnp.ndarray,
    base_color: jnp.ndarray,
    opacity: jnp.ndarray,
    camera: Camera,
    sh: Optional[jnp.ndarray] = None,
    sh_deg: int = 0,
    no_sh0: bool = False,
    background: tuple = (0.0, 0.0, 0.0),
    model_transform: Optional[tuple] = None,
    size: float = 1.0,
    max_std_dev: float = 3.0,
    display_mode: int = 0,
    antialiased: bool = False,
    pixel_window: Optional[tuple] = None,
) -> jnp.ndarray:
    """Render [H, W, 3] by blending every gaussian at every pixel.

    ``base_color``: [N, 3] in [0,1]; ``opacity``: [N] in [0,1];
    ``sh``: optional [N, 15, 3] rest coefficients.
    ``pixel_window``: optional (x0, y0, w, h) crop — identical blending
    semantics evaluated only at those pixels (projection still uses the
    full camera). Lets full-size gradient-parity checks avoid the
    infeasible O(N * W * H) dense evaluation (chip_smoke.py).
    """
    h, w_px = camera.height, camera.width
    splats = project(means, cov3d_sigma6, camera, model_transform,
                     size=size, radius_cutoff=max_std_dev,
                     antialiased=antialiased)
    opacity = opacity * splats.compensation
    if display_mode == 2:  # point
        pt = max(float(size), 0.5)
        conic_pt = jnp.array([1.0 / (pt * pt), 0.0, 1.0 / (pt * pt)],
                             jnp.float32)
        splats = splats._replace(
            conic=jnp.broadcast_to(conic_pt, splats.conic.shape),
            extent=jnp.where(
                splats.mask[:, None], jnp.ceil(max_std_dev * pt), 0.0
            ),
        )

    # View-dependent color, directions from camera center to each gaussian.
    dirs = view_directions(means, camera.position())
    rgb = gaussian_color(base_color, sh, dirs, sh_deg, no_sh0)  # [N, 3]

    # Blend order: depth ascending, invalid last (argsort is stable: ties
    # keep gaussian-id order, matching the tiled path's sort).
    depth_key = jnp.where(splats.mask, splats.depth, jnp.inf)
    order = jnp.argsort(depth_key)
    xy = splats.xy[order]
    conic = splats.conic[order]
    rgb = rgb[order]
    a = opacity[order] * splats.mask[order]

    # Pixel centers.
    if pixel_window is not None:
        # (x0, y0) may be traced (chunked-crop loops jit one signature);
        # only the crop SIZE must be static.
        wx0, wy0, h, w_px = (
            pixel_window[0], pixel_window[1], int(pixel_window[3]),
            int(pixel_window[2]),
        )
        ys, xs = jnp.mgrid[0:h, 0:w_px]
        ys = ys + wy0
        xs = xs + wx0
    else:
        ys, xs = jnp.mgrid[0:h, 0:w_px]
    px = (xs + 0.5).astype(jnp.float32).reshape(-1)  # [P]
    py = (ys + 0.5).astype(jnp.float32).reshape(-1)

    dx = px[None, :] - xy[:, 0:1]  # [N, P]
    dy = py[None, :] - xy[:, 1:2]
    q = (
        conic[:, 0:1] * dx * dx
        + 2.0 * conic[:, 1:2] * dx * dy
        + conic[:, 2:3] * dy * dy
    )
    cutoff_sq = float(max_std_dev) ** 2
    if display_mode == 1:  # ellipse outline: opaque ring at the boundary
        alpha = jnp.minimum(a[:, None] * jnp.ones_like(q), ALPHA_CLAMP)
        ok = (q <= cutoff_sq) & (q >= cutoff_sq * 0.64) & (alpha >= ALPHA_MIN)
    else:
        alpha = jnp.minimum(a[:, None] * jnp.exp(-0.5 * q), ALPHA_CLAMP)
        ok = (q <= cutoff_sq) & (alpha >= ALPHA_MIN)
    alpha = jnp.where(ok, alpha, 0.0)

    w, t_final = blend_weights(alpha)
    color = jnp.einsum("np,nc->pc", w, rgb,
                       precision=jax.lax.Precision.HIGHEST)  # [P, 3]
    bg = jnp.asarray(background, jnp.float32)
    img = color + t_final[:, None] * bg
    return img.reshape(h, w_px, 3)
