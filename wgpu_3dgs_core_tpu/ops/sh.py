"""Real spherical-harmonics evaluation for view-dependent color.

The reference core stores SH coefficients and unpacks them on device
(src/shader/gaussian.wesl:29-77) but evaluates them downstream; this module
implements the standard 3DGS evaluation the renderer extension needs.
Band-0 is pre-baked into the IR's u8 color (color = SH0 * 0.2820948 + 0.5,
reference: src/gaussian.rs:77-81), so evaluation starts at band 1 and the
``no_sh0``/``sh_deg`` knobs of :class:`GaussianTransform` select terms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Standard real SH constants (bands 1..3), as in the original 3DGS CUDA.
SH_C1 = 0.4886025119029199

SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)

SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def view_directions(means: jnp.ndarray, cam_pos) -> jnp.ndarray:
    """Unit directions [..., 3] from the camera centre to each mean.

    Written as ``v * rsqrt(max(v.v, 1e-24))`` (a mean at the camera centre
    gets a zero direction, not NaN). The form ``v / clip(norm(v))`` made
    XLA on an H100 return wrong position gradients through this function
    for ~13% of gaussians at batch sizes of 250,000 and 262,144 (right at
    125K, 500K and 1M), which broke the four-GPU sharded gradients.
    """
    v = means - cam_pos
    return v * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-24)
    )


def eval_sh(sh: jnp.ndarray, dirs: jnp.ndarray, sh_deg: int) -> jnp.ndarray:
    """Evaluate rest-band SH (bands 1..sh_deg) in unit directions.

    ``sh``: [..., 15, 3] rest coefficients (band 1: 0..2, band 2: 3..7,
    band 3: 8..14). ``dirs``: [..., 3] unit view directions. Returns
    [..., 3] color deltas to add to the band-0 base color.
    """
    if sh_deg == 0:
        return jnp.zeros_like(sh[..., 0, :])

    x = dirs[..., 0:1]
    y = dirs[..., 1:2]
    z = dirs[..., 2:3]

    result = SH_C1 * (-y * sh[..., 0, :] + z * sh[..., 1, :] - x * sh[..., 2, :])

    if sh_deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = result + (
            SH_C2[0] * xy * sh[..., 3, :]
            + SH_C2[1] * yz * sh[..., 4, :]
            + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 5, :]
            + SH_C2[3] * xz * sh[..., 6, :]
            + SH_C2[4] * (xx - yy) * sh[..., 7, :]
        )

    if sh_deg >= 3:
        result = result + (
            SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 8, :]
            + SH_C3[1] * xy * z * sh[..., 9, :]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 10, :]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 11, :]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 12, :]
            + SH_C3[5] * z * (xx - yy) * sh[..., 13, :]
            + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 14, :]
        )

    return result


def gaussian_color(base_color: jnp.ndarray, sh: jnp.ndarray | None,
                   dirs: jnp.ndarray, sh_deg: int,
                   no_sh0: bool = False) -> jnp.ndarray:
    """Final RGB in [0,1]: band-0 base (or neutral 0.5 when ``no_sh0``)
    plus rest-band SH, clamped at 0 like the original 3DGS.

    ``base_color``: [..., 3] f32 in [0,1] (the IR's unpacked u8 color).
    """
    base = jnp.full_like(base_color, 0.5) if no_sh0 else base_color
    if sh is None or sh_deg == 0:
        rgb = base
    else:
        rgb = base + eval_sh(sh, dirs, sh_deg)
    return jnp.maximum(rgb, 0.0)
