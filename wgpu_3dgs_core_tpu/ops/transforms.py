"""Device math library: quaternion/covariance/model-transform functions.

JAX equivalent of the reference's WESL shader library
(reference: src/shader/gaussian.wesl, src/shader/model_transform.wesl).
Pure jnp functions, batched over leading axes, usable both inside Pallas
kernels and in plain jitted code — the analog of WESL modules imported by
consumer shaders.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quat_to_mat3(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (xyzw, normalized) -> rotation matrix [..., 3, 3].

    Element-for-element the expansion used by the shaders
    (reference: src/shader/gaussian.wesl:84-118; glam Mat3::from_quat).
    """
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    one = jnp.ones_like(x)
    # Rows stacked; column j of the result is the image of basis vector j.
    return jnp.stack(
        [
            jnp.stack([one - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, one - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, one - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def cov3d_from_rot_scale(rot: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """(quat [...,4], scale [...,3]) -> upper-triangular sigma [...,6].

    Sigma = M M^T with M = R diag(s), packed (xx, xy, xz, yy, yz, zz)
    (reference: src/gaussian_config.rs:195-209 and
    src/shader/gaussian.wesl:80-129).
    """
    r = quat_to_mat3(rot)
    m = r * scale[..., None, :]
    sigma = jnp.einsum("...ik,...jk->...ij", m, m,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.stack(
        [
            sigma[..., 0, 0],
            sigma[..., 0, 1],
            sigma[..., 0, 2],
            sigma[..., 1, 1],
            sigma[..., 1, 2],
            sigma[..., 2, 2],
        ],
        axis=-1,
    )


def sigma6_to_mat3(sigma6: jnp.ndarray) -> jnp.ndarray:
    """Packed upper-triangular [...,6] -> symmetric matrix [...,3,3]."""
    xx, xy, xz, yy, yz, zz = (sigma6[..., i] for i in range(6))
    return jnp.stack(
        [
            jnp.stack([xx, xy, xz], axis=-1),
            jnp.stack([xy, yy, yz], axis=-1),
            jnp.stack([xz, yz, zz], axis=-1),
        ],
        axis=-2,
    )


def unpack_cov3d(cov3d: jnp.ndarray, rot_scale: bool) -> jnp.ndarray:
    """Device-side cov3d unpack -> f32 [...,6].

    The analog of the three WESL gaussian_unpack_cov3d variants
    (reference: src/shader/gaussian.wesl:80-149): rot_scale recomputes
    sigma; single/half are dtype casts (no u32 bit-unpacking needed —
    the packed SoA keeps native f16/f32 lanes).
    """
    if rot_scale:
        return cov3d_from_rot_scale(cov3d[..., 0:4], cov3d[..., 4:7])
    return cov3d[..., 0:6].astype(jnp.float32)


def unpack_sh(sh: jnp.ndarray | None, n: int) -> jnp.ndarray:
    """Device-side SH unpack -> f32 [..., 15, 3].

    The analog of the four WESL gaussian_unpack_sh variants
    (reference: src/shader/gaussian.wesl:29-77): f32 passthrough, f16 cast,
    int8 snorm (v/127 floored at -1), none -> zeros.
    """
    if sh is None:
        return jnp.zeros((n, 15, 3), jnp.float32)
    if sh.dtype == jnp.int8:
        vals = jnp.maximum(sh[..., :45].astype(jnp.float32) / 127.0, -1.0)
    else:
        vals = sh[..., :45].astype(jnp.float32)
    return vals.reshape(*sh.shape[:-1], 15, 3)


def unpack_color(color: jnp.ndarray) -> jnp.ndarray:
    """u8 [...,4] RGBA -> f32 [...,4] in [0,1].

    The analog of WESL unpack4x8unorm (reference:
    src/shader/gaussian.wesl:24-26).
    """
    return color.astype(jnp.float32) / 255.0


# ---------------------------------------------------------------------------
# Model transform (reference: src/shader/model_transform.wesl)
# ---------------------------------------------------------------------------


def model_transform_mat(pos: jnp.ndarray, rot: jnp.ndarray,
                        scale: jnp.ndarray) -> jnp.ndarray:
    """TRS model->world matrix [...,4,4]
    (reference: src/shader/model_transform.wesl:18-61)."""
    sr = model_scale_rot_mat(rot, scale)
    batch = sr.shape[:-2]
    m = jnp.zeros(batch + (4, 4), sr.dtype)
    m = m.at[..., :3, :3].set(sr)
    m = m.at[..., :3, 3].set(pos)
    m = m.at[..., 3, 3].set(1.0)
    return m


def model_to_world(pos: jnp.ndarray, rot: jnp.ndarray, scale: jnp.ndarray,
                   p: jnp.ndarray) -> jnp.ndarray:
    """Transform model-space point(s) to world space (homogeneous w=1)
    (reference: src/shader/model_transform.wesl:13-15)."""
    m = model_transform_mat(pos, rot, scale)
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    return jnp.einsum("...ij,...j->...i", m, ph,
                      precision=jax.lax.Precision.HIGHEST)


def model_scale_rot_mat(rot: jnp.ndarray, scale: jnp.ndarray) -> jnp.ndarray:
    """SR = R diag(s) [...,3,3]
    (reference: src/shader/model_transform.wesl:105-143)."""
    return quat_to_mat3(rot) * scale[..., None, :]


def model_transform_inv_sr_mat(rot: jnp.ndarray,
                               scale: jnp.ndarray) -> jnp.ndarray:
    """(SR)^-1 = diag(1/s) R^T [...,3,3]
    (reference: src/shader/model_transform.wesl:64-102)."""
    rt = jnp.swapaxes(quat_to_mat3(rot), -1, -2)
    return rt / scale[..., :, None]
