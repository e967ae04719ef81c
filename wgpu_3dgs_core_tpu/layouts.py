"""Quantized gaussian storage layouts (the 12 SH x cov3d configs).

JAX redesign of the reference's compile-time config system
(reference: src/gaussian_config.rs + src/buffer/gaussian.rs:231-384).
The Rust crate encodes each combination as a distinct `#[repr(C)]` POD
struct selected by trait generics, with matching WESL feature flags picking
the shader variant. Here a layout is a frozen dataclass value that

- selects array dtypes/packing in the packed SoA (``pack``/``unpack``), and
- statically specializes jitted/Pallas code paths (it hashes, so passing it
  as a static argument re-specializes the compiled kernel — the analog of
  WESL ``@if(feature)`` conditional compilation).

On the device the packed representation stays SoA (one array per field) rather than
an interleaved byte struct: XLA/VPU want contiguous per-field lanes, and
dtype conversion (f16/i8 -> f32) is a hardware cast, not bit juggling.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Optional

import numpy as np

from .errors import IrreversibleConfigError
from .models.gaussian import GaussianSoA
from .utils.numeric import cast_i8, f32


class ShFormat(Enum):
    """SH storage format (reference: src/gaussian_config.rs:15-134)."""

    SINGLE = "sh_single"  # f32[45]
    HALF = "sh_half"  # f16[46] (1 pad)
    NORM8 = "sh_norm8"  # i8[48] (3 pad), clamp +/-127
    NONE = "sh_none"  # dropped; cannot be unpacked


class Cov3dFormat(Enum):
    """3D covariance storage format (reference: src/gaussian_config.rs:147-233)."""

    ROT_SCALE = "cov3d_rot_scale"  # f32[7] quat xyzw + scale, lossless
    SINGLE = "cov3d_single"  # f32[6] upper-triangular sigma
    HALF = "cov3d_half"  # f16[6] upper-triangular sigma


SH_FEATURES = tuple(f.value for f in ShFormat)
COV3D_FEATURES = tuple(f.value for f in Cov3dFormat)
ALL_FEATURES = SH_FEATURES + COV3D_FEATURES  # 7 flags, exactly 2 enabled


@dataclass(frozen=True)
class GaussianLayout:
    """A (sh, cov3d) storage configuration.

    Hashable and comparable: usable as a jit static argument, mirroring how
    the reference's ``GaussianPod`` type parameter specializes pipelines.
    """

    sh: ShFormat = ShFormat.SINGLE
    cov3d: Cov3dFormat = Cov3dFormat.ROT_SCALE

    def features(self) -> tuple[tuple[str, bool], ...]:
        """All 7 feature flags with exactly 2 enabled
        (reference: src/buffer/gaussian.rs:270-287)."""
        return tuple(
            (name, name in (self.sh.value, self.cov3d.value))
            for name in ALL_FEATURES
        )

    @property
    def sh_dtype(self) -> Optional[np.dtype]:
        return {
            ShFormat.SINGLE: np.dtype(np.float32),
            ShFormat.HALF: np.dtype(np.float16),
            ShFormat.NORM8: np.dtype(np.int8),
            ShFormat.NONE: None,
        }[self.sh]

    @property
    def sh_width(self) -> int:
        """Per-gaussian packed SH element count, including the reference's
        alignment padding (gaussian_config.rs:54,90)."""
        return {
            ShFormat.SINGLE: 45,
            ShFormat.HALF: 46,
            ShFormat.NORM8: 48,
            ShFormat.NONE: 0,
        }[self.sh]

    @property
    def cov3d_dtype(self) -> np.dtype:
        return (
            np.dtype(np.float16)
            if self.cov3d == Cov3dFormat.HALF
            else np.dtype(np.float32)
        )

    @property
    def cov3d_width(self) -> int:
        return 7 if self.cov3d == Cov3dFormat.ROT_SCALE else 6

    @property
    def bytes_per_gaussian(self) -> int:
        """Packed SoA bytes per gaussian (pos 12 + color 4 + sh + cov3d)."""
        sh = 0 if self.sh_dtype is None else self.sh_width * self.sh_dtype.itemsize
        return 12 + 4 + sh + self.cov3d_width * self.cov3d_dtype.itemsize


ALL_LAYOUTS: tuple[GaussianLayout, ...] = tuple(
    GaussianLayout(sh=s, cov3d=c) for s in ShFormat for c in Cov3dFormat
)


@dataclass
class PackedGaussians:
    """Packed SoA gaussian collection for one :class:`GaussianLayout`.

    The analog of a ``GaussiansBuffer<G>``'s contents (reference:
    src/buffer/gaussian.rs:301-384), kept columnar:

    - ``pos``:   f32[N, 3]
    - ``color``: u8[N, 4]
    - ``sh``:    layout.sh_dtype[N, layout.sh_width] or None
    - ``cov3d``: layout.cov3d_dtype[N, layout.cov3d_width]
    """

    layout: GaussianLayout
    pos: Any
    color: Any
    sh: Any
    cov3d: Any

    def __len__(self) -> int:
        return self.pos.shape[0]


def _cov3d_sigma6(rot: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Upper-triangular covariance from quat + scale in f32
    (reference: src/gaussian_config.rs:195-209; same math as the WESL
    gaussian_unpack_cov3d, src/shader/gaussian.wesl:80-129)."""
    x, y, z, w = (f32(rot[..., i]) for i in range(4))
    x2, y2, z2 = x + x, y + y, z + z
    xx, xy, xz = x * x2, x * y2, x * z2
    yy, yz, zz = y * y2, y * z2, z * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    one = np.float32(1.0)
    # R columns (glam Mat3::from_quat, column-major).
    r = np.stack(
        [
            np.stack([one - (yy + zz), xy + wz, xz - wy], axis=-1),
            np.stack([xy - wz, one - (xx + zz), yz + wx], axis=-1),
            np.stack([xz + wy, yz - wx, one - (xx + yy)], axis=-1),
        ],
        axis=-1,
    )  # [..., 3(row), 3(col)]
    m = r * f32(scale)[..., None, :]  # M = R * diag(s): scale column j
    sigma = np.einsum("...ik,...jk->...ij", m, m).astype(np.float32)
    return np.stack(
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


def pack(soa: GaussianSoA, layout: GaussianLayout) -> PackedGaussians:
    """SoA IR -> packed arrays (the analog of ``G::from_gaussian`` over a
    whole collection, reference: src/buffer/gaussian.rs:314-339)."""
    n = len(soa)
    sh_flat = soa.sh.reshape(n, 45)

    if layout.sh == ShFormat.SINGLE:
        sh = f32(sh_flat).copy()
    elif layout.sh == ShFormat.HALF:
        sh = np.zeros((n, 46), dtype=np.float16)
        sh[:, :45] = sh_flat.astype(np.float16)
    elif layout.sh == ShFormat.NORM8:
        sh = np.zeros((n, 48), dtype=np.int8)
        # clamp(v * 127, -127, 127) as i8 (gaussian_config.rs:92-99)
        sh[:, :45] = cast_i8(
            np.clip(f32(sh_flat) * np.float32(127.0), -127.0, 127.0)
        )
    else:
        sh = None

    if layout.cov3d == Cov3dFormat.ROT_SCALE:
        cov3d = np.concatenate([soa.rot, soa.scale], axis=-1).astype(np.float32)
    else:
        sigma6 = _cov3d_sigma6(soa.rot, soa.scale)
        cov3d = sigma6.astype(layout.cov3d_dtype)

    return PackedGaussians(
        layout=layout,
        pos=soa.pos.copy(),
        color=soa.color.copy(),
        sh=sh,
        cov3d=cov3d,
    )


def unpack(packed: PackedGaussians) -> GaussianSoA:
    """Packed arrays -> SoA IR; raises for irreversible configs where the
    reference panics (src/gaussian_config.rs:131-133, 211-213, 230-232)."""
    layout = packed.layout
    n = len(packed)

    if layout.sh == ShFormat.NONE:
        raise IrreversibleConfigError(
            "Cannot convert from SH None configuration"
        )
    if layout.cov3d != Cov3dFormat.ROT_SCALE:
        raise IrreversibleConfigError(
            f"Cannot convert from Cov3d {layout.cov3d.name.title()} configuration"
        )

    if layout.sh == ShFormat.SINGLE:
        sh = f32(packed.sh[:, :45])
    elif layout.sh == ShFormat.HALF:
        sh = packed.sh[:, :45].astype(np.float32)
    else:  # NORM8: v / 127 floored at -1 (gaussian_config.rs:102-116)
        sh = np.maximum(
            packed.sh[:, :45].astype(np.float32) / np.float32(127.0),
            np.float32(-1.0),
        )

    cov3d = f32(packed.cov3d)
    return GaussianSoA(
        rot=cov3d[:, 0:4],
        pos=packed.pos,
        color=packed.color,
        sh=sh.reshape(n, 15, 3),
        scale=cov3d[:, 4:7],
    )
