"""Device buffer layer: gaussian storage and uniform-style transform state.

JAX redesign of the reference's L3 GPU buffer layer
(reference: src/buffer/). wgpu storage buffers become jnp device arrays in a
packed SoA; uploads are `jnp.asarray` (device_put), downloads are
`jax.device_get`, and `update_range` is a donated `.at[slice].set`. Uniform
buffers become small frozen dataclasses whose packed form matches the
reference's POD bit layout so flag round-trips stay pinned.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import IntEnum
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import (
    DownloadBufferError,
    FixedSizeBufferWrapperError,
    GaussiansBufferTryFromBufferError,
    GaussiansBufferUpdateError,
    GaussiansBufferUpdateRangeError,
)
from ..layouts import GaussianLayout, PackedGaussians, pack, unpack
from ..models.gaussian import GaussianSoA

_JNP_DTYPES = {
    np.dtype(np.float32): jnp.float32,
    np.dtype(np.float16): jnp.float16,
    np.dtype(np.int8): jnp.int8,
}


def download(array) -> np.ndarray:
    """Device -> host transfer, the BufferWrapper.download analog
    (reference: src/buffer/mod.rs:27-101).

    The reference's async map can fail (channel/poll errors,
    src/error.rs:56-63); the JAX analogs are a deleted/donated device
    buffer or a dead remote device — surfaced uniformly as
    :class:`DownloadBufferError`.
    """
    try:
        return jax.device_get(array)
    except RuntimeError as e:
        raise DownloadBufferError(str(e)) from e


class FixedSizeBufferWrapper:
    """A device array validated to hold exactly one POD of a known size —
    the analog of FixedSizeBufferWrapper (reference: src/buffer/mod.rs:111-150):
    TryFrom validates byte size; ``download_single`` pulls the one value.
    """

    def __init__(self, array, expected_nbytes: int):
        nbytes = int(np.prod(array.shape)) * array.dtype.itemsize
        if nbytes != expected_nbytes:
            raise FixedSizeBufferWrapperError(
                buffer_size=nbytes, expected_size=expected_nbytes
            )
        self._array = array

    @property
    def buffer(self):
        """The wrapped device array (the reference's Deref to wgpu::Buffer)."""
        return self._array

    def download_single(self) -> np.ndarray:
        """Device -> host single POD (reference: mod.rs:137-149)."""
        return download(self._array)


class GaussiansBuffer:
    """Device-resident packed gaussian storage
    (reference: src/buffer/gaussian.rs:13-229).

    Holds one jnp array per packed field. ``update``/``update_range`` mirror
    the reference's count validation; ``download`` pulls back to host numpy.
    """

    def __init__(self, packed_device: PackedGaussians):
        self._data = packed_device

    # ------------------------------------------------------------ creation

    @classmethod
    def new(cls, gaussians: GaussianSoA,
            layout: GaussianLayout = GaussianLayout()) -> "GaussiansBuffer":
        """Pack on host, upload to device
        (reference: gaussian.rs:21-30, 61-65)."""
        return cls.new_with_packed(pack(gaussians, layout))

    @classmethod
    def new_with_packed(cls, packed: PackedGaussians) -> "GaussiansBuffer":
        return cls(
            PackedGaussians(
                layout=packed.layout,
                pos=jnp.asarray(packed.pos),
                color=jnp.asarray(packed.color),
                sh=None if packed.sh is None else jnp.asarray(packed.sh),
                cov3d=jnp.asarray(packed.cov3d),
            )
        )

    @classmethod
    def new_empty(cls, n: int,
                  layout: GaussianLayout = GaussianLayout()) -> "GaussiansBuffer":
        """Zero-initialized buffer of n gaussians (reference: gaussian.rs:71-89)."""
        sh_dtype = layout.sh_dtype
        return cls(
            PackedGaussians(
                layout=layout,
                pos=jnp.zeros((n, 3), jnp.float32),
                color=jnp.zeros((n, 4), jnp.uint8),
                sh=(
                    None
                    if sh_dtype is None
                    else jnp.zeros((n, layout.sh_width), _JNP_DTYPES[sh_dtype])
                ),
                cov3d=jnp.zeros(
                    (n, layout.cov3d_width), _JNP_DTYPES[layout.cov3d_dtype]
                ),
            )
        )

    @classmethod
    def from_arrays(cls, layout: GaussianLayout, pos, color, sh,
                    cov3d) -> "GaussiansBuffer":
        """Adopt existing arrays, validating shapes against the layout —
        the analog of TryFrom<wgpu::Buffer> size validation
        (reference: gaussian.rs:213-229)."""
        n = pos.shape[0]
        expected = {
            "pos": (n, 3),
            "color": (n, 4),
            "cov3d": (n, layout.cov3d_width),
        }
        arrays = {"pos": pos, "color": color, "cov3d": cov3d}
        if layout.sh_dtype is not None:
            expected["sh"] = (n, layout.sh_width)
            arrays["sh"] = sh
        for name, shape in expected.items():
            arr = arrays[name]
            if arr is None or tuple(arr.shape) != shape:
                got = None if arrays[name] is None else int(np.prod(arr.shape))
                raise GaussiansBufferTryFromBufferError(
                    buffer_size=0 if got is None else got,
                    expected_multiple_size=int(np.prod(shape)),
                )
        return cls(
            PackedGaussians(
                layout=layout,
                pos=jnp.asarray(pos),
                color=jnp.asarray(color),
                sh=None if layout.sh_dtype is None else jnp.asarray(sh),
                cov3d=jnp.asarray(cov3d),
            )
        )

    # ------------------------------------------------------------- access

    @property
    def layout(self) -> GaussianLayout:
        return self._data.layout

    @property
    def data(self) -> PackedGaussians:
        """The device-resident packed SoA (pass fields into kernels)."""
        return self._data

    def __len__(self) -> int:
        return len(self._data)

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    @property
    def nbytes(self) -> int:
        return len(self) * self.layout.bytes_per_gaussian

    # ------------------------------------------------------------- update

    def update(self, gaussians: GaussianSoA) -> None:
        """Whole-buffer update; counts must match
        (reference: gaussian.rs:104-137)."""
        if len(gaussians) != len(self):
            raise GaussiansBufferUpdateError(
                count=len(gaussians), expected_count=len(self)
            )
        self._data = GaussiansBuffer.new_with_packed(
            pack(gaussians, self.layout)
        )._data

    def update_range(self, start: int, gaussians: GaussianSoA) -> None:
        """Partial update at offset; must fit
        (reference: gaussian.rs:142-183)."""
        if start + len(gaussians) > len(self):
            raise GaussiansBufferUpdateRangeError(
                count=len(gaussians), start=start, expected_count=len(self)
            )
        packed = pack(gaussians, self.layout)
        d = self._data
        self._data = PackedGaussians(
            layout=d.layout,
            pos=d.pos.at[start : start + len(gaussians)].set(packed.pos),
            color=d.color.at[start : start + len(gaussians)].set(packed.color),
            sh=(
                None
                if d.sh is None
                else d.sh.at[start : start + len(gaussians)].set(packed.sh)
            ),
            cov3d=d.cov3d.at[start : start + len(gaussians)].set(packed.cov3d),
        )

    # ----------------------------------------------------------- download

    def download_packed(self) -> PackedGaussians:
        """Device -> host packed arrays (reference: src/buffer/mod.rs:27-101)."""
        d = self._data
        return PackedGaussians(
            layout=d.layout,
            pos=jax.device_get(d.pos),
            color=jax.device_get(d.color),
            sh=None if d.sh is None else jax.device_get(d.sh),
            cov3d=jax.device_get(d.cov3d),
        )

    def download_gaussians(self) -> GaussianSoA:
        """Device -> host -> canonical IR (reference: gaussian.rs:186-194).
        Raises IrreversibleConfigError for lossy layouts, like the
        reference's panicking To conversions."""
        return unpack(self.download_packed())


# ---------------------------------------------------------------------------
# Gaussian transform "uniform" (reference: src/buffer/gaussian_transform.rs)
# ---------------------------------------------------------------------------


class GaussianDisplayMode(IntEnum):
    """(reference: gaussian_transform.rs:7-14)."""

    SPLAT = 0
    ELLIPSE = 1
    POINT = 2


def validate_sh_degree(sh_deg: int) -> int:
    """(reference: gaussian_transform.rs:21-31)."""
    if not 0 <= sh_deg <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {sh_deg}")
    return sh_deg


def quantize_max_std_dev(max_std_dev: float) -> int:
    """f32 in [0,3] -> u8, Rust `as u8` truncation
    (reference: gaussian_transform.rs:59-77)."""
    if not 0.0 <= max_std_dev <= 3.0:
        raise ValueError(
            f"max std dev must be in [0.0, 3.0], got {max_std_dev}"
        )
    return int(np.float32(max_std_dev) / np.float32(3.0) * np.float32(255.0))


@dataclass(frozen=True)
class GaussianTransform:
    """Render-time knobs (reference: GaussianTransformPod,
    gaussian_transform.rs:165-206).

    ``flags`` packs [display_mode, sh_deg, no_sh0, max_std_dev_u8] into a
    u32 exactly like the reference so device-side accessors stay compatible.
    """

    size: float = 1.0
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT
    sh_deg: int = 3
    no_sh0: bool = False
    max_std_dev: float = 3.0

    def __post_init__(self):
        validate_sh_degree(self.sh_deg)
        quantize_max_std_dev(self.max_std_dev)

    @property
    def flags(self) -> int:
        dm = int(self.display_mode) & 0xFF
        deg = self.sh_deg & 0xFF
        no0 = 1 if self.no_sh0 else 0
        std = quantize_max_std_dev(self.max_std_dev)
        return dm | (deg << 8) | (no0 << 16) | (std << 24)

    def to_pod(self) -> tuple[float, int]:
        return (float(np.float32(self.size)), self.flags)

    @classmethod
    def from_pod(cls, size: float, flags: int) -> "GaussianTransform":
        return cls(
            size=size,
            display_mode=GaussianDisplayMode(flags & 0xFF),
            sh_deg=(flags >> 8) & 0xFF,
            no_sh0=((flags >> 16) & 0xFF) != 0,
            max_std_dev=float(
                np.float32((flags >> 24) & 0xFF) / np.float32(255.0)
                * np.float32(3.0)
            ),
        )


# Device-side flag accessors — the analog of the WESL helpers
# (reference: src/shader/gaussian_transform.wesl:14-31).


def gaussian_transform_display_mode(flags: jnp.ndarray) -> jnp.ndarray:
    return flags & 0xFF


def gaussian_transform_sh_deg(flags: jnp.ndarray) -> jnp.ndarray:
    return (flags >> 8) & 0xFF


def gaussian_transform_no_sh0(flags: jnp.ndarray) -> jnp.ndarray:
    return ((flags >> 16) & 0xFF) != 0


def gaussian_transform_max_std_dev(flags: jnp.ndarray) -> jnp.ndarray:
    return jnp.asarray((flags >> 24) & 0xFF, jnp.float32) / 255.0 * 3.0


# ---------------------------------------------------------------------------
# Model transform "uniform" (reference: src/buffer/model_transform.rs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelTransform:
    """Model -> world TRS (reference: ModelTransformPod,
    model_transform.rs:60-84). Defaults to identity."""

    pos: tuple[float, float, float] = (0.0, 0.0, 0.0)
    rot: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)  # xyzw
    scale: tuple[float, float, float] = (1.0, 1.0, 1.0)

    def as_arrays(self) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        return (
            jnp.asarray(self.pos, jnp.float32),
            jnp.asarray(self.rot, jnp.float32),
            jnp.asarray(self.scale, jnp.float32),
        )

    def update(self, pos=None, rot=None, scale=None) -> "ModelTransform":
        """Functional update (reference: model_transform.rs:26-33)."""
        return replace(
            self,
            pos=self.pos if pos is None else tuple(pos),
            rot=self.rot if rot is None else tuple(rot),
            scale=self.scale if scale is None else tuple(scale),
        )
