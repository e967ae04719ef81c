"""Canonical gaussian intermediate representation, columnar (SoA).

Redesign of the reference's AoS ``Gaussian`` / ``Gaussians`` layer
(reference: src/gaussian.rs). The canonical IR is a structure-of-arrays
(:class:`GaussianSoA`) — numpy on the host, directly uploadable as jnp
arrays — instead of a ``Vec<Gaussian>``; all PLY/SPZ conversion math is
vectorized with the reference's exact constants and cast semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import BinaryIO, Optional, Union

import numpy as np

from ..utils.numeric import (
    F32,
    cast_u8,
    f32,
    logit,
    normalize_rows,
    sigmoid,
)
from . import spz as spz_mod
from .ply import PlyGaussians
from .spz import SpzEncodeOptions, SpzGaussians, SpzHeader

# SH0 -> linear color factor (reference: src/gaussian.rs:64).
SH0_TO_LINEAR_FACTOR = F32(0.2820948)
# SPZ flavor of the same factor (reference: src/gaussian.rs:67).
SPZ_SH0_TO_LINEAR_FACTOR = F32(0.15)


@dataclass
class GaussianSoA:
    """Canonical SoA gaussian collection.

    Fields mirror the reference ``Gaussian`` struct (src/gaussian.rs:53-60)
    but batched along a leading N axis:

    - ``rot``:   f32[N, 4] quaternion in (x, y, z, w) order, normalized
    - ``pos``:   f32[N, 3]
    - ``color``: u8[N, 4] RGBA (linear color + opacity, both 0..255)
    - ``sh``:    f32[N, 15, 3] rest-band SH coefficients (RGB interleaved)
    - ``scale``: f32[N, 3] linear (post-exp) scales
    """

    rot: np.ndarray
    pos: np.ndarray
    color: np.ndarray
    sh: np.ndarray
    scale: np.ndarray

    def __post_init__(self):
        self.rot = np.asarray(self.rot, dtype=np.float32).reshape(-1, 4)
        n = self.rot.shape[0]
        self.pos = np.asarray(self.pos, dtype=np.float32).reshape(n, 3)
        self.color = np.asarray(self.color, dtype=np.uint8).reshape(n, 4)
        self.sh = np.asarray(self.sh, dtype=np.float32).reshape(n, 15, 3)
        self.scale = np.asarray(self.scale, dtype=np.float32).reshape(n, 3)

    def __len__(self) -> int:
        return self.rot.shape[0]

    def __getitem__(self, idx) -> "GaussianSoA":
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return GaussianSoA(
            rot=self.rot[idx],
            pos=self.pos[idx],
            color=self.color[idx],
            sh=self.sh[idx],
            scale=self.scale[idx],
        )

    def at(self, i: int) -> "GaussianSoA":
        """One-gaussian slice — the per-item accessor that code porting
        from the reference's ``IterGaussian``/``ReadIterGaussian`` traits
        (reference: src/gaussian.rs:12-47) lands on. Batch over the SoA
        arrays instead of looping this in hot paths."""
        return self[i]

    @classmethod
    def zeros(cls, n: int) -> "GaussianSoA":
        return cls(
            rot=np.tile(np.array([0, 0, 0, 1], dtype=np.float32), (n, 1)),
            pos=np.zeros((n, 3), np.float32),
            color=np.zeros((n, 4), np.uint8),
            sh=np.zeros((n, 15, 3), np.float32),
            scale=np.ones((n, 3), np.float32),
        )

    @classmethod
    def concatenate(cls, parts: list["GaussianSoA"]) -> "GaussianSoA":
        return cls(
            rot=np.concatenate([p.rot for p in parts]),
            pos=np.concatenate([p.pos for p in parts]),
            color=np.concatenate([p.color for p in parts]),
            sh=np.concatenate([p.sh for p in parts]),
            scale=np.concatenate([p.scale for p in parts]),
        )

    # ----------------------------------------------------------- PLY <-> IR

    @classmethod
    def from_ply(cls, ply: PlyGaussians) -> "GaussianSoA":
        """PLY -> IR (reference: src/gaussian.rs:70-92)."""
        pos = f32(ply.pos).copy()
        # PLY quats are (w, x, y, z); the IR is (x, y, z, w), normalized.
        rot = normalize_rows(ply.rot[:, [1, 2, 3, 0]])
        scale = np.exp(f32(ply.scale)).astype(np.float32)
        rgb = (f32(ply.color) * SH0_TO_LINEAR_FACTOR + F32(0.5)) * F32(255.0)
        a = sigmoid(ply.alpha) * F32(255.0)
        rgba = np.concatenate([rgb, a[:, None]], axis=-1)
        color = cast_u8(np.clip(rgba, 0.0, 255.0))
        # PLY SH rest is planar (15 R, 15 G, 15 B); IR interleaves per coeff.
        sh = np.stack(
            [ply.sh[:, 0:15], ply.sh[:, 15:30], ply.sh[:, 30:45]], axis=-1
        ).astype(np.float32)
        return cls(rot=rot, pos=pos, color=color, sh=sh, scale=scale)

    def to_ply(self) -> PlyGaussians:
        """IR -> PLY (reference: src/gaussian.rs:95-125)."""
        n = len(self)
        block = np.zeros((n, 62), dtype=np.float32)
        block[:, 0:3] = self.pos
        block[:, 5] = 1.0  # normal = (0, 0, 1) (gaussian.rs:114)
        rgba = self.color.astype(np.float32) / F32(255.0)
        block[:, 6:9] = (rgba[:, 0:3] - F32(0.5)) / SH0_TO_LINEAR_FACTOR
        block[:, 9:54] = np.concatenate(
            [self.sh[:, :, 0], self.sh[:, :, 1], self.sh[:, :, 2]], axis=-1
        )
        block[:, 54] = logit(rgba[:, 3])
        with np.errstate(divide="ignore"):
            block[:, 55:58] = np.log(self.scale).astype(np.float32)
        block[:, 58] = self.rot[:, 3]  # w first in PLY order
        block[:, 59:62] = self.rot[:, 0:3]
        return PlyGaussians(block)

    # ----------------------------------------------------------- SPZ <-> IR

    @classmethod
    def from_spz(cls, spz: SpzGaussians) -> "GaussianSoA":
        """SPZ -> IR, dequantizing every field (reference:
        src/gaussian.rs:134-217)."""
        h = spz.header
        pos = spz_mod.decode_positions(spz.positions, h)
        scale = spz_mod.decode_scales(spz.scales)
        rot = spz_mod.decode_rotations(spz.rotations, h)
        rgb = spz_mod.decode_colors(spz.colors)
        color = np.concatenate([rgb, spz.alphas[:, None]], axis=-1)
        k = h.sh_num_coefficients
        sh = np.zeros((len(spz), 15, 3), dtype=np.float32)
        if k:
            sh[:, :k, :] = spz_mod.decode_shs(spz.shs)
        return cls(rot=rot, pos=pos, color=color, sh=sh, scale=scale)

    def to_spz(self, options: Optional[SpzEncodeOptions] = None) -> SpzGaussians:
        """IR -> SPZ, quantizing every field (reference:
        src/gaussian.rs:227-352, spz.rs:796-834)."""
        options = options or SpzEncodeOptions()
        header = SpzHeader(
            version=options.version,
            num_points=len(self),
            sh_degree=options.sh_degree,
            fractional_bits=options.fractional_bits,
            antialiased=options.antialiased,
        )
        return SpzGaussians(
            header,
            positions=spz_mod.encode_positions(self.pos, header),
            scales=spz_mod.encode_scales(self.scale),
            rotations=spz_mod.encode_rotations(self.rot, header),
            alphas=self.color[:, 3].copy(),
            colors=spz_mod.encode_colors(self.color[:, 0:3]),
            shs=spz_mod.encode_shs(
                self.sh, options.sh_degree, options.sh_quantize_bits
            ),
        )


class GaussiansSource(Enum):
    """Source discriminant (reference: src/gaussian.rs:395-410)."""

    INTERNAL = "internal"
    PLY = "ply"
    SPZ = "spz"


class Gaussians:
    """Unified gaussian collection (reference: src/gaussian.rs:412-537).

    Holds either the canonical SoA IR or a lossless per-format container,
    dispatching length / IO / conversion by source.
    """

    def __init__(self, data: Union[GaussianSoA, PlyGaussians, SpzGaussians]):
        self.data = data

    @property
    def source(self) -> GaussiansSource:
        if isinstance(self.data, GaussianSoA):
            return GaussiansSource.INTERNAL
        if isinstance(self.data, PlyGaussians):
            return GaussiansSource.PLY
        return GaussiansSource.SPZ

    def __len__(self) -> int:
        return len(self.data)

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    def to_soa(self) -> GaussianSoA:
        """The analog of ``iter_gaussian().collect()`` (gaussian.rs:539-547)."""
        if isinstance(self.data, GaussianSoA):
            return self.data
        if isinstance(self.data, PlyGaussians):
            return GaussianSoA.from_ply(self.data)
        return GaussianSoA.from_spz(self.data)

    @classmethod
    def from_soa(
        cls, soa: GaussianSoA, source: GaussiansSource = GaussiansSource.INTERNAL
    ) -> "Gaussians":
        """Re-encode an SoA into the given source representation
        (reference: from_gaussians_iter, gaussian.rs:427-436)."""
        if source == GaussiansSource.INTERNAL:
            return cls(soa)
        if source == GaussiansSource.PLY:
            return cls(soa.to_ply())
        return cls(soa.to_spz())

    @classmethod
    def read_from_file(cls, path, source: GaussiansSource) -> "Gaussians":
        if source == GaussiansSource.INTERNAL:
            raise IOError("cannot read Internal Gaussians from file")
        if source == GaussiansSource.PLY:
            return cls(PlyGaussians.read_from_file(path))
        return cls(SpzGaussians.read_from_file(path))

    @classmethod
    def read_from(cls, reader: BinaryIO, source: GaussiansSource) -> "Gaussians":
        if source == GaussiansSource.INTERNAL:
            raise IOError("cannot read Internal Gaussians from buffer")
        if source == GaussiansSource.PLY:
            return cls(PlyGaussians.read_from(reader))
        return cls(SpzGaussians.read_from(reader))

    def write_to_file(self, path) -> None:
        if isinstance(self.data, GaussianSoA):
            raise IOError("cannot write Internal Gaussians to file")
        self.data.write_to_file(path)

    def write_to(self, writer: BinaryIO) -> None:
        if isinstance(self.data, GaussianSoA):
            raise IOError("cannot write Internal Gaussians to buffer")
        self.data.write_to(writer)
