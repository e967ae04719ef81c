"""Typed error hierarchy.

JAX analog of the reference's thiserror enums (reference:
src/error.rs:1-143). Each Rust enum becomes an exception class; enum variants
become subclasses or structured fields so tests can assert on them the same
way the reference's tests match on variants.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


class Gs3dError(Exception):
    """Base class for all framework errors."""


# ---------------------------------------------------------------------------
# SPZ collection errors (reference: src/error.rs:7-52)
# ---------------------------------------------------------------------------


class SpzGaussiansCollectError(Gs3dError):
    """Error collecting per-field SPZ variants (reference: src/error.rs:44-52)."""


class SpzEmptyIteratorError(SpzGaussiansCollectError):
    """The iterator of SPZ gaussians was empty."""


@dataclass
class SpzInvalidMixedVariantError(SpzGaussiansCollectError):
    """Mixed encodings of one field within a single collection."""

    field: str
    first_variant: Any
    current_variant: Any

    def __str__(self) -> str:
        return (
            f"invalid mixed {self.field} variant: first {self.first_variant!r}, "
            f"got {self.current_variant!r}"
        )


class SpzGaussiansFromIterError(Gs3dError):
    """Errors validating SPZ gaussians against a header (reference: src/error.rs:7-40)."""


@dataclass
class SpzCountMismatchError(SpzGaussiansFromIterError):
    actual_count: int
    header_count: int

    def __str__(self) -> str:
        return (
            f"count mismatch: {self.actual_count} gaussians, header says "
            f"{self.header_count}"
        )


@dataclass
class SpzPositionFloat16MismatchError(SpzGaussiansFromIterError):
    is_float16: bool
    header_uses_float16: bool

    def __str__(self) -> str:
        return (
            f"position float16 mismatch: data float16={self.is_float16}, "
            f"header float16={self.header_uses_float16}"
        )


@dataclass
class SpzRotationQuatSmallestThreeMismatchError(SpzGaussiansFromIterError):
    is_quat_smallest_three: bool
    header_uses_quat_smallest_three: bool

    def __str__(self) -> str:
        return (
            "rotation smallest-three mismatch: data smallest-three="
            f"{self.is_quat_smallest_three}, header smallest-three="
            f"{self.header_uses_quat_smallest_three}"
        )


@dataclass
class SpzShDegreeMismatchError(SpzGaussiansFromIterError):
    sh_degree: int
    header_sh_degree: int

    def __str__(self) -> str:
        return (
            f"SH degree mismatch: data degree {self.sh_degree}, header degree "
            f"{self.header_sh_degree}"
        )


# ---------------------------------------------------------------------------
# Buffer errors (reference: src/error.rs:56-104)
# ---------------------------------------------------------------------------


class DownloadBufferError(Gs3dError):
    """Device-to-host transfer failed (reference: src/error.rs:56-63)."""


@dataclass
class GaussiansBufferUpdateError(Gs3dError):
    """Whole-buffer update count mismatch (reference: src/error.rs:67-73)."""

    count: int
    expected_count: int

    def __str__(self) -> str:
        return (
            f"gaussians buffer update count mismatch: got {self.count}, "
            f"expected {self.expected_count}"
        )


@dataclass
class GaussiansBufferUpdateRangeError(Gs3dError):
    """Range update does not fit (reference: src/error.rs:75-81)."""

    count: int
    start: int
    expected_count: int

    def __str__(self) -> str:
        return (
            f"gaussians buffer range update does not fit: {self.count} gaussians "
            f"at offset {self.start} into buffer of {self.expected_count}"
        )


@dataclass
class GaussiansBufferTryFromBufferError(Gs3dError):
    """Raw buffer size is not a multiple of the layout's itemsize
    (reference: src/error.rs:86-94)."""

    buffer_size: int
    expected_multiple_size: int

    def __str__(self) -> str:
        return (
            f"buffer size {self.buffer_size} is not a multiple of "
            f"{self.expected_multiple_size}"
        )


@dataclass
class FixedSizeBufferWrapperError(Gs3dError):
    """Fixed-size buffer has the wrong size (reference: src/error.rs:98-104)."""

    buffer_size: int
    expected_size: int

    def __str__(self) -> str:
        return (
            f"buffer size {self.buffer_size} does not match expected size "
            f"{self.expected_size}"
        )


# ---------------------------------------------------------------------------
# Kernel bundle errors (reference: src/error.rs:108-143)
# ---------------------------------------------------------------------------


class KernelBundleCreateError(Gs3dError):
    """Errors creating a kernel bundle (reference: src/error.rs:108-126)."""


@dataclass
class KernelBundleResourceCountError(KernelBundleCreateError):
    layout_index: int
    resource_count: int
    expected_count: int

    def __str__(self) -> str:
        return (
            f"resource group {self.layout_index}: got {self.resource_count} "
            f"resources, expected {self.expected_count}"
        )


@dataclass
class KernelBundleWorkgroupLimitError(KernelBundleCreateError):
    workgroup_size: int
    limit: int

    def __str__(self) -> str:
        return (
            f"block size {self.workgroup_size} exceeds device limit {self.limit}"
        )


class KernelBundleBuildError(Gs3dError):
    """Errors building a kernel bundle (reference: src/error.rs:130-143)."""


class MissingResourceLayoutError(KernelBundleBuildError):
    pass


class MissingKernelError(KernelBundleBuildError):
    pass


class MissingEntryPointError(KernelBundleBuildError):
    pass


class MissingLayoutConfigError(KernelBundleBuildError):
    pass


# ---------------------------------------------------------------------------
# IR / config errors
# ---------------------------------------------------------------------------


class IrreversibleConfigError(Gs3dError):
    """A packed layout cannot be converted back to the canonical IR.

    The reference panics in these cases (reference: src/gaussian_config.rs:131-133,
    211-213, 230-232); we raise instead so tests can assert on it.
    """
