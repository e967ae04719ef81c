"""Numeric helpers that mirror Rust f32 semantics on numpy arrays.

The reference does all format math in f32 with Rust cast/round semantics
(`as u8` saturating truncation, `f32::round` half-away-from-zero). These
helpers reproduce that bit-compatibly so this build's format round-trips
match the reference's numerics (see SURVEY.md §7.3 item 3).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def f32(x) -> np.ndarray:
    """Coerce to a float32 array (format math must stay in f32)."""
    return np.asarray(x, dtype=np.float32)


def rust_round(x: np.ndarray) -> np.ndarray:
    """`f32::round`: round half away from zero (numpy rounds half to even)."""
    x = np.asarray(x)
    return np.trunc(x + np.copysign(np.float32(0.5), x)).astype(x.dtype)


def cast_u8(x: np.ndarray) -> np.ndarray:
    """Rust `as u8`: saturate to [0, 255], truncate toward zero."""
    return np.trunc(np.clip(x, 0.0, 255.0)).astype(np.uint8)


def cast_u32(x: np.ndarray) -> np.ndarray:
    """Rust `as u32`: saturate to [0, 2^32-1], truncate toward zero."""
    return np.trunc(np.clip(x, 0.0, np.float64(2**32 - 1))).astype(np.uint32)


def cast_i32(x: np.ndarray) -> np.ndarray:
    """Rust `as i32`: saturate to i32 bounds, truncate toward zero."""
    return np.trunc(np.clip(x, -(2.0**31), 2.0**31 - 1)).astype(np.int64).astype(
        np.int32
    )


def cast_i8(x: np.ndarray) -> np.ndarray:
    """Rust `as i8`: saturate to [-128, 127], truncate toward zero."""
    return np.trunc(np.clip(x, -128.0, 127.0)).astype(np.int8)


def sigmoid(x: np.ndarray) -> np.ndarray:
    """1 / (1 + exp(-x)) in f32 (reference: src/gaussian.rs:79)."""
    x = f32(x)
    return (F32(1.0) / (F32(1.0) + np.exp(-x))).astype(np.float32)


def logit(p: np.ndarray) -> np.ndarray:
    """-ln(1/p - 1) in f32 (reference: src/gaussian.rs:105)."""
    p = f32(p)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (-np.log(F32(1.0) / p - F32(1.0))).astype(np.float32)


def normalize_rows(v: np.ndarray) -> np.ndarray:
    """Row-wise L2 normalization in f32 (glam `normalize`)."""
    v = f32(v)
    norm = np.sqrt(np.sum(v * v, axis=-1, keepdims=True, dtype=np.float32))
    with np.errstate(divide="ignore", invalid="ignore"):
        return (v / norm).astype(np.float32)


def f16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """IEEE half bits (u16) -> f32 (reference: src/gaussian.rs:138)."""
    return np.asarray(bits, dtype=np.uint16).view(np.float16).astype(np.float32)


def f32_to_f16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> IEEE half bits (u16), round-to-nearest-even like the `half` crate."""
    return f32(x).astype(np.float16).view(np.uint16)
