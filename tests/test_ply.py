"""PLY format tests (mirrors reference tests/e2e/ply.rs)."""

import io

import numpy as np
import pytest

from wgpu_3dgs_core_tpu import GaussianSoA, PlyGaussians
from wgpu_3dgs_core_tpu.models import ply as ply_mod

from .common import PLY_TOLERANCES, assert_gaussians_close, gaussians_soa

REFERENCE_MODEL_PLY = "/root/reference/examples/model.ply"


def test_read_reference_model_ply():
    ply = PlyGaussians.read_from_file(REFERENCE_MODEL_PLY)
    assert len(ply) == 9
    soa = GaussianSoA.from_ply(ply)
    assert len(soa) == 9
    # Quats come out normalized.
    np.testing.assert_allclose(
        np.linalg.norm(soa.rot, axis=1), 1.0, atol=1e-5, rtol=0
    )
    # Linear scales are positive (exp of log-scales).
    assert (soa.scale > 0).all()


def test_ply_header_inria_detection():
    with open(REFERENCE_MODEL_PLY, "rb") as f:
        header = ply_mod.read_header(f)
    assert header.inria
    assert header.count == 9


def test_ply_write_read_roundtrip_bytes_exact():
    ply = gaussians_soa().to_ply()
    buf = io.BytesIO()
    ply.write_to(buf)
    buf.seek(0)
    ply2 = PlyGaussians.read_from(buf)
    assert ply == ply2


def test_ply_gaussian_roundtrip_tolerances():
    original = gaussians_soa()
    back = GaussianSoA.from_ply(original.to_ply())
    assert_gaussians_close(original, back, PLY_TOLERANCES)


def test_ply_custom_property_order():
    """Shuffled float properties must land in the right columns
    (reference: tests/e2e/ply.rs custom-order cases)."""
    ply = gaussians_soa().to_ply()
    n = len(ply)
    order = list(range(ply_mod.NUM_PLY_PROPERTIES))[::-1]
    names = [ply_mod.PLY_PROPERTIES[i] for i in order]
    body = np.ascontiguousarray(ply.block[:, order], dtype="<f4").tobytes()

    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    for name in names:
        buf.write(f"property float {name}\n".encode())
    buf.write(b"end_header\n")
    buf.write(body)
    buf.seek(0)

    ply2 = PlyGaussians.read_from(buf)
    assert ply == ply2


def test_ply_big_endian():
    ply = gaussians_soa().to_ply()
    n = len(ply)
    body = np.ascontiguousarray(ply.block, dtype=">f4").tobytes()

    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_big_endian 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    for name in ply_mod.PLY_PROPERTIES:
        buf.write(f"property float {name}\n".encode())
    buf.write(b"end_header\n")
    buf.write(body)
    buf.seek(0)

    ply2 = PlyGaussians.read_from(buf)
    np.testing.assert_allclose(ply.block, ply2.block, rtol=0, atol=0)


def test_ply_ascii():
    ply = gaussians_soa().to_ply()
    n = len(ply)
    buf = io.BytesIO()
    buf.write(b"ply\nformat ascii 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    for name in ply_mod.PLY_PROPERTIES:
        buf.write(f"property float {name}\n".encode())
    buf.write(b"end_header\n")
    for row in ply.block:
        buf.write((" ".join(repr(float(v)) for v in row) + "\n").encode())
    buf.seek(0)

    ply2 = PlyGaussians.read_from(buf)
    np.testing.assert_allclose(ply.block, ply2.block, rtol=0, atol=1e-6)


def test_ply_non_float_properties_ignored_with_extra_columns():
    """Integer-typed properties are parsed but not applied
    (reference: ply.rs:107-115)."""
    ply = gaussians_soa().to_ply()
    n = len(ply)
    # x as float, extra uchar column, then the rest.
    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    buf.write(b"property float x\n")
    buf.write(b"property uchar red\n")  # unknown name -> warn + skip
    buf.write(b"property int y\n")  # known name, wrong type -> error log + skip
    buf.write(b"end_header\n")
    for row in ply.block:
        buf.write(np.float32(row[0]).tobytes())
        buf.write(np.uint8(7).tobytes())
        buf.write(np.int32(1234).tobytes())
    buf.seek(0)

    ply2 = PlyGaussians.read_from(buf)
    np.testing.assert_array_equal(ply2.block[:, 0], ply.block[:, 0])
    assert (ply2.block[:, 1] == 0).all()  # y untouched


def test_ply_binary_list_property_skipped():
    """A list property is consumed and ignored, not an error — the
    reference's generic path parses lists via ply-rs and never applies
    them (reference: ply.rs:374-378, ply.rs:25-100)."""
    ply = gaussians_soa().to_ply()
    n = len(ply)
    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    buf.write(b"property float x\n")
    buf.write(b"property list uchar int vertex_indices\n")
    buf.write(b"property float y\n")
    buf.write(b"end_header\n")
    for r, row in enumerate(ply.block):
        buf.write(np.float32(row[0]).tobytes())
        n_items = r % 3  # variable-length lists
        buf.write(np.uint8(n_items).tobytes())
        buf.write(np.arange(n_items, dtype="<i4").tobytes())
        buf.write(np.float32(row[1]).tobytes())
    buf.seek(0)

    ply2 = PlyGaussians.read_from(buf)
    np.testing.assert_array_equal(ply2.block[:, 0], ply.block[:, 0])
    np.testing.assert_array_equal(ply2.block[:, 1], ply.block[:, 1])
    assert (ply2.block[:, 2:] == 0).all()


def test_ply_binary_list_property_truncated_errors():
    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(b"element vertex 2\n")
    buf.write(b"property float x\n")
    buf.write(b"property list uchar int vertex_indices\n")
    buf.write(b"end_header\n")
    buf.write(np.float32(1.0).tobytes())
    buf.write(np.uint8(4).tobytes())  # promises 4 ints, delivers none
    buf.seek(0)
    with pytest.raises(IOError):
        PlyGaussians.read_from(buf)


def test_ply_binary_list_negative_count_errors():
    """A corrupt signed list count must raise, not walk ``off`` backward
    and silently misparse the rest of the body."""
    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(b"element vertex 2\n")
    buf.write(b"property float x\n")
    buf.write(b"property list int int vertex_indices\n")
    buf.write(b"end_header\n")
    buf.write(np.float32(1.0).tobytes())
    buf.write(np.int32(-7).tobytes())  # negative count
    buf.write(np.float32(2.0).tobytes())
    buf.write(np.int32(0).tobytes())
    buf.seek(0)
    with pytest.raises(IOError, match="negative PLY list count"):
        PlyGaussians.read_from(buf)


def test_ply_ascii_list_property_skipped():
    ply = gaussians_soa().to_ply()
    n = len(ply)
    buf = io.BytesIO()
    buf.write(b"ply\nformat ascii 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    buf.write(b"property float x\n")
    buf.write(b"property list uchar float weights\n")
    buf.write(b"property float y\n")
    buf.write(b"end_header\n")
    for r, row in enumerate(ply.block):
        n_items = r % 2 + 1
        items = " ".join(["9.5"] * n_items)
        buf.write(
            f"{float(row[0])!r} {n_items} {items} {float(row[1])!r}\n".encode()
        )
    buf.seek(0)

    ply2 = PlyGaussians.read_from(buf)
    np.testing.assert_allclose(ply2.block[:, 0], ply.block[:, 0], atol=1e-6)
    np.testing.assert_allclose(ply2.block[:, 1], ply.block[:, 1], atol=1e-6)


def test_ply_missing_vertex_element_errors():
    buf = io.BytesIO(b"ply\nformat ascii 1.0\nelement face 0\nend_header\n")
    with pytest.raises(IOError, match="vertex element not found"):
        PlyGaussians.read_from(buf)


def test_ply_truncated_body_errors():
    ply = gaussians_soa().to_ply()
    buf = io.BytesIO()
    ply.write_to(buf)
    data = buf.getvalue()[:-8]
    with pytest.raises(IOError, match="EOF"):
        PlyGaussians.read_from(io.BytesIO(data))


def test_ply_ascii_malformed_row_errors():
    buf = io.BytesIO()
    buf.write(b"ply\nformat ascii 1.0\nelement vertex 1\n")
    buf.write(b"property float x\nproperty float y\n")
    buf.write(b"end_header\n")
    buf.write(b"1.0\n")  # missing y
    buf.seek(0)
    with pytest.raises(IOError, match="invalid or missing"):
        PlyGaussians.read_from(buf)


def test_ply_not_a_ply_file_errors():
    with pytest.raises(IOError, match="magic"):
        PlyGaussians.read_from(io.BytesIO(b"obj\n"))


def test_ply_file_roundtrip(tmp_path):
    ply = gaussians_soa().to_ply()
    path = tmp_path / "model.ply"
    ply.write_to_file(path)
    assert PlyGaussians.read_from_file(path) == ply
