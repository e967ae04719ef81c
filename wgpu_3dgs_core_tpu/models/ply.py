"""PLY source format: Inria-format 3D Gaussian splatting point clouds.

JAX redesign of the reference's PLY layer (reference:
src/source_format/ply.rs). Instead of a per-gaussian POD struct iterated one
record at a time, this module parses the whole file into a columnar (SoA)
numpy representation in bulk:

- **Inria fast path**: when the header lists exactly the 62 float properties
  in canonical order with system-endian binary encoding (reference:
  ply.rs:292-321), the body is one contiguous f32[N, 62] block read with a
  single ``np.frombuffer`` — the vectorized analog of the reference's
  ``read_exact`` straight into ``PlyGaussianPod`` (ply.rs:334-338).
- **Generic path**: ascii / binary-LE / binary-BE with arbitrary property
  order and scalar types (reference: ply.rs:339-382), built as a numpy
  structured dtype and remapped to the canonical columns by name. Only
  float-typed properties are applied, mirroring the reference's
  ``set_property`` (ply.rs:107-115); unknown names warn (ply.rs:96).
"""

from __future__ import annotations

import io
import logging
from dataclasses import dataclass, field
from typing import BinaryIO, Optional, Union

import numpy as np

log = logging.getLogger(__name__)

# The canonical Inria property list (reference: src/source_format/ply.rs:204-267).
PLY_PROPERTIES: tuple[str, ...] = (
    ("x", "y", "z")
    + ("nx", "ny", "nz")
    + ("f_dc_0", "f_dc_1", "f_dc_2")
    + tuple(f"f_rest_{i}" for i in range(45))
    + ("opacity",)
    + ("scale_0", "scale_1", "scale_2")
    + ("rot_0", "rot_1", "rot_2", "rot_3")
)

NUM_PLY_PROPERTIES = len(PLY_PROPERTIES)  # 62

# Column ranges within the canonical f32[N, 62] block.
_COL = {name: i for i, name in enumerate(PLY_PROPERTIES)}

_PLY_SCALAR_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def _vertex_element_not_found() -> IOError:
    # Mirrors the reference's error message (ply.rs:186-191).
    return IOError("Gaussian vertex element not found in PLY header")


@dataclass
class PlyProperty:
    name: str
    type_name: str  # e.g. "float"; list properties keep "list <a> <b>"
    is_list: bool = False


@dataclass
class PlyElement:
    name: str
    count: int
    properties: list[PlyProperty] = field(default_factory=list)


@dataclass
class PlyHeader:
    """Parsed PLY header (reference: ply.rs:129-155).

    ``inria`` is True when the vertex element matches the canonical 62
    float properties in order and the encoding is binary little-endian
    (system endianness), enabling the bulk fast path.
    """

    encoding: str  # "ascii" | "binary_little_endian" | "binary_big_endian"
    elements: list[PlyElement]
    inria: bool

    def vertex(self) -> PlyElement:
        for el in self.elements:
            if el.name == "vertex":
                return el
        raise _vertex_element_not_found()

    @property
    def count(self) -> Optional[int]:
        for el in self.elements:
            if el.name == "vertex":
                return el.count
        return None


def read_header(reader: BinaryIO) -> PlyHeader:
    """Parse a PLY header and classify Inria vs custom (reference: ply.rs:292-321)."""
    magic = reader.readline().strip()
    if magic != b"ply":
        raise IOError("not a PLY file: missing 'ply' magic line")

    encoding: Optional[str] = None
    elements: list[PlyElement] = []

    while True:
        line = reader.readline()
        if not line:
            raise IOError("unexpected EOF in PLY header")
        parts = line.decode("ascii", errors="replace").strip().split()
        if not parts:
            continue
        kw = parts[0]
        if kw == "comment" or kw == "obj_info":
            continue
        if kw == "format":
            if len(parts) < 2 or parts[1] not in (
                "ascii",
                "binary_little_endian",
                "binary_big_endian",
            ):
                raise IOError(f"unsupported PLY format: {line!r}")
            encoding = parts[1]
        elif kw == "element":
            if len(parts) != 3:
                raise IOError(f"malformed PLY element line: {line!r}")
            elements.append(PlyElement(name=parts[1], count=int(parts[2])))
        elif kw == "property":
            if not elements:
                raise IOError("PLY property before any element")
            if len(parts) >= 2 and parts[1] == "list":
                elements[-1].properties.append(
                    PlyProperty(name=parts[-1], type_name=" ".join(parts[1:-1]),
                                is_list=True)
                )
            else:
                if len(parts) != 3:
                    raise IOError(f"malformed PLY property line: {line!r}")
                elements[-1].properties.append(
                    PlyProperty(name=parts[2], type_name=parts[1])
                )
        elif kw == "end_header":
            break
        else:
            raise IOError(f"unknown PLY header line: {line!r}")

    if encoding is None:
        raise IOError("PLY header missing format line")

    vertex = next((el for el in elements if el.name == "vertex"), None)
    if vertex is None:
        raise _vertex_element_not_found()

    # System endianness is little on every supported platform; the reference
    # compares against the compile-time system endianness (ply.rs:300-303).
    inria = (
        encoding == "binary_little_endian"
        and len(vertex.properties) == NUM_PLY_PROPERTIES
        and all(
            p.name == name and p.type_name in ("float", "float32") and not p.is_list
            for p, name in zip(vertex.properties, PLY_PROPERTIES)
        )
    )

    return PlyHeader(encoding=encoding, elements=elements, inria=inria)


def _read_inria_block(reader: BinaryIO, count: int) -> np.ndarray:
    nbytes = count * NUM_PLY_PROPERTIES * 4
    buf = reader.read(nbytes)
    if len(buf) < nbytes:
        raise IOError(
            f"unexpected EOF reading PLY body: got {len(buf)} of {nbytes} bytes"
        )
    return np.frombuffer(buf, dtype="<f4").reshape(count, NUM_PLY_PROPERTIES).copy()


def _read_custom_binary(reader: BinaryIO, vertex: PlyElement, count: int,
                        byteorder: str) -> np.ndarray:
    if any(p.is_list for p in vertex.properties):
        # List properties are consumed and never applied, matching the
        # reference's generic path, whose ply-rs element parse reads them
        # but set_value only accepts the 62 scalar floats (reference:
        # ply.rs:374-378, ply.rs:25-100). Variable-length records force a
        # per-record walk.
        return _read_custom_binary_with_lists(reader, vertex, count, byteorder)
    fields = []
    applied: list[tuple[str, str]] = []  # (struct field name, canonical name)
    for i, prop in enumerate(vertex.properties):
        base = _PLY_SCALAR_DTYPES.get(prop.type_name)
        if base is None:
            raise IOError(f"unknown PLY scalar type: {prop.type_name!r}")
        fname = f"p{i}"
        fields.append((fname, byteorder + base))
        if prop.name in _COL:
            # Only float-typed properties are applied; the reference's
            # set_property rejects non-floats (ply.rs:107-115).
            if base == "f4":
                applied.append((fname, prop.name))
            else:
                log.error("Property %s is not a float", prop.name)
        else:
            log.warning("Unknown property: %s", prop.name)

    dtype = np.dtype(fields)
    nbytes = count * dtype.itemsize
    buf = reader.read(nbytes)
    if len(buf) < nbytes:
        raise IOError(
            f"unexpected EOF reading PLY body: got {len(buf)} of {nbytes} bytes"
        )
    records = np.frombuffer(buf, dtype=dtype)

    block = np.zeros((count, NUM_PLY_PROPERTIES), dtype=np.float32)
    for fname, canonical in applied:
        block[:, _COL[canonical]] = records[fname].astype(np.float32)
    return block


def _read_custom_binary_with_lists(reader: BinaryIO, vertex: PlyElement,
                                   count: int, byteorder: str) -> np.ndarray:
    """Generic binary path for records containing list properties.

    The lists themselves are parsed and discarded; scalar float properties
    with canonical names are applied as usual (reference: ply.rs:374-378 —
    ply-rs consumes list properties, set_value never applies them).
    """
    plan = []  # ("scalar", np.dtype, col) | ("list", count_dtype, item_size)
    for prop in vertex.properties:
        if prop.is_list:
            parts = prop.type_name.split()  # "list <count_t> <item_t>"
            if len(parts) != 3:
                raise IOError(f"malformed PLY list type: {prop.type_name!r}")
            cnt_base = _PLY_SCALAR_DTYPES.get(parts[1])
            item_base = _PLY_SCALAR_DTYPES.get(parts[2])
            if cnt_base is None or item_base is None:
                raise IOError(f"unknown PLY scalar type in: {prop.type_name!r}")
            log.warning("Ignoring list property: %s", prop.name)
            plan.append(("list", np.dtype(byteorder + cnt_base),
                         np.dtype(item_base).itemsize))
        else:
            base = _PLY_SCALAR_DTYPES.get(prop.type_name)
            if base is None:
                raise IOError(f"unknown PLY scalar type: {prop.type_name!r}")
            col = -1
            if prop.name in _COL:
                if base == "f4":
                    col = _COL[prop.name]
                else:
                    log.error("Property %s is not a float", prop.name)
            else:
                log.warning("Unknown property: %s", prop.name)
            plan.append(("scalar", np.dtype(byteorder + base), col))

    buf = reader.read()
    block = np.zeros((count, NUM_PLY_PROPERTIES), dtype=np.float32)
    off = 0
    try:
        for r in range(count):
            for entry in plan:
                if entry[0] == "scalar":
                    _, dt, col = entry
                    if col >= 0:
                        block[r, col] = np.frombuffer(buf, dt, 1, off)[0]
                    off += dt.itemsize
                else:
                    _, cnt_dt, item_size = entry
                    n_items = int(np.frombuffer(buf, cnt_dt, 1, off)[0])
                    if n_items < 0:
                        # A corrupt signed count would move ``off``
                        # BACKWARD and silently misparse the rest of the
                        # body (the final bounds check never fires).
                        raise IOError(
                            "negative PLY list count (corrupt body)"
                        )
                    off += cnt_dt.itemsize + n_items * item_size
    except ValueError as e:  # frombuffer past the end of the body
        raise IOError("unexpected EOF reading PLY body") from e
    if off > len(buf):
        raise IOError("unexpected EOF reading PLY body")
    return block


def _read_custom_ascii(reader: BinaryIO, vertex: PlyElement, count: int) -> np.ndarray:
    block = np.zeros((count, NUM_PLY_PROPERTIES), dtype=np.float32)
    scalar_props = [p for p in vertex.properties if not p.is_list]
    n_props = len(scalar_props)
    cols = np.array(
        [_COL.get(p.name, -1) for p in scalar_props], dtype=np.int64
    )
    for p in vertex.properties:
        if p.is_list:
            log.warning("Ignoring list property: %s", p.name)
        elif p.name not in _COL:
            log.warning("Unknown property: %s", p.name)

    has_lists = any(p.is_list for p in vertex.properties)
    rows = np.empty((count, n_props), dtype=np.float32)
    for r in range(count):
        line = reader.readline()
        if not line:
            raise IOError("Gaussian element property invalid or missing in PLY")
        # The reference splits on single spaces and f32-parses every token
        # (ply.rs:347-370); extra tokens are ignored, short/invalid rows error.
        tokens = line.decode("ascii", errors="replace").split()
        try:
            if has_lists:
                # Consume tokens property by property; list values are
                # parsed (count + items) and discarded.
                vals, ti = [], 0
                for p in vertex.properties:
                    if p.is_list:
                        n_items = int(float(tokens[ti]))
                        ti += 1 + n_items
                    else:
                        vals.append(np.float32(tokens[ti]))
                        ti += 1
                if ti > len(tokens):
                    raise IndexError
                rows[r] = vals
            else:
                if len(tokens) < n_props:
                    raise IndexError
                rows[r] = [np.float32(t) for t in tokens[:n_props]]
        except (ValueError, IndexError) as e:
            raise IOError("Gaussian element property invalid or missing in PLY") from e

    keep = cols >= 0
    block[:, cols[keep]] = rows[:, keep]
    return block


class PlyGaussians:
    """Columnar container of raw Inria-PLY gaussian properties.

    SoA analog of the reference's ``PlyGaussians(Vec<PlyGaussianPod>)``
    (reference: ply.rs:193-200). ``block`` is the canonical f32[N, 62]
    property matrix in ``PLY_PROPERTIES`` order; the named views below slice
    it without copying.
    """

    def __init__(self, block: np.ndarray):
        block = np.asarray(block, dtype=np.float32)
        if block.ndim != 2 or block.shape[1] != NUM_PLY_PROPERTIES:
            raise ValueError(
                f"PLY block must be [N, {NUM_PLY_PROPERTIES}], got {block.shape}"
            )
        self.block = block

    # -- named column views (PLY storage order; SH is planar R15|G15|B15) --
    @property
    def pos(self) -> np.ndarray:
        return self.block[:, 0:3]

    @property
    def normal(self) -> np.ndarray:
        return self.block[:, 3:6]

    @property
    def color(self) -> np.ndarray:
        """f_dc SH0 coefficients, one per channel."""
        return self.block[:, 6:9]

    @property
    def sh(self) -> np.ndarray:
        """f_rest_0..44, planar: 15 R values, 15 G values, 15 B values."""
        return self.block[:, 9:54]

    @property
    def alpha(self) -> np.ndarray:
        """Pre-sigmoid opacity logit."""
        return self.block[:, 54]

    @property
    def scale(self) -> np.ndarray:
        """Log-scales."""
        return self.block[:, 55:58]

    @property
    def rot(self) -> np.ndarray:
        """Quaternion in PLY (w, x, y, z) order, unnormalized."""
        return self.block[:, 58:62]

    def __len__(self) -> int:
        return self.block.shape[0]

    def __eq__(self, other) -> bool:
        return isinstance(other, PlyGaussians) and np.array_equal(
            self.block, other.block
        )

    # ------------------------------------------------------------------ I/O

    @classmethod
    def read_from(cls, reader: BinaryIO) -> "PlyGaussians":
        """Read a full PLY stream (reference: ply.rs:393-408)."""
        header = read_header(reader)
        return cls.read_gaussians(reader, header)

    @classmethod
    def read_gaussians(cls, reader: BinaryIO, header: PlyHeader) -> "PlyGaussians":
        """Read the body given a parsed header (reference: ply.rs:326-384)."""
        vertex = header.vertex()
        count = vertex.count
        log.info("Reading PLY format with %d Gaussians", count)
        if header.inria:
            block = _read_inria_block(reader, count)
        elif header.encoding == "ascii":
            block = _read_custom_ascii(reader, vertex, count)
        else:
            byteorder = "<" if header.encoding == "binary_little_endian" else ">"
            block = _read_custom_binary(reader, vertex, count, byteorder)
        return cls(block)

    @classmethod
    def read_from_file(cls, path) -> "PlyGaussians":
        with open(path, "rb") as f:
            return cls.read_from(io.BufferedReader(f))

    def write_to(self, writer: BinaryIO) -> None:
        """Write binary little-endian Inria PLY (reference: ply.rs:410-431)."""
        writer.write(b"ply\n")
        writer.write(b"format binary_little_endian 1.0\n")
        writer.write(f"element vertex {len(self)}\n".encode("ascii"))
        for name in PLY_PROPERTIES:
            writer.write(f"property float {name}\n".encode("ascii"))
        writer.write(b"end_header\n")
        writer.write(np.ascontiguousarray(self.block, dtype="<f4").tobytes())

    def write_to_file(self, path) -> None:
        with open(path, "wb") as f:
            self.write_to(f)


def read_ply(source: Union[str, BinaryIO]) -> PlyGaussians:
    """Convenience entry point: path or binary stream -> PlyGaussians."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        return PlyGaussians.read_from_file(source)
    return PlyGaussians.read_from(source)
