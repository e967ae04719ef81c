"""Native C++ codec vs numpy bit-exactness (csrc/spz_codec.cpp)."""

import numpy as np
import pytest

from wgpu_3dgs_core_tpu.models import spz as spz_mod
from wgpu_3dgs_core_tpu.models.spz import SpzHeader
from wgpu_3dgs_core_tpu.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native codec library not built"
)

N = 50_000  # above MIN_NATIVE_N so the native path engages


@pytest.fixture
def numpy_only(monkeypatch):
    """Force the numpy fallback inside spz codecs."""
    monkeypatch.setattr(spz_mod._native, "get_lib", lambda: None)


def _rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("version", [2, 3])
def test_positions_roundtrip_exact(version, monkeypatch):
    header = SpzHeader(version=version, num_points=N, sh_degree=0,
                       fractional_bits=12)
    pos = (_rng().random((N, 3), dtype=np.float32) * 100 - 50)

    enc_native = spz_mod.encode_positions(pos, header)
    dec_native = spz_mod.decode_positions(enc_native, header)
    monkeypatch.setattr(spz_mod._native, "get_lib", lambda: None)
    enc_numpy = spz_mod.encode_positions(pos, header)
    dec_numpy = spz_mod.decode_positions(enc_numpy, header)

    np.testing.assert_array_equal(enc_native, enc_numpy)
    np.testing.assert_array_equal(dec_native, dec_numpy)


def test_scales_exact(monkeypatch):
    scale = (_rng().random((N, 3), dtype=np.float32) * 5 + 1e-3)
    enc_n = spz_mod.encode_scales(scale)
    dec_n = spz_mod.decode_scales(enc_n)
    monkeypatch.setattr(spz_mod._native, "get_lib", lambda: None)
    enc_p = spz_mod.encode_scales(scale)
    dec_p = spz_mod.decode_scales(enc_p)
    np.testing.assert_array_equal(enc_n, enc_p)
    np.testing.assert_allclose(dec_n, dec_p, rtol=1e-6)


@pytest.mark.parametrize("version", [2, 3])
def test_rotations_exact(version, monkeypatch):
    header = SpzHeader(version=version, num_points=N, sh_degree=0,
                       fractional_bits=12)
    q = _rng().normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    enc_n = spz_mod.encode_rotations(q, header)
    dec_n = spz_mod.decode_rotations(enc_n, header)
    monkeypatch.setattr(spz_mod._native, "get_lib", lambda: None)
    enc_p = spz_mod.encode_rotations(q, header)
    dec_p = spz_mod.decode_rotations(enc_p, header)

    np.testing.assert_array_equal(enc_n, enc_p)
    np.testing.assert_allclose(dec_n, dec_p, atol=1e-6)


def test_colors_exact(monkeypatch):
    c = _rng().integers(0, 256, (N, 3)).astype(np.uint8)
    enc_n = spz_mod.encode_colors(c)
    dec_n = spz_mod.decode_colors(enc_n)
    monkeypatch.setattr(spz_mod._native, "get_lib", lambda: None)
    enc_p = spz_mod.encode_colors(c)
    dec_p = spz_mod.decode_colors(enc_p)
    np.testing.assert_array_equal(enc_n, enc_p)
    np.testing.assert_array_equal(dec_n, dec_p)


@pytest.mark.parametrize("bits", [2, 4, 5, 8])
def test_sh_exact(bits, monkeypatch):
    sh = (_rng().random((N, 15, 3), dtype=np.float32) * 2 - 1)
    enc_n = spz_mod.encode_shs(sh, 3, (bits, bits, bits))
    dec_n = spz_mod.decode_shs(enc_n)
    monkeypatch.setattr(spz_mod._native, "get_lib", lambda: None)
    enc_p = spz_mod.encode_shs(sh, 3, (bits, bits, bits))
    dec_p = spz_mod.decode_shs(enc_p)
    np.testing.assert_array_equal(enc_n, enc_p)
    np.testing.assert_array_equal(dec_n, dec_p)


def test_full_file_roundtrip_native_matches_numpy(monkeypatch, tmp_path):
    """Whole-file SPZ write with native codecs == numpy byte-for-byte."""
    from wgpu_3dgs_core_tpu import GaussianSoA

    rng = _rng()
    soa = GaussianSoA(
        rot=rng.normal(size=(N, 4)).astype(np.float32),
        pos=(rng.random((N, 3), dtype=np.float32) * 10 - 5),
        color=rng.integers(0, 256, (N, 4)).astype(np.uint8),
        sh=(rng.random((N, 15, 3), dtype=np.float32) * 2 - 1),
        scale=(rng.random((N, 3), dtype=np.float32) + 0.01),
    )
    soa.rot /= np.linalg.norm(soa.rot, axis=1, keepdims=True)

    spz_native = soa.to_spz()
    monkeypatch.setattr(spz_mod._native, "get_lib", lambda: None)
    spz_numpy = soa.to_spz()
    assert spz_native == spz_numpy


# --- loader branch coverage ----------------------------------------------


@pytest.fixture
def fresh_loader(monkeypatch):
    """Reset the module-level load cache around each loader test."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    yield
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_loader_disabled_by_env(fresh_loader, monkeypatch):
    monkeypatch.setenv("GS3D_DISABLE_NATIVE", "1")
    assert native.get_lib() is None
    assert not native.available()


def test_loader_build_failure_falls_back(fresh_loader, monkeypatch, tmp_path):
    # Missing library AND missing build script -> numpy fallback.
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(native, "_CSRC", str(tmp_path))
    assert native._build() is False
    assert native.get_lib() is None


def test_loader_broken_build_script(fresh_loader, monkeypatch, tmp_path):
    # A build script that fails (nonzero exit) is swallowed -> fallback.
    script = tmp_path / "build.sh"
    script.write_text("exit 3\n")
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(native, "_CSRC", str(tmp_path))
    assert native._build() is False
    assert native.get_lib() is None


def test_loader_corrupt_library(fresh_loader, monkeypatch, tmp_path):
    # A present-but-unloadable .so raises OSError inside CDLL -> fallback.
    bad = tmp_path / "libspz_codec.so"
    bad.write_bytes(b"not an elf file")
    monkeypatch.setattr(native, "_LIB_PATH", str(bad))
    assert native.get_lib() is None


def test_loader_abi_mismatch(fresh_loader, monkeypatch):
    # A library reporting the wrong ABI version is rejected.
    class FakeFn:
        restype = None
        argtypes = None

        def __call__(self):
            return 999

    class FakeLib:
        def __getattr__(self, name):
            return FakeFn()

    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(native.os.path, "exists", lambda p: True)
    assert native.get_lib() is None


def test_loader_caches_result(fresh_loader, monkeypatch):
    calls = []
    monkeypatch.setenv("GS3D_DISABLE_NATIVE", "1")
    orig = native.os.path.exists

    def counting(p):
        calls.append(p)
        return orig(p)

    monkeypatch.setattr(native.os.path, "exists", counting)
    assert native.get_lib() is None
    n_calls = len(calls)
    # Second call short-circuits on the _tried flag (no new stat calls).
    assert native.get_lib() is None
    assert len(calls) == n_calls


# ---- loader branch coverage ---------------------------------------------
# The build-failure / ABI-mismatch / disable paths must all fall back to
# None (numpy) without raising; each test resets the module-level cache.


def _fresh(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_disable_env_short_circuits(monkeypatch):
    _fresh(monkeypatch)
    monkeypatch.setenv("GS3D_DISABLE_NATIVE", "1")
    assert native.get_lib() is None
    # cached: a second call stays None even after the env goes away
    monkeypatch.delenv("GS3D_DISABLE_NATIVE")
    assert native.get_lib() is None


def test_missing_lib_and_build_script(monkeypatch, tmp_path):
    _fresh(monkeypatch)
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "no.so"))
    monkeypatch.setattr(native, "_CSRC", str(tmp_path))
    assert native._build() is False  # no build.sh at all
    assert native.get_lib() is None


def test_build_failure_falls_back(monkeypatch, tmp_path):
    _fresh(monkeypatch)
    script = tmp_path / "build.sh"
    script.write_text("exit 1\n")
    monkeypatch.setattr(native, "_CSRC", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "no.so"))
    assert native._build() is False  # nonzero exit -> CalledProcessError
    assert native.get_lib() is None


def test_build_without_artifact(monkeypatch, tmp_path):
    _fresh(monkeypatch)
    script = tmp_path / "build.sh"
    script.write_text("exit 0\n")  # succeeds but produces no .so
    monkeypatch.setattr(native, "_CSRC", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "no.so"))
    assert native._build() is False


def test_unloadable_library(monkeypatch, tmp_path):
    _fresh(monkeypatch)
    bad = tmp_path / "libbad.so"
    bad.write_bytes(b"not an elf file")
    monkeypatch.setattr(native, "_LIB_PATH", str(bad))
    assert native.get_lib() is None  # OSError branch


def test_abi_mismatch(monkeypatch):
    _fresh(monkeypatch)

    class FakeFn:
        restype = None
        argtypes = None

        def __call__(self):
            return 999  # wrong ABI version

    class FakeLib:
        def __getattr__(self, name):
            return FakeFn()

    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(native.os.path, "exists", lambda p: True)
    assert native.get_lib() is None
