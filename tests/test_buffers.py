"""Device buffer layer tests (mirrors reference tests/buffer/*.rs)."""

import numpy as np
import pytest

from wgpu_3dgs_core_tpu import (
    ALL_LAYOUTS,
    Cov3dFormat,
    GaussianDisplayMode,
    GaussianLayout,
    GaussiansBuffer,
    GaussiansBufferTryFromBufferError,
    GaussiansBufferUpdateError,
    GaussiansBufferUpdateRangeError,
    GaussianTransform,
    IrreversibleConfigError,
    ModelTransform,
    ShFormat,
)
from wgpu_3dgs_core_tpu.buffer import (
    gaussian_transform_display_mode,
    gaussian_transform_max_std_dev,
    gaussian_transform_no_sh0,
    gaussian_transform_sh_deg,
)

from .common import gaussian_soa_with_seeds, gaussians_soa

REVERSIBLE = [
    l for l in ALL_LAYOUTS
    if l.sh != ShFormat.NONE and l.cov3d == Cov3dFormat.ROT_SCALE
]


def _layout_id(l):
    return f"{l.sh.name.lower()}-{l.cov3d.name.lower()}"


@pytest.mark.parametrize("layout", ALL_LAYOUTS, ids=_layout_id)
def test_buffer_len_and_empty(layout):
    buf = GaussiansBuffer.new(gaussians_soa(), layout)
    assert len(buf) == 2
    assert not buf.is_empty
    empty = GaussiansBuffer.new_empty(0, layout)
    assert empty.is_empty


@pytest.mark.parametrize("layout", REVERSIBLE, ids=_layout_id)
def test_buffer_download_roundtrip(layout):
    soa = gaussians_soa()
    buf = GaussiansBuffer.new(soa, layout)
    back = buf.download_gaussians()
    np.testing.assert_array_equal(back.pos, soa.pos)
    np.testing.assert_array_equal(back.color, soa.color)


def test_buffer_download_irreversible_raises():
    buf = GaussiansBuffer.new(
        gaussians_soa(), GaussianLayout(cov3d=Cov3dFormat.SINGLE)
    )
    with pytest.raises(IrreversibleConfigError):
        buf.download_gaussians()
    # but the packed download works
    packed = buf.download_packed()
    assert packed.cov3d.shape == (2, 6)


def test_buffer_update():
    soa = gaussians_soa()
    buf = GaussiansBuffer.new(soa, GaussianLayout())
    soa2 = gaussian_soa_with_seeds([7, 8])
    buf.update(soa2)
    np.testing.assert_array_equal(buf.download_gaussians().pos, soa2.pos)
    with pytest.raises(GaussiansBufferUpdateError):
        buf.update(gaussian_soa_with_seeds([1, 2, 3]))


def test_buffer_update_range():
    buf = GaussiansBuffer.new(gaussian_soa_with_seeds([1, 2, 3, 4]))
    sub = gaussian_soa_with_seeds([9])
    buf.update_range(2, sub)
    got = buf.download_gaussians()
    np.testing.assert_array_equal(got.pos[2], sub.pos[0])
    np.testing.assert_array_equal(got.pos[0], gaussian_soa_with_seeds([1]).pos[0])
    with pytest.raises(GaussiansBufferUpdateRangeError):
        buf.update_range(3, gaussian_soa_with_seeds([1, 2]))


def test_buffer_from_arrays_validation():
    soa = gaussians_soa()
    buf = GaussiansBuffer.new(soa)
    d = buf.data
    ok = GaussiansBuffer.from_arrays(buf.layout, d.pos, d.color, d.sh, d.cov3d)
    assert len(ok) == 2
    with pytest.raises(GaussiansBufferTryFromBufferError):
        GaussiansBuffer.from_arrays(
            buf.layout, d.pos, d.color, d.sh, d.cov3d[:, :5]
        )


def test_buffer_nbytes():
    buf = GaussiansBuffer.new(gaussians_soa(), GaussianLayout())
    assert buf.nbytes == 2 * buf.layout.bytes_per_gaussian


# ---------------------------------------------------------------- uniforms


def test_gaussian_transform_flags_roundtrip():
    """(mirrors tests/buffer/gaussian_transform.rs +
    tests/shader/gaussian_transform.rs flag accessors)."""
    t = GaussianTransform(
        size=2.5,
        display_mode=GaussianDisplayMode.ELLIPSE,
        sh_deg=2,
        no_sh0=True,
        max_std_dev=1.5,
    )
    size, flags = t.to_pod()
    assert size == 2.5
    assert int(gaussian_transform_display_mode(flags)) == 1
    assert int(gaussian_transform_sh_deg(flags)) == 2
    assert bool(gaussian_transform_no_sh0(flags))
    # u8 quantization: 1.5/3*255 = 127.5 -> truncates to 127 -> 127/255*3
    np.testing.assert_allclose(
        float(gaussian_transform_max_std_dev(flags)), 127 / 255 * 3, atol=1e-6
    )
    t2 = GaussianTransform.from_pod(size, flags)
    assert t2.display_mode == t.display_mode
    assert t2.sh_deg == t.sh_deg
    assert t2.no_sh0 == t.no_sh0


def test_gaussian_transform_defaults():
    t = GaussianTransform()
    assert t.size == 1.0
    assert t.display_mode == GaussianDisplayMode.SPLAT
    assert t.sh_deg == 3
    assert not t.no_sh0
    assert t.max_std_dev == 3.0
    _, flags = t.to_pod()
    assert (flags >> 24) & 0xFF == 255


def test_gaussian_transform_validation():
    with pytest.raises(ValueError, match="SH degree"):
        GaussianTransform(sh_deg=4)
    with pytest.raises(ValueError, match="max std dev"):
        GaussianTransform(max_std_dev=3.5)
    with pytest.raises(ValueError, match="max std dev"):
        GaussianTransform(max_std_dev=-0.1)


def test_model_transform_defaults_and_update():
    mt = ModelTransform()
    pos, rot, scale = mt.as_arrays()
    np.testing.assert_array_equal(np.asarray(pos), [0, 0, 0])
    np.testing.assert_array_equal(np.asarray(rot), [0, 0, 0, 1])
    np.testing.assert_array_equal(np.asarray(scale), [1, 1, 1])
    mt2 = mt.update(pos=(1, 2, 3))
    assert mt2.pos == (1, 2, 3)
    assert mt2.rot == mt.rot


def test_fixed_size_wrapper_accepts_exact_size():
    import jax.numpy as jnp

    from wgpu_3dgs_core_tpu import FixedSizeBufferWrapper

    arr = jnp.zeros((2, 4), jnp.float32)  # 32 bytes
    w = FixedSizeBufferWrapper(arr, expected_nbytes=32)
    got = w.download_single()
    assert got.shape == (2, 4)
    assert w.buffer is arr


def test_fixed_size_wrapper_rejects_wrong_size():
    import jax.numpy as jnp

    from wgpu_3dgs_core_tpu import FixedSizeBufferWrapper
    from wgpu_3dgs_core_tpu.errors import FixedSizeBufferWrapperError

    arr = jnp.zeros((3,), jnp.float32)  # 12 bytes
    with pytest.raises(FixedSizeBufferWrapperError) as ei:
        FixedSizeBufferWrapper(arr, expected_nbytes=16)
    assert ei.value.buffer_size == 12
    assert ei.value.expected_size == 16


def test_download_helper_and_error():
    import jax.numpy as jnp

    from wgpu_3dgs_core_tpu import download
    from wgpu_3dgs_core_tpu.errors import DownloadBufferError

    arr = jnp.arange(8, dtype=jnp.float32)
    np.testing.assert_array_equal(
        download(arr), np.arange(8, dtype=np.float32)
    )

    # The reference's failed-map path (src/error.rs:56-63): a deleted
    # device buffer is the JAX analog of an unmappable staging buffer.
    arr2 = jnp.arange(4, dtype=jnp.float32) + 1.0
    arr2.delete()
    with pytest.raises(DownloadBufferError):
        download(arr2)
