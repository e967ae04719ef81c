"""Kernel bundle tests (mirrors reference tests/e2e/compute_bundle.rs:
the array_map_add harness kernel, happy paths, and every builder error)."""

import jax.numpy as jnp
import numpy as np
import pytest

from wgpu_3dgs_core_tpu import (
    KernelBundleBuilder,
    OutputSpec,
    ResourceGroupLayout,
)
from wgpu_3dgs_core_tpu.errors import (
    KernelBundleResourceCountError,
    KernelBundleWorkgroupLimitError,
    MissingEntryPointError,
    MissingKernelError,
    MissingResourceLayoutError,
)


def _map_add_kernel(a_ref, b_ref, out_ref, *, scale=1.0):
    """The array_map_add analog (reference:
    tests/common/shader/array_map_add.wesl): out = (a + b) * scale."""
    out_ref[...] = (a_ref[...] + b_ref[...]) * scale


def _builder():
    return (
        KernelBundleBuilder()
        .label("array map add")
        .resource_layout(ResourceGroupLayout("inputs", arity=2))
        .kernel(_map_add_kernel)
        .output(1, jnp.float32)
    )


def test_map_add_dispatch():
    n = 1000  # non-multiple of block size: tail masking
    a = jnp.arange(n, dtype=jnp.float32)
    b = jnp.ones(n, dtype=jnp.float32)
    bundle = _builder().block_size(256).build([[a, b]])
    out = bundle.dispatch(n)
    np.testing.assert_allclose(np.asarray(out)[:, 0], np.arange(n) + 1.0)


def test_map_add_with_override_constant():
    """Pipeline-overridable constants analog
    (reference: tests/e2e/compute_bundle.rs override cases)."""
    n = 64
    a = jnp.full(n, 2.0)
    b = jnp.full(n, 3.0)
    bundle = _builder().constants(scale=10.0).block_size(64).build([[a, b]])
    out = bundle.dispatch(n)
    np.testing.assert_allclose(np.asarray(out)[:, 0], 50.0)


def test_caller_managed_resources():
    """The ComputeBundle<()> type state
    (reference: compute_bundle.rs:255-352)."""
    n = 32
    bundle = _builder().block_size(32).build_without_resources()
    out = bundle.dispatch(n, [[jnp.ones(n), jnp.ones(n)]])
    np.testing.assert_allclose(np.asarray(out)[:, 0], 2.0)
    # no resources bound and none given -> error
    with pytest.raises(KernelBundleResourceCountError):
        bundle.dispatch(n)


def test_update_resources():
    n = 16
    bundle = _builder().block_size(16).build([[jnp.ones(n), jnp.ones(n)]])
    bundle.update_resources([[jnp.full(n, 5.0), jnp.full(n, 6.0)]])
    out = bundle.dispatch(n)
    np.testing.assert_allclose(np.asarray(out)[:, 0], 11.0)


def test_multiple_groups_and_outputs():
    def kernel(a_ref, b_ref, c_ref, sum_ref, prod_ref):
        s = a_ref[...] + b_ref[...] + c_ref[...]
        sum_ref[...] = s
        prod_ref[...] = a_ref[...] * b_ref[...] * c_ref[...]

    n = 128
    bundle = (
        KernelBundleBuilder()
        .resource_layout(ResourceGroupLayout("ab", arity=2))
        .resource_layout(ResourceGroupLayout("c", arity=1))
        .kernel(kernel)
        .output(1)
        .output(1)
        .block_size(64)
        .build([[jnp.full(n, 2.0), jnp.full(n, 3.0)], [jnp.full(n, 4.0)]])
    )
    s, p = bundle.dispatch(n)
    np.testing.assert_allclose(np.asarray(s)[:, 0], 9.0)
    np.testing.assert_allclose(np.asarray(p)[:, 0], 24.0)


def test_vector_valued_items():
    """Items can be [N, F] rows, not just scalars."""

    def kernel(x_ref, out_ref):
        out_ref[...] = x_ref[...] * 2.0

    n, f = 100, 8
    x = jnp.arange(n * f, dtype=jnp.float32).reshape(n, f)
    bundle = (
        KernelBundleBuilder()
        .resource_layout(ResourceGroupLayout("x", arity=1))
        .kernel(kernel)
        .output(f)
        .block_size(32)
        .build([[x]])
    )
    out = bundle.dispatch(n)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x) * 2.0)


def test_kernel_module_entry_points():
    def double(x_ref, out_ref):
        out_ref[...] = x_ref[...] * 2.0

    def triple(x_ref, out_ref):
        out_ref[...] = x_ref[...] * 3.0

    n = 16
    base = (
        KernelBundleBuilder()
        .resource_layout(ResourceGroupLayout("x", arity=1))
        .kernel_module({"double": double, "triple": triple})
        .output(1)
        .block_size(16)
    )
    out = base.entry_point("triple").build([[jnp.ones(n)]]).dispatch(n)
    np.testing.assert_allclose(np.asarray(out)[:, 0], 3.0)


# --------------------------------------------------------------- errors
# (reference: tests/e2e/compute_bundle.rs:242-378 — all builder/creation
# error variants)


def test_missing_resource_layout():
    with pytest.raises(MissingResourceLayoutError):
        KernelBundleBuilder().kernel(_map_add_kernel).build_without_resources()


def test_missing_kernel():
    with pytest.raises(MissingKernelError):
        (
            KernelBundleBuilder()
            .resource_layout(ResourceGroupLayout("x", arity=1))
            .build_without_resources()
        )


def test_missing_entry_point():
    with pytest.raises(MissingEntryPointError):
        (
            KernelBundleBuilder()
            .resource_layout(ResourceGroupLayout("x", arity=1))
            .kernel_module({"a": _map_add_kernel, "b": _map_add_kernel})
            .build_without_resources()
        )


def test_unknown_entry_point():
    with pytest.raises(MissingEntryPointError, match="nope"):
        (
            KernelBundleBuilder()
            .resource_layout(ResourceGroupLayout("x", arity=1))
            .kernel_module({"a": _map_add_kernel})
            .entry_point("nope")
            .build_without_resources()
        )


def test_block_size_limit():
    """(reference: compute_bundle.rs:269-281 workgroup limit error)."""
    with pytest.raises(KernelBundleWorkgroupLimitError):
        _builder().block_size(1 << 20).build_without_resources()


def test_resource_count_mismatch():
    n = 8
    with pytest.raises(KernelBundleResourceCountError):
        _builder().build([[jnp.ones(n)]])  # arity 2, got 1
    with pytest.raises(KernelBundleResourceCountError):
        _builder().build([[jnp.ones(n), jnp.ones(n)], [jnp.ones(n)]])


def test_gaussian_unpack_via_bundle():
    """End-to-end shader-test analog (reference: tests/shader/gaussian.rs):
    run the device unpack math inside a bundle-dispatched Pallas kernel and
    compare against the host (numpy) packing."""
    from wgpu_3dgs_core_tpu import GaussianLayout, GaussiansBuffer
    from wgpu_3dgs_core_tpu.ops import unpack_cov3d

    from .common import gaussians_soa

    def kernel(cov3d_ref, out_ref, *, config):
        # Refs are padded to power-of-two widths; the 6 live columns are
        # written and the bundle slices them back out.
        out_ref[:, :6] = unpack_cov3d(
            cov3d_ref[...], rot_scale=config
        )

    soa = gaussians_soa()
    layout = GaussianLayout()
    buf = GaussiansBuffer.new(soa, layout)
    bundle = (
        KernelBundleBuilder()
        .label("unpack cov3d")
        .resource_layout(ResourceGroupLayout("gaussians", arity=1))
        .kernel(kernel)
        .layout_config(True)
        .output(6, jnp.float32)
        .block_size(8)
        .build([[buf.data.cov3d]])
    )
    out = np.asarray(bundle.dispatch(len(buf)))

    from wgpu_3dgs_core_tpu import Cov3dFormat, pack

    expected = pack(soa, GaussianLayout(cov3d=Cov3dFormat.SINGLE)).cov3d
    np.testing.assert_allclose(out, expected, atol=1e-3, rtol=1e-5)


def test_missing_layout_config():
    """A config-specialized kernel must get .layout_config() before build
    (the missing-WESL-features analog, reference: compute_bundle.rs:505-519)."""
    from wgpu_3dgs_core_tpu.errors import MissingLayoutConfigError

    def kernel(in_ref, out_ref, *, config):
        out_ref[...] = in_ref[...]

    builder = (
        KernelBundleBuilder()
        .resource_layout(ResourceGroupLayout("io", 1))
        .kernel(kernel)
        .output(1)
    )
    with pytest.raises(MissingLayoutConfigError):
        builder.build_without_resources()
    # Supplying the config builds fine.
    builder.layout_config({"dtype": "f32"}).build_without_resources()


def test_dispatch_is_cached_no_retrace():
    """Build-once / dispatch-many: a second dispatch of the same shape
    reuses the jitted launcher without retracing (reference analog:
    compute_bundle.rs:311-330 builds the pipeline once)."""
    n = 256
    a = jnp.arange(n, dtype=jnp.float32)
    b = jnp.ones(n, dtype=jnp.float32)
    bundle = _builder().build([[a, b]])

    r1 = bundle.dispatch(n)
    assert len(bundle._dispatch_cache) == 1
    (run,) = bundle._dispatch_cache.values()
    traces_after_first = run._cache_size()

    r2 = bundle.dispatch(n)
    assert len(bundle._dispatch_cache) == 1
    assert run._cache_size() == traces_after_first  # no retrace
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))

    # A different shape gets its own cached launcher.
    m = 128
    bundle.dispatch(m, [[a[:m], b[:m]]])
    assert len(bundle._dispatch_cache) == 2
