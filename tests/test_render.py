"""Renderer tests: tiled Pallas path vs brute-force jnp reference.

The verification idiom mirrors the reference's shader tests (device kernel
vs CPU result within epsilon, SURVEY.md §3.5), extended with gradient
parity: the hand-derived Pallas VJP must match autodiff of the reference
renderer for every gaussian parameter (BASELINE.md gradient correctness).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wgpu_3dgs_core_tpu import (
    Camera,
    GaussianLayout,
    GaussiansBuffer,
    GaussianSoA,
    GaussianTransform,
    ModelTransform,
    read_ply,
    render,
    render_gaussians,
    render_reference,
)
from wgpu_3dgs_core_tpu.ops.transforms import cov3d_from_rot_scale


def _random_scene(n=30, seed=0):
    rng = np.random.default_rng(seed)
    means = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats = jnp.asarray(quats / np.linalg.norm(quats, axis=1, keepdims=True))
    scales = jnp.asarray(0.05 + 0.2 * rng.random((n, 3)), jnp.float32)
    color = jnp.asarray(rng.random((n, 3)), jnp.float32)
    opac = jnp.asarray(0.3 + 0.6 * rng.random(n), jnp.float32)
    sh = jnp.asarray(0.2 * rng.normal(size=(n, 15, 3)), jnp.float32)
    return means, quats, scales, color, opac, sh


CAM = Camera.look_at(eye=(0, 0, -5), target=(0, 0, 0), width=64, height=48,
                     fov_y=0.8)
BG = (0.1, 0.2, 0.3)


def test_forward_matches_reference():
    means, quats, scales, color, opac, sh = _random_scene()
    cov6 = cov3d_from_rot_scale(quats, scales)
    ref = render_reference(means, cov6, color, opac, CAM, sh=sh, sh_deg=3,
                           background=BG)
    res = render(means, cov6, color, opac, CAM, sh=sh, sh_deg=3,
                 background=BG)
    assert not bool(res.overflow)
    np.testing.assert_allclose(np.asarray(res.image), np.asarray(ref),
                               atol=3e-5, rtol=0)
    assert res.image.shape == (48, 64, 3)
    assert res.transmittance.shape == (48, 64)


def test_forward_empty_region_is_background():
    means, quats, scales, color, opac, _ = _random_scene(n=3, seed=1)
    cov6 = cov3d_from_rot_scale(quats, scales * 0.1)
    res = render(means, cov6, color, opac, CAM, background=BG)
    corner = np.asarray(res.image[0, 0])
    np.testing.assert_allclose(corner, BG, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.transmittance[0, 0]), 1.0,
                               atol=1e-6)


def test_gradients_match_reference_autodiff():
    """Pixel-gradient allclose w.r.t. every gaussian parameter
    (BASELINE.json gradient correctness criterion)."""
    means, quats, scales, color, opac, sh = _random_scene(n=20, seed=2)
    target = jnp.asarray(
        np.random.default_rng(3).random((48, 64, 3)), jnp.float32
    )

    def loss_tiled(means, quats, scales, color, opac, sh):
        cov6 = cov3d_from_rot_scale(quats, scales)
        res = render(means, cov6, color, opac, CAM, sh=sh, sh_deg=3,
                     background=BG)
        return jnp.sum((res.image - target) ** 2)

    def loss_ref(means, quats, scales, color, opac, sh):
        cov6 = cov3d_from_rot_scale(quats, scales)
        img = render_reference(means, cov6, color, opac, CAM, sh=sh,
                               sh_deg=3, background=BG)
        return jnp.sum((img - target) ** 2)

    args = (means, quats, scales, color, opac, sh)
    g_tiled = jax.grad(loss_tiled, argnums=tuple(range(6)))(*args)
    g_ref = jax.grad(loss_ref, argnums=tuple(range(6)))(*args)
    for name, a, b in zip(
        ["means", "quats", "scales", "color", "opac", "sh"], g_tiled, g_ref
    ):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4, rtol=0,
                                   err_msg=name)


def test_gradients_saturating_scene():
    """A dense opaque scene saturates tiles after a few fragments, firing
    the blend kernels' early exit: the fragments behind the saturation
    point must get exactly zero gradient rows, and every other gradient
    must still reach its own gaussian."""
    n = 300
    rng = np.random.default_rng(7)
    means = jnp.asarray(
        np.concatenate(
            [rng.normal(scale=0.15, size=(n, 2)),
             rng.uniform(-1.0, 1.0, (n, 1))],
            axis=1,
        ),
        jnp.float32,
    )
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats = jnp.asarray(quats / np.linalg.norm(quats, axis=1, keepdims=True))
    scales = jnp.asarray(0.08 + 0.1 * rng.random((n, 3)), jnp.float32)
    color = jnp.asarray(rng.random((n, 3)), jnp.float32)
    opac = jnp.full((n,), 0.95, jnp.float32)  # saturates in ~2 fragments
    target = jnp.asarray(rng.random((48, 64, 3)), jnp.float32)

    def loss_tiled(means, quats, scales, color, opac):
        cov6 = cov3d_from_rot_scale(quats, scales)
        res = render(means, cov6, color, opac, CAM, background=BG)
        return jnp.sum((res.image - target) ** 2)

    def loss_ref(means, quats, scales, color, opac):
        cov6 = cov3d_from_rot_scale(quats, scales)
        img = render_reference(means, cov6, color, opac, CAM, background=BG)
        return jnp.sum((img - target) ** 2)

    args = (means, quats, scales, color, opac)
    # forward parity first (confirms the scene itself is handled)
    cov6 = cov3d_from_rot_scale(quats, scales)
    res = render(means, cov6, color, opac, CAM, background=BG)
    assert not bool(res.overflow)
    g_tiled = jax.grad(loss_tiled, argnums=tuple(range(5)))(*args)
    g_ref = jax.grad(loss_ref, argnums=tuple(range(5)))(*args)
    for name, a, b in zip(
        ["means", "quats", "scales", "color", "opac"], g_tiled, g_ref
    ):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4, rtol=0,
                                   err_msg=name)


def test_overflow_zeroes_gradients():
    """On fragment-capacity overflow the forward image misses fragments,
    so the backward must return exactly zero rather than the gradients of
    an arbitrary subset of the scene."""
    means, quats, scales, color, opac, _ = _random_scene(n=50, seed=5)
    cov6 = cov3d_from_rot_scale(quats, scales * 10.0)  # huge splats

    def loss(color, opac):
        res = render(means, cov6, color, opac, CAM, max_fragments=256)
        return jnp.sum(res.image), res.overflow

    (_, overflow), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True
    )(color, opac)
    assert bool(overflow)
    for g in grads:
        np.testing.assert_array_equal(np.asarray(g), 0.0)


def test_transmittance_gradient():
    """dL/dT_final flows through the kernel's fourth channel."""
    means, quats, scales, color, opac, _ = _random_scene(n=10, seed=4)
    cov6 = cov3d_from_rot_scale(quats, scales)

    def loss(opac):
        res = render(means, cov6, color, opac, CAM, background=BG)
        return jnp.sum(res.transmittance)

    g = np.asarray(jax.grad(loss)(opac))
    assert np.isfinite(g).all()
    assert (g <= 1e-6).all()  # more opacity can only reduce transmittance
    assert (g < 0).any()


def test_overflow_flag():
    means, quats, scales, color, opac, _ = _random_scene(n=50, seed=5)
    cov6 = cov3d_from_rot_scale(quats, scales * 10.0)  # huge splats
    res = render(means, cov6, color, opac, CAM, max_fragments=256)
    assert bool(res.overflow)


def test_render_model_ply():
    soa = GaussianSoA.from_ply(read_ply("/root/reference/examples/model.ply"))
    buf = GaussiansBuffer.new(soa)
    cam = Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=80,
                         height=64, fov_y=0.9)
    res = render_gaussians(buf, cam, background=(1.0, 1.0, 1.0))
    img = np.asarray(res.image)
    assert img.shape == (64, 80, 3)
    assert np.isfinite(img).all()
    # something must have been splatted (not all background)
    assert (np.abs(img - 1.0) > 0.01).any()


@pytest.mark.parametrize("sh_fmt", ["SINGLE", "HALF", "NORM8", "NONE"])
def test_render_gaussians_layouts(sh_fmt):
    """Layout specialization reaches the renderer (the WESL feature-flag
    analog): all SH storage formats render, NONE falls back to base color."""
    from wgpu_3dgs_core_tpu import ShFormat

    soa = GaussianSoA.from_ply(read_ply("/root/reference/examples/model.ply"))
    layout = GaussianLayout(sh=ShFormat[sh_fmt])
    buf = GaussiansBuffer.new(soa, layout)
    cam = Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=32,
                         height=32, fov_y=0.9)
    res = render_gaussians(buf, cam, GaussianTransform(sh_deg=2))
    assert np.isfinite(np.asarray(res.image)).all()


def test_render_gaussians_transform_knobs():
    # model.ply has all-zero rest SH; give the scene real coefficients so
    # sh_deg actually changes the image.
    soa = GaussianSoA.from_ply(read_ply("/root/reference/examples/model.ply"))
    soa.sh[:] = 0.3 * np.random.default_rng(0).normal(size=soa.sh.shape)
    buf = GaussiansBuffer.new(soa)
    cam = Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=32,
                         height=32, fov_y=0.9)
    base = render_gaussians(buf, cam, GaussianTransform(sh_deg=0))
    with_sh = render_gaussians(buf, cam, GaussianTransform(sh_deg=3))
    no0 = render_gaussians(buf, cam, GaussianTransform(no_sh0=True, sh_deg=0))
    assert not np.allclose(np.asarray(base.image), np.asarray(with_sh.image))
    assert not np.allclose(np.asarray(base.image), np.asarray(no0.image))


def test_model_transform_moves_scene():
    soa = GaussianSoA.from_ply(read_ply("/root/reference/examples/model.ply"))
    buf = GaussiansBuffer.new(soa)
    cam = Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=32,
                         height=32, fov_y=0.9)
    here = render_gaussians(buf, cam)
    moved = render_gaussians(
        buf, cam, model_transform=ModelTransform(pos=(100.0, 0.0, 0.0))
    )
    np.testing.assert_allclose(np.asarray(moved.image), 0.0, atol=1e-6)
    assert not np.allclose(np.asarray(here.image), 0.0)


def test_gradients_finite_with_unvisited_padding_blocks():
    """Regression: when real fragments fill less than the stream capacity,
    the backward pass must not leak uninitialized cotangents from fragment
    blocks the work schedule never visits (they gather into gaussian n-1
    through the clamped padding index)."""
    soa = GaussianSoA.from_ply(read_ply("/root/reference/examples/model.ply"))
    packed = GaussiansBuffer.new(soa).data
    from wgpu_3dgs_core_tpu.ops.transforms import unpack_color, unpack_cov3d

    cov6 = unpack_cov3d(packed.cov3d, rot_scale=True)
    color = unpack_color(packed.color)
    cam = Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=160,
                         height=120, fov_y=0.9)

    def loss(op):
        res = render(packed.pos, cov6, color[:, 0:3], op, cam,
                     background=(1.0, 1.0, 1.0))
        return jnp.mean((res.image - 0.5) ** 2)

    g = np.asarray(jax.grad(loss)(color[:, 3]))
    assert np.isfinite(g).all()

    def loss_ref(op):
        img = render_reference(packed.pos, cov6, color[:, 0:3], op, cam,
                               background=(1.0, 1.0, 1.0))
        return jnp.mean((img - 0.5) ** 2)

    g_ref = np.asarray(jax.grad(loss_ref)(color[:, 3]))
    np.testing.assert_allclose(g, g_ref, atol=1e-7, rtol=0)


def test_render_jit_compatible():
    means, quats, scales, color, opac, _ = _random_scene(n=10, seed=6)
    cov6 = cov3d_from_rot_scale(quats, scales)

    @jax.jit
    def f(means, cov6, color, opac):
        return render(means, cov6, color, opac, CAM, background=BG).image

    a = np.asarray(f(means, cov6, color, opac))
    b = np.asarray(render(means, cov6, color, opac, CAM, background=BG).image)
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_render_single_chunk_capacity():
    """A stream capacity of a few batches, whose last tile ends inside
    the final batch, renders exactly (the kernels read past a tile's end
    only through masked lanes)."""
    means, quats, scales, color, opac, sh = _random_scene(12, seed=5)
    cov6 = cov3d_from_rot_scale(quats, scales)
    res = render(means, cov6, color, opac, CAM, sh=sh, sh_deg=3,
                 background=BG, max_fragments=128)
    assert not bool(res.overflow)
    ref = render_reference(means, cov6, color, opac, CAM, sh=sh, sh_deg=3,
                           background=BG)
    np.testing.assert_allclose(np.asarray(res.image), np.asarray(ref),
                               atol=2e-5, rtol=0)


def test_forward_opaque_chain_precision():
    """The transmittance cumsum's worst case: stacked alpha-0.99
    fragments make every log1p(-alpha) term -4.6, the largest magnitudes
    the per-batch cumsum ever sums, so its f32 rounding accumulates
    fastest here. The blended image must stay within ~1e-4 of the
    reference renderer."""
    n = 120
    rng = np.random.default_rng(11)
    means = jnp.asarray(
        np.concatenate(
            [rng.normal(scale=0.2, size=(n, 2)),
             rng.uniform(-1.0, 1.0, (n, 1))],
            axis=1,
        ),
        jnp.float32,
    )
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats = jnp.asarray(quats / np.linalg.norm(quats, axis=1, keepdims=True))
    scales = jnp.asarray(0.1 + 0.1 * rng.random((n, 3)), jnp.float32)
    color = jnp.asarray(rng.random((n, 3)), jnp.float32)
    opac = jnp.full((n,), 0.999, jnp.float32)  # alpha clamps to 0.99
    cov6 = cov3d_from_rot_scale(quats, scales)
    res = render(means, cov6, color, opac, CAM, background=BG)
    assert not bool(res.overflow)
    ref = render_reference(means, cov6, color, opac, CAM, background=BG)
    np.testing.assert_allclose(np.asarray(res.image), np.asarray(ref),
                               atol=1e-4, rtol=0)


def test_reference_pixel_window_matches_full():
    """pixel_window crop == the same crop of the full reference render,
    including with a traced origin (the full-size parity phase of
    chip_smoke.py crops the reference to a window of a 1080p camera)."""
    means, quats, scales, color, opac, sh = _random_scene(40, seed=5)
    cov6 = cov3d_from_rot_scale(quats, scales)
    full = np.asarray(
        render_reference(means, cov6, color, opac, CAM, sh=sh, sh_deg=2,
                         background=BG)
    )

    crop = render_reference(
        means, cov6, color, opac, CAM, sh=sh, sh_deg=2, background=BG,
        pixel_window=(16, 8, 32, 24),
    )
    # Different array shapes let XLA reassociate the N-reductions
    # differently: bit-equality is not expected, 1e-6 is.
    np.testing.assert_allclose(
        np.asarray(crop), full[8:32, 16:48], atol=1e-6, rtol=0
    )

    @jax.jit
    def crop_at(y0):
        return render_reference(
            means, cov6, color, opac, CAM, sh=sh, sh_deg=2, background=BG,
            pixel_window=(16, y0, 32, 8),
        )

    for y0 in (0, 8, 40):
        np.testing.assert_allclose(
            np.asarray(crop_at(jnp.int32(y0))), full[y0:y0 + 8, 16:48],
            atol=1e-6, rtol=0,
        )
