"""GaussianTransform knob tests: size, max_std_dev cutoff, display modes
(the renderer-side semantics for reference: src/buffer/gaussian_transform.rs).

Image parity atol is 3e-5: the tiled kernel's per-batch blending regroups
the f32 transmittance recurrence (a log-domain cumsum instead of the
reference's running product), so individual pixels can move a few e-6
relative to the brute-force reference; pixels sitting exactly on a blend
threshold (T ~ T_MIN) can move ~1e-5."""

import numpy as np
import pytest

from wgpu_3dgs_core_tpu import (
    Camera,
    GaussianDisplayMode,
    GaussiansBuffer,
    GaussianSoA,
    GaussianTransform,
    read_ply,
    render,
    render_gaussians,
    render_reference,
)
from wgpu_3dgs_core_tpu.ops.transforms import cov3d_from_rot_scale

from .test_render import _random_scene

CAM = Camera.look_at(eye=(0, 0, -5), target=(0, 0, 0), width=64, height=48,
                     fov_y=0.8)
BG = (0.1, 0.2, 0.3)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_modes_match_reference(mode):
    means, quats, scales, color, opac, _ = _random_scene(n=20, seed=7)
    cov6 = cov3d_from_rot_scale(quats, scales)
    kw = dict(background=BG, size=1.0, max_std_dev=3.0)
    ref = render_reference(means, cov6, color, opac, CAM, display_mode=mode,
                           **kw)
    res = render(means, cov6, color, opac, CAM,
                 display_mode=GaussianDisplayMode(mode), **kw)
    np.testing.assert_allclose(np.asarray(res.image), np.asarray(ref),
                               atol=3e-5, rtol=0)


def test_modes_differ_visually():
    means, quats, scales, color, opac, _ = _random_scene(n=20, seed=7)
    cov6 = cov3d_from_rot_scale(quats, scales)
    imgs = [
        np.asarray(
            render(means, cov6, color, opac, CAM, background=BG,
                   display_mode=GaussianDisplayMode(m)).image
        )
        for m in (0, 1, 2)
    ]
    assert not np.allclose(imgs[0], imgs[1])
    assert not np.allclose(imgs[0], imgs[2])


@pytest.mark.parametrize("max_std_dev", [1.0, 2.0, 3.0])
def test_max_std_dev_cutoff_matches_reference(max_std_dev):
    means, quats, scales, color, opac, _ = _random_scene(n=20, seed=8)
    cov6 = cov3d_from_rot_scale(quats, scales)
    ref = render_reference(means, cov6, color, opac, CAM, background=BG,
                           max_std_dev=max_std_dev)
    res = render(means, cov6, color, opac, CAM, background=BG,
                 max_std_dev=max_std_dev)
    np.testing.assert_allclose(np.asarray(res.image), np.asarray(ref),
                               atol=3e-5, rtol=0)


def test_smaller_cutoff_shows_more_background():
    means, quats, scales, color, opac, _ = _random_scene(n=20, seed=8)
    cov6 = cov3d_from_rot_scale(quats, scales)
    t_small = np.asarray(
        render(means, cov6, color, opac, CAM, max_std_dev=1.0).transmittance
    )
    t_big = np.asarray(
        render(means, cov6, color, opac, CAM, max_std_dev=3.0).transmittance
    )
    assert t_small.mean() > t_big.mean()


@pytest.mark.parametrize("size", [0.5, 1.0, 2.0])
def test_size_matches_reference(size):
    means, quats, scales, color, opac, _ = _random_scene(n=20, seed=9)
    cov6 = cov3d_from_rot_scale(quats, scales)
    ref = render_reference(means, cov6, color, opac, CAM, background=BG,
                           size=size)
    res = render(means, cov6, color, opac, CAM, background=BG, size=size)
    np.testing.assert_allclose(np.asarray(res.image), np.asarray(ref),
                               atol=3e-5, rtol=0)


def test_size_grows_coverage():
    means, quats, scales, color, opac, _ = _random_scene(n=10, seed=10)
    cov6 = cov3d_from_rot_scale(quats, scales)
    t1 = np.asarray(
        render(means, cov6, color, opac, CAM, size=0.5).transmittance
    )
    t2 = np.asarray(
        render(means, cov6, color, opac, CAM, size=2.0).transmittance
    )
    assert t2.mean() < t1.mean()


def test_render_gaussians_passes_knobs():
    soa = GaussianSoA.from_ply(read_ply("/root/reference/examples/model.ply"))
    buf = GaussiansBuffer.new(soa)
    cam = Camera.look_at(eye=(0, -1, -3), target=(0, 0, 0), width=32,
                         height=32, fov_y=0.9)
    base = render_gaussians(buf, cam)
    pt = render_gaussians(
        buf, cam,
        GaussianTransform(display_mode=GaussianDisplayMode.POINT, size=2.0),
    )
    small = render_gaussians(buf, cam, GaussianTransform(max_std_dev=0.5))
    assert not np.allclose(np.asarray(base.image), np.asarray(pt.image))
    assert not np.allclose(np.asarray(base.image), np.asarray(small.image))


def test_antialiased_compensation_matches_reference():
    """SPZ antialiased flag behavior: opacity compensated by the blur
    dilation ratio (reference stores the flag at spz.rs:565-567)."""
    means, quats, scales, color, opac, _ = _random_scene(n=20, seed=11)
    # tiny splats: strong compensation effect
    cov6 = cov3d_from_rot_scale(quats, scales * 0.1)
    ref = render_reference(means, cov6, color, opac, CAM, background=BG,
                           antialiased=True)
    res = render(means, cov6, color, opac, CAM, background=BG,
                 antialiased=True)
    np.testing.assert_allclose(np.asarray(res.image), np.asarray(ref),
                               atol=3e-5, rtol=0)
    plain = render(means, cov6, color, opac, CAM, background=BG)
    # compensation reduces small splats' opacity -> more background
    assert (np.asarray(res.transmittance).mean()
            > np.asarray(plain.transmittance).mean())
