"""Blend kernels (ops/rasterize.py) on hand-built fragment streams.

The Triton-route kernels run in the Pallas interpreter here and are held
to a jnp oracle with the reference renderer's semantics
(render/reference.blend_weights: cumprod transmittance, T_MIN cutoff):
forward tiles, and the hand-derived backward against autodiff of the
oracle. Also pinned: the per-gaussian gradient reduction, where Pallas
runs (backend rule), the kernel bundle's power-of-two padding and the
compile-cache location.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wgpu_3dgs_core_tpu import (
    Camera,
    KernelBundleBuilder,
    ResourceGroupLayout,
    render,
    render_reference,
)
from wgpu_3dgs_core_tpu.ops import kernel_bundle
from wgpu_3dgs_core_tpu.ops.binning import TILE_SIZE
from wgpu_3dgs_core_tpu.ops.rasterize import (
    ALPHA_CLAMP,
    ALPHA_MIN,
    BATCH,
    PIX,
    rasterize_tiles_bwd,
    rasterize_tiles_fwd,
    reduce_fragment_grads,
)
from wgpu_3dgs_core_tpu.render.reference import blend_weights
from wgpu_3dgs_core_tpu.utils import compile_cache

BG = (0.1, 0.2, 0.3)


def _stream(counts, tiles_x, seed=0, opacity=(0.3, 0.9), sigma=(2.0, 6.0)):
    """Sorted [9, F] attribute stream with ``counts[t]`` fragments centred
    in tile t (random anisotropic conics), plus its tile ranges."""
    rng = np.random.default_rng(seed)
    cols = []
    for t, k in enumerate(counts):
        ox = (t % tiles_x) * TILE_SIZE
        oy = (t // tiles_x) * TILE_SIZE
        for _ in range(k):
            sx, sy = rng.uniform(*sigma, 2)
            rho = rng.uniform(-0.6, 0.6)
            cov = np.array([[sx * sx, rho * sx * sy], [rho * sx * sy, sy * sy]])
            con = np.linalg.inv(cov)
            cols.append([
                ox + rng.uniform(0, TILE_SIZE), oy + rng.uniform(0, TILE_SIZE),
                con[0, 0], con[0, 1], con[1, 1],
                *rng.uniform(0, 1, 3), rng.uniform(*opacity),
            ])
    attrs = jnp.asarray(np.asarray(cols, np.float32).T.reshape(9, -1))
    end = np.cumsum(counts).astype(np.int32)
    start = (end - np.asarray(counts)).astype(np.int32)
    return attrs, jnp.asarray(start), jnp.asarray(end)


def _oracle(attrs, start, end, tiles_x, bg, cutoff_sq=9.0, mode=0):
    """Per-tile blend with the reference renderer's semantics, in jnp
    (differentiable in ``attrs``) -> [n_tiles, 4, 256]."""
    p = np.arange(PIX)
    tiles = []
    for t, (s, e) in enumerate(zip(np.asarray(start), np.asarray(end))):
        px = ((t % tiles_x) * TILE_SIZE + p % TILE_SIZE) + 0.5
        py = ((t // tiles_x) * TILE_SIZE + p // TILE_SIZE) + 0.5
        a = attrs[:, s:e]
        dx = px.astype(np.float32)[None, :] - a[0][:, None]
        dy = py.astype(np.float32)[None, :] - a[1][:, None]
        q = (a[2][:, None] * dx * dx + 2.0 * a[3][:, None] * dx * dy
             + a[4][:, None] * dy * dy)
        if mode == 1:
            alpha = jnp.minimum(a[8][:, None] * jnp.ones_like(q), ALPHA_CLAMP)
            ok = (q <= cutoff_sq) & (q >= cutoff_sq * 0.64)
        else:
            alpha = jnp.minimum(a[8][:, None] * jnp.exp(-0.5 * q),
                                ALPHA_CLAMP)
            ok = q <= cutoff_sq
        alpha = jnp.where(ok & (alpha >= ALPHA_MIN), alpha, 0.0)
        if e > s:
            w, t_f = blend_weights(alpha)
            rgb = [jnp.sum(w * a[5 + c][:, None], axis=0) for c in range(3)]
        else:
            t_f = jnp.ones((PIX,), jnp.float32)
            rgb = [jnp.zeros((PIX,), jnp.float32)] * 3
        tiles.append(jnp.stack(
            [rgb[c] + t_f * bg[c] for c in range(3)] + [t_f]
        ))
    return jnp.stack(tiles)


def _check(attrs, start, end, tiles_x, bg=BG, mode=0, seed=1):
    """Kernel forward and backward vs the oracle and its autodiff."""
    n_tiles = int(start.shape[0])
    out = rasterize_tiles_fwd(attrs, start, end, tiles_x, n_tiles, bg,
                              mode=mode)
    ref, vjp = jax.vjp(
        lambda a: _oracle(a, start, end, tiles_x, bg, mode=mode), attrs
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5,
                               rtol=0)
    g_out = jnp.asarray(
        np.random.default_rng(seed).normal(size=out.shape), jnp.float32
    )
    dfrag = np.asarray(rasterize_tiles_bwd(attrs, start, end, out, g_out,
                                           tiles_x, n_tiles, bg, mode=mode))
    (d_ref,) = vjp(g_out)
    d_ref = np.asarray(d_ref)
    for r in range(9):
        scale = np.abs(d_ref[r]).max() + 1e-8
        np.testing.assert_allclose(dfrag[r] / scale, d_ref[r] / scale,
                                   atol=1e-4, rtol=0, err_msg=f"row {r}")
    return np.asarray(out), dfrag


@pytest.mark.parametrize("k", [BATCH - 1, BATCH, BATCH + 1, 2 * BATCH + 1])
def test_fragment_counts_across_batch_boundary(k):
    attrs, start, end = _stream([k, 3], tiles_x=2, seed=k)
    _check(attrs, start, end, tiles_x=2)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_display_modes_with_background(mode):
    attrs, start, end = _stream([BATCH + 5, 7, 0, 2], tiles_x=2,
                                seed=10 + mode)
    _check(attrs, start, end, tiles_x=2, bg=(0.7, 0.05, 0.4), mode=mode)


def test_empty_and_saturated_tiles():
    counts = [0, 3 * BATCH, 5, 0, 2 * BATCH, 1]
    attrs, start, end = _stream(counts, tiles_x=3, seed=4)
    # Tile 1: broad, nearly opaque splats saturate every pixel within the
    # first batch, so the loops exit early.
    a = np.asarray(attrs).copy()
    s1, e1 = int(start[1]), int(end[1])
    a[2, s1:e1], a[3, s1:e1], a[4, s1:e1] = 1e-3, 0.0, 1e-3
    a[8, s1:e1] = 0.999
    attrs = jnp.asarray(a)
    out, dfrag = _check(attrs, start, end, tiles_x=3)

    for t in (0, 3):  # empty: background, T = 1
        np.testing.assert_allclose(out[t, :3], np.asarray(BG)[:, None]
                                   * np.ones((3, PIX)), atol=1e-7)
        np.testing.assert_array_equal(out[t, 3], 1.0)
    assert (out[1, 3] < 1e-3).all()  # saturated
    # Fragments behind the saturation point get exactly zero gradients.
    assert (dfrag[:, s1 + BATCH:e1] == 0.0).all()
    assert np.abs(dfrag[:, s1:s1 + 2]).max() > 0.0


def test_render_gradients_with_empty_tiles_match_reference():
    """Through the public entry point: a sparse scene leaves most tiles
    empty; image and every gradient still match the reference."""
    rng = np.random.default_rng(21)
    n = 6
    means = jnp.asarray(rng.normal(scale=0.6, size=(n, 3)), jnp.float32)
    cov6 = jnp.tile(jnp.asarray([[0.01, 0.0, 0.0, 0.01, 0.0, 0.01]],
                                jnp.float32), (n, 1))
    color = jnp.asarray(rng.random((n, 3)), jnp.float32)
    opac = jnp.asarray(0.4 + 0.5 * rng.random(n), jnp.float32)
    cam = Camera.look_at(eye=(0, 0, -5), target=(0, 0, 0), width=96,
                         height=64, fov_y=0.8)
    target = jnp.asarray(rng.random((64, 96, 3)), jnp.float32)

    def loss(f, *a):
        img = f(*a)
        return jnp.sum((img - target) ** 2)

    def tiled(m, c, col, o):
        return render(m, c, col, o, cam, background=BG).image

    def ref(m, c, col, o):
        return render_reference(m, c, col, o, cam, background=BG)

    args = (means, cov6, color, opac)
    np.testing.assert_allclose(np.asarray(tiled(*args)),
                               np.asarray(ref(*args)), atol=3e-5, rtol=0)
    g_t = jax.grad(lambda *a: loss(tiled, *a), argnums=(0, 1, 2, 3))(*args)
    g_r = jax.grad(lambda *a: loss(ref, *a), argnums=(0, 1, 2, 3))(*args)
    for a, b in zip(g_t, g_r):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4, rtol=0)


@pytest.mark.parametrize("drop", [False, True])
def test_reduce_fragment_grads_matches_numpy(drop):
    rng = np.random.default_rng(5)
    n, f = 37, 500
    dfrag = rng.normal(size=(9, f)).astype(np.float32)
    gid = rng.integers(0, n, f).astype(np.int32)
    if drop:
        gid[::7] = n  # out-of-range ids (padding slots) are dropped
    want = np.zeros((9, n), np.float64)
    keep = gid < n
    np.add.at(want.T, gid[keep], dfrag.T[keep])
    got = np.asarray(reduce_fragment_grads(jnp.asarray(dfrag),
                                           jnp.asarray(gid), n))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("platform,expect", [
    ("cpu", True), ("gpu", False), ("tpu", None),
])
def test_interpret_mode_rule(monkeypatch, platform, expect):
    monkeypatch.setattr(kernel_bundle.jax, "default_backend",
                        lambda: platform)
    if expect is None:
        with pytest.raises(RuntimeError, match=platform):
            kernel_bundle.interpret_mode()
    else:
        assert kernel_bundle.interpret_mode() is expect


@pytest.mark.parametrize("n,block,width", [(100, 100, 3), (33, 8, 5)])
def test_bundle_pads_to_powers_of_two(n, block, width):
    seen = []

    def kernel(x_ref, out_ref):
        seen.append(tuple(x_ref.shape))
        out_ref[...] = x_ref[...] * 2.0 + 1.0

    x = jnp.arange(n * width, dtype=jnp.float32).reshape(n, width)
    out = (
        KernelBundleBuilder()
        .resource_layout(ResourceGroupLayout("x", arity=1))
        .kernel(kernel)
        .output(width)
        .block_size(block)
        .build([[x]])
        .dispatch(n)
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(x) * 2.0 + 1.0)
    rows, cols = seen[0]
    assert rows >= max(block, kernel_bundle.MIN_BLOCK_ROWS)
    assert rows & (rows - 1) == 0 and cols & (cols - 1) == 0
    assert cols >= width


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing is set


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = compile_cache.enable_compile_cache()
    root = compile_cache.DEFAULT_CACHE_DIR.parent
    assert path == str(root / ".jax_cache")
    assert (root / "wgpu_3dgs_core_tpu" / "utils" / "compile_cache.py").exists()
    assert calls == [("jax_compilation_cache_dir", path)]


@pytest.mark.gpu
def test_blend_kernels_compiled_on_gpu():
    """The kernels compiled through Triton (no interpreter) match the
    oracle; chip_smoke.py runs the full-size version of this check."""
    assert not kernel_bundle.interpret_mode()
    attrs, start, end = _stream([BATCH + 3, 0, 2 * BATCH], tiles_x=3)
    _check(attrs, start, end, tiles_x=3)
