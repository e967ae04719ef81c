"""Exact row-trimmed binning.

The two-level expansion (gaussians -> bbox tile rows -> exact per-row
x-intervals) must (a) only ever SHRINK the bbox stream (image-exactness is
pinned by the renderer parity tests in test_render.py), (b) agree exactly
with the count_fragments_exact dry pass used to size capacities, and (c)
keep every live fragment of the support ellipse: each culled tile contains
no pixel with q <= Q = min(cutoff^2, 2 ln(255 op_eff)).
"""

import numpy as np
import jax.numpy as jnp
from wgpu_3dgs_core_tpu.ops.binning import (
    TILE_SIZE,
    bin_splats_attrs,
    count_fragments,
    count_fragments_exact,
    count_rows,
    exact_radii,
    num_tiles,
    tile_bounds,
)
from wgpu_3dgs_core_tpu.ops.projection import project
from wgpu_3dgs_core_tpu.ops.transforms import cov3d_from_rot_scale
from wgpu_3dgs_core_tpu.render.camera import Camera


def random_scene(n, seed=0):
    rng = np.random.default_rng(seed)
    means = np.empty((n, 3), np.float32)
    means[:, 0] = rng.uniform(-1.5, 1.5, n)
    means[:, 1] = rng.uniform(-1.0, 1.0, n)
    means[:, 2] = rng.uniform(-1.0, 1.0, n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32)
    cov6 = cov3d_from_rot_scale(jnp.asarray(q), jnp.asarray(scales))
    color = jnp.asarray(rng.random((n, 3)), jnp.float32)
    opac = jnp.asarray(0.2 + 0.7 * rng.random(n), jnp.float32)
    return jnp.asarray(means), cov6, color, opac, None


W, H = 256, 192


def _scene(n=2500, seed=3):
    cam = Camera.look_at(
        eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
        width=W, height=H, fov_y=0.9,
    )
    means, cov6, color, opac, _ = random_scene(n, seed=seed)
    spl = project(means, cov6, cam, opacity=opac)
    attr = jnp.concatenate(
        [spl.xy.T, spl.conic.T, color.T, (opac * spl.mask)[None, :]], axis=0
    )
    return spl, attr


def test_trim_is_subset_of_bbox_and_counts_agree():
    spl, attr = _scene()
    tx, ty = num_tiles(W, H)
    st, _ = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr,
        tiles_x=tx, tiles_y=ty, max_fragments=8192,
    )
    n_exact = int(st.num_fragments)
    n_bbox = int(count_fragments(spl.xy, spl.extent, spl.mask, tx, ty))
    assert n_exact <= n_bbox
    assert n_exact > 0

    op_eff = attr[8]
    _, y0, _, y1 = tile_bounds(spl.xy, spl.extent, tx, ty)
    max_sy = int(jnp.max(jnp.maximum(y1 - y0, 0)))
    n_dry = int(
        count_fragments_exact(spl.xy, spl.extent, spl.conic, op_eff,
                              spl.mask, tx, ty, max_span_y=max_sy)
    )
    assert n_dry == n_exact
    n_rows = int(
        count_rows(spl.xy, spl.extent, spl.conic, op_eff, spl.mask, tx, ty)
    )
    assert 0 < n_rows <= n_exact


def test_no_blendable_pixel_culled():
    """Brute force: every pixel with q <= Q and alpha >= 1/255 lies in a
    tile the trimmed stream kept for that gaussian."""
    spl, attr = _scene(n=300, seed=7)
    tx, ty = num_tiles(W, H)
    st, _ = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr,
        tiles_x=tx, tiles_y=ty, max_fragments=8192,
    )
    nf = int(st.num_fragments)
    kept = set(zip(np.asarray(st.tile_id)[:nf].tolist(),
                   np.asarray(st.gauss_id)[:nf].tolist()))

    xy = np.asarray(spl.xy)
    conic = np.asarray(spl.conic)
    op = np.asarray(attr[8])
    mask = np.asarray(spl.mask)
    px, py = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    for g in range(xy.shape[0]):
        if not mask[g] or op[g] <= 0:
            continue
        dx = px - xy[g, 0]
        dy = py - xy[g, 1]
        q = (conic[g, 0] * dx * dx + 2 * conic[g, 1] * dx * dy
             + conic[g, 2] * dy * dy)
        alpha = op[g] * np.exp(-0.5 * q)
        blend = (q <= 9.0) & (alpha >= 1.0 / 255.0)
        ys, xs = np.nonzero(blend)
        tiles = set(zip((ys // TILE_SIZE * tx + xs // TILE_SIZE).tolist()))
        for (t,) in tiles:
            assert (t, g) in kept, (
                f"gaussian {g}: blendable pixel in tile {t} was culled"
            )


def test_exact_radii_below_extent():
    """The exact support radii never exceed the ceiled projection extent
    (count_fragments stays an upper bound; sharded strip routing by the
    extent bbox stays a superset)."""
    spl, attr = _scene()
    rx, ry = exact_radii(
        (attr[2], attr[3], attr[4]), attr[8], 9.0, True
    )
    from wgpu_3dgs_core_tpu.ops.binning import ROW_TRIM_EPS

    ext = np.asarray(spl.extent)
    live = np.asarray(spl.mask) & (ext[:, 0] > 0)
    slack = ROW_TRIM_EPS + 1e-3
    assert (np.asarray(rx)[live] <= ext[live, 0] + slack).all()
    assert (np.asarray(ry)[live] <= ext[live, 1] + slack).all()


def test_overflow_flags_row_truncation():
    spl, attr = _scene()
    tx, ty = num_tiles(W, H)
    st, _ = bin_splats_attrs(
        spl.xy, spl.extent, spl.depth, spl.mask, attr,
        tiles_x=tx, tiles_y=ty, max_fragments=8192, max_rows=512,
    )
    assert bool(st.overflow)
