"""The full differentiable renderer: projection -> binning -> tiles -> image.

Renderer extension (SURVEY.md §7 M4/M5). ``render`` is the low-level
array-in/image-out function (jittable, differentiable w.r.t. every gaussian
parameter); ``render_gaussians`` is the high-level entry taking a
:class:`GaussiansBuffer`/packed layout plus the reference-style
GaussianTransform/ModelTransform knobs.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..buffer import (
    GaussianDisplayMode,
    GaussiansBuffer,
    GaussianTransform,
    ModelTransform,
)
from ..layouts import Cov3dFormat, PackedGaussians
from ..ops.binning import (
    bin_splats_attrs,
    default_max_fragments,
    num_tiles,
)
from ..ops.projection import project
from ..ops.rasterize import (
    rasterize_tiles_bwd,
    rasterize_tiles_fwd,
    reduce_fragment_grads,
    tiles_to_image,
)
from ..ops.sh import gaussian_color, view_directions
from ..ops.transforms import unpack_color, unpack_cov3d, unpack_sh
from .camera import Camera


class RenderResult(NamedTuple):
    image: jnp.ndarray  # [H, W, 3] f32
    transmittance: jnp.ndarray  # [H, W] f32 final T per pixel
    overflow: jnp.ndarray  # scalar bool: fragment capacity exceeded


def project_and_color(
    means, cov3d_sigma6, base_color, opacity, camera,
    sh=None, sh_deg: int = 0, no_sh0: bool = False,
    model_transform=None, size: float = 1.0, max_std_dev: float = 3.0,
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT,
    antialiased: bool = False,
):
    """Shared render prologue: EWA projection + view-dependent color.

    Honors every GaussianTransform knob (reference:
    src/buffer/gaussian_transform.rs:7-98) identically for the
    single-device and sharded renderers. Returns
    (splats, rgb [N, 3], opacity' [N]).
    """
    splats = project(
        means, cov3d_sigma6, camera, model_transform,
        size=size, radius_cutoff=max_std_dev, antialiased=antialiased,
        opacity=(
            opacity if display_mode == GaussianDisplayMode.SPLAT else None
        ),
    )
    opacity = opacity * splats.compensation
    if display_mode == GaussianDisplayMode.POINT:
        # Fixed-size isotropic dot of ~``size`` pixels std dev.
        pt = max(float(size), 0.5)
        conic_pt = jnp.array([1.0 / (pt * pt), 0.0, 1.0 / (pt * pt)],
                             jnp.float32)
        splats = splats._replace(
            conic=jnp.broadcast_to(conic_pt, splats.conic.shape),
            # zeros_like keeps the [N, 2] extent shape (a bare 0.0 would
            # broadcast the whole expression down to [N, 1]).
            extent=jnp.where(
                splats.mask[:, None], jnp.ceil(max_std_dev * pt),
                jnp.zeros_like(splats.extent),
            ),
        )

    dirs = view_directions(means, camera.position())
    rgb = gaussian_color(base_color, sh, dirs, sh_deg, no_sh0)
    return splats, rgb, opacity


def measure_max_fragments(
    means: jnp.ndarray,
    cov3d_sigma6: jnp.ndarray,
    opacity: jnp.ndarray,
    camera: Camera,
    headroom: float = 1.3,
    model_transform: Optional[tuple] = None,
    size: float = 1.0,
    max_std_dev: float = 3.0,
    antialiased: bool = False,
) -> int:
    """Measured ``max_fragments`` for a scene+camera: one N-scale dry pass.

    Projects the scene (opacity-aware extents, same as the renderer) and
    counts live fragments exactly — no fragment-scale work. Returns a
    lane-aligned capacity with ``headroom`` slack for parameter drift
    during training. Every fragment-scale op costs proportional to the
    STATIC capacity, so sizing from a measurement instead of the
    ``default_max_fragments`` heuristic is both faster and safer
    (bench.py sizes its capacity the same way). Blocks on the device
    (returns a Python int) — call once per scene/camera, outside jit.
    """
    from ..ops.binning import count_fragments_exact, tile_bounds

    h, w_px = camera.height, camera.width
    tiles_x, tiles_y = num_tiles(w_px, h)
    splats = project(
        means, cov3d_sigma6, camera, model_transform,
        size=size, radius_cutoff=max_std_dev, antialiased=antialiased,
        opacity=opacity,
    )
    _, y0, _, y1 = tile_bounds(splats.xy, splats.extent, tiles_x, tiles_y)
    max_sy = int(jnp.max(jnp.maximum(y1 - y0, 0)))
    op_eff = opacity * splats.compensation * splats.mask
    total = int(
        count_fragments_exact(splats.xy, splats.extent, splats.conic,
                              op_eff, splats.mask, tiles_x, tiles_y,
                              max_span_y=max_sy,
                              cutoff_sq=float(max_std_dev) ** 2)
    )
    cap = max(int(total * headroom), 1024)
    return -(-cap // 256) * 256


def measure_max_rows(
    means: jnp.ndarray,
    cov3d_sigma6: jnp.ndarray,
    opacity: jnp.ndarray,
    camera: Camera,
    headroom: float = 1.3,
    model_transform: Optional[tuple] = None,
    size: float = 1.0,
    max_std_dev: float = 3.0,
    antialiased: bool = False,
) -> int:
    """Measured ``max_rows`` (the level-1 row-stream capacity) for a
    scene+camera — the companion of :func:`measure_max_fragments`. Rows
    cost far less than fragments downstream, so the default (max_rows =
    max_fragments) is always safe; sizing it shaves the row-scale table
    and interval work."""
    from ..ops.binning import count_rows

    h, w_px = camera.height, camera.width
    tiles_x, tiles_y = num_tiles(w_px, h)
    splats = project(
        means, cov3d_sigma6, camera, model_transform,
        size=size, radius_cutoff=max_std_dev, antialiased=antialiased,
        opacity=opacity,
    )
    op_eff = opacity * splats.compensation * splats.mask
    total = int(
        count_rows(splats.xy, splats.extent, splats.conic, op_eff,
                   splats.mask, tiles_x, tiles_y,
                   cutoff_sq=float(max_std_dev) ** 2)
    )
    cap = max(int(total * headroom), 1024)
    return -(-cap // 512) * 512


def render(
    means: jnp.ndarray,
    cov3d_sigma6: jnp.ndarray,
    base_color: jnp.ndarray,
    opacity: jnp.ndarray,
    camera: Camera,
    sh: Optional[jnp.ndarray] = None,
    sh_deg: int = 0,
    no_sh0: bool = False,
    background: tuple = (0.0, 0.0, 0.0),
    model_transform: Optional[tuple] = None,
    max_fragments: Optional[int] = None,
    size: float = 1.0,
    max_std_dev: float = 3.0,
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT,
    antialiased: bool = False,
    max_rows: Optional[int] = None,
) -> RenderResult:
    """Differentiable tiled render to [H, W, 3].

    ``means`` [N,3], ``cov3d_sigma6`` [N,6], ``base_color`` [N,3] in [0,1],
    ``opacity`` [N] in [0,1], optional ``sh`` [N,15,3].
    ``size``/``max_std_dev``/``display_mode`` implement the reference's
    GaussianTransform knobs (reference: src/buffer/gaussian_transform.rs).
    ``max_fragments``/``max_rows`` are the static stream capacities (size
    them with :func:`measure_max_fragments`/:func:`measure_max_rows`); a
    stream that exceeds them is truncated, ``overflow`` is set and the
    gradients are zeroed.
    """
    h, w_px = camera.height, camera.width
    tiles_x, tiles_y = num_tiles(w_px, h)
    n = means.shape[0]

    if max_fragments is None:
        max_fragments = default_max_fragments(n, tiles_x, tiles_y)

    splats, rgb, opacity = project_and_color(
        means, cov3d_sigma6, base_color, opacity, camera,
        sh=sh, sh_deg=sh_deg, no_sh0=no_sh0,
        model_transform=model_transform, size=size,
        max_std_dev=max_std_dev, display_mode=display_mode,
        antialiased=antialiased,
    )

    tiles, overflow = rasterize_splats(
        splats.xy, splats.depth, splats.conic, splats.extent, splats.mask,
        rgb, opacity, tiles_x, tiles_y, int(max_fragments),
        tuple(background), cutoff_sq=float(max_std_dev) ** 2,
        mode=int(display_mode), max_rows=max_rows,
    )
    img = tiles_to_image(tiles, tiles_x, tiles_y, w_px, h)
    return RenderResult(
        image=img[..., 0:3],
        transmittance=img[..., 3],
        overflow=overflow,
    )


def _bin_rasterize_impl(attr_cols, xy, extent, depth, mask_f,
                        tile_y_offset, tiles_x, tiles_y, f_cap, bg,
                        cutoff_sq, mode, r_cap):
    """Bin + attribute fetch + forward blend.

    ``attr_cols`` is attribute-major [9, N]: x, y, conic (3), rgb, opacity.
    Returns ((tiles, overflow), residuals-for-backward).
    """
    stream, attrs_sorted = bin_splats_attrs(
        xy, extent, depth, mask_f > 0.5, attr_cols, tiles_x, tiles_y, f_cap,
        tile_y_offset, max_rows=r_cap, cutoff_sq=cutoff_sq,
        opacity_cull=mode != 1,
    )
    tiles = rasterize_tiles_fwd(
        attrs_sorted, stream.tile_start, stream.tile_end, tiles_x,
        tiles_x * tiles_y, bg, cutoff_sq, mode, tile_y_offset,
    )
    res = (attrs_sorted, stream.gauss_id, stream.tile_start,
           stream.tile_end, tiles, stream.overflow, xy, extent, depth,
           mask_f, tile_y_offset)
    return (tiles, stream.overflow), res


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9, 10, 11, 12))
def _bin_rasterize(attr_cols, xy, extent, depth, mask_f,
                   tile_y_offset, tiles_x, tiles_y, f_cap, bg, cutoff_sq,
                   mode, r_cap):
    """Differentiable-in-``attr_cols`` binning + tiled blend.

    Backward: the blend kernel replays each tile and writes every
    fragment's attribute gradients once, in stream order; one
    ``segment_sum`` by gaussian id reduces them to the [9, N] table.
    """
    out, _ = _bin_rasterize_impl(attr_cols, xy, extent, depth, mask_f,
                                 tile_y_offset, tiles_x, tiles_y, f_cap, bg,
                                 cutoff_sq, mode, r_cap)
    return out


def _bin_rasterize_fwd(attr_cols, xy, extent, depth, mask_f,
                       tile_y_offset, tiles_x, tiles_y, f_cap, bg,
                       cutoff_sq, mode, r_cap):
    return _bin_rasterize_impl(attr_cols, xy, extent, depth, mask_f,
                               tile_y_offset, tiles_x, tiles_y, f_cap, bg,
                               cutoff_sq, mode, r_cap)


def _bin_rasterize_bwd(tiles_x, tiles_y, f_cap, bg, cutoff_sq, mode, r_cap,
                       residuals, cots):
    (attrs_sorted, gauss_id, tile_start, tile_end, tiles_out, overflow,
     xy, extent, depth, mask_f, tile_y_offset) = residuals
    d_tiles = cots[0]  # the overflow flag is non-differentiable
    n = xy.shape[0]

    dfrag = rasterize_tiles_bwd(
        attrs_sorted, tile_start, tile_end, tiles_out, d_tiles, tiles_x,
        tiles_x * tiles_y, bg, cutoff_sq, mode, tile_y_offset,
    )  # [9, F]; zero outside every tile range
    d_cols = reduce_fragment_grads(dfrag, gauss_id, n)
    # On fragment-capacity overflow the stream is truncated and the
    # forward image misses fragments, so the step's gradients would be an
    # arbitrary subset — zero the table so an overflowing step trains on
    # nothing (render/train.py surfaces the flag).
    d_cols = jnp.where(overflow, 0.0, d_cols)
    return (d_cols, jnp.zeros_like(xy), jnp.zeros_like(extent),
            jnp.zeros_like(depth), jnp.zeros_like(mask_f), None)


_bin_rasterize.defvjp(_bin_rasterize_fwd, _bin_rasterize_bwd)


def rasterize_splats(xy, depth, conic, extent, mask, rgb, opacity,
                     tiles_x: int, tiles_y: int, f_cap: int,
                     background: tuple, tile_y_offset=0,
                     cutoff_sq: float = 9.0, mode: int = 0, max_rows=None):
    """Projected splats -> [tiles_x*tiles_y, 4, 256] tile blocks.

    The shared middle of the pipeline (binning + blend kernels), reused by
    the single-device and strip-sharded renderers. ``tile_y_offset``
    (int, may be traced) selects a horizontal strip of the global tile
    grid; splat coordinates stay global.
    """
    opac = opacity * mask  # culled gaussians contribute nothing
    attr_cols = jnp.concatenate(
        [xy.T, conic.T, rgb.T, opac[None, :]], axis=0
    )  # [9, N]
    return _bin_rasterize(
        attr_cols,
        jax.lax.stop_gradient(xy),
        jax.lax.stop_gradient(extent),
        jax.lax.stop_gradient(depth),
        mask.astype(jnp.float32),
        jnp.asarray(tile_y_offset, jnp.int32),
        tiles_x, tiles_y, int(f_cap),
        tuple(background), float(cutoff_sq), int(mode),
        None if max_rows is None else int(max_rows),
    )


def render_gaussians(
    gaussians: Any,
    camera: Camera,
    transform: GaussianTransform = GaussianTransform(),
    model_transform: Optional[ModelTransform] = None,
    background: tuple = (0.0, 0.0, 0.0),
    **kw,
) -> RenderResult:
    """High-level render of a :class:`GaussiansBuffer` / packed layout.

    Consumes the packed layout directly via the device unpack library —
    the analog of a downstream WESL shader importing gaussian_unpack_*
    (reference: src/shader/gaussian.wesl) — honoring the reference's
    GaussianTransform knobs (sh_deg, no_sh0).
    """
    if isinstance(gaussians, GaussiansBuffer):
        packed = gaussians.data
    elif isinstance(gaussians, PackedGaussians):
        packed = gaussians
    else:
        raise TypeError(
            "render_gaussians expects a GaussiansBuffer or PackedGaussians; "
            "convert a GaussianSoA with GaussiansBuffer.new first"
        )

    layout = packed.layout
    n = len(packed)
    cov3d6 = unpack_cov3d(
        jnp.asarray(packed.cov3d, jnp.float32)
        if layout.cov3d != Cov3dFormat.HALF
        else jnp.asarray(packed.cov3d),
        rot_scale=layout.cov3d == Cov3dFormat.ROT_SCALE,
    )
    color = unpack_color(jnp.asarray(packed.color))
    sh = unpack_sh(
        None if packed.sh is None else jnp.asarray(packed.sh), n
    )

    mt = None
    if model_transform is not None:
        mt = model_transform.as_arrays()

    return render(
        means=jnp.asarray(packed.pos),
        cov3d_sigma6=cov3d6,
        base_color=color[:, 0:3],
        opacity=color[:, 3],
        camera=camera,
        sh=None if packed.sh is None else sh,
        sh_deg=transform.sh_deg,
        no_sh0=transform.no_sh0,
        background=background,
        model_transform=mt,
        size=transform.size,
        max_std_dev=transform.max_std_dev,
        display_mode=transform.display_mode,
        **kw,
    )
