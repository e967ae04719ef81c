"""Tile rasterizer: per-tile blend kernels with a hand-derived backward.

Renderer extension (SURVEY.md §7 M4/M5, hard parts #1/#2), laid out like
the original 3DGS CUDA rasterizer (Kerbl et al. 2023):

- one Pallas program per 16x16 tile (Triton route on the GPU); the
  program holds the tile's 256 pixels as one vector and walks the tile's
  ``[tile_start, tile_end)`` range of the (tile, depth)-sorted fragment
  stream (ops/binning.bin_splats_attrs) front to back, ``BATCH``
  fragments per loop step, with masked loads past the tile's end;
- per batch the [256 pixels, BATCH] alphas give the transmittance
  recurrence as exp(lt + exclusive cumsum of log1p(-alpha)) along the
  fragment axis, where ``lt`` is the per-pixel log-transmittance carried
  between steps; the loop stops once every pixel is saturated
  (log T <= LOG_T_MIN);
- every program writes its own tile, empty tiles included (background,
  T = 1), so no output block is ever left unwritten;
- the backward replays the tile with the front-to-back suffix-sum form
  S_i = C_blend - A_i (only the forward's final colour and T are needed as
  residuals). Each fragment belongs to exactly one tile, so its gradient
  row is written exactly once, in stream order; the caller reduces the
  rows to per-gaussian sums by gaussian id.

Blending semantics match render/reference.py exactly (alpha clamp 0.99,
alpha floor 1/255, q cutoff 3 sigma, T floor 1e-4).

Stream rows (attribute-major [ATTR_ROWS, F]): 0:x 1:y 2:conic_a 3:conic_b
4:conic_c 5:r 6:g 7:b 8:opacity, x/y in image pixel coordinates (a strip
of the image keeps them global and passes its first tile row, so every
device computes the same f32 pixel deltas as a single-device render).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .binning import TILE_SIZE
from .kernel_bundle import interpret_mode

ATTR_ROWS = 9
PIX = TILE_SIZE * TILE_SIZE  # 256 pixels per tile

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
# The kernels carry log(T) per pixel; the saturation tests compare in the
# log domain (exp(lt + ecs) vs T * exp(ecs) differs by ~|lt| * eps).
LOG_T_MIN = -9.210340371976182  # ln(T_MIN)
Q_CUTOFF = 9.0  # RADIUS_CUTOFF ** 2

# Fragments per loop step: [PIX, BATCH] f32 working arrays spread over the
# program's warps. A power of two, as the Triton route requires.
BATCH = 16
NUM_WARPS = 8


def _compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def _pixel_centers(t, tiles_x, row0):
    """Pixel-centre coordinate columns ([PIX, 1] each) of tile ``t`` of a
    grid whose first tile row is global row ``row0``, in the same f32
    arithmetic as the reference renderer."""
    p = jnp.arange(PIX, dtype=jnp.int32)
    px = ((t % tiles_x) * TILE_SIZE + p % TILE_SIZE).astype(jnp.float32)
    py = ((t // tiles_x + row0) * TILE_SIZE + p // TILE_SIZE).astype(
        jnp.float32)
    return (px + 0.5)[:, None], (py + 0.5)[:, None]


def _load_batch(attr_ref, base, end):
    """The attribute rows ([BATCH] each) of fragments [base, base+BATCH),
    lanes past ``end`` masked to zero."""
    valid = base + jnp.arange(BATCH, dtype=jnp.int32) < end
    rows = [
        plgpu.load(attr_ref.at[r, pl.ds(base, BATCH)], mask=valid,
                   other=0.0)
        for r in range(ATTR_ROWS)
    ]
    return rows, valid


def _alphas(rows, valid, px, py, cutoff_sq, mode):
    """Per-(pixel, fragment) alphas of one batch ([PIX, BATCH] each).

    ``mode``: 0 splat (gaussian falloff), 1 ellipse (opaque boundary ring),
    2 point (treated as splat; projection substitutes an isotropic conic) —
    the GaussianDisplayMode analog (reference: gaussian_transform.rs:7-14).
    """
    x, y, ca, cb, cc = (r[None, :] for r in rows[0:5])
    op = rows[8][None, :]
    dx = px - x
    dy = py - y
    q = ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy
    if mode == 1:
        g_exp = jnp.ones_like(q)
        ring = (q <= cutoff_sq) & (q >= cutoff_sq * 0.64)
    else:
        g_exp = jnp.exp(-0.5 * q)
        ring = q <= cutoff_sq
    alpha_raw = op * g_exp
    alpha = jnp.minimum(alpha_raw, ALPHA_CLAMP)
    ok = valid[None, :] & ring & (alpha >= ALPHA_MIN)
    alpha = jnp.where(ok, alpha, 0.0)
    return alpha, alpha_raw, g_exp, ok, dx, dy


def _transmittance(alpha, lt):
    """(log1p(-alpha), T_i, blend mask) of one batch given the per-pixel
    log-transmittance ``lt`` [PIX] in front of it."""
    log1m = jnp.log1p(-alpha)
    lt_i = lt[:, None] + (jnp.cumsum(log1m, axis=1) - log1m)
    return log1m, jnp.exp(lt_i), lt_i > LOG_T_MIN


def _tile_range(start_ref, end_ref):
    t = pl.program_id(0)
    start = start_ref[t]
    end = end_ref[t]
    return t, start, end, (end - start + BATCH - 1) // BATCH


def _fwd_kernel(row0_ref, start_ref, end_ref, attr_ref, out_ref, *, tiles_x,
                bg, cutoff_sq, mode):
    t, start, end, n_batches = _tile_range(start_ref, end_ref)
    px, py = _pixel_centers(t, tiles_x, row0_ref[0])

    def cond(carry):
        i, lt = carry[0], carry[1]
        return (i < n_batches) & (jnp.max(lt) > LOG_T_MIN)

    def body(carry):
        i, lt, *acc = carry
        rows, valid = _load_batch(attr_ref, start + i * BATCH, end)
        alpha = _alphas(rows, valid, px, py, cutoff_sq, mode)[0]
        log1m, t_i, blend = _transmittance(alpha, lt)
        wgt = jnp.where(blend, alpha * t_i, 0.0)
        acc = [a + jnp.sum(wgt * rows[5 + ch][None, :], axis=1)
               for ch, a in enumerate(acc)]
        lt = lt + jnp.sum(jnp.where(blend, log1m, 0.0), axis=1)
        return (i + 1, lt, *acc)

    zero = jnp.zeros((PIX,), jnp.float32)
    _, lt, *acc = jax.lax.while_loop(
        cond, body, (jnp.int32(0), zero, zero, zero, zero)
    )
    t_f = jnp.exp(lt)
    for ch in range(3):
        out_ref[ch, :] = acc[ch] + t_f * float(bg[ch])
    out_ref[3, :] = t_f


def _bwd_kernel(row0_ref, start_ref, end_ref, attr_ref, out_ref, g_ref,
                _zeros_ref, dfrag_ref, *, tiles_x, bg, cutoff_sq, mode):
    t, start, end, n_batches = _tile_range(start_ref, end_ref)
    px, py = _pixel_centers(t, tiles_x, row0_ref[0])

    # Per-pixel constants of the tile: dL/d(rgb), the forward's final T,
    # dL/dT_final including the background term, and sum_ch g_ch C_blend_ch.
    t_f = out_ref[3, :]
    g = [g_ref[ch, :] for ch in range(3)]
    g_t_total = g_ref[3, :]
    g_cbl = jnp.zeros((PIX,), jnp.float32)
    for ch in range(3):
        g_t_total = g_t_total + g[ch] * float(bg[ch])
        g_cbl = g_cbl + g[ch] * (out_ref[ch, :] - t_f * float(bg[ch]))
    g_tt = (g_t_total * t_f)[:, None]

    def cond(carry):
        i, lt = carry[0], carry[1]
        return (i < n_batches) & (jnp.max(lt) > LOG_T_MIN)

    def body(carry):
        i, lt, *acc = carry
        base = start + i * BATCH
        rows, valid = _load_batch(attr_ref, base, end)
        alpha, alpha_raw, g_exp, ok, dx, dy = _alphas(
            rows, valid, px, py, cutoff_sq, mode
        )
        log1m, t_i, blend = _transmittance(alpha, lt)
        wgt = jnp.where(blend, alpha * t_i, 0.0)

        # dL/dalpha_i = sum_ch g_ch (T_i c_ich - S_ich / (1 - a_i))
        #              - gT_total T_f / (1 - a_i),  S_i = C_blend - A_i
        # (A_i inclusive). With u = sum_ch g_ch c_ch the channel sums
        # collapse into one inclusive cumsum of wgt * u.
        u = sum(g[ch][:, None] * rows[5 + ch][None, :] for ch in range(3))
        g_cbl_a = g_cbl - sum(g[ch] * acc[ch] for ch in range(3))
        gs_i = g_cbl_a[:, None] - jnp.cumsum(wgt * u, axis=1)
        dalpha = t_i * u - (gs_i + g_tt) / (1.0 - alpha)
        # alpha = min(0.99, op * G): the clamp kills the gradient.
        dalpha = jnp.where(blend & ok & (alpha_raw < ALPHA_CLAMP), dalpha,
                           0.0)

        grads = [None] * ATTR_ROWS
        for ch in range(3):
            grads[5 + ch] = jnp.sum(g[ch][:, None] * wgt, axis=0)
        if mode == 1:
            # Ellipse: alpha is flat inside the ring, only opacity learns.
            grads[8] = jnp.sum(dalpha, axis=0)
            zero = jnp.zeros((BATCH,), jnp.float32)
            for r in range(5):
                grads[r] = zero
        else:
            ca, cb, cc = rows[2], rows[3], rows[4]
            dag = dalpha * g_exp
            grads[8] = jnp.sum(dag, axis=0)
            d_q = (-0.5 * rows[8])[None, :] * dag  # dL/dq
            d_qx = d_q * dx
            d_qy = d_q * dy
            sx = jnp.sum(d_qx, axis=0)
            sy = jnp.sum(d_qy, axis=0)
            # dx = px - x: dq/dx = -2 (a dx + b dy), dq/dy = -2 (b dx + c dy)
            grads[0] = -2.0 * (ca * sx + cb * sy)
            grads[1] = -2.0 * (cb * sx + cc * sy)
            grads[2] = jnp.sum(d_qx * dx, axis=0)
            grads[3] = 2.0 * jnp.sum(d_qx * dy, axis=0)
            grads[4] = jnp.sum(d_qy * dy, axis=0)
        for r in range(ATTR_ROWS):
            plgpu.store(dfrag_ref.at[r, pl.ds(base, BATCH)], grads[r],
                        mask=valid)

        acc = [a + jnp.sum(wgt * rows[5 + ch][None, :], axis=1)
               for ch, a in enumerate(acc)]
        lt = lt + jnp.sum(jnp.where(blend, log1m, 0.0), axis=1)
        return (i + 1, lt, *acc)

    zero = jnp.zeros((PIX,), jnp.float32)
    # Fragments behind the saturation point keep the zero rows the output
    # buffer starts with: their gradients are exactly zero.
    jax.lax.while_loop(cond, body, (jnp.int32(0), zero, zero, zero, zero))


def _pad_stream(attrs):
    """BATCH zero columns past the capacity: a batch starting inside the
    stream never reads or writes past the array, on the card or in the
    interpreter (whose dynamic slices clamp instead of masking)."""
    return jnp.pad(attrs, ((0, 0), (0, BATCH)))


def _row0(tile_y_offset):
    return jnp.reshape(jnp.asarray(tile_y_offset, jnp.int32), (1,))


def rasterize_tiles_fwd(attrs, tile_start, tile_end, tiles_x: int,
                        n_tiles: int, bg: tuple,
                        cutoff_sq: float = Q_CUTOFF, mode: int = 0,
                        tile_y_offset=0):
    """Blend every tile of the sorted stream.

    ``attrs`` [ATTR_ROWS, F] f32 sorted stream; ``tile_start``/``tile_end``
    [n_tiles] int32 fragment ranges; ``tile_y_offset`` (int, may be traced)
    the global tile row of the grid's first row, for a strip of a larger
    image. Returns [n_tiles, 4, 256] f32: RGB rows
    (background composited) and the final transmittance, pixels last. Not
    differentiable by itself — render/renderer.py wires the custom vjp
    around binning, this and :func:`rasterize_tiles_bwd`.
    """
    return pl.pallas_call(
        functools.partial(_fwd_kernel, tiles_x=tiles_x, bg=tuple(bg),
                          cutoff_sq=float(cutoff_sq), mode=int(mode)),
        grid=(n_tiles,),
        out_specs=pl.BlockSpec((None, 4, PIX), lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles, 4, PIX), jnp.float32),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret_mode(),
        name="blend_fwd",
    )(_row0(tile_y_offset), tile_start, tile_end, _pad_stream(attrs))


def rasterize_tiles_bwd(attrs, tile_start, tile_end, out, g_out,
                        tiles_x: int, n_tiles: int, bg: tuple,
                        cutoff_sq: float = Q_CUTOFF, mode: int = 0,
                        tile_y_offset=0):
    """Hand-derived backward of :func:`rasterize_tiles_fwd`.

    ``out`` is the forward output (residual) and ``g_out`` its cotangent,
    both [n_tiles, 4, 256]. Returns dfrag [ATTR_ROWS, F]: each fragment's
    gradient with respect to its stream attributes (zero for fragments
    outside every tile range and behind each tile's saturation point).
    """
    f = attrs.shape[1]
    pix_spec = pl.BlockSpec((None, 4, PIX), lambda t: (t, 0, 0))
    dfrag = pl.pallas_call(
        functools.partial(_bwd_kernel, tiles_x=tiles_x, bg=tuple(bg),
                          cutoff_sq=float(cutoff_sq), mode=int(mode)),
        grid=(n_tiles,),
        in_specs=[
            pl.no_block_spec, pl.no_block_spec, pl.no_block_spec,
            pl.no_block_spec, pix_spec, pix_spec, pl.no_block_spec,
        ],
        out_specs=pl.no_block_spec,
        out_shape=jax.ShapeDtypeStruct((ATTR_ROWS, f + BATCH), jnp.float32),
        input_output_aliases={6: 0},
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret_mode(),
        name="blend_bwd",
    )(_row0(tile_y_offset), tile_start, tile_end, _pad_stream(attrs), out,
      g_out, jnp.zeros((ATTR_ROWS, f + BATCH), jnp.float32))
    return dfrag[:, :f]


def reduce_fragment_grads(dfrag, gauss_id, n: int):
    """Per-fragment gradient rows [ATTR_ROWS, F] -> per-gaussian sums
    [ATTR_ROWS, n]: one scatter-add by gaussian id (ids outside [0, n)
    are dropped)."""
    return jax.ops.segment_sum(dfrag.T, gauss_id, num_segments=n).T


def tiles_to_image(tiles: jnp.ndarray, tiles_x: int, tiles_y: int,
                   width: int, height: int) -> jnp.ndarray:
    """[T, C, 256] tile blocks -> [height, width, C] image crop."""
    c = tiles.shape[1]
    img = tiles.reshape(tiles_y, tiles_x, c, TILE_SIZE, TILE_SIZE)
    img = img.transpose(0, 3, 1, 4, 2).reshape(
        tiles_y * TILE_SIZE, tiles_x * TILE_SIZE, c
    )
    return img[:height, :width]
