"""Sharded differentiable rendering over a device mesh.

The north-star parallel design (SURVEY.md §2.3, §7 M6), the analog of
sequence-parallel attention for the gaussian axis:

- **Gaussians sharded** over the ``data`` axis: each device projects and
  colors only its shard (projection is elementwise — perfect scaling).
- **Splat exchange** (default ``exchange="all_to_all"``): each device
  routes its projected splats (~14 f32 each — far smaller than the raw
  parameters + SH) to the devices whose tile-row strips their screen
  bboxes overlap, via ONE ``all_to_all``. Each device then bins
  only the O(N/D · skew) splats that can actually land in its strip —
  per-device binning work and exchange volume both shrink with the device
  count (the ``all_gather`` mode replicates all N splats everywhere and
  is kept for A/B and as an overflow-proof fallback).
- **Tiles strip-partitioned**: each device bins + rasterizes a horizontal
  strip of tile rows; the binning sort shrinks to its strip's fragments.
- **Gradients**: autodiff through shard_map. The all_to_all transposes to
  the reverse all_to_all of splat gradients, and the shard-local routing
  gathers transpose to segment sums back onto each source shard — XLA
  overlaps them with the backward sweep; no hand-written NCCL analog.

The image comes back replicated ([H, W, 3]); losses computed on it
differentiate straight through.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..buffer import GaussianDisplayMode
from ..ops.binning import TILE_SIZE, default_max_fragments, num_tiles
from ..ops.rasterize import tiles_to_image
from ..render.camera import Camera
from ..render.renderer import (
    RenderResult,
    project_and_color,
    rasterize_splats,
)
from .mesh import DATA_AXIS

# Packed projected-splat row layout exchanged between devices.
_PK_XY = slice(0, 2)
_PK_CONIC = slice(2, 5)
_PK_RGB = slice(5, 8)
_PK_OPAC = 8
_PK_DEPTH = 9
_PK_EXTENT = slice(10, 12)
_PK_MASK = 12
_PK_COLS = 13


def _strip_rows(tiles_y: int, n_dev: int) -> int:
    return -(-tiles_y // n_dev)


def _route_to_strips(packed, s0, s1, n_dev: int, cap: int):
    """Build the [D, cap, C] all_to_all send buffer from local splats.

    ``s0``/``s1``: inclusive strip range each local splat overlaps (s1 < s0
    for dead splats). For each destination strip d the overlapping splats
    are compacted (order-preserving, so global gaussian order — and with
    it the renderer's stable depth tie-break — survives the exchange).
    Returns (send, overflowed) where ``overflowed`` flags any destination
    whose overlap count exceeded ``cap`` (excess splats dropped).

    Sort-based build: instead of a per-destination vmapped
    cumsum/searchsorted/gather, this expands (splat, dst) slots into the
    D*cap send capacity, sorts ONE small (dst, src)-keyed index stream,
    and fills the buffer with a single row gather (same
    source-order-within-destination semantics).
    """
    n_local = packed.shape[0]
    if n_dev == 1:
        # Routing to one strip is the identity: every live splat goes to
        # device 0 (dead splats ride along with mask 0 and are culled by
        # the binning). Keeps D=1 sharded close to the
        # plain renderer instead of paying a pointless N-scale shuffle.
        # NOTE: at cap < n_local this truncates the RAW
        # order (possibly dropping live splats the D>1 compaction would
        # keep); the default sizing yields cap == n_local at D=1
        # (splat_skew >= 1), so the branch is reachable only with a
        # hand-picked smaller cap/skew, and the overflow flag still
        # fires there.
        if cap >= n_local:
            send = jnp.pad(packed, ((0, cap - n_local), (0, 0)))[None]
            return send, jnp.asarray(False)
        return packed[None, :cap], jnp.asarray(True)

    r_cap = n_dev * cap  # total send capacity bounds the live slots

    span = jnp.maximum(s1 - s0 + 1, 0)
    offsets = jnp.cumsum(span) - span
    total = offsets[-1] + span[-1]

    # Owner of each expansion slot: scatter each live splat's index at its
    # segment start, running-max forward (same idiom as binning).
    start_idx = jnp.where(span > 0, offsets, r_cap)  # OOB -> dropped
    starts = jnp.zeros(r_cap, jnp.int32).at[start_idx].max(
        jnp.arange(1, n_local + 1, dtype=jnp.int32), mode="drop"
    )
    owner = jnp.clip(
        jax.lax.associative_scan(jnp.maximum, starts) - 1, 0,
        max(n_local - 1, 0),
    )
    slot = jnp.arange(r_cap, dtype=jnp.int32)
    live = slot < jnp.minimum(total, r_cap)
    dst = s0[owner] + (slot - offsets[owner])

    # One key sort: (dst, source order). Live keys < (n_dev * n_local);
    # dead slots sort last. Source order within a destination is the
    # stable depth tie-break guarantee.
    key = jnp.where(live, dst * n_local + owner, n_dev * n_local + slot)
    key_sorted, owner_sorted = jax.lax.sort(
        (key, owner), num_keys=1, is_stable=False,
    )

    dst_starts = jnp.searchsorted(
        key_sorted, jnp.arange(n_dev, dtype=jnp.int32) * n_local,
        side="left",
    ).astype(jnp.int32)
    dst_end = jnp.searchsorted(
        key_sorted, jnp.arange(1, n_dev + 1, dtype=jnp.int32) * n_local,
        side="left",
    ).astype(jnp.int32)
    counts = dst_end - dst_starts

    j = jnp.arange(cap, dtype=jnp.int32)
    pos = dst_starts[:, None] + j[None, :]  # [D, cap]
    valid = j[None, :] < jnp.minimum(counts, cap)[:, None]
    src = owner_sorted[jnp.clip(pos.reshape(-1), 0, r_cap - 1)]
    # ONE [D*cap, C] row gather; its transpose (the backward) is a
    # scatter-add of the routed splat gradients onto their sources.
    send = jnp.where(
        valid.reshape(-1)[:, None], packed[src], 0.0
    ).reshape(n_dev, cap, -1)
    # total > r_cap implies some destination exceeded cap (pigeonhole),
    # so the truncated expansion is always surfaced.
    return send, jnp.any(counts > cap) | (total > r_cap)


def render_sharded(
    means: jnp.ndarray,
    cov3d_sigma6: jnp.ndarray,
    base_color: jnp.ndarray,
    opacity: jnp.ndarray,
    camera: Camera,
    mesh,
    sh: Optional[jnp.ndarray] = None,
    sh_deg: int = 0,
    no_sh0: bool = False,
    background: tuple = (0.0, 0.0, 0.0),
    model_transform: Optional[tuple] = None,
    max_fragments: Optional[int] = None,
    per_device_fragments: Optional[int] = None,
    size: float = 1.0,
    max_std_dev: float = 3.0,
    display_mode: GaussianDisplayMode = GaussianDisplayMode.SPLAT,
    antialiased: bool = False,
    strip_skew: float = 2.0,
    exchange: str = "all_to_all",
    splat_skew: float = 2.0,
) -> RenderResult:
    """Differentiable multi-device render (feature parity with ``render``).

    Inputs are sharded on their leading (gaussian) axis over ``mesh``'s
    ``data`` axis; N must divide evenly by the axis size (use
    ``parallel.mesh.pad_to_multiple`` with zero-opacity padding gaussians).
    Returns a replicated RenderResult.

    Capacities (both checked, overflow surfaced in the result):

    - ``max_fragments`` is the GLOBAL fragment budget; each device gets a
      strip-local capacity of ``max_fragments / n_dev * strip_skew`` (the
      skew factor absorbs uneven fragment concentration across strips).
      Callers tuning per-device memory directly should pass
      ``per_device_fragments`` instead, which bypasses the division.
    - with ``exchange="all_to_all"``, each (source, strip) routing bucket
      holds ``N/D^2 * splat_skew`` splats (a device receives
      ``N/D * splat_skew`` total). ``exchange="all_gather"`` replicates
      all N splats on every device instead — no routing capacity to
      overflow, at O(N) per-device cost.

    ``size``/``max_std_dev``/``display_mode``/``no_sh0``/
    ``model_transform`` match :func:`wgpu_3dgs_core_tpu.render` exactly
    (reference: src/buffer/gaussian_transform.rs knobs).
    """
    if exchange not in ("all_to_all", "all_gather"):
        raise ValueError(f"unknown exchange mode: {exchange!r}")
    n_dev = mesh.shape[DATA_AXIS]
    h, w_px = camera.height, camera.width
    tiles_x, tiles_y = num_tiles(w_px, h)
    rows_per_dev = _strip_rows(tiles_y, n_dev)
    n = means.shape[0]
    n_local = n // n_dev

    if per_device_fragments is not None:
        f_cap = per_device_fragments
    else:
        if max_fragments is None:
            max_fragments = default_max_fragments(n, tiles_x, tiles_y)
        f_cap = max_fragments
        if n_dev > 1:
            f_cap = int(f_cap * strip_skew / n_dev)

    # Per-(source, strip) routing capacity: N/D^2 * skew, lane-rounded.
    route_cap = max(int(n_local / max(n_dev, 1) * splat_skew), 128)
    route_cap = -(-route_cap // 128) * 128
    route_cap = min(route_cap, max(n_local, 1))

    bg = tuple(background)
    use_sh = sh is not None
    cutoff_sq = float(max_std_dev) ** 2
    mode = int(display_mode)

    in_specs = (
        P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS),
        P(DATA_AXIS) if use_sh else P(),
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(means_l, cov_l, color_l, opac_l, sh_l):
        # Local projection + color of this device's gaussian shard, with
        # the full GaussianTransform knob set (shared with `render`).
        splats, rgb_l, opac_l = project_and_color(
            means_l, cov_l, color_l, opac_l, camera,
            sh=sh_l if use_sh else None, sh_deg=sh_deg, no_sh0=no_sh0,
            model_transform=model_transform, size=size,
            max_std_dev=max_std_dev, display_mode=display_mode,
            antialiased=antialiased,
        )

        packed = jnp.concatenate(
            [
                splats.xy,
                splats.conic,
                rgb_l,
                (opac_l * splats.mask)[:, None],
                splats.depth[:, None],
                splats.extent,
                splats.mask.astype(jnp.float32)[:, None],
            ],
            axis=-1,
        )  # [N_local, 13]

        route_overflow = jnp.zeros((), bool)
        if exchange == "all_gather":
            # O(N)-per-device fallback: every device sees every splat.
            packed = jax.lax.all_gather(packed, DATA_AXIS, axis=0,
                                        tiled=True)
        else:
            # Route splats to the strips their bbox overlaps (the same
            # tile-row arithmetic as ops/binning.tile_bounds, divided by
            # the strip height), then ONE all_to_all.
            xy_y = packed[:, 1]
            ey = packed[:, 11]
            live = (packed[:, _PK_MASK] > 0.5) & (ey > 0.0)
            y0t = jnp.floor((xy_y - ey) / TILE_SIZE)
            y1t = jnp.floor((xy_y + ey) / TILE_SIZE)  # inclusive tile row
            s0 = jnp.clip(
                jnp.floor(y0t / rows_per_dev), 0, n_dev - 1
            ).astype(jnp.int32)
            s1 = jnp.clip(
                jnp.floor(y1t / rows_per_dev), 0, n_dev - 1
            ).astype(jnp.int32)
            s1 = jnp.where(live, s1, s0 - 1)  # empty range for dead splats
            send, route_overflow = _route_to_strips(
                packed, s0, s1, n_dev, route_cap
            )
            recv = jax.lax.all_to_all(
                send, DATA_AXIS, split_axis=0, concat_axis=0, tiled=True
            )  # [n_dev, cap, 13], source-major
            packed = recv.reshape(n_dev * route_cap, _PK_COLS)

        xy = packed[:, _PK_XY]
        conic = packed[:, _PK_CONIC]
        rgb = packed[:, _PK_RGB]
        opac = packed[:, _PK_OPAC]
        depth = packed[:, _PK_DEPTH]
        extent = packed[:, _PK_EXTENT]
        mask = packed[:, _PK_MASK] > 0.5

        # Rasterize this device's strip of tile rows. Splat coordinates
        # stay global: the kernels offset their pixel centres by the
        # strip's first tile row, so every pixel delta is the same f32
        # value a single-device render computes.
        d = jax.lax.axis_index(DATA_AXIS)
        tiles, overflow = rasterize_splats(
            xy, depth, conic, extent, mask, rgb, opac,
            tiles_x, rows_per_dev, f_cap, bg,
            tile_y_offset=d * rows_per_dev, cutoff_sq=cutoff_sq, mode=mode,
        )

        strips = jax.lax.all_gather(tiles, DATA_AXIS, axis=0, tiled=True)
        any_overflow = jax.lax.psum(
            (overflow | route_overflow).astype(jnp.int32), DATA_AXIS
        ) > 0
        return strips, any_overflow

    # Jitted so that an eager call compiles the sharded program once
    # instead of running the shard_map body op by op.
    strips, overflow = jax.jit(step)(
        means, cov3d_sigma6, base_color, opacity,
        sh if use_sh else jnp.zeros((1, 15, 3), jnp.float32),
    )
    img = tiles_to_image(
        strips, tiles_x, rows_per_dev * n_dev, w_px, h
    )
    return RenderResult(
        image=img[..., 0:3], transmittance=img[..., 3], overflow=overflow
    )
