"""Benchmark: forward+backward differentiable render throughput.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

Runs on one GPU and exits non-zero without one. Lines before the JSON
line name the device (platform, device kind, count) and the card's name
and power limit. Mpix/s = (H * W) / seconds per full forward+backward
step on a 1M-gaussian, 1080p scene; ``vs_baseline`` divides it by the
250 Mpix/s target of BASELINE.md.

The default run measures ONLY the headline step (fwd+bwd on the standard
~2.6-fragments/gaussian cloud); `--full` additionally reports a fwd-only
split and a heavy scene with capture-like overlap (>= 8
fragments/gaussian).
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

BASELINE_MPIX_S = 250.0


def synthetic_gaussians(n, seed=0, spread=3.0, scale_lo=0.004,
                        scale_hi=0.012):
    """A 1080p-friendly cloud: ~few-pixel splats spread over the frustum.

    Returns numpy (means, quats, scales, color, opacity, sh).
    """
    rng = np.random.default_rng(seed)
    means = np.empty((n, 3), np.float32)
    means[:, 0] = rng.uniform(-spread, spread, n)
    means[:, 1] = rng.uniform(-spread * 0.6, spread * 0.6, n)
    means[:, 2] = rng.uniform(-2.0, 2.0, n)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scales = rng.uniform(scale_lo, scale_hi, (n, 3)).astype(np.float32)
    color = rng.random((n, 3)).astype(np.float32)
    opac = (0.2 + 0.7 * rng.random(n)).astype(np.float32)
    sh = (0.1 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    return means, q, scales, color, opac, sh


def synthetic_scene(n, seed=0, **kw):
    """:func:`synthetic_gaussians` as render() arrays
    (means, cov6, color, opacity, sh)."""
    import jax.numpy as jnp

    from wgpu_3dgs_core_tpu.ops.transforms import cov3d_from_rot_scale

    means, q, scales, color, opac, sh = synthetic_gaussians(n, seed, **kw)
    cov6 = cov3d_from_rot_scale(jnp.asarray(q), jnp.asarray(scales))
    return (jnp.asarray(means), cov6, jnp.asarray(color), jnp.asarray(opac),
            jnp.asarray(sh))


def heavy_scene(n, seed=1):
    """Capture-like overlap: larger splats, >= 8 fragments/gaussian."""
    return synthetic_scene(n, seed=seed, scale_lo=0.010, scale_hi=0.030)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--gaussians", type=int, default=1_000_000)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    # Capacity sized to the scene: the exact row-trimmed binning gives the
    # headline cloud 2,639,616 live fragments / 1,640,960 rows and the
    # heavy scene 5,992,448 / 2,516,992, so these defaults leave ~1.12x /
    # 1.22x headroom (measure_max_fragments / measure_max_rows size them
    # the same way). Every fragment-scale op costs in proportion to this
    # STATIC capacity, not the live count. Overflow is checked every run
    # and reported in the JSON line.
    parser.add_argument("--max-fragments", type=int, default=2_957_312)
    parser.add_argument("--heavy-max-fragments", type=int, default=7_311_360)
    parser.add_argument("--max-rows", type=int, default=1_887_232)
    parser.add_argument("--heavy-max-rows", type=int, default=2_894_848)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--sh-deg", type=int, default=3)
    parser.add_argument("--small", action="store_true",
                        help="tiny config for smoke testing")
    # Each extra jit signature adds a cold compile, so the default run
    # measures ONLY the headline step; the fwd-only split and the
    # heavy-overlap scene are opt-in diagnostics.
    parser.add_argument("--full", action="store_true",
                        help="also measure fwd-only split and heavy scene "
                             "(2 extra jit signatures)")
    args = parser.parse_args()

    if args.small:
        args.gaussians = 10_000
        args.width, args.height = 512, 512
        args.max_fragments = 262_144
        args.heavy_max_fragments = 1_048_576
        args.max_rows = 131_072
        args.heavy_max_rows = 262_144
        args.iters, args.warmup = 3, 1

    # The card's name and power limit, read before JAX opens the card.
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        sys.exit(f"bench: no GPU (nvidia-smi: {e})")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: JAX found no GPU (platform {dev.platform!r})")
    print(f"device: platform {dev.platform}, kind {dev.device_kind}, "
          f"count {len(jax.devices())}", flush=True)
    print(f"card: {card}", flush=True)
    import jax.numpy as jnp

    from wgpu_3dgs_core_tpu import Camera, render
    from wgpu_3dgs_core_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cam = Camera.look_at(
        eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
        width=args.width, height=args.height, fov_y=0.9,
    )
    scene = synthetic_scene(args.gaussians)
    target = jnp.zeros((args.height, args.width, 3), jnp.float32)

    def make_step(max_fragments, max_rows):
        def loss_fn(means, cov6, color, opac, sh):
            res = render(
                means, cov6, color, opac, cam, sh=sh, sh_deg=args.sh_deg,
                background=(0.0, 0.0, 0.0), max_fragments=max_fragments,
                max_rows=max_rows,
            )
            return jnp.mean((res.image - target) ** 2), res.overflow

        @jax.jit
        def step(means, cov6, color, opac, sh):
            (loss, overflow), grads = jax.value_and_grad(
                loss_fn, argnums=(0, 1, 2, 3, 4), has_aux=True
            )(means, cov6, color, opac, sh)
            return loss, overflow, grads

        return step

    # Device-to-host copy of one element: waits for every program
    # enqueued before it (they execute in order).
    def sync(x):
        return float(np.asarray(x))

    def time_fn(fn, fn_args, warmup, iters, overflow_ix=None):
        out = fn(*fn_args)
        if overflow_ix is not None and bool(np.asarray(out[overflow_ix])):
            print("WARNING: fragment capacity overflow; raise capacity",
                  file=sys.stderr)
        for _ in range(warmup - 1):
            out = fn(*fn_args)
        sync(jax.tree.leaves(out)[0].ravel()[0])
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*fn_args)
        # programs execute in order; waiting on the last waits on all
        sync(jax.tree.leaves(out)[0].ravel()[0])
        return (time.perf_counter() - t0) / iters, out

    npix = args.width * args.height
    step = make_step(args.max_fragments, args.max_rows)
    dt, out = time_fn(step, scene, args.warmup, args.iters, overflow_ix=1)
    loss, overflow = out[0], out[1]
    mpix_s = npix / dt / 1e6
    msplats_s = args.gaussians / dt / 1e6

    extras = {}
    if args.full:
        def fwd_loss(means, cov6, color, opac, sh):
            res = render(
                means, cov6, color, opac, cam, sh=sh, sh_deg=args.sh_deg,
                background=(0.0, 0.0, 0.0),
                max_fragments=args.max_fragments, max_rows=args.max_rows,
            )
            return jnp.mean((res.image - target) ** 2)

        fwd = jax.jit(fwd_loss)
        dt_f, _ = time_fn(fwd, scene, args.warmup, args.iters)
        extras["fwd_ms"] = round(dt_f * 1e3, 2)
        extras["bwd_ms"] = round((dt - dt_f) * 1e3, 2)

    if args.full:
        hscene = heavy_scene(args.gaussians)
        hstep = make_step(args.heavy_max_fragments, args.heavy_max_rows)
        dt_h, hout = time_fn(hstep, hscene, args.warmup, args.iters,
                             overflow_ix=1)
        extras["heavy_mpix_s"] = round(npix / dt_h / 1e6, 2)
        extras["heavy_step_ms"] = round(dt_h * 1e3, 2)
        extras["heavy_overflow"] = bool(np.asarray(hout[1]))

    print(
        json.dumps(
            {
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "metric": "fwd+bwd render throughput "
                f"({args.height}p, {args.gaussians} gaussians, "
                f"sh_deg={args.sh_deg})",
                "value": round(mpix_s, 2),
                "unit": "Mpix/s",
                "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 4),
                "msplats_s": round(msplats_s, 2),
                "step_ms": round(dt * 1e3, 2),
                "loss": float(loss),
                "overflow": bool(np.asarray(overflow)),
                **extras,
            }
        )
    )


if __name__ == "__main__":
    main()
