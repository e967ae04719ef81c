"""Smoke test of the differentiable renderer on one GPU, at full size.

Drives the user entry points once — ``render`` (forward frame) and
``make_train_step`` (forward + backward + Adam) — on the 1M-gaussian,
1920x1080, SH degree 3 scene of ``bench.py``, with every Pallas kernel
compiled for the card, and checks the results:

1. device: JAX must see a GPU (no CPU fallback);
2. compile: lower + compile the train step and the forward frame, print
   their memory analysis and compile seconds;
3. parity: 100K gaussians, full 1080p camera, loss on a 256x256 crop;
   image and every parameter gradient against ``render_reference``
   (evaluated crop-row by crop-row at highest matmul precision). Bars:
   image max abs error <= 2e-5, normalized gradient max error <= 1e-4;
4. train: 5 Adam steps at the headline size (finite loss, no capacity
   overflow, parameters changed) and one forward frame.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failure exits non-zero before it is printed.

Usage:
    python chip_smoke.py            # one GPU, phases 1-4
    python chip_smoke.py --four     # four GPUs: render_sharded forward +
                                    # backward vs single-card render only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

IMG_BAR = 2e-5
GRAD_BAR = 1e-4
HEADLINE = dict(gaussians=1_000_000, width=1920, height=1080, sh_deg=3)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_lines() -> list[str]:
    """Name and power limit of each card, read before JAX opens them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi unavailable: {e}")
    if not out:
        fail("nvidia-smi reports no GPU")
    return out.splitlines()


def headline_camera(camera_cls, width, height):
    return camera_cls.look_at(
        eye=(0.0, 0.0, -6.0), target=(0.0, 0.0, 0.0),
        width=width, height=height, fov_y=0.9,
    )


def normalized_err(a, b):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def capacities(gs, scene, cam):
    from wgpu_3dgs_core_tpu.render.renderer import measure_max_rows

    means, cov6, _, opac, _ = scene
    return (gs.measure_max_fragments(means, cov6, opac, cam),
            measure_max_rows(means, cov6, opac, cam))


def phase_compile(gs, jax, jnp, scene, cam, caps):
    """Lower and compile the headline train step and forward frame."""
    import optax

    from bench import synthetic_gaussians

    max_frag, max_rows = caps
    rkw = dict(sh_deg=HEADLINE["sh_deg"], max_fragments=max_frag,
               max_rows=max_rows)

    @jax.jit
    def frame(means, cov6, color, opac, sh):
        return gs.render(means, cov6, color, opac, cam, sh=sh, **rkw)

    raw = synthetic_gaussians(HEADLINE["gaussians"])
    means, quats, scales, color, opac, sh = (jnp.asarray(x) for x in raw)
    params = gs.TrainableGaussians(
        means=means, quats=quats, log_scales=jnp.log(scales),
        color_logit=jax.scipy.special.logit(color),
        # Start from fainter splats than the target was rendered with.
        opacity_logit=jax.scipy.special.logit(opac) - 0.5,
        sh=sh,
    )
    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)
    opt = optax.adam(1e-3)
    step = gs.make_train_step(cam, target, opt, **rkw)
    opt_state = opt.init(params)

    compiled = {}
    for name, fn, args in (
        ("train_step", step, (params, opt_state)),
        ("forward_frame", frame, scene),
    ):
        t0 = time.perf_counter()
        exe = fn.lower(*args).compile()
        dt = time.perf_counter() - t0
        print(f"compile {name}: {dt:.1f} s", flush=True)
        print(f"  memory_analysis {name}: {exe.memory_analysis()}",
              flush=True)
        compiled[name] = exe
    return compiled, params, opt_state, opt, frame


def phase_parity(gs, jax, jnp, np, n=100_000, c=256):
    """``n`` gaussians, headline camera, c x c crop: image + gradients."""
    from bench import synthetic_scene

    scene = synthetic_scene(n)
    cam = headline_camera(gs.Camera, HEADLINE["width"], HEADLINE["height"])
    caps = capacities(gs, scene, cam)
    rows = 8  # reference rows per chunk: bounds its [N, pixels] memory
    x0 = (cam.width - c) // 2
    y0 = (cam.height - c) // 2
    tgt = 0.35
    norm = 3.0 * c * c
    sh_deg = HEADLINE["sh_deg"]

    def loss_tiled(*s):
        res = gs.render(*s[:4], cam, sh=s[4], sh_deg=sh_deg,
                        max_fragments=caps[0], max_rows=caps[1])
        crop = res.image[y0:y0 + c, x0:x0 + c]
        return jnp.sum((crop - tgt) ** 2) / norm, (crop, res.overflow)

    @jax.jit
    def tiled(*s):
        return jax.value_and_grad(loss_tiled, argnums=tuple(range(5)),
                                  has_aux=True)(*s)

    def loss_ref(*s):
        means, cov6, color, opac, sh, row0 = s
        img = gs.render_reference(means, cov6, color, opac, cam, sh=sh,
                                  sh_deg=sh_deg,
                                  pixel_window=(x0, row0, c, rows))
        return jnp.sum((img - tgt) ** 2) / norm, img

    @jax.jit
    def ref_rows(row0, *s):
        return jax.value_and_grad(loss_ref, argnums=tuple(range(5)),
                                  has_aux=True)(*s, row0)

    t0 = time.perf_counter()
    (loss_t, (crop_t, ovf)), g_t = tiled(*scene)
    crop_t = np.asarray(crop_t)
    print(f"parity: tiled loss {float(loss_t):.8f}, overflow "
          f"{bool(ovf)} ({time.perf_counter() - t0:.1f} s incl. compile)",
          flush=True)
    if bool(ovf):
        fail("parity scene overflowed its measured capacity")

    t0 = time.perf_counter()
    loss_r, g_r, crop_r = 0.0, None, []
    with jax.default_matmul_precision("highest"):
        for row0 in range(y0, y0 + c, rows):
            (lo, img), g = ref_rows(jnp.int32(row0), *scene)
            loss_r += float(lo)
            crop_r.append(np.asarray(img))
            g_r = g if g_r is None else jax.tree.map(jnp.add, g_r, g)
    crop_r = np.concatenate(crop_r, axis=0)
    print(f"parity: reference loss {loss_r:.8f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    img_err = float(np.abs(crop_t - crop_r).max())
    errs = {"image_max_abs": img_err}
    for name, a, b in zip(["means", "cov3d", "color", "opacity", "sh"],
                          g_t, g_r):
        errs[f"grad_{name}"] = normalized_err(a, b)
    print(f"parity errors: {json.dumps(errs)}", flush=True)
    if not img_err <= IMG_BAR:
        fail(f"image error {img_err} > {IMG_BAR}")
    bad = {k: v for k, v in errs.items()
           if k.startswith("grad_") and not v <= GRAD_BAR}
    if bad:
        fail(f"gradient errors over {GRAD_BAR}: {bad}")


def phase_train(jax, jnp, np, compiled, params, opt_state, scene, card):
    """5 Adam steps and one forward frame, with informational timings."""
    step = compiled["train_step"]
    frame = compiled["forward_frame"]
    p = params
    losses = []
    jax.block_until_ready(step(p, opt_state))  # warm-up, not kept
    t0 = time.perf_counter()
    for _ in range(5):
        p, opt_state, loss, overflow = step(p, opt_state)
        losses.append(loss)
        if bool(overflow):
            fail("train step overflowed its measured capacity")
    jax.block_until_ready(p)
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    losses = [float(x) for x in losses]
    print(f"train: losses {losses}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"non-finite loss {losses}")
    moved = max(float(jnp.abs(a - b).max())
                for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(params)))
    if not moved > 0.0:
        fail("parameters did not change")

    res = frame(*scene)
    jax.block_until_ready(res)
    t0 = time.perf_counter()
    for _ in range(5):
        res = frame(*scene)
    jax.block_until_ready(res)
    frame_ms = (time.perf_counter() - t0) / 5 * 1e3
    img = np.asarray(res.image)
    if img.shape != (HEADLINE["height"], HEADLINE["width"], 3):
        fail(f"frame shape {img.shape}")
    if not np.isfinite(img).all() or bool(res.overflow):
        fail("forward frame non-finite or overflowed")
    print(f"timing (informational; {card}): train step {step_ms:.2f} ms, "
          f"forward frame {frame_ms:.2f} ms", flush=True)


def phase_four(gs, jax, jnp, np, scene, cam, caps):
    """render_sharded over a 4-GPU mesh vs single-card render."""
    from wgpu_3dgs_core_tpu.parallel import (
        gaussian_sharding,
        make_mesh,
        render_sharded,
    )

    if len(jax.devices()) < 4:
        fail(f"--four needs 4 GPUs, found {len(jax.devices())}")
    mesh = make_mesh(4)
    sh_deg = HEADLINE["sh_deg"]
    target = jnp.full((cam.height, cam.width, 3), 0.35, jnp.float32)

    def loss_sharded(*s):
        # Each strip may receive every splat and hold the whole frame's
        # fragments: no capacity overflow however the scene falls across
        # the strips.
        r = render_sharded(*s[:4], cam, mesh, sh=s[4], sh_deg=sh_deg,
                           per_device_fragments=caps[0], splat_skew=4.0,
                           exchange="all_to_all")
        return jnp.mean((r.image - target) ** 2), (r.image, r.overflow)

    def loss_single(*s):
        r = gs.render(*s[:4], cam, sh=s[4], sh_deg=sh_deg,
                      max_fragments=caps[0], max_rows=caps[1])
        return jnp.mean((r.image - target) ** 2), (r.image, r.overflow)

    grad = dict(argnums=tuple(range(5)), has_aux=True)
    shd = gaussian_sharding(mesh)
    dev0 = jax.devices()[0]
    t0 = time.perf_counter()
    (_, (img_s, ovf_s)), g_s = jax.jit(
        jax.value_and_grad(loss_sharded, **grad)
    )(*(jax.device_put(x, shd) for x in scene))
    print(f"four: sharded fwd+bwd {time.perf_counter() - t0:.1f} s incl. "
          f"compile, overflow {bool(ovf_s)}", flush=True)
    (_, (img_1, ovf_1)), g_1 = jax.jit(
        jax.value_and_grad(loss_single, **grad)
    )(*(jax.device_put(x, dev0) for x in scene))
    if bool(ovf_s) or bool(ovf_1):
        fail("capacity overflow in the four-card comparison")
    errs = {"image_max_abs": float(
        np.abs(np.asarray(img_s) - np.asarray(img_1)).max())}
    for name, a, b in zip(["means", "cov3d", "color", "opacity", "sh"],
                          g_s, g_1):
        errs[f"grad_{name}"] = normalized_err(a, b)
    print(f"four errors (sharded vs single card): {json.dumps(errs)}",
          flush=True)
    if not errs["image_max_abs"] <= IMG_BAR:
        fail(f"sharded image error {errs['image_max_abs']} > {IMG_BAR}")
    bad = {k: v for k, v in errs.items()
           if k.startswith("grad_") and not v <= GRAD_BAR}
    if bad:
        fail(f"sharded gradient errors over {GRAD_BAR}: {bad}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only render_sharded on 4 GPUs vs one card")
    args = ap.parse_args()

    # Phase 1: device. The card's name and power limit come from a child
    # process started before this process opens the card.
    cards = card_lines()
    card = cards[0]
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import numpy as np

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devices[0].platform!r})")
    import wgpu_3dgs_core_tpu as gs
    from bench import synthetic_scene
    from wgpu_3dgs_core_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    kind = devices[0].device_kind
    print(f"device: {kind} x{len(devices)}, jax {jax.__version__}",
          flush=True)

    scene = synthetic_scene(HEADLINE["gaussians"])
    cam = headline_camera(gs.Camera, HEADLINE["width"], HEADLINE["height"])
    caps = capacities(gs, scene, cam)
    print(f"capacities: max_fragments {caps[0]}, max_rows {caps[1]}",
          flush=True)

    if args.four:
        phase_four(gs, jax, jnp, np, scene, cam, caps)
        count = 4
    else:
        compiled, params, opt_state, _, _ = phase_compile(
            gs, jax, jnp, scene, cam, caps
        )
        phase_parity(gs, jax, jnp, np)
        phase_train(jax, jnp, np, compiled, params, opt_state, scene, card)
        count = 1

    for line in cards[:count]:
        print(f"card: {line}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind, "count": count,
    }}))


if __name__ == "__main__":
    main()
