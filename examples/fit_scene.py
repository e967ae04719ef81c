"""Fit gaussians to a target image with the differentiable renderer.

Renders a target from the example scene, perturbs the scene, then recovers
it by gradient descent — the end-to-end training path (projection, binning,
Pallas forward/backward, Adam).

Usage: python examples/fit_scene.py [steps]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from wgpu_3dgs_core_tpu import (  # noqa: E402
    Camera,
    GaussianSoA,
    GaussiansBuffer,
    read_ply,
    render_gaussians,
)
from wgpu_3dgs_core_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)
from wgpu_3dgs_core_tpu.render.train import fit  # noqa: E402


def main():
    enable_compile_cache()
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    soa = GaussianSoA.from_ply(
        read_ply(os.path.join(os.path.dirname(__file__), "model.ply"))
    )
    cam = Camera.look_at(eye=(0, -0.5, -4), target=(0, 0, 0), width=64,
                         height=64, fov_y=0.9)
    target = np.asarray(render_gaussians(GaussiansBuffer.new(soa), cam).image)

    perturbed = GaussianSoA(
        rot=soa.rot,
        pos=soa.pos + np.random.default_rng(0).normal(0, 0.2, soa.pos.shape),
        color=soa.color,
        sh=soa.sh,
        scale=soa.scale * 1.5,
    )
    fitted, losses = fit(perturbed, cam, target, steps=steps,
                         learning_rate=1e-2, sh_deg=0, log_every=10)
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f} over {steps} steps")
    print(f"mean position error: "
          f"{np.abs(fitted.pos - soa.pos).mean():.4f} "
          f"(started {np.abs(perturbed.pos - soa.pos).mean():.4f})")


if __name__ == "__main__":
    main()
