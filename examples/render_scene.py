"""Render a gaussian scene to an image — the renderer-extension example
(no reference analog: the core crate stops at buffers; see SURVEY.md §7).

Usage: python examples/render_scene.py [model.ply] [out.png]
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


def main():
    enable_compile_cache()
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "model.ply"
    )
    out = sys.argv[2] if len(sys.argv) > 2 else "render.png"

    soa = GaussianSoA.from_ply(read_ply(path))
    buf = GaussiansBuffer.new(soa)
    center = soa.pos.mean(axis=0)
    extent = float(np.abs(soa.pos - center).max()) + 1.0
    cam = Camera.look_at(
        eye=center + np.array([0.0, -0.5 * extent, -2.5 * extent]),
        target=center,
        width=640, height=480, fov_y=0.9,
    )
    res = render_gaussians(buf, cam, background=(1.0, 1.0, 1.0))
    img = np.clip(np.asarray(res.image), 0.0, 1.0)

    try:
        from PIL import Image

        Image.fromarray((img * 255).astype(np.uint8)).save(out)
        print(f"rendered {len(buf)} gaussians -> {out}")
    except ImportError:
        np.save(out + ".npy", img)
        print(f"rendered {len(buf)} gaussians -> {out}.npy (PIL unavailable)")


if __name__ == "__main__":
    main()
