"""wgpu_3dgs_core_tpu — JAX 3D Gaussian splatting framework for NVIDIA GPUs.

Brand-new JAX/XLA/Pallas implementation with the capabilities of the
wgpu-3dgs-core Rust crate (file formats, gaussian IR, quantized layouts,
device math library, kernel dispatch) plus the differentiable forward +
backward splat renderer built on top, sharded across device meshes.

Everything is re-exported flat from the package root, mirroring the
reference's flat crate root (reference: src/lib.rs:11-20).
"""

from .buffer import (  # noqa: F401
    FixedSizeBufferWrapper,
    GaussianDisplayMode,
    GaussiansBuffer,
    GaussianTransform,
    ModelTransform,
    download,
)
from .errors import *  # noqa: F401,F403
from .layouts import (  # noqa: F401
    ALL_LAYOUTS,
    Cov3dFormat,
    GaussianLayout,
    PackedGaussians,
    ShFormat,
    pack,
    unpack,
)
from .models import *  # noqa: F401,F403
from .ops import (  # noqa: F401
    KernelBundle,
    KernelBundleBuilder,
    OutputSpec,
    ResourceGroupLayout,
)
from .render import (  # noqa: F401
    Camera,
    RenderResult,
    TrainableGaussians,
    measure_max_fragments,
    fit,
    make_train_step,
    render,
    render_gaussians,
    render_reference,
)

__version__ = "0.1.0"
