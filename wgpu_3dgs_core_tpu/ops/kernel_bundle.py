"""Kernel bundle: the compute-dispatch abstraction (L5).

Redesign of the reference's ComputeBundle/ComputeBundleBuilder
(reference: src/compute_bundle.rs). The WESL->WGSL compile + pipeline +
bind-group machinery becomes a thin, validated launcher around
``pl.pallas_call`` (Triton route on the GPU) for 1D map-style kernels over
N items:

- bind group layouts        -> ResourceGroupLayout arity validation
- WESL feature flags        -> a hashable static ``config`` partial-applied
                               into the kernel (Python-level ``@if``)
- pipeline-overridable
  ``workgroup_size``        -> ``block_size`` (grid = ceil(count/block),
                               reference: compute_bundle.rs:131)
- other override constants  -> ``constants`` dict partial-applied statically
- dispatch(encoder, count)  -> dispatch(count) returning jnp outputs

Kernels are plain Pallas kernels: ``fn(*in_refs, *out_refs, **constants)``
where each ref holds a [block, F'] tile of its array. The Triton route
takes only power-of-two block shapes, so ``block`` is the block size
(at least MIN_BLOCK_ROWS) and F' the item width F, each rounded up to a
power of two: padded rows and columns are zero on input and sliced off
every output (N items, F columns).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ..errors import (
    KernelBundleResourceCountError,
    KernelBundleWorkgroupLimitError,
    MissingEntryPointError,
    MissingKernelError,
    MissingLayoutConfigError,
    MissingResourceLayoutError,
)

log = logging.getLogger(__name__)

# The analog of min(max_compute_workgroup_size_x,
# max_compute_invocations_per_workgroup) (reference: compute_bundle.rs:269-281):
# how many items one program instance may process. A Triton program holds
# its [block, width] tiles in the registers of its warps (a few thousand
# 32-bit values per thread at most before they spill to local memory), so
# the bound is registers per program, not a thread count.
MAX_BLOCK_SIZE = 8192
DEFAULT_BLOCK_SIZE = 1024
# A program runs at least one warp of 32 threads, so smaller blocks are
# padded up to 32 rows rather than leaving lanes idle.
MIN_BLOCK_ROWS = 32


def interpret_mode() -> bool:
    """Where Pallas kernels run: compiled through Triton on the GPU,
    interpreted on the CPU (the test meshes). Any other platform has no
    route and raises — nothing falls back silently."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"Pallas kernels run on 'gpu' (Triton) or 'cpu' (interpreted); "
        f"no route for platform {platform!r}"
    )


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclass(frozen=True)
class ResourceGroupLayout:
    """Declares one group of same-lifetime resources — the analog of a
    wgpu::BindGroupLayoutDescriptor (reference: compute_bundle.rs:383-390)."""

    label: str
    arity: int


@dataclass(frozen=True)
class OutputSpec:
    """Per-item output: each dispatched item produces a [width] vector."""

    width: int
    dtype: Any = jnp.float32


class KernelBundle:
    """A built, dispatchable kernel (reference: ComputeBundle,
    compute_bundle.rs:49-60).

    Created by :class:`KernelBundleBuilder`. If built with resources, they
    are owned by the bundle (the ``ComputeBundle<wgpu::BindGroup>`` type
    state); otherwise pass resources at dispatch
    (``ComputeBundle<()>``, compute_bundle.rs:255-352).
    """

    def __init__(self, label, layouts, kernel, outputs, block_size, resources):
        self.label = label
        self._layouts = layouts
        self._kernel = kernel
        self._outputs = outputs
        self.block_size = block_size
        self._resources = resources
        # Build-once / dispatch-many (reference: compute_bundle.rs:311-330
        # creates the pipeline once; dispatch only records a pass): the
        # padded pallas_call launcher is jitted once per (count, input
        # shapes/dtypes) signature and reused for every later dispatch.
        self._dispatch_cache: dict[Any, Any] = {}

    # ------------------------------------------------------------ resources

    def update_resources(self, resources: Sequence[Sequence[Any]]) -> None:
        """Re-point the bundle at new arrays (reference:
        compute_bundle.rs:204-228)."""
        self._resources = _validate_resources(self._layouts, resources)

    # ------------------------------------------------------------- dispatch

    def dispatch(self, count: int, resources: Optional[Sequence] = None):
        """Run the kernel over ``count`` items
        (reference: compute_bundle.rs:114-132).

        grid = ceil(count / block_size) programs, each seeing a
        [block_size, F] tile per resource.
        """
        if resources is None:
            resources = self._resources
            if resources is None:
                raise KernelBundleResourceCountError(
                    layout_index=0, resource_count=0,
                    expected_count=self._layouts[0].arity,
                )
        else:
            resources = _validate_resources(self._layouts, resources)

        flat = []
        for arr in (a for group in resources for a in group):
            a = jnp.asarray(arr)
            if a.ndim == 1:
                a = a[:, None]
            if a.shape[0] != count:
                raise ValueError(
                    f"{self.label}: resource has {a.shape[0]} items, "
                    f"dispatch count is {count}"
                )
            flat.append(a)

        key = (count, tuple((a.shape, a.dtype.name) for a in flat))
        run = self._dispatch_cache.get(key)
        if run is None:
            run = self._build_dispatch(count, flat)
            self._dispatch_cache[key] = run

        result = run(*flat)
        return result if len(result) > 1 else result[0]

    def _build_dispatch(self, count: int, flat):
        """Jitted pad + pallas_call launcher for one dispatch signature."""
        block = max(_pow2(self.block_size), MIN_BLOCK_ROWS)
        grid = pl.cdiv(count, block)
        padded = grid * block
        in_widths = [_pow2(a.shape[1]) for a in flat]
        out_widths = [_pow2(o.width) for o in self._outputs]
        in_specs = [
            pl.BlockSpec((block, w), lambda i: (i, 0)) for w in in_widths
        ]
        out_shapes = [
            jax.ShapeDtypeStruct((padded, w), o.dtype)
            for w, o in zip(out_widths, self._outputs)
        ]
        out_specs = [
            pl.BlockSpec((block, w), lambda i: (i, 0)) for w in out_widths
        ]

        @jax.jit
        def run(*ins):
            ins = tuple(
                jnp.pad(a, ((0, padded - count), (0, w - a.shape[1])))
                for a, w in zip(ins, in_widths)
            )
            outs = pl.pallas_call(
                self._kernel,
                grid=(grid,),
                in_specs=in_specs,
                out_specs=out_specs,
                out_shape=out_shapes,
                backend="triton",
                interpret=interpret_mode(),
            )(*ins)
            return tuple(
                out[:count, :o.width] for out, o in zip(outs, self._outputs)
            )

        return run


def _validate_resources(layouts, resources):
    if len(resources) != len(layouts):
        raise KernelBundleResourceCountError(
            layout_index=min(len(resources), len(layouts)),
            resource_count=len(resources),
            expected_count=len(layouts),
        )
    for i, (layout, group) in enumerate(zip(layouts, resources)):
        if len(group) != layout.arity:
            raise KernelBundleResourceCountError(
                layout_index=i,
                resource_count=len(group),
                expected_count=layout.arity,
            )
    return [list(group) for group in resources]


class KernelBundleBuilder:
    """Fluent builder (reference: ComputeBundleBuilder,
    compute_bundle.rs:364-497)."""

    def __init__(self):
        self._label = "Kernel Bundle"
        self._layouts: list[ResourceGroupLayout] = []
        self._module: Optional[dict[str, Callable]] = None
        self._entry_point: Optional[str] = None
        self._outputs: list[OutputSpec] = []
        self._block_size: Optional[int] = None
        self._constants: dict[str, Any] = {}
        self._config: Any = None

    def label(self, label: str) -> "KernelBundleBuilder":
        self._label = label
        return self

    def resource_layout(self, layout: ResourceGroupLayout) -> "KernelBundleBuilder":
        self._layouts.append(layout)
        return self

    def resource_layouts(self, layouts) -> "KernelBundleBuilder":
        self._layouts.extend(layouts)
        return self

    def kernel(self, fn: Callable) -> "KernelBundleBuilder":
        """Single-function module (main shader analog)."""
        self._module = {"main": fn}
        self._entry_point = "main"
        return self

    def kernel_module(self, module: dict[str, Callable]) -> "KernelBundleBuilder":
        """Named kernels; select with entry_point
        (main_shader analog, compute_bundle.rs:449-456)."""
        self._module = module
        return self

    def entry_point(self, name: str) -> "KernelBundleBuilder":
        self._entry_point = name
        return self

    def output(self, width: int, dtype=jnp.float32) -> "KernelBundleBuilder":
        self._outputs.append(OutputSpec(width, dtype))
        return self

    def block_size(self, block_size: int) -> "KernelBundleBuilder":
        """The workgroup_size override (reference: compute_bundle.rs:489-496)."""
        self._block_size = block_size
        return self

    def constants(self, **constants) -> "KernelBundleBuilder":
        """Pipeline-overridable constants: partial-applied statically
        (reference: compute_bundle.rs:311-330)."""
        self._constants.update(constants)
        return self

    def layout_config(self, config) -> "KernelBundleBuilder":
        """Static layout specialization — the WESL feature-flag analog:
        passed to the kernel as ``config=`` (reference:
        GaussianPod::wesl_features, src/buffer/gaussian.rs:289-298)."""
        self._config = config
        return self

    def build(self, resources: Sequence[Sequence[Any]]) -> KernelBundle:
        """Build with bundle-owned resources
        (reference: compute_bundle.rs:500-543)."""
        bundle = self.build_without_resources()
        bundle.update_resources(resources)
        return bundle

    def build_without_resources(self) -> KernelBundle:
        """Build with caller-managed resources
        (reference: compute_bundle.rs:546-586)."""
        if not self._layouts:
            raise MissingResourceLayoutError(
                f"{self._label}: no resource group layouts"
            )
        if self._module is None:
            raise MissingKernelError(f"{self._label}: no kernel")
        if self._entry_point is None:
            raise MissingEntryPointError(f"{self._label}: no entry point")
        if self._entry_point not in self._module:
            raise MissingEntryPointError(
                f"{self._label}: entry point {self._entry_point!r} not in "
                f"module {sorted(self._module)}"
            )
        if not self._outputs:
            self._outputs = [OutputSpec(1, jnp.float32)]

        # A kernel declaring a required ``config`` parameter is layout-
        # specialized (the WESL feature-flag analog): building it without
        # .layout_config(...) is the reference's missing-features error
        # (reference: compute_bundle.rs:505-519 Missing* validation).
        if self._config is None:
            import inspect

            fn = self._module[self._entry_point]
            try:
                params = inspect.signature(fn).parameters
            except (TypeError, ValueError):
                params = {}
            cfg = params.get("config")
            if cfg is not None and cfg.default is inspect.Parameter.empty:
                raise MissingLayoutConfigError(
                    f"{self._label}: kernel {self._entry_point!r} requires a "
                    "layout config; call .layout_config(...) before build"
                )

        block = self._block_size or DEFAULT_BLOCK_SIZE
        if block > MAX_BLOCK_SIZE:
            raise KernelBundleWorkgroupLimitError(
                workgroup_size=block, limit=MAX_BLOCK_SIZE
            )

        kernel = self._module[self._entry_point]
        statics = dict(self._constants)
        if self._config is not None:
            statics["config"] = self._config
        if statics:
            import functools

            kernel = functools.partial(kernel, **statics)

        log.debug("building kernel bundle %r (block=%d)", self._label, block)
        return KernelBundle(
            label=self._label,
            layouts=tuple(self._layouts),
            kernel=kernel,
            outputs=tuple(self._outputs),
            block_size=block,
            resources=None,
        )
