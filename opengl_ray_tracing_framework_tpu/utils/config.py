"""Typed render configuration.

Replaces the reference's global mutable settings surface
(src/core/RenderSettings.h:8-90: SCR_WIDTH/SCR_HEIGHT, RENDER_SCALE,
MAX_BOUNCE, feature toggles, envIntensity/envAngle/maxBounce/maxIterations)
with one immutable, hashable dataclass that is passed as a static argument to
jitted render functions. Anything that should be differentiable / traced
(camera pose, material table, env intensity & angle) lives in pytrees
instead — see models.camera.Camera and models.material.MaterialTable.
"""

from __future__ import annotations

import dataclasses
import functools

import jax

TRACERS = ("kernel", "whileloop")

# Compile options of every program that renders. XLA's GPU priority fusion
# can form multi-output Triton fusions that make its fusion graph cyclic on
# the integrator's compaction branches; the compiler then aborts the
# process ("A cycle is detected while visiting instruction", seen on an
# H100 compiling render_pass at 1024x512x8 with either tracer). Turning
# that fusion kind off avoids it. Other backends ignore GPU options.
XLA_OPTIONS = {"xla_gpu_unsupported_enable_triton_multi_output_fusion": False}


def jit(fun=None, **kwargs):
    """jax.jit with XLA_OPTIONS among its compiler options.

    Every jitted entry point of the package is made with it, and so must be
    any program of a caller's that calls one (an optimizer step around
    material_grad, say). JAX takes compiler options only from the
    outermost program and refuses them on a jit traced inside another, so
    there the function runs as a plain jit (traced once more) and the
    outer program's options apply. Usable as `jit(f, ...)`, `@jit` or
    `@jit(static_argnames=...)`."""
    if fun is None:
        return lambda f: jit(f, **kwargs)
    options = {**XLA_OPTIONS, **kwargs.pop("compiler_options", {})}
    outer = jax.jit(fun, compiler_options=options, **kwargs)
    inner = jax.jit(fun, **kwargs)

    @functools.wraps(fun)
    def call(*args, **kw):
        try:
            return outer(*args, **kw)
        except ValueError as e:
            if "compiler_options" not in str(e):
                raise
            return inner(*args, **kw)

    call.clear_cache = lambda: (outer.clear_cache(), inner.clear_cache())
    return call


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable: usable as a jit static arg).

    Defaults mirror the reference (RenderSettings.h:8-12, 81-90).
    """

    width: int = 1024
    height: int = 512
    # Resolution multiplier applied to width/height (RENDER_SCALE,
    # RenderSettings.h:11; main.cpp:84,107 renders at width*RENDER_SCALE).
    # Applied once at construction: width/height are rewritten to the
    # scaled values and render_scale resets to 1, so n_pixels and every
    # consumer see the final resolution.
    render_scale: float = 1.0
    max_bounce: int = 8
    # Progressive-iteration cap; -1 means unlimited (RenderSettings.h:90,
    # main.cpp:367 UI range -1..3000).
    max_iterations: int = 3000

    # Feature toggles (RenderSettings.h:81-88).
    enable_env_map: bool = True
    enable_mis: bool = True
    enable_bsdf: bool = True          # False -> legacy 3-lobe BRDF integrator
    enable_tone_mapping: bool = True
    enable_gamma_correction: bool = True

    # GL-faithful bilinear filtering for the in-loop environment fetches
    # (NEE sample/pdf/radiance + bounce-miss radiance/pdf). The reference
    # samples its HDR map and cache with GL_LINEAR (texture(),
    # glsl:635-646, 1165-1186); the default fast path fetches nearest
    # texels from the fused env_fetch table (one row gather per site,
    # ops/envmap.py). Flip on for parity probes / quantifying the
    # deviation; costs 4 gathers + the separate cache/pdf lookups per
    # site.
    env_bilinear: bool = False

    # Sampling.
    spp_per_pass: int = 1             # reference renders 1 spp/frame (glsl:1552)
    pixel_jitter: bool = False        # reference always shoots pixel centers
    # BVH leaf size used at build time (Scene.h:197 uses 8).
    bvh_leaf_size: int = 8

    # Tracers.
    use_bvh: bool = True              # False -> brute force (oracle path)
    # "kernel": the Pallas/Triton BVH traversal kernel (ops/bvh_kernel.py),
    # the measured fastest on an H100. "whileloop": the XLA wavefront
    # traversal (ops/traverse.py), the reference it is checked against.
    tracer: str = "kernel"
    # Rematerialization granularity of the backward pass. True wraps each
    # ray tile in jax.checkpoint (save-only-"hit"), so reverse-mode saves
    # only the flat traversal outputs per tile and replays the whole
    # tile's shading once before the per-bounce scan replays it again —
    # the most memory-lean policy (needed at >= 131072-ray grad tiles).
    # False relies on the per-bounce scan checkpoints alone: the scan's
    # flat (3R,) carry stack and named hits are saved per tile, shading
    # replays ONCE instead of twice in the backward sweep (~the fwd
    # shading cost saved per grad step) at a modest residual-memory cost.
    # Purely a performance/memory knob — gradients are identical.
    grad_tile_checkpoint: bool = True
    # What the between-bounce compaction switch wraps:
    #   "full"  — the whole bounce body (NEE gather, BSDF sample, casts,
    #             shading) runs at the bucketed width. Fastest forward
    #             pass; under reverse-mode AD every switch branch is
    #             replayed AND transposed, and the boundary
    #             materializations add to the backward sweep.
    #   "casts" — only the (detached) traversal launches run bucketed;
    #             shading runs at full width. The switch carries no
    #             cotangents (stop_gradient'ed operands) and its hits are
    #             checkpoint-saved, so the backward sweep never sees it.
    #             The gradient entry points (parallel.autodiff) select
    #             this mode for their internal render; images and
    #             gradients are exact in both modes.
    compaction_mode: str = "full"
    # compaction_mode the gradient entry points (parallel.autodiff)
    # substitute for their internal render: with "casts" the backward
    # sweep never crosses a switch boundary. Set to "full" to force the
    # grad programs onto the render path's exact program structure.
    grad_compaction_mode: str = "casts"
    # Wavefront compaction between bounces: partition alive rays to a dense
    # prefix each bounce and run the whole bounce (NEE shadow cast, BSDF
    # sample, bounce cast, shading) at the smallest bucketed width that
    # holds them (lax.switch over static widths R/1, R/2, R/4, R/8, R/16,
    # R/64 — see ops.integrator._BUCKET_DIVISORS — plus an all-dead skip).
    # On glass scenes few paths survive the first bounces, so per-bounce
    # work scales with live rays instead of launch width. Exact: compaction uses
    # bounce-start aliveness and dead lanes outside the prefix are
    # untouched. Costs ~3x extra traversal compiles (one per width).
    compaction_buckets: int = 6

    def __post_init__(self):
        if self.render_scale != 1.0:
            if self.render_scale <= 0:
                raise ValueError(
                    f"render_scale must be > 0, got {self.render_scale}")
            object.__setattr__(
                self, "width", max(1, int(round(self.width
                                                * self.render_scale))))
            object.__setattr__(
                self, "height", max(1, int(round(self.height
                                                 * self.render_scale))))
            object.__setattr__(self, "render_scale", 1.0)
        if self.tracer not in TRACERS:
            raise ValueError(f"unknown tracer {self.tracer!r}; "
                             f"one of {TRACERS}")

    def validate(self) -> "RenderConfig":
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad image size {self.width}x{self.height}")
        if self.max_bounce < 1:
            raise ValueError("max_bounce must be >= 1")
        if self.spp_per_pass < 1:
            raise ValueError("spp_per_pass must be >= 1")
        if not 0 <= self.compaction_buckets <= 6:
            raise ValueError("compaction_buckets must be in [0, 6]")
        if self.compaction_mode not in ("full", "casts"):
            raise ValueError(f"unknown compaction_mode "
                             f"{self.compaction_mode!r}")
        if self.grad_compaction_mode not in ("full", "casts"):
            raise ValueError(f"unknown grad_compaction_mode "
                             f"{self.grad_compaction_mode!r}")
        return self

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
