"""Differentiable progressive Monte-Carlo path tracer in JAX.

A from-scratch JAX/Pallas re-design of the capabilities of
georgehuan1994/OpenGL-Ray-Tracing-Framework (C++/GLSL, single GPU):

- Scene ingestion (OBJ + TRS + unit-scale normalization), SAH BVH,
  Disney-principled BSDF with media, HDR environment importance sampling,
  progressive accumulation with invalidation, ACES/gamma post, image export.
- Re-designed for an accelerator: SoA device arrays instead of texture
  buffers, a wavefront integrator under `jit` with a BVH traversal kernel
  (Pallas through Triton on NVIDIA GPUs) instead of a fragment-shader
  megakernel, `shard_map` pixel/sample sharding over a device mesh, and
  reverse-mode pixel gradients w.r.t. material/camera parameters (the
  differentiable analogue of the reference's live-edit loop).

Reference layer map: see SURVEY.md.
"""

__version__ = "0.1.0"

from .utils.cache import enable_compilation_cache

# Persistent XLA compilation cache: cold compiles of the fused render
# program are slow; cached reloads are fast. Opt out with ORTF_NO_CACHE=1
# (utils/cache.py).
enable_compilation_cache()

from .utils.config import RenderConfig, jit
from .models.material import Material, MaterialTable, MEDIUM_NONE, MEDIUM_ABSORB, MEDIUM_SCATTER, MEDIUM_EMISSIVE
from .models.camera import Camera
from .models.scene import Scene, SceneData
from .render import render, render_progressive, RenderState, init_render_state, render_pass

__all__ = [
    "RenderConfig",
    "jit",
    "Material",
    "MaterialTable",
    "Camera",
    "Scene",
    "SceneData",
    "render",
    "render_progressive",
    "RenderState",
    "init_render_state",
    "render_pass",
    "MEDIUM_NONE",
    "MEDIUM_ABSORB",
    "MEDIUM_SCATTER",
    "MEDIUM_EMISSIVE",
    "__version__",
]
