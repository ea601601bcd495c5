"""Headless render API: progressive accumulation, invalidation, finalize.

Replaces the reference's GLFW/ImGui frame loop + FBO ping-pong
(src/sources/main.cpp:165-253, src/core/Screen.h:110-155) with a functional
API:

- `render_pass`    one progressive sample for every pixel (PASS 1,
                   main.cpp:177-201, one fragment per pixel -> one jitted
                   batched trace, tiled with lax.map to bound memory),
- `RenderState`    the accumulator: running mean + sample count. The
                   reference's ping-pong `curColor = (1/n) sample +
                   ((n-1)/n) hist` (glsl:1552) becomes
                   `acc + (sample - acc)/n` — same mean, no ping-pong,
- `render_progressive`  the loop with the maxIterations cap
                   (RenderSettings.h:90); any scene/camera edit simply
                   starts a fresh RenderState (the analogue of
                   `camera.LoopNum = 0` invalidation, main.cpp:324-327),
- `finalize`       tone map + gamma (PASS 3, main.cpp:215-227).

Everything is a pytree, so checkpoint/resume is `save(state)` — a
capability the reference lacks entirely (accumulation restarts on any
perturbation).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .models.camera import Camera
from .models.scene import SceneData
from .ops.integrator import trace_radiance
from .ops import tonemap
from .ops.sampling import rand01
from .utils.config import RenderConfig, jit


class RenderState(NamedTuple):
    """Progressive accumulator (a pytree; serialize freely)."""

    accum: jax.Array      # (H, W, 3) float32 running mean of radiance
    n_samples: jax.Array  # scalar int32 — the reference's camera.LoopNum


def init_render_state(config: RenderConfig) -> RenderState:
    return RenderState(
        accum=jnp.zeros((config.height, config.width, 3), jnp.float32),
        n_samples=jnp.zeros((), jnp.int32),
    )


def tile_traced(scene, frame, config):
    """Checkpointed FLAT per-tile trace: (3T,), (3T,), (T,) -> (3T,).

    The lax.map over ray tiles is a reverse-mode AD boundary: without a
    checkpoint, every shading intermediate the backward sweep needs is
    saved *stacked per tile*, and any materialized f32[T, 3] / f32[T, 1]
    would be saved per tile at full size. Two countermeasures, both
    exact:

      * the whole tile is jax.checkpoint'ed with the save-only-"hit"
        policy, so per tile only the named traversal outputs (all flat
        (T,)-shaped, ops.integrator._named_hit) are saved and the bwd
        replays shading math — the same policy the per-bounce scan
        already uses, lifted to the tile level;
      * every value crossing the map/checkpoint boundary is 1-D: ray
        origins/directions enter as (3T,) and radiance leaves as (3T,)
        (xyz-interleaved reshape, a relayout-free bitcast).
    """

    def tile(o3, d3, pid):
        rad = trace_radiance(scene, o3.reshape(-1, 3), d3.reshape(-1, 3),
                             pid, frame, config)
        return rad.reshape(-1)

    if not config.grad_tile_checkpoint:
        # rely on the per-bounce scan checkpoints alone (the scan carry is
        # already flat, ops.integrator._bounce_scan) — one less full
        # shading replay in the backward sweep; see RenderConfig
        return tile
    return jax.checkpoint(
        tile, policy=jax.checkpoint_policies.save_only_these_names("hit"))


def _trace_image(scene: SceneData, camera: Camera, frame, config: RenderConfig,
                 rays_per_tile: int = 65536):
    """One sample per pixel -> (H, W, 3) radiance. frame is the 1-based
    progressive index (camera.loopNum + 1, glsl:1325/1409). Pixels are
    traced in row order: a kernel block of consecutive pixels is a short
    image row segment, coherent enough for the primary cast."""
    n_pix = config.n_pixels
    h, w = config.height, config.width

    pixel_id = jnp.arange(n_pix, dtype=jnp.uint32)

    px = (pixel_id % w).astype(jnp.float32)
    py = (pixel_id // w).astype(jnp.float32)
    if config.pixel_jitter:
        ju = rand01(pixel_id, frame, 1001)
        jv = rand01(pixel_id, frame, 1002)
    else:
        ju = jv = 0.5
    u = (px + ju) / w
    v = (py + jv) / h

    origin, direction = camera.generate_rays(u, v)

    tile = min(rays_per_tile, n_pix)
    pad = (-n_pix) % tile
    if pad:
        origin = jnp.concatenate([origin, origin[:pad]])
        direction = jnp.concatenate([direction, direction[:pad]])
        pixel_id = jnp.concatenate([pixel_id, pixel_id[:pad]])
    n_tiles = origin.shape[0] // tile

    tile_fn = tile_traced(scene, frame, config)
    radiance = jax.lax.map(
        lambda args: tile_fn(*args),
        (origin.reshape(n_tiles, tile * 3),
         direction.reshape(n_tiles, tile * 3),
         pixel_id.reshape(n_tiles, tile)),
    ).reshape(-1, 3)[:n_pix]
    return radiance.reshape(h, w, 3)


def _one_pass(scene: SceneData, camera: Camera, state: RenderState,
              config: RenderConfig, rays_per_tile: int) -> RenderState:
    accum = state.accum
    n = state.n_samples
    for s in range(config.spp_per_pass):
        frame = n + (s + 1)
        sample = _trace_image(scene, camera, frame, config, rays_per_tile)
        cnt = (n + s + 1).astype(jnp.float32)
        accum = accum + (sample - accum) / cnt
    return RenderState(accum=accum,
                       n_samples=n + config.spp_per_pass)


@jit(static_argnames=("config", "rays_per_tile"))
def render_pass(scene: SceneData, camera: Camera, state: RenderState,
                config: RenderConfig, rays_per_tile: int = 65536
                ) -> RenderState:
    """Advance the progressive render by spp_per_pass samples/pixel."""
    return _one_pass(scene, camera, state, config, rays_per_tile)


@jit(static_argnames=("config", "n_passes", "rays_per_tile"),
     donate_argnames=("state",))
def render_passes(scene: SceneData, camera: Camera, state: RenderState,
                  config: RenderConfig, n_passes: int,
                  rays_per_tile: int = 65536) -> RenderState:
    """n_passes progressive passes as ONE device program: a lax.fori_loop
    with the accumulator donated, so convergence runs (the reference's
    3000-iteration loop, RenderSettings.h:90) never round-trip the
    accumulator through the host and pay a single dispatch."""
    def body(_, st):
        return _one_pass(scene, camera, st, config, rays_per_tile)
    return jax.lax.fori_loop(0, n_passes, body, state)


def finalize(state: RenderState, config: RenderConfig):
    """Display transform: simpleACES + gamma (tone-mapping pass)."""
    return tonemap.post_process(
        state.accum,
        enable_tone_mapping=config.enable_tone_mapping,
        enable_gamma=config.enable_gamma_correction,
    )


def render_progressive(scene: SceneData, camera: Camera, config: RenderConfig,
                       n_iterations: int | None = None, state=None,
                       callback=None, rays_per_tile: int = 65536):
    """Run progressive passes up to n_iterations (default: the config's
    maxIterations cap; -1 caps are treated as the explicit argument's duty).

    Returns (display_image, state). `callback(state, i)` is invoked after
    each pass (the analogue of the live preview / FPS readout).
    """
    config = config.validate()
    if state is None:
        state = init_render_state(config)
    if n_iterations is None:
        n_iterations = config.max_iterations if config.max_iterations > 0 else 1
    n_passes = -(-n_iterations // config.spp_per_pass)
    if callback is None and n_passes > 1:
        # no per-pass observer: run the whole loop on-device
        state = render_passes(scene, camera, state, config, n_passes,
                              rays_per_tile)
    else:
        for i in range(n_passes):
            state = render_pass(scene, camera, state, config, rays_per_tile)
            if callback is not None:
                callback(state, i)
    return finalize(state, config), state


def render(scene: SceneData, camera: Camera, config: RenderConfig,
           spp: int = 64, rays_per_tile: int = 65536):
    """Convenience: render `spp` samples/pixel, return the display image."""
    image, _ = render_progressive(scene, camera, config, n_iterations=spp,
                                  rays_per_tile=rays_per_tile)
    return image


def render_radiance(scene: SceneData, camera: Camera, config: RenderConfig,
                    spp: int = 16, rays_per_tile: int = 65536):
    """Linear-radiance render (no tone map) — the quantity that is compared
    against oracles and differentiated in inverse rendering."""
    state = init_render_state(config)
    cfg = config.replace(spp_per_pass=spp)
    state = render_pass(scene, Camera(*camera), state, cfg, rays_per_tile)
    return state.accum
