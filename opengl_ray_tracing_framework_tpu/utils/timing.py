"""Per-stage device-time breakdown (the `--timing` flag).

The reference's only observability is the ImGui frame-time/FPS readout and
the iteration counter (src/sources/main.cpp:366-372). This module gives a
per-stage profile: each stage of a progressive pass is
timed as its own jitted sub-program with block_until_ready fences, at the
true batch shapes and with *representative* ray populations:

  raygen          camera ray generation for one tile
  primary_cast    coherent closest-hit (camera rays)
  shadow_cast     incoherent any-hit from hit points toward env samples
  bounce_cast     incoherent closest-hit from hit points, hemisphere dirs
  shade           surface attrs + Disney eval + Disney sample
  env             environment importance sample + radiance/pdf fetches
  accumulate      running-mean update of the (H, W, 3) accumulator

`estimated_pass` composes these the way a pass does (1 primary + per-bounce
shadow/bounce/shade/env); `full_pass` is the real fused render_pass, which
XLA may fuse tighter — both are reported so the gap is visible.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def _timeit(fn, *args, repeats: int = 3):
    out = jax.block_until_ready(fn(*args))   # compile + warm
    t0 = time.time()
    for _ in range(repeats):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / repeats


def pass_breakdown(scene, camera, config, rays_per_tile: int = 131072,
                   repeats: int = 3) -> dict:
    """Per-stage device seconds for one spp of `config` on `scene`."""
    from ..models.camera import pixel_uv
    from ..ops import disney
    from ..ops.envmap import (
        env_radiance_pdf_nearest, env_sample_nearest)
    from ..ops.intersect import surface_attributes
    from ..ops.integrator import PathState
    from ..ops.sampling import rand01
    from ..ops.traverse import closest_hit
    from ..render import init_render_state, render_pass

    w, h = config.width, config.height
    r = min(rays_per_tile, config.n_pixels)
    u, v = pixel_uv(w, h)
    o_full, d_full = camera.generate_rays(u, v)
    o, d = o_full[:r], d_full[:r]
    pid = jnp.arange(r, dtype=jnp.uint32)

    times: dict[str, float] = {}

    # raygen ----------------------------------------------------------------
    uu, vv = u[:r], v[:r]
    times["raygen"] = _timeit(
        jax.jit(lambda uu, vv: camera.generate_rays(uu, vv)), uu, vv,
        repeats=repeats)

    # casts -------------------------------------------------------------------
    cast = jax.jit(
        lambda o, d, ah: closest_hit(scene, o, d, config, any_hit=ah),
        static_argnums=2)
    times["primary_cast"] = _timeit(lambda o, d: cast(o, d, False), o, d,
                                    repeats=repeats)

    hit = jax.block_until_ready(cast(o, d, False))
    hp = o + d * jnp.minimum(hit.t, 100.0)[:, None]

    hh, ww = scene.hdr_map.shape[0], scene.hdr_map.shape[1]
    xl1 = rand01(pid, jnp.int32(1), 0)
    xl2 = rand01(pid, jnp.int32(1), 1)
    l_dir, _, _ = env_sample_nearest(scene.env_fetch, hh, ww, xl1, xl2,
                                  scene.env_angle)
    hp, l_dir = jax.block_until_ready((hp, l_dir))
    times["shadow_cast"] = _timeit(lambda o, d: cast(o, d, True), hp, l_dir,
                                   repeats=repeats)

    # hemisphere bounce dirs (uniform; representative incoherence)
    z1 = rand01(pid, jnp.int32(2), 0) * 2.0 - 1.0
    z2 = rand01(pid, jnp.int32(2), 1) * 2.0 * jnp.pi
    s = jnp.sqrt(jnp.maximum(1.0 - z1 * z1, 0.0))
    bd = jnp.stack([s * jnp.cos(z2), jnp.abs(z1), s * jnp.sin(z2)], axis=-1)
    bd = jax.block_until_ready(bd)
    times["bounce_cast"] = _timeit(lambda o, d: cast(o, d, False), hp, bd,
                                   repeats=repeats)

    # shading -----------------------------------------------------------------
    def do_shade(o, d, hit_t, hit_tri, hit_inside, xi):
        st = PathState(origin=o, direction=d, t=hit_t, tri=hit_tri,
                       inside=hit_inside, history=jnp.ones_like(o),
                       lo=jnp.zeros_like(o), alive=hit_tri >= 0)
        hit_point, n, vv, mat = surface_attributes(scene, st)
        f, pdf = disney.disney_eval(mat, vv, n, l_dir)
        smp = disney.disney_sample(mat, vv, n, xi[:, 0], xi[:, 1], xi[:, 2])
        return f, pdf, smp.direction, smp.pdf

    xi = jnp.stack([rand01(pid, jnp.int32(3), k) for k in range(3)], axis=-1)
    times["shade"] = _timeit(
        jax.jit(do_shade), o, d, hit.t, hit.tri, hit.inside, xi,
        repeats=repeats)

    # environment -------------------------------------------------------------
    def do_env(xl1, xl2, d):
        ld, lpdf, lfr = env_sample_nearest(scene.env_fetch, hh, ww, xl1, xl2,
                                      scene.env_angle)
        fr, pdf2 = env_radiance_pdf_nearest(scene.env_fetch, hh, ww, d,
                                            scene.env_angle)
        return ld, lpdf, fr, pdf2

    times["env"] = _timeit(jax.jit(do_env), xl1, xl2, bd, repeats=repeats)

    # accumulate ----------------------------------------------------------------
    acc = jnp.zeros((h, w, 3), jnp.float32)
    sample = jnp.ones((h, w, 3), jnp.float32)
    times["accumulate"] = _timeit(
        jax.jit(lambda a, s: a + (s - a) / 7.0), acc, sample,
        repeats=repeats)

    n_tiles = max(1, config.n_pixels // r)
    b = config.max_bounce
    times["estimated_pass"] = n_tiles * (
        times["raygen"] + times["primary_cast"]
        + b * (times["shadow_cast"] + times["bounce_cast"]
               + 2 * times["shade"] + times["env"])
    ) + times["accumulate"]

    state = init_render_state(config)
    times["full_pass"] = _timeit(
        lambda st: render_pass(scene, camera, st, config,
                               rays_per_tile=rays_per_tile),
        state, repeats=max(1, repeats - 1))
    times["_meta"] = {
        "rays_per_tile": r, "n_tiles": n_tiles, "bounces": b,
        "pixels": config.n_pixels,
        "rays_per_pass": config.n_pixels * (1 + 2 * b),
    }
    return times


def format_breakdown(times: dict) -> str:
    meta = times.get("_meta", {})
    lines = ["stage             device ms"]
    for k, val in times.items():
        if k.startswith("_"):
            continue
        lines.append(f"{k:16s} {val * 1e3:10.2f}")
    if meta:
        full = times.get("full_pass")
        if full:
            rps = meta["rays_per_pass"] / full
            lines.append(f"pass rays/s      {rps:,.0f}")
    return "\n".join(lines)
