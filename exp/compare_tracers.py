"""The measurement that chose the default tracer: the Pallas BVH kernel
against what XLA makes of the while-loop reference, on one GPU.

    python exp/compare_tracers.py          # on a GPU, about 3 minutes
    python exp/compare_tracers.py --tiny   # CPU check at a toy size, the
                                           # kernel run by the interpreter

1. Casts: 131,072 camera rays (the first rows of the 1024x512 frame) and
   131,072 random rays around the glass sphere, one cast each, for the
   while-loop and for the kernel with 32-, 64- and 128-ray blocks.
2. End to end: render_pass at 1024x512, 8 bounces, 131,072-ray tiles on
   chip_smoke.py's 81,922-triangle scene, both tracers in one process,
   three passes per turn in the turns kernel, while-loop, while-loop,
   kernel, so that a drift of the card's clock hits both alike.

Every time is printed with the card's name and power limit.
"""

import functools
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

TINY = "--tiny" in sys.argv


def timed(fn, *args, n=5):
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / n


def main():
    if TINY:
        os.environ["ORTF_NO_CACHE"] = "1"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from opengl_ray_tracing_framework_tpu.models.material import (
            preset_materials,
        )
        from opengl_ray_tracing_framework_tpu.models.scene import (
            build_test_scene,
        )
        cs.W, cs.H, cs.BOUNCES, cs.TILE = 32, 16, 3, 256
        _, scene = build_test_scene(
            n_sphere_subdiv=2, material=preset_materials()["tear_glass"])
        label = "cpu, interpreted kernel"
    else:
        cs.device_check()
        import jax
        label = cs.card()
        scene = cs.smoke_scene()
    import numpy as np
    from opengl_ray_tracing_framework_tpu import RenderConfig
    from opengl_ray_tracing_framework_tpu.models.camera import (
        Camera,
        pixel_uv,
    )
    from opengl_ray_tracing_framework_tpu.ops.bvh_kernel import (
        closest_hit_kernel,
    )
    from opengl_ray_tracing_framework_tpu.ops.traverse import bvh_closest_hit
    from opengl_ray_tracing_framework_tpu.render import (
        init_render_state,
        render_pass,
    )

    n = cs.TILE
    cam = Camera.make(aspect=cs.W / cs.H)
    u, v = pixel_uv(cs.W, cs.H)
    rng = np.random.default_rng(1)
    ro = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    ro[:, 2] += 3.0                    # the sphere sits at z = 3
    rd = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rays = {"camera": cam.generate_rays(u[:n], v[:n]),
            "random": (jax.numpy.asarray(ro), jax.numpy.asarray(rd))}
    casts = {"whileloop": jax.jit(bvh_closest_hit)}
    for block in (32,) if TINY else (32, 64, 128):
        casts[f"kernel_{block}"] = jax.jit(functools.partial(
            closest_hit_kernel, block_rays=block, interpret=TINY))
    for name, (o, d) in rays.items():
        for cast, fn in casts.items():
            s = timed(fn, scene, o, d)
            print(f"cast {name} {n} rays {cast}: {s * 1e3:.4f} ms "
                  f"({n / s / 1e6:.1f} Mrays/s) [{label}]", flush=True)

    if TINY:
        # the interpreter stands in for the kernel: a check, not a timing
        import opengl_ray_tracing_framework_tpu.ops.bvh_kernel as bk
        bk.closest_hit_kernel = functools.partial(closest_hit_kernel,
                                                  interpret=True)
    cfgs = {t: RenderConfig(width=cs.W, height=cs.H, max_bounce=cs.BOUNCES,
                            tracer=t) for t in ("kernel", "whileloop")}
    states = {}
    for t, cfg in cfgs.items():
        t0 = time.perf_counter()
        states[t] = jax.block_until_ready(render_pass(
            scene, cam, init_render_state(cfg), cfg, rays_per_tile=cs.TILE))
        print(f"render_pass {t}: first call {time.perf_counter() - t0:.2f} s "
              f"[{label}]", flush=True)
    times = {t: [] for t in cfgs}
    for t in ("kernel", "whileloop", "whileloop", "kernel"):
        for _ in range(3):
            t0 = time.perf_counter()
            states[t] = jax.block_until_ready(render_pass(
                scene, cam, states[t], cfgs[t], rays_per_tile=cs.TILE))
            times[t].append(time.perf_counter() - t0)
    n_rays = cs.W * cs.H * (1 + 2 * cs.BOUNCES)
    for t, v in times.items():
        print(f"render_pass {t} {cs.W}x{cs.H}x{cs.BOUNCES}: s/pass min "
              f"{min(v):.6f} median {statistics.median(v):.6f} all "
              f"{[round(x, 6) for x in v]} rays/s {n_rays / min(v):.6g} "
              f"[{label}]", flush=True)
    a, b = (np.asarray(states[t].accum) for t in cfgs)
    print(f"kernel vs whileloop image after 7 passes: "
          f"{cs._fmt(cs._close(a, b, 1e-3))}", flush=True)


if __name__ == "__main__":
    main()
