"""Headline benchmark: rays/sec on one GPU (BASELINE.md).

Renders the reference's default scene (floor + loong_100000, tear-glass
material, HDR environment, 8 bounces, 1024x512 — Scene.h:111-162,
RenderSettings.h:8-12) when its assets are present, else a procedural
scene labelled "procedural" in the metric, and reports traced rays per second for one
progressive pass, forward AND forward+backward (the north-star metric of
BASELINE.md is rays/sec/chip fwd+bwd). Ray accounting is fixed by
definition so rounds are comparable: each pixel sample launches 1 primary
ray plus, per bounce, 1 NEE shadow ray and 1 bounce ray
=> rays = W * H * spp * (1 + 2 * bounces), the same rays the reference
megakernel issues per frame. The backward pass re-plays the same rays
under value_and_grad w.r.t. the material table (traversal detached,
shading differentiated), so fwd+bwd rays/s = rays / grad-step seconds.

Prints ONE JSON line: {"metric", "value", "unit", ...}. `value` is the
forward number; `bwd_*` fields carry the gradient-step numbers; `device`
names the platform, device kind and count, and the card's name and power
limit. It needs a GPU and fails without one. BENCH_TIMING=1 additionally
prints the per-stage device-time breakdown (utils/timing.py) to stderr.
"""

import json
import os
import subprocess
import sys
import time


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU backend (JAX platform is {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]

    from opengl_ray_tracing_framework_tpu import RenderConfig
    from opengl_ray_tracing_framework_tpu.models.camera import Camera
    from opengl_ray_tracing_framework_tpu.models.scene import (
        build_reference_scene,
        build_test_scene,
    )
    from opengl_ray_tracing_framework_tpu.render import (
        init_render_state,
        render_pass,
    )

    width, height, bounces = 1024, 512, 8
    spp_per_pass = int(os.environ.get("BENCH_SPP", "1"))
    rays_per_tile = int(os.environ.get("BENCH_TILE", "131072"))
    # The backward renders with cast-only compaction (RenderConfig.
    # grad_compaction_mode="casts", applied inside material_grad): the
    # detached traversal launches stay bucketed but shading runs full
    # width, so the backward sweep crosses no lax.switch boundary.
    bwd_tile = int(os.environ.get("BENCH_BWD_TILE", "131072"))

    try:
        _, scene = build_reference_scene(objects=("floor", "loong"))
        scene_name = "loong-100k"
    except Exception as e:  # assets unavailable: procedural fallback
        print(f"# loong assets unavailable ({e}); procedural fallback",
              file=sys.stderr)
        _, scene = build_test_scene(n_sphere_subdiv=4)
        scene_name = "procedural"

    camera = Camera.make(aspect=width / height)
    # the default tracer: the BVH kernel (ops/bvh_kernel.py); its parity
    # with the while-loop reference is checked on the card by
    # chip_smoke.py and tests/test_gpu.py
    config = RenderConfig(width=width, height=height, max_bounce=bounces,
                          spp_per_pass=spp_per_pass)

    state = init_render_state(config)
    # warmup / compile. "compile_seconds" is whatever this process paid
    # (served from the persistent cache when warm); "warm_compile_seconds"
    # re-traces the same program in-process (AOT cost ~0) so cache misses
    # can't masquerade as perf changes.
    t0 = time.time()
    state = render_pass(scene, camera, state, config,
                        rays_per_tile=rays_per_tile)
    jax.block_until_ready(state.accum)
    compile_s = time.time() - t0
    t0 = time.time()
    render_pass.clear_cache()
    state = render_pass(scene, camera, state, config,
                        rays_per_tile=rays_per_tile)
    jax.block_until_ready(state.accum)
    warm_compile_s = time.time() - t0

    n_timed = int(os.environ.get("BENCH_PASSES", "3"))
    t0 = time.time()
    for _ in range(n_timed):
        state = render_pass(scene, camera, state, config,
                            rays_per_tile=rays_per_tile)
        jax.block_until_ready(state.accum)
    elapsed = (time.time() - t0) / n_timed

    rays = width * height * spp_per_pass * (1 + 2 * bounces)
    rays_per_sec = rays / elapsed

    # --- backward: one value_and_grad step w.r.t. the material table ------
    import jax.numpy as jnp
    from opengl_ray_tracing_framework_tpu.parallel.autodiff import (
        material_grad,
    )
    target = jnp.zeros((height, width, 3), jnp.float32)
    t0 = time.time()
    loss, grads = material_grad(scene, camera, target, config,
                                spp=spp_per_pass,
                                rays_per_tile=bwd_tile)
    jax.block_until_ready(loss)
    bwd_compile_s = time.time() - t0
    n_bwd = max(1, n_timed - 1)
    t0 = time.time()
    for _ in range(n_bwd):
        loss, grads = material_grad(scene, camera, target, config,
                                    spp=spp_per_pass,
                                    rays_per_tile=bwd_tile)
        jax.block_until_ready(loss)
    bwd_elapsed = (time.time() - t0) / n_bwd
    bwd_rays_per_sec = rays / bwd_elapsed

    if os.environ.get("BENCH_TIMING") == "1":
        from opengl_ray_tracing_framework_tpu.utils.timing import (
            format_breakdown, pass_breakdown)
        times = pass_breakdown(scene, camera, config,
                               rays_per_tile=rays_per_tile)
        print(format_breakdown(times), file=sys.stderr)

    out = {
        "metric": f"rays/sec/chip fwd ({scene_name}, {width}x{height}, "
                  f"{bounces} bounces)",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "pass_seconds": round(elapsed, 4),
        "compile_seconds": round(compile_s, 2),
        "warm_compile_seconds": round(warm_compile_s, 2),
        "bwd_rays_per_sec": round(bwd_rays_per_sec, 1),
        "bwd_step_seconds": round(bwd_elapsed, 4),
        "bwd_compile_seconds": round(bwd_compile_s, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "n_triangles": scene.n_triangles,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
