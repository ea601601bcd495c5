"""Headless command-line renderer.

The batch-mode replacement for the reference's interactive app
(src/sources/main.cpp): scene presets, progressive sampling with the
maxIterations cap, tone mapping toggles, and PNG export (the `Save Image`
button, main.cpp:475-477). Live parameter editing becomes flags; the
accumulator-reset-on-edit semantics are implicit (each invocation renders
from a fresh state).

    python -m opengl_ray_tracing_framework_tpu.cli \
        --scene loong --spp 256 --out loong.png
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Differentiable path tracer")
    p.add_argument("--scene", default="test",
                   help="test | bunny | loong | sphere | comma list of "
                        "reference objects. NOTE: the reference's Scene.h "
                        "also lists 'panther', but the asset "
                        "(panther_100000.obj) does not ship in the "
                        "reference's resources — requesting it fails "
                        "with a clear error; use --scene loong "
                        "--material brown_glass for BASELINE config-4 "
                        "physics (ABSORB medium + refraction)")
    p.add_argument("--material", default="tear_glass",
                   help="preset for the focus object (Scene.h:53-109)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--render-scale", type=float, default=1.0,
                   help="resolution multiplier on width/height "
                        "(RENDER_SCALE, RenderSettings.h:11)")
    p.add_argument("--spp", type=int, default=64,
                   help="samples per pixel (maxIterations analogue)")
    p.add_argument("--spp-per-pass", type=int, default=1)
    p.add_argument("--max-bounce", type=int, default=8)
    p.add_argument("--no-env", action="store_true")
    p.add_argument("--no-mis", action="store_true")
    p.add_argument("--brdf", action="store_true",
                   help="legacy BRDF mode (enableBSDF=false)")
    p.add_argument("--no-tonemap", action="store_true")
    p.add_argument("--no-gamma", action="store_true")
    p.add_argument("--env-intensity", type=float, default=1.0)
    p.add_argument("--env-angle", type=float, default=0.0)
    p.add_argument("--camera", type=float, nargs=5,
                   metavar=("X", "Y", "Z", "YAW", "PITCH"),
                   default=[0.0, 0.0, 7.0, -87.78, -14.0])
    p.add_argument("--zoom", type=float, default=30.0)
    p.add_argument("--out", default="render.png")
    p.add_argument("--save-state", default=None,
                   help="write the accumulator checkpoint (npz)")
    p.add_argument("--resume", default=None,
                   help="resume from an accumulator checkpoint")
    p.add_argument("--rays-per-tile", type=int, default=131072)
    p.add_argument("--progress-every", type=int, default=0,
                   help="print a progress line every N passes")
    p.add_argument("--preview-every", type=int, default=0,
                   help="write the current image to --out every N passes "
                        "(the live-preview analogue of the ImGui loop)")
    p.add_argument("--tracer", default="kernel",
                   choices=("kernel", "whileloop", "brute"),
                   help="closest-hit tracer: the BVH kernel (GPU), the "
                        "XLA while-loop reference, or brute force")
    p.add_argument("--timing", action="store_true",
                   help="print a per-stage device-time breakdown "
                        "(raygen/casts/shade/env/accumulate) "
                        "before rendering — the FPS/ms readout analogue "
                        "(main.cpp:366-372)")
    p.add_argument("--distributed", action="store_true",
                   help="call jax.distributed.initialize() for multi-host "
                        "runs (single-process runs don't need it)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.render_scale != 1.0:
        # main.cpp:84,107: the render target is width*RENDER_SCALE x
        # height*RENDER_SCALE; fold it in here so every downstream use
        # (aspect, ray accounting, RenderConfig) sees the final size.
        args.width = max(1, int(round(args.width * args.render_scale)))
        args.height = max(1, int(round(args.height * args.render_scale)))

    import jax
    from . import RenderConfig
    from .models.camera import Camera
    from .models.scene import build_reference_scene, build_test_scene
    from .render import (
        finalize,
        init_render_state,
        render_pass,
        render_passes,
    )
    from .utils.image import save_render
    from .utils import checkpoint as ckpt

    if args.distributed:
        from .parallel.sharding import init_distributed
        init_distributed()

    t0 = time.time()
    if args.scene == "test":
        _, scene = build_test_scene()
        cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                          zoom=args.zoom,
                          aspect=args.width / args.height)
    else:
        from .models.scene import _OBJ_FILES
        requested = [s for s in args.scene.split(",") if s]
        unknown = [s for s in requested if s not in _OBJ_FILES]
        if unknown:
            sys.exit(f"error: unknown scene object(s) {unknown}; choose from "
                     f"test, {', '.join(_OBJ_FILES)}")
        objects = tuple(
            ["floor"] + [s for s in requested if s != "floor"])
        _, scene = build_reference_scene(
            objects=objects, current_material=args.material)
        scene = scene._replace(
            env_intensity=jax.numpy.float32(args.env_intensity),
            env_angle=jax.numpy.float32(args.env_angle))
        x, y, z, yaw, pitch = args.camera
        cam = Camera.make(position=(x, y, z), yaw=yaw, pitch=pitch,
                          zoom=args.zoom,
                          aspect=args.width / args.height)
    print(f"scene: {scene.n_triangles} triangles, {scene.n_nodes} BVH nodes "
          f"({time.time() - t0:.1f}s)", file=sys.stderr)

    config = RenderConfig(
        width=args.width, height=args.height, max_bounce=args.max_bounce,
        spp_per_pass=args.spp_per_pass,
        enable_env_map=not args.no_env,
        enable_mis=not args.no_mis,
        enable_bsdf=not args.brdf,
        enable_tone_mapping=not args.no_tonemap,
        enable_gamma_correction=not args.no_gamma,
        use_bvh=args.tracer != "brute",
        tracer="whileloop" if args.tracer == "whileloop" else "kernel",
    )

    if args.timing:
        from .utils.timing import format_breakdown, pass_breakdown
        times = pass_breakdown(scene, cam, config,
                               rays_per_tile=args.rays_per_tile)
        print(format_breakdown(times), file=sys.stderr)

    state = init_render_state(config)
    if args.resume:
        state = ckpt.load_render_state(args.resume)
        print(f"resumed at {int(state.n_samples)} spp", file=sys.stderr)

    n_passes = -(-args.spp // config.spp_per_pass)
    # host sync points: the smallest observer interval; everything between
    # runs as one on-device lax.fori_loop (render_passes)
    intervals = [x for x in (args.progress_every, args.preview_every) if x]
    chunk = min(intervals) if intervals else n_passes
    t0 = time.time()
    done = 0
    while done < n_passes:
        step = min(chunk, n_passes - done)
        if step == 1:
            state = render_pass(scene, cam, state, config,
                                rays_per_tile=args.rays_per_tile)
        else:
            state = render_passes(scene, cam, state, config, step,
                                  rays_per_tile=args.rays_per_tile)
        done += step
        if args.progress_every and done % args.progress_every == 0:
            jax.block_until_ready(state.accum)
            dt = time.time() - t0
            print(f"pass {done}/{n_passes} "
                  f"({int(state.n_samples)} spp, {dt:.1f}s, "
                  f"{done / dt:.2f} passes/s)", file=sys.stderr)
        if args.preview_every and done % args.preview_every == 0 \
                and done < n_passes:
            save_render(args.out, finalize(state, config))
            print(f"preview written to {args.out} at "
                  f"{int(state.n_samples)} spp", file=sys.stderr)
    jax.block_until_ready(state.accum)
    elapsed = time.time() - t0

    image = finalize(state, config)
    save_render(args.out, image)
    if args.save_state:
        ckpt.save_render_state(args.save_state, state)

    rays = args.width * args.height * int(state.n_samples) \
        * (1 + 2 * args.max_bounce)
    print(json.dumps({
        "out": args.out,
        "spp": int(state.n_samples),
        "seconds": round(elapsed, 2),
        "rays_per_sec": round(rays / max(elapsed, 1e-9), 1),
    }))


if __name__ == "__main__":
    main()
