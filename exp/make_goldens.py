"""Generate golden acceptance artifacts on a GPU.

The reference's de-facto acceptance artifacts are its converged renders
(/root/reference/screenshot/screenshot_{bunny,loong,panther}.png,
README.md:49-61). This script produces this renderer's equivalents:

  tests/goldens/{scene}_oracle.npz   128x64, 4 spp linear radiance from the
                                     while-loop oracle tracer — the exact
                                     parity target for the BVH kernel
                                     (same deterministic RNG => images match
                                     to float tolerance, not statistically)
  tests/goldens/{scene}_conv.npz     512x256, 512 spp converged radiance
                                     from the BVH kernel (f16, compressed)
                                     — the regression golden
  screenshots/{scene}.png            tone-mapped converged render — the
                                     visual analogue of the reference's
                                     screenshots

Scenes mirror the reference README: bunny/jade (cover), loong/tear_glass
(README.md:49-55), panther/brown_glass = ABSORB medium + refraction
(README.md:55-61, Scene.h:152-158 — BASELINE config 4).

Needs the reference's assets (models/scene.py DEFAULT_ASSETS_DIR) and a GPU.
Usage: python exp/make_goldens.py [scene ...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from opengl_ray_tracing_framework_tpu import RenderConfig
from opengl_ray_tracing_framework_tpu.models.camera import Camera
from opengl_ray_tracing_framework_tpu.models.scene import build_reference_scene
from opengl_ray_tracing_framework_tpu.render import (
    finalize, init_render_state, render_pass, render_passes)
from opengl_ray_tracing_framework_tpu.utils.image import save_render

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
SHOTS = os.path.join(REPO, "screenshots")
os.makedirs(GOLD, exist_ok=True)
os.makedirs(SHOTS, exist_ok=True)

SCENES = {
    "bunny": ("bunny", "jade"),
    "loong": ("loong", "tear_glass"),
    # The reference's Scene.h also lists panther/brown_glass, but
    # panther_100000.obj does not ship in its resources/. brown_loong
    # covers BASELINE config-4 physics (ABSORB medium + refraction,
    # Scene.h:152-158) on real 100k geometry instead.
    "brown_loong": ("loong", "brown_glass"),
}

ORACLE_W, ORACLE_H, ORACLE_SPP = 128, 64, 4
CONV_W, CONV_H, CONV_SPP = 512, 256, 512

names = sys.argv[1:] or list(SCENES)
for name in names:
    obj, mat = SCENES[name]
    t0 = time.time()
    _, scene = build_reference_scene(objects=("floor", obj),
                                     current_material=mat)
    print(f"[{name}] scene: {scene.n_triangles} tris "
          f"({time.time()-t0:.0f}s)", flush=True)

    # --- oracle golden (while-loop tracer, exact parity target) ---------
    cam = Camera.make(aspect=ORACLE_W / ORACLE_H)
    cfg = RenderConfig(width=ORACLE_W, height=ORACLE_H, max_bounce=8,
                       tracer="whileloop", spp_per_pass=ORACLE_SPP)
    t0 = time.time()
    st = init_render_state(cfg)
    st = render_pass(scene, cam, st, cfg, rays_per_tile=ORACLE_W * ORACLE_H)
    rad = np.asarray(jax.block_until_ready(st.accum))
    np.savez_compressed(os.path.join(GOLD, f"{name}_oracle.npz"),
                        radiance=rad, spp=ORACLE_SPP,
                        width=ORACLE_W, height=ORACLE_H, material=mat)
    print(f"[{name}] oracle {ORACLE_W}x{ORACLE_H}x{ORACLE_SPP}spp: "
          f"mean {rad.mean():.4f} ({time.time()-t0:.0f}s)", flush=True)

    # --- converged render (BVH kernel) ----------------------------------
    cam = Camera.make(aspect=CONV_W / CONV_H)
    cfg = RenderConfig(width=CONV_W, height=CONV_H, max_bounce=8)
    t0 = time.time()
    st = init_render_state(cfg)
    # chunk the convergence loop so progress prints every 32 spp
    CHUNK = 32
    for i in range(0, CONV_SPP, CHUNK):
        st = render_passes(scene, cam, st, cfg, min(CHUNK, CONV_SPP - i),
                           rays_per_tile=CONV_W * CONV_H)
        jax.block_until_ready(st.accum)
        print(f"[{name}]   {i + CHUNK}/{CONV_SPP} spp "
              f"({time.time()-t0:.0f}s)", flush=True)
    rad = np.asarray(jax.block_until_ready(st.accum))
    np.savez_compressed(os.path.join(GOLD, f"{name}_conv.npz"),
                        radiance=rad.astype(np.float16), spp=CONV_SPP,
                        width=CONV_W, height=CONV_H, material=mat)
    img = finalize(type(st)(accum=jax.numpy.asarray(rad),
                            n_samples=st.n_samples), cfg)
    save_render(os.path.join(SHOTS, f"{name}.png"), img)
    print(f"[{name}] converged {CONV_W}x{CONV_H}x{CONV_SPP}spp: "
          f"mean {rad.mean():.4f} ({time.time()-t0:.0f}s) -> "
          f"screenshots/{name}.png", flush=True)
