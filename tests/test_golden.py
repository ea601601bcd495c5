"""Golden converged acceptance tests (GPU lane).

The reference's acceptance artifacts are its converged screenshots
(/root/reference/screenshot/screenshot_{bunny,loong,panther}.png,
README.md:49-61) — verified by eye. Here they are verified by machine:

- *oracle parity*: the BVH kernel must reproduce the while-loop oracle's
  128x64 render to float tolerance — same deterministic counter-based RNG,
  so the comparison is exact, not statistical (goldens generated on a
  device by exp/make_goldens.py and committed under tests/goldens/).
- *converged regression*: a fresh 512x256, 512-spp render must match
  the committed converged golden. Covers bunny/jade, loong/tear_glass and
  panther/brown_glass — the ABSORB-medium + refraction physics of
  BASELINE config 4 (Scene.h:152-158).

Needs the reference's assets (models/scene.py DEFAULT_ASSETS_DIR); skips
without them. Run: python -m pytest tests/test_golden.py -m gpu -q (the
converged cases are additionally marked slow; deselect with
`-m "gpu and not slow"` for a quick lane).
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

SCENES = {
    "bunny": ("bunny", "jade"),
    "loong": ("loong", "tear_glass"),
    # The reference's Scene.h also lists panther/brown_glass, but
    # panther_100000.obj does not ship in its resources/. brown_loong
    # covers BASELINE config-4 physics (ABSORB medium + refraction,
    # Scene.h:152-158) on real 100k geometry instead.
    "brown_loong": ("loong", "brown_glass"),
}


def _build(name):
    from opengl_ray_tracing_framework_tpu.models.scene import (
        build_reference_scene,
    )
    obj, mat = SCENES[name]
    try:
        _, scene = build_reference_scene(objects=("floor", obj),
                                         current_material=mat)
    except Exception as e:  # pragma: no cover - assets missing
        pytest.skip(f"{name} assets unavailable: {e}")
    return scene


def _golden(name, kind):
    path = os.path.join(GOLD, f"{name}_{kind}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden {path} not generated (run exp/make_goldens.py)")
    return np.load(path)


@pytest.mark.parametrize("name", list(SCENES))
def test_oracle_parity(name):
    from opengl_ray_tracing_framework_tpu import RenderConfig
    from opengl_ray_tracing_framework_tpu.models.camera import Camera
    from opengl_ray_tracing_framework_tpu.render import (
        init_render_state, render_pass)

    gold = _golden(name, "oracle")
    w, h, spp = int(gold["width"]), int(gold["height"]), int(gold["spp"])
    scene = _build(name)
    cam = Camera.make(aspect=w / h)
    cfg = RenderConfig(width=w, height=h, max_bounce=8, spp_per_pass=spp)
    st = init_render_state(cfg)
    st = render_pass(scene, cam, st, cfg, rays_per_tile=w * h)
    img = np.asarray(st.accum)
    ref = gold["radiance"]
    assert abs(img.mean() - ref.mean()) < 1e-4 * max(ref.mean(), 1e-6)
    mismatch = ~np.isclose(img, ref, atol=1e-3, rtol=1e-3)
    assert mismatch.mean() < 1e-3, f"{mismatch.mean():.5f} texels diverge"


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SCENES))
def test_converged_golden(name):
    from opengl_ray_tracing_framework_tpu import RenderConfig
    from opengl_ray_tracing_framework_tpu.models.camera import Camera
    from opengl_ray_tracing_framework_tpu.render import (
        init_render_state, render_passes)

    gold = _golden(name, "conv")
    w, h, spp = int(gold["width"]), int(gold["height"]), int(gold["spp"])
    scene = _build(name)
    cam = Camera.make(aspect=w / h)
    cfg = RenderConfig(width=w, height=h, max_bounce=8)
    st = init_render_state(cfg)
    for i in range(0, spp, 32):
        st = render_passes(scene, cam, st, cfg, min(32, spp - i),
                           rays_per_tile=w * h)
    img = np.asarray(st.accum)
    ref = gold["radiance"].astype(np.float32)
    assert np.isfinite(img).all()
    # deterministic RNG: the only differences are float ordering + the f16
    # storage quantization of the golden
    err = np.abs(img - ref) / (np.abs(ref) + 1e-2)
    assert np.quantile(err, 0.999) < 2e-2, float(np.quantile(err, 0.999))
    assert err.mean() < 2e-3, float(err.mean())
