"""End-to-end render tests: accumulation semantics, determinism, energy
sanity, tone mapping, PNG round trip."""

import numpy as np
import jax.numpy as jnp

import opengl_ray_tracing_framework_tpu as ortf
from opengl_ray_tracing_framework_tpu.models.camera import Camera, pixel_uv
from opengl_ray_tracing_framework_tpu.models.scene import (
    Scene,
    build_test_scene,
)
from opengl_ray_tracing_framework_tpu.models import mesh as mesh_lib
from opengl_ray_tracing_framework_tpu.models.material import (
    Material,
    preset_materials,
)
from opengl_ray_tracing_framework_tpu.models.hdr import make_gradient_hdr
from opengl_ray_tracing_framework_tpu.render import (
    finalize,
    init_render_state,
    render_pass,
)
from opengl_ray_tracing_framework_tpu.ops import tonemap

CAM = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                  zoom=30.0, aspect=1.0)


def _cfg(**kw):
    base = dict(width=24, height=24, max_bounce=3, spp_per_pass=1,
                tracer="whileloop")
    base.update(kw)
    return ortf.RenderConfig(**base)


def test_render_deterministic(test_scene):
    cfg = _cfg()
    s1 = render_pass(test_scene, CAM, init_render_state(cfg), cfg,
                     rays_per_tile=576)
    s2 = render_pass(test_scene, CAM, init_render_state(cfg), cfg,
                     rays_per_tile=576)
    np.testing.assert_array_equal(np.asarray(s1.accum), np.asarray(s2.accum))
    assert int(s1.n_samples) == 1


def test_accumulation_running_mean(test_scene):
    """acc after k passes == mean of the k per-pass samples (glsl:1552)."""
    cfg = _cfg()
    state = init_render_state(cfg)
    samples = []
    for _ in range(3):
        prev = np.asarray(state.accum)
        n_prev = int(state.n_samples)
        state = render_pass(test_scene, CAM, state, cfg, rays_per_tile=576)
        cur = np.asarray(state.accum)
        sample = cur * (n_prev + 1) - prev * n_prev
        samples.append(sample)
    mean = np.mean(samples, axis=0)
    np.testing.assert_allclose(np.asarray(state.accum), mean,
                               rtol=1e-4, atol=1e-5)


def test_env_only_render_matches_env():
    """No geometry in view: every pixel is exactly hdrColor(dir)*intensity
    (glsl:1532-1539)."""
    from opengl_ray_tracing_framework_tpu.ops.envmap import hdr_color
    scene = Scene()
    # one far-away tiny triangle so the BVH exists but nothing is visible
    tiny = mesh_lib.MeshData(
        positions=np.array([[1000.0, 1000.0, 1000.0], [1000.1, 1000.0, 1000.0],
                            [1000.0, 1000.1, 1000.0]], np.float32),
        normals=None,
        faces=np.array([[0, 1, 2]], np.int32))
    scene.add_object(tiny, preset_materials()["white"], normalize=False)
    scene.set_environment(make_gradient_hdr(32, 16))
    data = scene.build(env_intensity=1.5)

    cfg = _cfg(max_bounce=1)
    state = render_pass(data, CAM, init_render_state(cfg), cfg,
                        rays_per_tile=576)
    u, v = pixel_uv(cfg.width, cfg.height)
    _, d = CAM.generate_rays(u, v)
    expect = np.asarray(hdr_color(data.hdr_map, d, data.env_angle)) * 1.5
    got = np.asarray(state.accum).reshape(-1, 3)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)


def test_emissive_object_lights_scene():
    """An emissive quad over a diffuse floor adds light vs. no quad."""
    presets = preset_materials()

    def build(with_light):
        scene = Scene()
        floor_tm = mesh_lib.transform_matrix((0, 0, 0), (0, -1, 3),
                                             (5, 1, 5))
        scene.add_object(mesh_lib.make_quad(), presets["white"], floor_tm,
                         normalize=False)
        if with_light:
            light = Material.make(emissive=(5.0, 5.0, 5.0))
            light_tm = mesh_lib.transform_matrix((180, 0, 0), (0, 2.0, 3),
                                                 (2, 1, 2))
            scene.add_object(mesh_lib.make_quad(), light, light_tm,
                             normalize=False)
        scene.set_environment(make_gradient_hdr(16, 8) * 0.05)
        return scene.build()

    cfg = _cfg(max_bounce=2, spp_per_pass=4)
    lit = render_pass(build(True), CAM, init_render_state(cfg), cfg,
                      rays_per_tile=576)
    unlit = render_pass(build(False), CAM, init_render_state(cfg), cfg,
                        rays_per_tile=576)
    assert float(jnp.mean(lit.accum)) > float(jnp.mean(unlit.accum)) * 1.3


def test_no_nans_all_modes(test_scene):
    for kw in (dict(), dict(enable_bsdf=False), dict(enable_env_map=False),
               dict(enable_mis=False), dict(use_bvh=False)):
        cfg = _cfg(**kw)
        st = render_pass(test_scene, CAM, init_render_state(cfg), cfg,
                         rays_per_tile=576)
        arr = np.asarray(st.accum)
        assert np.isfinite(arr).all(), kw
        assert arr.min() >= 0.0, kw


def test_bvh_matches_brute_force_image(test_scene):
    """Same RNG + same integrator: the BVH image must equal the brute-force
    image almost exactly."""
    cfg_bvh = _cfg(max_bounce=2)
    cfg_brute = cfg_bvh.replace(use_bvh=False)
    a = render_pass(test_scene, CAM, init_render_state(cfg_bvh), cfg_bvh,
                    rays_per_tile=576)
    b = render_pass(test_scene, CAM, init_render_state(cfg_brute), cfg_brute,
                    rays_per_tile=576)
    aa, bb = np.asarray(a.accum), np.asarray(b.accum)
    # identical winners except epsilon ties on shared edges
    close = np.isclose(aa, bb, rtol=1e-3, atol=1e-3)
    assert close.mean() > 0.995, close.mean()


def test_finalize_tonemap(test_scene):
    cfg = _cfg()
    st = render_pass(test_scene, CAM, init_render_state(cfg), cfg,
                     rays_per_tile=576)
    img = np.asarray(finalize(st, cfg))
    assert img.min() >= 0.0 and img.max() <= 1.0
    raw = np.asarray(finalize(st, cfg.replace(enable_tone_mapping=False,
                                              enable_gamma_correction=False)))
    np.testing.assert_array_equal(raw, np.asarray(st.accum))


def test_tonemap_values():
    c = jnp.asarray([[0.0, 1.0, 10.0]], jnp.float32)
    out = np.asarray(tonemap.simple_aces(c))
    assert out[0, 0] == 0.0
    assert 0.77 < out[0, 1] < 0.84       # ACES(1.0) ~ 0.80
    assert out[0, 2] == 1.0
    g = np.asarray(tonemap.gamma_correct(jnp.asarray([0.5], jnp.float32)))
    assert np.isclose(g[0], 0.5 ** (1 / 2.2), atol=1e-5)


def test_png_roundtrip(tmp_path):
    from opengl_ray_tracing_framework_tpu.utils.image import (
        read_png,
        write_png,
    )
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    path = str(tmp_path / "t.png")
    write_png(path, img)
    back = read_png(path)
    np.testing.assert_array_equal(img, back)


def test_render_scale_knob():
    # RENDER_SCALE (RenderSettings.h:11): width/height scale at
    # construction, and the scaled config renders at the scaled size.
    cfg = _cfg(width=32, height=16, render_scale=0.5)
    assert (cfg.width, cfg.height) == (16, 8)
    assert cfg.render_scale == 1.0          # folded in, stays hashable
    assert _cfg(width=32, height=16, render_scale=2.0).n_pixels == 64 * 32
    try:
        _cfg(render_scale=-1.0)
    except ValueError:
        pass
    else:
        raise AssertionError("render_scale <= 0 must be rejected")
