"""Wavefront compaction exactness.

The integrator's between-bounce compaction (ops.integrator._compacted_bounce)
claims exactness: bucketed alive-prefix execution must produce the SAME
image as uncompacted full-width execution. The CPU suite's usual shapes
(<= 576 rays/tile) never enter a narrow-width branch because of the 512-ray
floor in _bucket_widths, so these tests run at >= 2048 rays/tile where the
make_branch gather/scatter path is actually taken — and assert bitwise
equality, not allclose.

The merged NEE-shadow + bounce launch is checked against two separate
casts in tests/test_bvh_kernel.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from opengl_ray_tracing_framework_tpu.models.camera import Camera
from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
from opengl_ray_tracing_framework_tpu.ops.integrator import _bucket_widths
from opengl_ray_tracing_framework_tpu.render import render_radiance
from opengl_ray_tracing_framework_tpu.utils.config import RenderConfig


@pytest.fixture(scope="module")
def scene():
    _, data = build_test_scene(n_sphere_subdiv=2)
    return data


def test_bucket_widths_narrow_at_2048():
    # the premise of this file: 2048-ray tiles DO get narrow branches
    assert _bucket_widths(2048, 6) == [2048, 1024, 512]
    # ... and the CPU suite's usual small tiles do not
    assert _bucket_widths(576, 6) == [576]


def test_compaction_bitwise_equal(scene):
    """render_pass with compaction_buckets=6 == compaction_buckets=0,
    bitwise, at a 2048-ray tile (64x32, one tile per pass)."""
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=2.0)
    base = dict(width=64, height=32, max_bounce=6, tracer="whileloop")
    img_c = render_radiance(
        scene, cam, RenderConfig(compaction_buckets=6, **base),
        spp=2, rays_per_tile=2048)
    img_u = render_radiance(
        scene, cam, RenderConfig(compaction_buckets=0, **base),
        spp=2, rays_per_tile=2048)
    a, b = np.asarray(img_c), np.asarray(img_u)
    assert np.isfinite(a).all()
    # some rays must actually die early for compaction to engage
    assert (a == b).all(), f"max abs diff {np.abs(a - b).max()}"


def test_compaction_bitwise_equal_kernel(scene, interpret_kernel):
    """Same bitwise contract through the default tracer, the BVH kernel
    (run by the Pallas interpreter), where compaction additionally changes
    the kernel's launch widths."""
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=2.0)
    base = dict(width=64, height=32, max_bounce=4, tracer="kernel")
    img_c = render_radiance(
        scene, cam, RenderConfig(compaction_buckets=6, **base),
        spp=1, rays_per_tile=2048)
    img_u = render_radiance(
        scene, cam, RenderConfig(compaction_buckets=0, **base),
        spp=1, rays_per_tile=2048)
    a, b = np.asarray(img_c), np.asarray(img_u)
    assert np.isfinite(a).all()
    assert (a == b).all(), f"max abs diff {np.abs(a - b).max()}"


def test_cast_compaction_bitwise_equal(scene):
    """compaction_mode="casts" (bucketed detached casts, full-width
    shading) == "full" == uncompacted, bitwise, at a 2048-ray tile."""
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=2.0)
    base = dict(width=64, height=32, max_bounce=6, tracer="whileloop")
    imgs = [np.asarray(render_radiance(
        scene, cam, RenderConfig(**kw, **base), spp=2, rays_per_tile=2048))
        for kw in (dict(compaction_mode="casts", compaction_buckets=6),
                   dict(compaction_mode="full", compaction_buckets=6),
                   dict(compaction_buckets=0))]
    assert np.isfinite(imgs[0]).all()
    assert (imgs[0] == imgs[1]).all(), \
        f"casts vs full: {np.abs(imgs[0] - imgs[1]).max()}"
    assert (imgs[0] == imgs[2]).all(), \
        f"casts vs uncompacted: {np.abs(imgs[0] - imgs[2]).max()}"


def test_cast_compaction_brdf_and_no_env(scene):
    """The casts-mode switch also covers the BRDF integrator and the
    single-cast (env off) sites.

    Tolerance note: under the suite's 8-virtual-device XLA flag, XLA:CPU
    compiles the BRDF integrator's shared math with different fusion
    shapes per program variant (fma/transcendental contraction), so even
    the PRE-EXISTING full-mode compaction differs from uncompacted by
    ~4e-7 here (single-device CPU is bitwise across all modes — verified
    2026-08-21). Assert to 1e-6 accordingly; the BSDF-mode tests above
    keep the bitwise contract."""
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=2.0)
    for extra in (dict(enable_bsdf=False),
                  dict(enable_env_map=False),
                  dict(enable_bsdf=False, enable_env_map=False)):
        base = dict(width=64, height=32, max_bounce=4, tracer="whileloop",
                    **extra)
        a = np.asarray(render_radiance(
            scene, cam,
            RenderConfig(compaction_mode="casts", compaction_buckets=6,
                         **base), spp=1, rays_per_tile=2048))
        b = np.asarray(render_radiance(
            scene, cam, RenderConfig(compaction_buckets=0, **base),
            spp=1, rays_per_tile=2048))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                   err_msg=str(extra))
