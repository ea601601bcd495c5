"""Regression: material gradients stay finite at non-toy shapes.

Round-3 defect: at 256x256x8-bounce the specular-lobe backward produced
NaN material gradients (cotangents ~1/eps^2 through output-side _safe_div
clamps overflowed f32) while every <=128x128 test stayed green. The lobe
evals now mask *inputs* (ops/disney.py::_mask1) before dividing; this test
pins the failing shape. Matches the reference's material-edit re-render
loop (main.cpp:329-480) which this gradient path replaces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opengl_ray_tracing_framework_tpu import RenderConfig
from opengl_ray_tracing_framework_tpu.models.camera import Camera
from opengl_ray_tracing_framework_tpu.models.material import preset_materials
from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
from opengl_ray_tracing_framework_tpu.parallel.autodiff import material_grad


@pytest.mark.slow
@pytest.mark.parametrize("mat_name", ["brown_glass", "white"])
def test_material_grad_finite_256(mat_name):
    presets = preset_materials()
    _, scene = build_test_scene(n_sphere_subdiv=2, material=presets[mat_name])
    camera = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                         zoom=30.0, aspect=1.0)
    config = RenderConfig(width=256, height=256, max_bounce=8, spp_per_pass=1,
                          tracer="whileloop")
    target = jnp.zeros((256, 256, 3), jnp.float32)
    loss, grads = material_grad(scene, camera, target, config,
                                rays_per_tile=16384)
    assert np.isfinite(float(loss))
    leaves = [g for g in jax.tree.leaves(grads)
              if g.dtype != jax.dtypes.float0]
    assert leaves
    for g in leaves:
        assert np.isfinite(np.asarray(g)).all()
    # the gradient is not degenerate: something nonzero flows to materials
    assert any(np.abs(np.asarray(g)).max() > 0 for g in leaves)


def test_grad_remat_policies_identical():
    # grad_tile_checkpoint is a pure remat knob: both policies compute the
    # same loss and gradients (only residual memory / replay count differ).
    presets = preset_materials()
    _, scene = build_test_scene(n_sphere_subdiv=1,
                                material=presets["brown_glass"])
    camera = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                         zoom=30.0, aspect=1.0)
    target = jnp.zeros((32, 32, 3), jnp.float32)
    out = {}
    for flag in (True, False):
        config = RenderConfig(width=32, height=32, max_bounce=3,
                              spp_per_pass=1, grad_tile_checkpoint=flag,
                              tracer="whileloop")
        loss, grads = material_grad(scene, camera, target, config,
                                    rays_per_tile=256)
        out[flag] = (float(loss), [np.asarray(g) for g in
                                   jax.tree.leaves(grads)
                                   if g.dtype != jax.dtypes.float0])
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
