"""Differentiable rendering + multi-device sharding tests.

Exercises the capabilities the reference lacks (SURVEY.md north star):
reverse-mode pixel gradients w.r.t. scene parameters, and pixel-sharded
rendering over a (virtual, 8-device CPU) mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import opengl_ray_tracing_framework_tpu as ortf
from opengl_ray_tracing_framework_tpu.models.camera import Camera
from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
from opengl_ray_tracing_framework_tpu.parallel.autodiff import (
    camera_grad,
    material_grad,
    material_grad_sharded,
)
from opengl_ray_tracing_framework_tpu.parallel.sharding import (
    make_mesh,
    render_pass_sharded,
    replicate_scene,
)
from opengl_ray_tracing_framework_tpu.render import (
    init_render_state,
    render_pass,
)

CAM = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                  zoom=30.0, aspect=1.0)
CFG = ortf.RenderConfig(width=16, height=16, max_bounce=2, spp_per_pass=1,
                        tracer="whileloop")


def test_material_grad_finite_and_informative(test_scene):
    target = jnp.zeros((16, 16, 3), jnp.float32)
    loss, grads = material_grad(test_scene, CAM, target, CFG, spp=1,
                                rays_per_tile=256)
    assert np.isfinite(float(loss)) and float(loss) > 0.0
    leaves = [g for g in jax.tree.leaves(grads)
              if g.dtype != jax.dtypes.float0]
    assert leaves
    assert all(np.isfinite(np.asarray(g)).all() for g in leaves)
    # against a black target, more base-color reflectance -> more radiance
    # -> larger loss: d loss / d base_color must be positive somewhere
    assert float(jnp.max(grads.mat.base_color)) > 0.0


def test_material_grad_matches_finite_difference(test_scene):
    """AD gradient of the loss w.r.t. a base-color channel vs. central
    finite differences (same RNG stream -> deterministic renders)."""
    target = jnp.zeros((16, 16, 3), jnp.float32)

    def loss_of(delta):
        mats = test_scene.materials
        bc = mats.mat.base_color.at[0, 1].add(delta)
        scene2 = test_scene.with_materials(
            mats._replace(mat=mats.mat._replace(base_color=bc)))
        from opengl_ray_tracing_framework_tpu.parallel.autodiff import (
            material_loss,
        )
        return float(material_loss(scene2.materials, scene2, CAM, target,
                                   CFG, jnp.int32(0), CFG.height, 1, 256))

    eps = 3e-3
    fd = (loss_of(eps) - loss_of(-eps)) / (2 * eps)
    _, grads = material_grad(test_scene, CAM, target, CFG, spp=1,
                             rays_per_tile=256)
    ad = float(grads.mat.base_color[0, 1])
    assert np.isfinite(fd) and np.isfinite(ad)
    assert abs(fd - ad) < 0.05 * max(abs(fd), abs(ad), 1.0), (fd, ad)


def test_camera_grad_finite(test_scene):
    target = jnp.zeros((16, 16, 3), jnp.float32)
    loss, grads = camera_grad(test_scene, CAM, target, CFG, spp=1,
                              rays_per_tile=256)
    assert np.isfinite(float(loss))
    for name, g in grads._asdict().items():
        assert np.isfinite(np.asarray(g)).all(), name


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_render_matches_single_device(test_scene):
    cfg = ortf.RenderConfig(width=16, height=16, max_bounce=2,
                            spp_per_pass=1, tracer="whileloop")
    mesh = make_mesh(jax.devices()[:8])
    scene_r = replicate_scene(test_scene, mesh)

    single = render_pass(test_scene, CAM, init_render_state(cfg), cfg,
                         rays_per_tile=256)

    state = init_render_state(cfg)
    sharded = render_pass_sharded(scene_r, CAM, state, cfg, mesh,
                                  rays_per_tile=32)
    np.testing.assert_allclose(np.asarray(sharded.accum),
                               np.asarray(single.accum), rtol=2e-5,
                               atol=1e-6)
    assert int(sharded.n_samples) == 1

    # second pass accumulates
    sharded2 = render_pass_sharded(scene_r, CAM, sharded, cfg, mesh,
                                   rays_per_tile=32)
    assert int(sharded2.n_samples) == 2


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_material_grad_matches_single(test_scene):
    cfg = ortf.RenderConfig(width=16, height=16, max_bounce=2,
                            spp_per_pass=1, tracer="whileloop")
    mesh = make_mesh(jax.devices()[:8])
    scene_r = replicate_scene(test_scene, mesh)
    target = jnp.zeros((16, 16, 3), jnp.float32)

    loss_s, grads_s = material_grad_sharded(scene_r, CAM, target, cfg,
                                            mesh, spp=1, rays_per_tile=32)
    loss_1, grads_1 = material_grad(test_scene, CAM, target, cfg, spp=1,
                                    rays_per_tile=256)
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(grads_s.mat.base_color),
        np.asarray(grads_1.mat.base_color), rtol=5e-3, atol=1e-4)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_camera_grad_matches_single(test_scene):
    from opengl_ray_tracing_framework_tpu.parallel.autodiff import (
        param_grad_sharded,
    )
    cfg = ortf.RenderConfig(width=16, height=16, max_bounce=2,
                            spp_per_pass=1, tracer="whileloop")
    mesh = make_mesh(jax.devices()[:8])
    scene_r = replicate_scene(test_scene, mesh)
    target = jnp.zeros((16, 16, 3), jnp.float32)

    loss_s, grads_s = param_grad_sharded(scene_r, CAM, target, cfg, mesh,
                                         param="camera", spp=1,
                                         rays_per_tile=32)
    loss_1, grads_1 = camera_grad(test_scene, CAM, target, cfg, spp=1,
                                  rays_per_tile=256)
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-4)
    for name in ("position", "yaw", "pitch"):
        np.testing.assert_allclose(
            np.asarray(getattr(grads_s, name)),
            np.asarray(getattr(grads_1, name)), rtol=5e-3, atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_sharded_geometry_grad_matches_single(test_scene):
    from opengl_ray_tracing_framework_tpu.parallel.autodiff import (
        geometry_grad,
        param_grad_sharded,
    )
    cfg = ortf.RenderConfig(width=16, height=16, max_bounce=2,
                            spp_per_pass=1, tracer="whileloop")
    mesh = make_mesh(jax.devices()[:8])
    scene_r = replicate_scene(test_scene, mesh)
    target = jnp.zeros((16, 16, 3), jnp.float32)

    loss_s, grads_s = param_grad_sharded(scene_r, CAM, target, cfg, mesh,
                                         param="geometry", spp=1,
                                         rays_per_tile=32)
    loss_1, grads_1 = geometry_grad(test_scene, CAM, target, cfg, spp=1,
                                    rays_per_tile=256)
    assert grads_s.shape == grads_1.shape == (3, 3, test_scene.n_triangles)
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(grads_s), np.asarray(grads_1),
                               rtol=5e-3, atol=1e-4)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_spp_axis_sharding_matches_single(test_scene):
    """(tiles, spp) 2-D mesh: the psum-merged sample mean must equal the
    single-device sequential accumulation of the same frames."""
    from opengl_ray_tracing_framework_tpu.parallel.sharding import (
        make_mesh_2d,
    )
    cfg = ortf.RenderConfig(width=16, height=16, max_bounce=2,
                            spp_per_pass=4, tracer="whileloop")
    mesh = make_mesh_2d(jax.devices()[:8], n_tiles=4)   # 4 tiles x 2 spp
    scene_r = replicate_scene(test_scene, mesh)

    single = render_pass(test_scene, CAM, init_render_state(cfg), cfg,
                         rays_per_tile=256)
    sharded = render_pass_sharded(scene_r, CAM, init_render_state(cfg),
                                  cfg, mesh, rays_per_tile=64)
    np.testing.assert_allclose(np.asarray(sharded.accum),
                               np.asarray(single.accum), rtol=2e-5,
                               atol=1e-6)
    assert int(sharded.n_samples) == 4
