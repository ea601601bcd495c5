"""Inverse rendering: end-to-end parameter recovery + geometry gradients.

The reference's interactive analogue is the ImGui edit -> re-render loop
(main.cpp:329-480); here gradient descent closes that loop automatically
(BASELINE config 5). Geometry gradients flow through the fused tri_attr
table (ops/intersect.py surface_attributes) with detached traversal.
"""

import numpy as np
import jax
import jax.numpy as jnp

import opengl_ray_tracing_framework_tpu as ortf
from opengl_ray_tracing_framework_tpu.models.camera import Camera
from opengl_ray_tracing_framework_tpu.models.material import Material
from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
from opengl_ray_tracing_framework_tpu.parallel.autodiff import (
    geometry_grad,
    material_loss,
    render_rows_radiance,
)

CAM = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                  zoom=30.0, aspect=1.0)
CFG = ortf.RenderConfig(width=16, height=16, max_bounce=2, spp_per_pass=1,
                        tracer="whileloop")


def _render(scene, spp=2):
    return render_rows_radiance(scene, CAM, CFG, jnp.int32(0), CFG.height,
                                spp, rays_per_tile=256)


def test_fit_base_color_recovers_target():
    """Gradient descent recovers a perturbed base_color to < 5% in < 100
    steps."""
    true_color = np.asarray([0.75, 0.25, 0.2], np.float32)
    mat = Material.make(base_color=tuple(true_color), roughness=0.6)
    _, scene = build_test_scene(material=mat)
    target = _render(scene)

    # start from a wrong color on the sphere's material slot (slot 1)
    mats0 = scene.materials
    bc0 = mats0.mat.base_color.at[1].set(
        jnp.asarray([0.4, 0.55, 0.6], jnp.float32))
    params = mats0._replace(mat=mats0.mat._replace(base_color=bc0))

    import optax
    opt = optax.adam(2e-2)
    opt_state = opt.init(params.mat.base_color)

    @ortf.jit
    def step(mats, opt_state):
        loss, grads = jax.value_and_grad(material_loss, allow_int=True)(
            mats, scene, CAM, target, CFG, jnp.int32(0), CFG.height,
            2, 256)
        updates, opt_state = opt.update(grads.mat.base_color, opt_state)
        bc = jnp.clip(mats.mat.base_color + updates, 0.0, 1.0)
        return loss, mats._replace(mat=mats.mat._replace(base_color=bc)), \
            opt_state

    losses = []
    for i in range(80):
        loss, params, opt_state = step(params, opt_state)
        losses.append(float(loss))

    got = np.asarray(params.mat.base_color[1])
    assert losses[-1] < 0.05 * losses[0], losses[::16]
    np.testing.assert_allclose(got, true_color, atol=0.05)


def test_vertex_grad_finite_and_fd():
    """Geometry gradients: finite, informative, and FD-checked on one
    vertex coordinate (same RNG stream -> deterministic renders)."""
    _, scene = build_test_scene()
    target = jnp.zeros((16, 16, 3), jnp.float32)

    loss, grads = geometry_grad(scene, CAM, target, CFG, spp=1,
                                rays_per_tile=256)
    assert np.isfinite(float(loss)) and float(loss) > 0.0
    g = np.asarray(grads)
    assert g.shape == (3, 3, scene.n_triangles)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0

    # FD check on the vertex coordinate with the largest |grad| (most
    # informative, least noise-dominated)
    k, ax, tri = np.unravel_index(np.abs(g).argmax(), g.shape)
    row = int(3 * k + ax)

    def loss_of(delta):
        tri_attr = scene.tri_attr.at[row, tri].add(delta)
        sc = scene._replace(tri_attr=tri_attr)
        img = render_rows_radiance(sc, CAM, CFG, jnp.int32(0), CFG.height,
                                   1, 256)
        return float(jnp.sum((img - target) ** 2))

    eps = 2e-3
    fd = (loss_of(eps) - loss_of(-eps)) / (2 * eps)
    ad = float(g[k, ax, tri])
    # detached traversal: FD sees silhouette motion the AD gradient does
    # not — compare with a generous but meaningful tolerance
    assert abs(fd - ad) < 0.25 * max(abs(fd), abs(ad)), (fd, ad)


def test_package_jit_nests_in_a_callers_program():
    """JAX refuses compiler options on a jit traced inside another
    program: a package entry point called there runs as a plain jit, and
    the caller's program, made with ortf.jit, carries the options."""
    entry = ortf.jit(lambda x, n: x * n, static_argnames="n")
    x = jnp.arange(3.0)
    np.testing.assert_array_equal(entry(x, n=2), x * 2)
    step = ortf.jit(lambda x: entry(x, n=2) + 1.0)
    np.testing.assert_array_equal(step(x), x * 2 + 1)
    np.testing.assert_array_equal(jax.jit(lambda x: entry(x, n=3))(x), x * 3)
    # arrays a caller's program closes over reach the entry point as
    # constants, not tracers
    np.testing.assert_array_equal(jax.jit(lambda: entry(x, n=4))(), x * 4)
