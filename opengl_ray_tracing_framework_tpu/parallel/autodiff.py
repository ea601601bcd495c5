"""Differentiable rendering across the device mesh.

The capability the reference only has interactively — edit a material, see
the re-render (ImGui loop, main.cpp:329-480 + RefreshTriangleMaterial) —
becomes reverse-mode AD: d(pixel loss)/d(material table). Pixels are
sharded like the forward pass; each device backprops its own rows and the
parameter gradients are summed across devices (scene parameters are
replicated, so the reduction is the only collective).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.camera import Camera
from ..utils.config import RenderConfig, jit
from .sharding import _trace_rows


def _grad_config(config: RenderConfig) -> RenderConfig:
    """The config the gradient programs render with: cast-only compaction
    (config.grad_compaction_mode) keeps the bucketed traversal launches
    but runs shading full-width, so the backward sweep never crosses a
    lax.switch boundary. Images and gradients are exact in both modes
    (tests/test_compaction.py)."""
    return config.replace(compaction_mode=config.grad_compaction_mode)


def render_rows_radiance(scene, camera, config, row0, n_rows, spp,
                         rays_per_tile=65536, flat=False):
    """Mean radiance over spp samples for rows [row0, row0+n_rows).

    flat=True: 1-D row-major radiance (see _trace_rows) — the loss path,
    compared with the flattened target."""
    shape = (n_rows * config.width * 3,) if flat \
        else (n_rows, config.width, 3)
    acc = jnp.zeros(shape, jnp.float32)
    for s in range(spp):
        frame = jnp.int32(s + 1)
        sample = _trace_rows(scene, camera, frame, config, row0, n_rows,
                             rays_per_tile, flat=flat)
        acc = acc + (sample - acc) / (s + 1)
    return acc


def material_loss(materials, scene, camera, target_rows, config, row0,
                  n_rows, spp, rays_per_tile):
    scene = scene.with_materials(materials)
    img = render_rows_radiance(scene, camera, config, row0, n_rows, spp,
                               rays_per_tile, flat=True)
    return jnp.sum((img - target_rows.reshape(-1)) ** 2)


# Parameter groups for sharded autodiff: name -> (get, put) where
# get(scene, camera) extracts the differentiable pytree and
# put(scene, camera, params) re-applies it. "geometry" differentiates the
# leaf-ordered triangle vertices through the fused tri_attr table (see
# geometry_grad below for the detached-traversal semantics).
_PARAM_GROUPS = {
    "material": (
        lambda scene, camera: scene.materials,
        lambda scene, camera, p: (scene.with_materials(p), camera),
    ),
    "camera": (
        lambda scene, camera: camera,
        lambda scene, camera, p: (scene, p),
    ),
    "geometry": (
        lambda scene, camera: scene.tri_attr[0:9, :].reshape(3, 3, -1),
        lambda scene, camera, p: (
            scene._replace(
                tri_attr=scene.tri_attr.at[0:9, :].set(p.reshape(9, -1))),
            camera),
    ),
}


def param_grad_sharded(scene, camera: Camera, target, config: RenderConfig,
                       mesh: Mesh, param: str = "material", spp: int = 1,
                       rays_per_tile: int = 65536):
    """(loss, grads) of sum((render - target)^2) w.r.t. a named parameter
    group — "material" (the table), "camera" (the pose pytree) or
    "geometry" (leaf-ordered triangle vertices, (3, 3, N)) — with pixels
    sharded over `mesh` and gradients reduced across it.

    Collective discipline: the shard_map body issues ZERO collectives.
    Differentiating a *replicated* parameter inside shard_map inserts one
    implicit psum per parameter leaf at transpose time; together with an
    explicit loss psum that is ~19 independent all-reduces whose relative
    order the concurrent thunk executor does not pin — observed on the
    XLA:CPU backend as cross-device collective-order mismatches (gloo:
    `op.preamble.length` EnforceNotMet; in-process: permanent rendezvous
    deadlock, 2026-08-21). Instead each device receives its OWN copy of
    the parameters (in_specs P("tiles") over a broadcast leading axis, so
    cotangents stay device-varying and transpose inserts nothing),
    returns [flat grads | loss] as ONE stacked vector, and the cross-
    device sum happens outside the body as a single deterministic
    reduction of the sharded output."""
    from jax import shard_map

    config = _grad_config(config)
    try:
        get, put = _PARAM_GROUPS[param]
    except KeyError:
        raise ValueError(f"unknown param group {param!r}; "
                         f"one of {sorted(_PARAM_GROUPS)}") from None
    n_dev = mesh.devices.size
    if config.height % n_dev:
        raise ValueError("height must divide the mesh size")
    rows_per_dev = config.height // n_dev

    params = jax.tree.map(jnp.asarray, get(scene, camera))
    leaves, treedef = jax.tree.flatten(params)
    is_float = [jnp.issubdtype(l.dtype, jnp.floating) for l in leaves]

    def device_block(scene, camera, target_block, dev_idx, params_local):
        p = jax.tree.map(lambda x: x[0], params_local)
        row0 = dev_idx[0] * rows_per_dev

        def loss_fn(p):
            sc, cam = put(scene, camera, p)
            img = render_rows_radiance(sc, cam, config, row0, rows_per_dev,
                                       spp, rays_per_tile, flat=True)
            return jnp.sum(
                (img - target_block.reshape(-1)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(p)
        gl = jax.tree.leaves(grads)
        flat = jnp.concatenate(
            [jnp.ravel(g) for g, f in zip(gl, is_float) if f]
            + [loss[None]])
        return flat[None]

    dev_ids = jnp.arange(n_dev, dtype=jnp.int32)
    params_stack = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_dev,) + x.shape), params)
    fn = shard_map(
        device_block,
        mesh=mesh,
        in_specs=(P(), P(), P("tiles", None, None), P("tiles"), P("tiles")),
        out_specs=P("tiles"),
        check_vma=False,   # Pallas kernel bodies carry no vma types
    )
    stacked = jit(fn)(
        scene, camera, target, dev_ids, params_stack)
    total = jnp.sum(stacked, axis=0)     # ONE cross-device reduction
    loss = total[-1]

    import numpy as np
    grads_leaves, off = [], 0
    for leaf, f in zip(leaves, is_float):
        if f:
            grads_leaves.append(total[off:off + leaf.size].reshape(leaf.shape))
            off += leaf.size
        else:
            # int/bool leaves: no gradient (same contract as value_and_grad
            # with allow_int — a float0 zero of the leaf's shape)
            grads_leaves.append(np.zeros(leaf.shape, jax.dtypes.float0))
    return loss, jax.tree.unflatten(treedef, grads_leaves)


def material_grad_sharded(scene, camera: Camera, target, config: RenderConfig,
                          mesh: Mesh, spp: int = 1, rays_per_tile: int = 65536):
    """(loss, grads) of sum((render - target)^2) w.r.t. the material table,
    with pixels sharded over `mesh` and gradients psum-reduced."""
    return param_grad_sharded(scene, camera, target, config, mesh,
                              param="material", spp=spp,
                              rays_per_tile=rays_per_tile)


@jit(static_argnames=("config", "spp", "rays_per_tile"))
def material_grad(scene, camera: Camera, target, config: RenderConfig,
                  spp: int = 1, rays_per_tile: int = 65536):
    """Single-device (loss, grads) w.r.t. the material table."""
    config = _grad_config(config)
    loss, grads = jax.value_and_grad(material_loss, allow_int=True)(
        scene.materials, scene, camera, target, config, jnp.int32(0),
        config.height, spp, rays_per_tile)
    return loss, grads


@jit(static_argnames=("config", "spp", "rays_per_tile"))
def camera_grad(scene, camera: Camera, target, config: RenderConfig,
                spp: int = 1, rays_per_tile: int = 65536):
    """Single-device (loss, grads) w.r.t. the camera pose pytree."""
    config = _grad_config(config)

    def loss_fn(cam):
        img = render_rows_radiance(scene, cam, config, jnp.int32(0),
                                   config.height, spp, rays_per_tile,
                                   flat=True)
        return jnp.sum((img - target.reshape(-1)) ** 2)

    return jax.value_and_grad(loss_fn)(camera)


@jit(static_argnames=("config", "spp", "rays_per_tile"))
def geometry_grad(scene, camera: Camera, target, config: RenderConfig,
                  spp: int = 1, rays_per_tile: int = 65536):
    """Single-device (loss, vertex_grads) w.r.t. the triangle vertices.

    Shading recomputes the hit distance and normal from the fused tri_attr
    table (ops.intersect.surface_attributes), so reverse-mode gradients
    w.r.t. vertex positions flow through the hit point, the shading normal
    and every downstream BSDF term. Traversal stays detached — silhouette
    (visibility) gradients are the documented bias of detached sampling
    (SURVEY.md §7).

    Returns (loss, grads) with grads shaped (3, 3, N): d loss / d p_k[axis]
    for vertex k of every leaf-ordered triangle.
    """
    config = _grad_config(config)

    def loss_fn(vertices):
        tri_attr = scene.tri_attr.at[0:9, :].set(
            vertices.reshape(9, -1))
        sc = scene._replace(tri_attr=tri_attr)
        img = render_rows_radiance(sc, camera, config, jnp.int32(0),
                                   config.height, spp, rays_per_tile,
                                   flat=True)
        return jnp.sum((img - target.reshape(-1)) ** 2)

    vertices = scene.tri_attr[0:9, :].reshape(3, 3, -1)
    return jax.value_and_grad(loss_fn)(vertices)
