"""Ray-primitive intersection.

Vectorized jnp reimplementations of the reference's intersection routines
(src/shaders/fragment_shader_ray_tracing.glsl):

- ray/triangle plane + inside test via cross products   (hitTriangle, glsl:241-299)
- ray/AABB slab test                                    (hitAABB,     glsl:303-316)
- brute-force closest hit over the whole soup           (hitArray,    glsl:320-334)

Design difference vs. the reference: the SIMT megakernel returns a full
HitRecord (point, normal, material) per ray; here traversal returns only
(t, triangle index, inside flag) and shading attributes are *recomputed
differentiably* from the winning triangle id. That separation of discrete
(which triangle) from continuous (where/how lit) is what makes reverse-mode
pixel gradients well-defined.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

INF = 114514.0          # the reference's sentinel "infinite" distance (glsl:10)
T_MIN = 0.0005          # minimum hit distance (glsl:268)
PARALLEL_EPS = 1e-5     # ray-parallel-to-plane epsilon (glsl:262)


class Hit(NamedTuple):
    """Per-ray closest-hit record (all arrays share the ray batch shape)."""

    t: jax.Array          # distance to hit (INF when miss)
    tri: jax.Array        # int32 winning triangle index (-1 when miss)
    inside: jax.Array     # bool, ray hit the backface (glsl:256-259)

    @property
    def is_hit(self):
        return self.tri >= 0


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def ray_triangle(origin, direction, p1, p2, p3):
    """Intersect rays with triangles, broadcasting over leading dims.

    origin/direction: (..., 3); p1/p2/p3: (..., 3) broadcast-compatible.
    Returns (hit_mask, t, inside):
      hit_mask — valid intersection with t >= T_MIN inside the triangle,
      t        — plane distance minus the reference's 1e-5 pullback
                 (glsl:284), INF where miss,
      inside   — geometric normal faced away from the ray (glsl:256-259).
    """
    e1 = p2 - p1
    e2 = p3 - p1
    n = jnp.cross(e1, e2)  # unnormalized geometric normal direction

    ndotd = _dot(n, direction)
    inside = ndotd > 0.0
    # Flip so n opposes the ray, as the reference does before testing.
    n_f = jnp.where(inside[..., None], -n, n)
    ndotd_f = _dot(n_f, direction)

    # Normalized-direction parallel test to match glsl:262's threshold scale.
    n_len = jnp.sqrt(jnp.maximum(_dot(n, n), 1e-30))
    parallel = jnp.abs(ndotd_f) < PARALLEL_EPS * n_len

    t = _dot(n_f, p1 - origin) / jnp.where(parallel, 1.0, ndotd_f)

    p = origin + direction * t[..., None]
    c1 = jnp.cross(p2 - p1, p - p1)
    c2 = jnp.cross(p3 - p2, p - p2)
    c3 = jnp.cross(p1 - p3, p - p3)
    d1 = _dot(c1, n_f)
    d2 = _dot(c2, n_f)
    d3 = _dot(c3, n_f)
    in_tri = ((d1 > 0) & (d2 > 0) & (d3 > 0)) | ((d1 < 0) & (d2 < 0) & (d3 < 0))

    hit = in_tri & ~parallel & (t >= T_MIN)
    t_out = jnp.where(hit, t - 1e-5, INF)
    return hit, t_out, inside


def ray_aabb(origin, inv_direction, aa, bb):
    """Slab test (glsl:303-316).

    Returns entry distance t0 when the box is ahead, exit distance t1 when
    the origin is inside, and -1 on miss — exactly the reference's
    convention, which traversal interprets as "visit if > 0".
    """
    f = (bb - origin) * inv_direction
    n = (aa - origin) * inv_direction
    t1 = jnp.min(jnp.maximum(f, n), axis=-1)   # nearest exit
    t0 = jnp.max(jnp.minimum(f, n), axis=-1)   # farthest entry
    return jnp.where(t1 >= t0, jnp.where(t0 > 0.0, t0, t1), -1.0)


def ray_aabb_visit(origin, inv_direction, aa, bb):
    """(visit, t_enter) for traversal: visit iff the slab interval overlaps
    [0, inf) — same boxes the reference's "d > 0" rule visits — and
    t_enter = max(t0, 0), a *conservative* entry distance that is valid for
    the `t_enter > best_t` pruning cut even when the origin is inside the
    box (where ray_aabb would return the exit distance)."""
    f = (bb - origin) * inv_direction
    n = (aa - origin) * inv_direction
    t1 = jnp.min(jnp.maximum(f, n), axis=-1)
    t0 = jnp.max(jnp.minimum(f, n), axis=-1)
    visit = (t1 >= t0) & (t1 > 0.0)
    return visit, jnp.maximum(t0, 0.0)


def closest_hit_brute(origin, direction, p1s, p2s, p3s, chunk=1024):
    """Oracle path: closest hit over every triangle (hitArray over [0, N)).

    origin/direction: (R, 3). p1s/p2s/p3s: (N, 3). Scans triangle chunks so
    peak memory is O(R * chunk). Returns Hit with batch shape (R,).
    """
    n_tri = p1s.shape[0]
    pad = (-n_tri) % chunk
    if pad:
        padv = jnp.zeros((pad, 3), p1s.dtype)
        p1s = jnp.concatenate([p1s, padv])
        p2s = jnp.concatenate([p2s, padv])
        p3s = jnp.concatenate([p3s, padv])
    n_chunks = p1s.shape[0] // chunk
    p1c = p1s.reshape(n_chunks, chunk, 3)
    p2c = p2s.reshape(n_chunks, chunk, 3)
    p3c = p3s.reshape(n_chunks, chunk, 3)

    r = origin.shape[0]
    init = Hit(
        t=jnp.full((r,), INF, jnp.float32),
        tri=jnp.full((r,), -1, jnp.int32),
        inside=jnp.zeros((r,), bool),
    )
    o = origin[:, None, :]
    d = direction[:, None, :]

    def body(best, chunk_data):
        ci, (q1, q2, q3) = chunk_data
        hit, t, inside = ray_triangle(o, d, q1[None], q2[None], q3[None])
        # mask padded triangles
        tri_ids = ci * chunk + jnp.arange(chunk, dtype=jnp.int32)
        valid = tri_ids < n_tri
        t = jnp.where(hit & valid[None, :], t, INF)
        k = jnp.argmin(t, axis=-1)
        t_best = jnp.take_along_axis(t, k[:, None], axis=-1)[:, 0]
        inside_best = jnp.take_along_axis(inside, k[:, None], axis=-1)[:, 0]
        closer = t_best < best.t
        new = Hit(
            t=jnp.where(closer, t_best, best.t),
            tri=jnp.where(closer, tri_ids[k], best.tri),
            inside=jnp.where(closer, inside_best, best.inside),
        )
        return new, None

    chunk_ids = jnp.arange(n_chunks, dtype=jnp.int32)
    best, _ = jax.lax.scan(body, init, (chunk_ids, (p1c, p2c, p3c)))
    return best


def shading_normal(p, p1, p2, p3, n1, n2, n3, inside):
    """Interpolated shading normal at point p on the winning triangle.

    The reference interpolates with xy-projected barycentrics
    (glsl:289-295), which degenerate for triangles parallel to the z axis;
    we use proper areal (3D) barycentrics — same intent, robust everywhere.
    Flips by `inside` like glsl:295.
    """
    n_geo = jnp.cross(p2 - p1, p3 - p1)
    denom = jnp.maximum(_dot(n_geo, n_geo), 1e-30)
    w1 = _dot(jnp.cross(p3 - p2, p - p2), n_geo) / denom
    w2 = _dot(jnp.cross(p1 - p3, p - p3), n_geo) / denom
    w3 = 1.0 - w1 - w2
    ns = w1[..., None] * n1 + w2[..., None] * n2 + w3[..., None] * n3
    ns = ns / jnp.sqrt(jnp.maximum(_dot(ns, ns), 1e-30))[..., None]
    return jnp.where(inside[..., None], -ns, ns)


def surface_attributes(scene, state):
    """Differentiable hit attributes from a (origin, direction, t, tri,
    inside) record: hit point, shading normal, view vector V = -d, and the
    gathered material.

    The discrete winner `tri` comes from (detached) traversal; the hit
    distance is *recomputed* here from the winning triangle's plane so that
    gradients w.r.t. ray origin/direction and vertices flow — the traversal
    t is only a reference value (they agree to the 1e-5 pullback).

    Triangle data comes from the fused (20, N) SceneData.tri_attr table in
    ONE column gather; vertex gradients therefore accumulate on
    tri_attr."""
    safe = jnp.clip(state.tri, 0, scene.n_triangles - 1)
    g = scene.tri_attr[:, safe]                     # (20, R)
    ax = lambda rows: jnp.moveaxis(rows, 0, -1)
    p1, p2, p3 = ax(g[0:3]), ax(g[3:6]), ax(g[6:9])
    n1, n2, n3 = ax(g[9:12]), ax(g[12:15]), ax(g[15:18])
    n_geo = jnp.cross(p2 - p1, p3 - p1)
    denom = _dot(n_geo, state.direction)
    denom = jnp.where(jnp.abs(denom) < 1e-12,
                      jnp.where(denom < 0, -1e-12, 1e-12), denom)
    t_diff = _dot(n_geo, p1 - state.origin) / denom - 1e-5
    # straight-through: forward value = traversal t, derivative = plane t
    t = state.t + (t_diff - jax.lax.stop_gradient(t_diff))
    hit_point = state.origin + state.direction * t[..., None]
    n = shading_normal(hit_point, p1, p2, p3, n1, n2, n3, state.inside)
    v = -state.direction
    mat = scene.materials.gather(g[18].astype(jnp.int32))
    return hit_point, n, v, mat
