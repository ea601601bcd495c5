"""BVH traversal: the tracer dispatch and the XLA wavefront reference.

The reference traverses its BVH per fragment with an explicit 256-entry
stack and near-child-first ordering (hitBVH, glsl:338-392), visiting leaves
of <= 8 triangles with a brute-force loop (hitArray, glsl:320-334).

`closest_hit` / `closest_hit_pair` dispatch on RenderConfig.tracer: the
Pallas BVH kernel (ops/bvh_kernel.py, one ray per GPU thread) or
`bvh_closest_hit`, the plain-XLA reference it is checked against.

`bvh_closest_hit` runs one traversal step for a whole *batch* of rays per
`lax.while_loop` iteration. Every ray keeps a small per-ray stack as a row
of an (R, D) int32 array; pushes/pops are one-hot masked writes, node and
triangle fetches are batched gathers, and leaf handling intersects the whole
leaf (up to leaf_size triangles) against each ray in one vectorized
ray_triangle call. Rays that finish idle until the whole wavefront drains.
Near-child-first ordering and the early-out `t_enter > best_t` cut keep
visited-node counts close to the scalar reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.bvh import STACK_DEPTH
from .intersect import Hit, INF, ray_aabb_visit, ray_triangle


def bvh_closest_hit(scene, origin, direction,
                    stack_depth: int = STACK_DEPTH,
                    leaf_size: int = 8) -> Hit:
    """Closest hit of each ray against the scene BVH.

    origin/direction: (R, 3) float32. Returns Hit with batch shape (R,).
    Semantics match hitBVH + hitArray (glsl:320-392): ordered descent into
    the nearer child, child visited iff its slab distance > 0.
    """
    r = origin.shape[0]
    inv_dir = 1.0 / jnp.where(jnp.abs(direction) < 1e-12,
                              jnp.where(direction < 0, -1e-12, 1e-12),
                              direction)

    left = scene.bvh_left
    right = scene.bvh_right
    count = scene.bvh_count
    first = scene.bvh_first
    bmin = scene.bvh_min
    bmax = scene.bvh_max
    n_nodes = left.shape[0]

    # Derive initial carries from the ray inputs so their sharding/varying
    # type matches the loop outputs under shard_map (jax >= 0.8 vma typing).
    # Both origin and direction contribute: either may carry the varying axis.
    zero_i = (jnp.zeros_like(origin[:, 0])
              + jnp.zeros_like(direction[:, 0])).astype(jnp.int32)   # (r,)
    stack = jnp.zeros((r, stack_depth), jnp.int32) + zero_i[:, None]
    stack = stack.at[:, 0].set(1)  # root is node 1 (Scene.h:189-196)
    sp = zero_i + 1

    best = Hit(
        t=zero_i.astype(jnp.float32) + INF,
        tri=zero_i - 1,
        inside=zero_i != 0,
    )

    cols = jnp.arange(stack_depth, dtype=jnp.int32)[None, :]
    lane = jnp.arange(leaf_size, dtype=jnp.int32)[None, :]

    # Safety bound: a correct traversal visits each node at most once.
    max_steps = 4 * n_nodes + 64

    def cond(state):
        sp, _, _, steps = state
        return jnp.logical_and(jnp.any(sp > 0), steps < max_steps)

    def body(state):
        sp, stack, best, steps = state
        active = sp > 0
        top_col = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, top_col[:, None], axis=1)[:, 0]
        node = jnp.where(active, node, 0)

        n_count = count[node]
        n_first = first[node]
        n_left = left[node]
        n_right = right[node]

        is_leaf = active & (n_count > 0)
        is_internal = active & (n_count <= 0)

        # ---- leaf: intersect up to leaf_size triangles ------------------
        tri_ids = n_first[:, None] + lane                       # (R, K)
        tri_valid = is_leaf[:, None] & (lane < n_count[:, None])
        safe_ids = jnp.clip(tri_ids, 0, scene.n_triangles - 1)
        q1 = scene.p1[safe_ids]
        q2 = scene.p2[safe_ids]
        q3 = scene.p3[safe_ids]
        hit_mask, t, inside = ray_triangle(
            origin[:, None, :], direction[:, None, :], q1, q2, q3)
        t = jnp.where(hit_mask & tri_valid, t, INF)
        k = jnp.argmin(t, axis=-1)
        t_leaf = jnp.take_along_axis(t, k[:, None], axis=1)[:, 0]
        tri_leaf = jnp.take_along_axis(safe_ids, k[:, None], axis=1)[:, 0]
        inside_leaf = jnp.take_along_axis(inside, k[:, None], axis=1)[:, 0]
        closer = is_leaf & (t_leaf < best.t)
        best = Hit(
            t=jnp.where(closer, t_leaf, best.t),
            tri=jnp.where(closer, tri_leaf, best.tri),
            inside=jnp.where(closer, inside_leaf, best.inside),
        )

        # ---- internal: slab-test both children, push near-first ---------
        lmin = bmin[n_left]
        lmax = bmax[n_left]
        rmin = bmin[n_right]
        rmax = bmax[n_right]
        v1, d1 = ray_aabb_visit(origin, inv_dir, lmin, lmax)
        v2, d2 = ray_aabb_visit(origin, inv_dir, rmin, rmax)
        # Early-out: a box whose (conservative) entry distance is beyond the
        # current best hit cannot improve it.
        hit1 = is_internal & (n_left > 0) & v1 & (d1 < best.t)
        hit2 = is_internal & (n_right > 0) & v2 & (d2 < best.t)
        both = hit1 & hit2
        near_is_left = d1 < d2
        # push far child first so the near child pops first
        far_node = jnp.where(near_is_left, n_right, n_left)
        near_node = jnp.where(near_is_left, n_left, n_right)
        only = jnp.where(hit1, n_left, n_right)

        # pop the current node
        sp_after_pop = jnp.where(active, sp - 1, sp)

        push1 = both | (hit1 ^ hit2)            # at least one push
        push2 = both                             # second push
        val1 = jnp.where(both, far_node, only)
        val2 = near_node

        w1 = push1[:, None] & (cols == sp_after_pop[:, None])
        stack = jnp.where(w1, val1[:, None], stack)
        sp1 = sp_after_pop + push1.astype(jnp.int32)
        w2 = push2[:, None] & (cols == sp1[:, None])
        stack = jnp.where(w2, val2[:, None], stack)
        sp2 = sp1 + push2.astype(jnp.int32)

        return sp2, stack, best, steps + 1

    _, _, best, _ = jax.lax.while_loop(
        cond, body, (sp, stack, best, jnp.int32(0)))
    return best


def _tracer(config):
    """Resolve config to (cast, merges): cast(scene, origin, direction,
    mask, any_hit) -> Hit, and whether it takes per-ray any-hit flags, so
    that one launch can carry a shadow batch and a bounce batch."""
    if not config.use_bvh:
        from .intersect import closest_hit_brute
        return _masked(lambda scene, o, d: closest_hit_brute(
            o, d, scene.p1, scene.p2, scene.p3)), False
    if config.tracer == "whileloop":
        return _masked(lambda scene, o, d: bvh_closest_hit(
            scene, o, d, leaf_size=config.bvh_leaf_size)), False
    from . import bvh_kernel
    return (lambda scene, o, d, mask, any_hit: bvh_kernel.closest_hit_kernel(
        scene, o, d, mask, any_hit, leaf_size=config.bvh_leaf_size)), True


def _masked(cast):
    """Give a cast(scene, origin, direction) the tracer signature: masked
    lanes return a miss; any_hit is ignored (a closest hit answers an
    occlusion query too)."""
    def masked(scene, origin, direction, mask, any_hit):
        hit = cast(scene, origin, direction)
        if mask is None:
            return hit
        return Hit(t=jnp.where(mask, hit.t, INF),
                   tri=jnp.where(mask, hit.tri, -1),
                   inside=mask & hit.inside)
    return masked


def _detached(hit: Hit) -> Hit:
    return Hit(t=jax.lax.stop_gradient(hit.t), tri=hit.tri,
               inside=hit.inside)


def closest_hit(scene, origin, direction, config, mask=None,
                any_hit: bool = False) -> Hit:
    """Closest hit through the configured tracer (RenderConfig.tracer;
    use_bvh=False is the brute-force reference).

    mask: optional (R,) bool — False lanes return a miss (the kernel does
    not trace them at all).
    any_hit: occlusion-query semantics; the kernel stops each ray at its
    first hit (is_hit is then the only meaningful field).

    Traversal is *detached* from autodiff: the discrete winner (tri, inside)
    has no useful derivative and lax.while_loop cannot be transposed, so
    inputs and the returned t are wrapped in stop_gradient. Shading
    recomputes the hit distance differentiably from the winning triangle
    (intersect.surface_attributes), which restores exact gradients for the
    continuous quantities — the "differentiate the integrand" scheme
    (detached sampling; discontinuity gradients at silhouettes are the
    documented bias, SURVEY.md §7)."""
    sg = jax.lax.stop_gradient
    cast, _ = _tracer(config)
    flag = jnp.ones(origin.shape[:1], bool) if any_hit else None
    return _detached(cast(scene, sg(origin), sg(direction), mask, flag))


def closest_hit_pair(scene, o_any, d_any, m_any, o_cls, d_cls, m_cls,
                     config):
    """The integrator's per-bounce cast pair — NEE shadow (any-hit) +
    bounce (closest). The kernel traces both batches in ONE launch, with
    a per-ray any-hit flag on the shadow half; the reference tracers run
    two casts. Results are identical either way (exact per-ray
    semantics); detached like closest_hit."""
    cast, merges = _tracer(config)
    if not merges:
        return (closest_hit(scene, o_any, d_any, config, mask=m_any,
                            any_hit=True),
                closest_hit(scene, o_cls, d_cls, config, mask=m_cls))
    sg = jax.lax.stop_gradient
    r = o_any.shape[0]
    cat = lambda a, b: jnp.concatenate([a, b])
    flag = cat(jnp.ones_like(m_any), jnp.zeros_like(m_cls))
    hit = cast(scene, sg(cat(o_any, o_cls)), sg(cat(d_any, d_cls)),
               cat(m_any, m_cls), flag)
    return (_detached(Hit(*(x[:r] for x in hit))),
            _detached(Hit(*(x[r:] for x in hit))))
