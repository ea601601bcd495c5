"""BVH closest-hit traversal as one Pallas kernel for NVIDIA GPUs (Triton).

The reference walks its BVH per fragment: a private stack, near child
first, leaves of <= 8 triangles tested one by one (hitBVH + hitArray,
glsl:320-392). This kernel is that walk, one ray per GPU thread:

- one program per block of `block_rays` rays (a power of two, 32 per
  warp); origin, direction and per-ray flags are loaded once;
- the walk runs the "while-while" loop of Aila & Laine (HPG 2009): every
  lane descends internal nodes until it holds a leaf (or has finished),
  then the block tests its leaves, then pops. Each block stops when its
  own rays are done, so a slow ray holds back only its block;
- the traversal stack is per-ray scratch in device memory laid out
  (slot, lane), so lanes at the same depth touch one cache line. Its
  working set is tiny and stays in L1/L2; registers hold only per-ray
  scalars. A push onto a full stack is dropped, so a block never writes
  outside its own slots; models.bvh.build_bvh refuses trees that could
  fill it;
- nodes and triangles are gathered straight from the scene's flat BVH
  (`SceneData.bvh_*`) and leaf-ordered `p1..p3`, so there is no second
  scene layout;
- a per-ray any-hit flag retires a shadow ray at its first hit, so one
  launch carries a bounce's NEE-shadow and bounce rays together.

The arithmetic is `ops.intersect.ray_triangle` / `ray_aabb_visit` written
per lane: the same epsilons (T_MIN, the 1e-5 pull-back, the strict
interior test), no dot products, no reduced precision. Masked lanes
return a miss (t = INF, tri = -1).

`interpret=True` runs the same kernel through the Pallas interpreter on
any backend; only tests ask for it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.bvh import STACK_DEPTH
from .intersect import Hit, INF, PARALLEL_EPS, T_MIN

ACTIVE = 1      # flag bit: trace this lane
ANY_HIT = 2     # flag bit: stop at the first hit (occlusion query)


def _any(x):
    """Block-wide OR as a scalar (Triton reduces ints, not bools)."""
    return jnp.max(x.astype(jnp.int32)) > 0


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _ray_triangle(o, d, q1, q2, q3):
    """Per-lane ops.intersect.ray_triangle -> (hit, t, inside)."""
    ox, oy, oz = o
    dx, dy, dz = d
    e1 = [b - a for a, b in zip(q1, q2)]
    e2 = [b - a for a, b in zip(q1, q3)]
    n = _cross(*e1, *e2)
    ndotd = _dot(*n, dx, dy, dz)
    inside = ndotd > 0.0
    nf = [jnp.where(inside, -c, c) for c in n]
    ndotd_f = _dot(*nf, dx, dy, dz)
    n_len = jnp.sqrt(jnp.maximum(_dot(*n, *n), 1e-30))
    parallel = jnp.abs(ndotd_f) < PARALLEL_EPS * n_len
    t = _dot(*nf, q1[0] - ox, q1[1] - oy, q1[2] - oz) \
        / jnp.where(parallel, 1.0, ndotd_f)
    p = (ox + dx * t, oy + dy * t, oz + dz * t)

    def side(a, b):
        c = _cross(*[y - x for x, y in zip(a, b)],
                   *[y - x for x, y in zip(a, p)])
        return _dot(*c, *nf)

    s1, s2, s3 = side(q1, q2), side(q2, q3), side(q3, q1)
    in_tri = ((s1 > 0) & (s2 > 0) & (s3 > 0)) \
        | ((s1 < 0) & (s2 < 0) & (s3 < 0))
    hit = in_tri & ~parallel & (t >= T_MIN)
    return hit, jnp.where(hit, t - 1e-5, INF), inside


def _slab(o, inv, lo, hi):
    """Per-lane ops.intersect.ray_aabb_visit -> (visit, t_enter)."""
    t0 = t1 = None
    for oc, ic, a, b in zip(o, inv, lo, hi):
        f = (b - oc) * ic
        n = (a - oc) * ic
        near, far = jnp.minimum(f, n), jnp.maximum(f, n)
        t0 = near if t0 is None else jnp.maximum(t0, near)
        t1 = far if t1 is None else jnp.minimum(t1, far)
    return (t1 >= t0) & (t1 > 0.0), jnp.maximum(t0, 0.0)


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, flag_ref,
            left_ref, right_ref, count_ref, first_ref, bmin_ref, bmax_ref,
            p1_ref, p2_ref, p3_ref,
            t_ref, tri_ref, inside_ref, stack_ref,
            *, block, depth, leaf_size, max_steps):
    lane = jnp.arange(block, dtype=jnp.int32)
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    flags = flag_ref[...]
    any_hit = (flags & ANY_HIT) != 0
    inv = tuple(1.0 / jnp.where(jnp.abs(c) < 1e-12,
                                jnp.where(c < 0, -1e-12, 1e-12), c)
                for c in d)

    def gather(ref, idx, mask, col=None, other=0):
        at = ref.at[idx] if col is None else ref.at[idx, col]
        return plgpu.load(at, mask=mask, other=other)

    def push(sp, val, mask):
        ok = mask & (sp < depth)
        plgpu.store(stack_ref.at[sp * block + lane], val, mask=ok)
        return jnp.where(ok, sp + 1, sp)

    def pop(sp, mask):
        ok = mask & (sp > 0)
        top = gather(stack_ref, (sp - 1) * block + lane, ok)
        return top, jnp.where(ok, sp - 1, sp)

    def box(node, mask):
        lo = tuple(gather(bmin_ref, node, mask, c, 0.0) for c in range(3))
        hi = tuple(gather(bmax_ref, node, mask, c, 0.0) for c in range(3))
        return _slab(o, inv, lo, hi)

    # root is node 1 (Scene.h:189-196); node 0 means "no node": done
    node = jnp.where((flags & ACTIVE) != 0, 1, 0).astype(jnp.int32)
    cnt = gather(count_ref, node, node > 0)
    sp = jnp.zeros((block,), jnp.int32)
    best_t = jnp.full((block,), INF, jnp.float32)
    best_tri = jnp.full((block,), -1, jnp.int32)
    best_in = jnp.zeros((block,), jnp.int32)

    def descend(carry):
        node, cnt, sp, best_t, steps = carry
        inner = (node > 0) & (cnt == 0)
        left = gather(left_ref, node, inner)
        right = gather(right_ref, node, inner)
        v1, d1 = box(left, inner)
        v2, d2 = box(right, inner)
        # a child whose entry distance is beyond the best hit cannot win
        hit1 = inner & (left > 0) & v1 & (d1 < best_t)
        hit2 = inner & (right > 0) & v2 & (d2 < best_t)
        both = hit1 & hit2
        near_left = d1 < d2
        near = jnp.where(near_left, left, right)
        far = jnp.where(near_left, right, left)
        sp = push(sp, far, both)
        top, sp = pop(sp, inner & ~hit1 & ~hit2)
        nxt = jnp.where(both, near,
                        jnp.where(hit1, left, jnp.where(hit2, right, top)))
        node = jnp.where(inner, nxt, node)
        cnt = jnp.where(inner, gather(count_ref, node, inner & (node > 0)),
                        cnt)
        return node, cnt, sp, best_t, steps + 1

    def descend_more(carry):
        node, cnt, _, _, steps = carry
        return _any((node > 0) & (cnt == 0)) & (steps < max_steps)

    def leaf_tests(node, cnt, best):
        leaf = node > 0
        first = gather(first_ref, node, leaf)
        n_max = jnp.max(jnp.where(leaf, cnt, 0))

        def one(k, best):
            best_t, best_tri, best_in = best
            valid = leaf & (k < cnt)
            tri = first + k
            q = [tuple(gather(ref, tri, valid, c, 0.0) for c in range(3))
                 for ref in (p1_ref, p2_ref, p3_ref)]
            hit, t, inside = _ray_triangle(o, d, *q)
            closer = valid & hit & (t < best_t)
            return (jnp.where(closer, t, best_t),
                    jnp.where(closer, tri, best_tri),
                    jnp.where(closer, inside.astype(jnp.int32), best_in))

        return jax.lax.fori_loop(0, jnp.minimum(n_max, leaf_size), one, best)

    def walk(carry):
        node, cnt, sp, best_t, best_tri, best_in, steps = carry
        node, cnt, sp, best_t, steps = jax.lax.while_loop(
            descend_more, descend, (node, cnt, sp, best_t, steps))
        best_t, best_tri, best_in = leaf_tests(node, cnt,
                                               (best_t, best_tri, best_in))
        leaf = node > 0
        # an occlusion query retires at its first hit; others pop on
        top, sp = pop(sp, leaf & ~(any_hit & (best_tri >= 0)))
        node = jnp.where(leaf, top, node)
        cnt = jnp.where(leaf, gather(count_ref, node, leaf & (node > 0)),
                        cnt)
        return node, cnt, sp, best_t, best_tri, best_in, steps + 1

    def walking(carry):
        return _any(carry[0] > 0) & (carry[-1] < max_steps)

    _, _, _, best_t, best_tri, best_in, _ = jax.lax.while_loop(
        walking, walk, (node, cnt, sp, best_t, best_tri, best_in,
                        jnp.int32(0)))
    t_ref[...] = best_t
    tri_ref[...] = best_tri
    inside_ref[...] = best_in


@functools.partial(jax.jit, static_argnames=(
    "stack_depth", "leaf_size", "block_rays", "interpret"))
def closest_hit_kernel(scene, origin, direction, mask=None, any_hit=None, *,
                       stack_depth: int = STACK_DEPTH, leaf_size: int = 8,
                       block_rays: int = 32, interpret: bool = False) -> Hit:
    """Closest hit of each ray against the scene BVH on the GPU.

    origin/direction: (R, 3) float32. mask: optional (R,) bool, False
    lanes return a miss. any_hit: optional (R,) bool, True lanes stop at
    their first hit (then only is_hit is meaningful). Returns Hit with
    batch shape (R,), matching ops.traverse.bvh_closest_hit."""
    if block_rays & (block_rays - 1) or block_rays < 16:
        raise ValueError(f"block_rays must be a power of two >= 16, "
                         f"got {block_rays}")
    depth = 1 << max(stack_depth - 1, 1).bit_length()  # power of two
    r = origin.shape[0]
    n_blocks = -(-r // block_rays)
    pad = n_blocks * block_rays - r

    flags = jnp.ones((r,), jnp.int32) if mask is None \
        else mask.astype(jnp.int32)
    if any_hit is not None:
        flags = flags | (any_hit.astype(jnp.int32) * ANY_HIT)
    cols = [origin[:, c] for c in range(3)] \
        + [direction[:, c] for c in range(3)] + [flags]
    cols = [jnp.pad(x, (0, pad)) for x in cols]   # padding lanes: flags 0

    rays = pl.BlockSpec((block_rays,), lambda i: (i,))
    whole = pl.no_block_spec
    n = n_blocks * block_rays
    out = lambda size, dtype: jax.ShapeDtypeStruct((size,), dtype)
    t, tri, inside, _ = pl.pallas_call(
        functools.partial(_kernel, block=block_rays, depth=depth,
                          leaf_size=leaf_size,
                          max_steps=4 * scene.n_nodes + 64),
        out_shape=(out(n, jnp.float32), out(n, jnp.int32),
                   out(n, jnp.int32), out(n * depth, jnp.int32)),
        grid=(n_blocks,),
        in_specs=[rays] * 7 + [whole] * 9,
        out_specs=(rays, rays, rays,
                   pl.BlockSpec((block_rays * depth,), lambda i: (i,))),
        compiler_params=plgpu.CompilerParams(
            num_warps=max(block_rays // 32, 1), num_stages=1),
        interpret=interpret,
        name="bvh_kernel",
    )(*cols, scene.bvh_left, scene.bvh_right, scene.bvh_count,
      scene.bvh_first, scene.bvh_min, scene.bvh_max,
      scene.p1, scene.p2, scene.p3)
    return Hit(t=t[:r], tri=tri[:r], inside=inside[:r] != 0)
