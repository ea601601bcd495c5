"""Intersection + BVH construction/traversal tests.

The load-bearing test: vectorized stack traversal (ops.traverse) returns
bit-identical winners to the brute-force oracle (ops.intersect) on random
ray batches over random triangle soups — the analogue of validating hitBVH
against hitArray (glsl:320-392)."""

import numpy as np
import jax.numpy as jnp
import pytest

from opengl_ray_tracing_framework_tpu.models.bvh import build_bvh, validate_bvh
from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
from opengl_ray_tracing_framework_tpu.ops.intersect import (
    closest_hit_brute,
    ray_aabb,
    ray_triangle,
)
from opengl_ray_tracing_framework_tpu.ops.traverse import bvh_closest_hit


def _f(x):
    return jnp.asarray(x, jnp.float32)


def test_ray_triangle_basic():
    # wound so the geometric normal cross(p2-p1, p3-p1) faces -z
    p1 = _f([[0.0, 0.0, 5.0]])
    p2 = _f([[0.0, 2.0, 5.0]])
    p3 = _f([[2.0, 0.0, 5.0]])
    o = _f([[0.5, 0.5, 0.0]])
    d = _f([[0.0, 0.0, 1.0]])
    hit, t, inside = ray_triangle(o, d, p1, p2, p3)
    assert bool(hit[0])
    assert np.isclose(float(t[0]), 5.0, atol=1e-4)
    assert not bool(inside[0])
    # from behind (along the normal) -> inside flag set (glsl:256-259)
    o2 = _f([[0.5, 0.5, 10.0]])
    d2 = _f([[0.0, 0.0, -1.0]])
    hit, t, inside = ray_triangle(o2, d2, p1, p2, p3)
    assert bool(hit[0]) and bool(inside[0])
    # outside the triangle
    o3 = _f([[1.9, 1.9, 0.0]])
    hit, _, _ = ray_triangle(o3, d, p1, p2, p3)
    assert not bool(hit[0])
    # behind the origin
    hit, _, _ = ray_triangle(o, -d, p1, p2, p3)
    assert not bool(hit[0])


def test_ray_aabb_conventions():
    o = _f([[0.0, 0.0, 0.0]])
    inv = 1.0 / _f([[1.0, 1.0, 1.0]])
    aa = _f([[1.0, 1.0, 1.0]])
    bb = _f([[2.0, 2.0, 2.0]])
    t = ray_aabb(o, inv, aa, bb)
    assert np.isclose(float(t[0]), 1.0, atol=1e-6)     # entry distance
    # origin inside -> exit distance
    t = ray_aabb(_f([[1.5, 1.5, 1.5]]), inv, aa, bb)
    assert np.isclose(float(t[0]), 0.5, atol=1e-6)
    # miss -> -1
    t = ray_aabb(o, 1.0 / _f([[1.0, -1.0, 1.0]]), aa, bb)
    assert float(t[0]) == -1.0


def _random_soup(rng, n):
    base = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, size=(n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, size=(n, 3)).astype(np.float32)
    return base, base + e1, base + e2


def test_bvh_invariants(rng):
    p1, p2, p3 = _random_soup(rng, 300)
    for method in ("sah", "median"):
        bvh = build_bvh(p1, p2, p3, leaf_size=8, method=method)
        validate_bvh(bvh, 300)
        # leaves cover contiguous permuted ranges starting at 0
        leaf = bvh.count > 0
        firsts = np.sort(bvh.first[leaf])
        counts = bvh.count[leaf][np.argsort(bvh.first[leaf])]
        assert firsts[0] == 0
        assert (firsts[1:] == (firsts + counts)[:-1]).all()


def test_bvh_depth_is_bounded(rng):
    """build_bvh refuses a tree deeper than the traversal stacks hold."""
    p1, p2, p3 = _random_soup(rng, 300)
    build_bvh(p1, p2, p3, leaf_size=1)
    with pytest.raises(ValueError, match="deeper than 3 levels"):
        build_bvh(p1, p2, p3, leaf_size=1, max_depth=3)


class _MiniScene:
    """Duck-typed scene carrying only geometry + BVH for traversal tests."""

    def __init__(self, p1, p2, p3, bvh):
        perm = bvh.perm
        self.p1 = jnp.asarray(p1[perm])
        self.p2 = jnp.asarray(p2[perm])
        self.p3 = jnp.asarray(p3[perm])
        self.bvh_left = jnp.asarray(bvh.left)
        self.bvh_right = jnp.asarray(bvh.right)
        self.bvh_count = jnp.asarray(bvh.count)
        self.bvh_first = jnp.asarray(bvh.first)
        self.bvh_min = jnp.asarray(bvh.aabb_min)
        self.bvh_max = jnp.asarray(bvh.aabb_max)
        self.n_triangles = int(self.p1.shape[0])


def test_traversal_matches_brute_force():
    rng = np.random.default_rng(42)
    p1, p2, p3 = _random_soup(rng, 257)
    bvh = build_bvh(p1, p2, p3, leaf_size=8)
    ms = _MiniScene(p1, p2, p3, bvh)

    n_rays = 512
    # half the origins far outside the soup, half *inside* it (origin-inside-
    # AABB exercises the exit-distance convention of the slab test)
    origin = rng.uniform(-4, 4, size=(n_rays, 3)).astype(np.float32)
    origin[: n_rays // 2] = rng.uniform(
        -1, 1, size=(n_rays // 2, 3)).astype(np.float32)
    direction = rng.normal(size=(n_rays, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)

    o = jnp.asarray(origin)
    d = jnp.asarray(direction)
    brute = closest_hit_brute(o, d, ms.p1, ms.p2, ms.p3, chunk=64)
    trav = bvh_closest_hit(ms, o, d, stack_depth=64)

    hb = np.asarray(brute.tri >= 0)
    ht = np.asarray(trav.tri >= 0)
    assert np.array_equal(hb, ht), "hit masks differ"
    assert (hb.sum() > 30), "degenerate test: almost no hits"
    np.testing.assert_allclose(np.asarray(trav.t)[hb],
                               np.asarray(brute.t)[hb], rtol=1e-5)
    # winners must agree except where two triangles tie within epsilon
    tie = np.isclose(np.asarray(trav.t), np.asarray(brute.t), atol=2e-4)
    same = np.asarray(trav.tri == brute.tri)
    assert (same | ~hb | tie).all()


def test_traversal_on_built_scene(test_scene, rng):
    n_rays = 256
    origin = np.tile(np.array([0.0, 0.5, -2.0], np.float32), (n_rays, 1))
    direction = rng.normal(size=(n_rays, 3)).astype(np.float32)
    direction[:, 2] = np.abs(direction[:, 2]) + 0.5
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    o = jnp.asarray(origin)
    d = jnp.asarray(direction)
    brute = closest_hit_brute(o, d, test_scene.p1, test_scene.p2,
                              test_scene.p3, chunk=32)
    trav = bvh_closest_hit(test_scene, o, d)
    assert np.array_equal(np.asarray(brute.tri >= 0),
                          np.asarray(trav.tri >= 0))
    hb = np.asarray(brute.tri >= 0)
    np.testing.assert_allclose(np.asarray(trav.t)[hb],
                               np.asarray(brute.t)[hb], rtol=1e-5)
