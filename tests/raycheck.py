"""Ray batches and the brute-force oracle check shared by the tracer tests."""

import numpy as np
import jax.numpy as jnp

from opengl_ray_tracing_framework_tpu.ops.intersect import closest_hit_brute
from opengl_ray_tracing_framework_tpu.utils.parity import (
    hit_parity,
    hit_parity_ok,
)


def random_rays(rng, n, spread=3.0):
    origin = np.asarray(rng.normal(0, spread, (n, 3)), np.float32)
    origin[:, 2] -= 1.0
    d = np.asarray(rng.normal(0, 1, (n, 3)), np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(origin), jnp.asarray(d)


def assert_matches_oracle(scene, hit, o, d):
    """Every hit must match closest_hit_brute (same epsilons) to the
    hit-level contract of utils.parity."""
    oracle = closest_hit_brute(o, d, scene.p1, scene.p2, scene.p3)
    m = hit_parity(hit, oracle)
    assert hit_parity_ok(m), m
