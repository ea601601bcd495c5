"""BVH traversal kernel (ops/bvh_kernel.py) and the tracer dispatch.

Every tracer must match the brute-force oracle (same epsilons) on
randomized ray batches: the kernel, run here by the Pallas interpreter
(the `interpret_kernel` fixture of conftest.py), and the XLA while-loop
reference it is checked against. tests/test_gpu.py repeats the parity
with the compiled kernel on the card.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest

from opengl_ray_tracing_framework_tpu.models.bvh import STACK_DEPTH
from opengl_ray_tracing_framework_tpu.models.camera import Camera
from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
from opengl_ray_tracing_framework_tpu.ops import bvh_kernel, traverse
from opengl_ray_tracing_framework_tpu.ops.bvh_kernel import closest_hit_kernel
from opengl_ray_tracing_framework_tpu.ops.intersect import (
    INF,
    closest_hit_brute,
)
from opengl_ray_tracing_framework_tpu.ops.traverse import (
    closest_hit,
    closest_hit_pair,
)
from opengl_ray_tracing_framework_tpu.render import render_radiance
from opengl_ray_tracing_framework_tpu.utils import config as config_mod
from opengl_ray_tracing_framework_tpu.utils.config import RenderConfig

from raycheck import assert_matches_oracle, random_rays

TRACERS = ["kernel", "whileloop"]


@pytest.fixture(scope="module")
def scene():
    _, data = build_test_scene(n_sphere_subdiv=2)
    return data


@pytest.fixture(scope="module")
def many_leaf_scene():
    """Two-triangle leaves: a deep tree with many leaves, the regime that
    exercises the traversal stack."""
    scene, _ = build_test_scene(n_sphere_subdiv=3)
    data = scene.build(leaf_size=2)
    assert data.n_nodes > 1000, data.n_nodes
    return data


def _inside_rays(rng, n):
    """Rays starting inside the sphere at z=3 (refraction paths)."""
    origin = np.asarray(rng.normal(0, 0.4, (n, 3)), np.float32)
    origin[:, 2] += 3.0
    d = np.asarray(rng.normal(0, 1, (n, 3)), np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(origin), jnp.asarray(d)


@pytest.mark.parametrize("tracer", TRACERS)
@pytest.mark.parametrize("case", ["random", "many_leaf", "inside",
                                  "any_hit", "mask"])
def test_tracer_matches_oracle(scene, many_leaf_scene, case, tracer,
                               request):
    if tracer == "kernel":
        request.getfixturevalue("interpret_kernel")
    cfg = RenderConfig(tracer=tracer)
    rng = np.random.default_rng(11)
    if case == "random":
        # 2000 rays: not a multiple of the kernel block, so padding runs
        o, d = random_rays(rng, 2000)
        assert_matches_oracle(scene, closest_hit(scene, o, d, cfg), o, d)
    elif case == "many_leaf":
        o, d = random_rays(rng, 2048)
        hit = closest_hit(many_leaf_scene, o, d, cfg)
        assert_matches_oracle(many_leaf_scene, hit, o, d)
    elif case == "inside":
        o, d = _inside_rays(rng, 512)
        assert_matches_oracle(scene, closest_hit(scene, o, d, cfg), o, d)
    elif case == "any_hit":
        # an occlusion query's only contract is is_hit
        o, d = random_rays(rng, 1024)
        hit = closest_hit(many_leaf_scene, o, d, cfg, any_hit=True)
        oracle = closest_hit_brute(o, d, many_leaf_scene.p1,
                                   many_leaf_scene.p2, many_leaf_scene.p3)
        assert (np.asarray(hit.tri >= 0)
                == np.asarray(oracle.tri >= 0)).all()
    else:
        # masked lanes return a miss and do not perturb live lanes
        o, d = random_rays(rng, 512)
        mask = jnp.asarray(rng.random(512) < 0.5)
        hit = closest_hit(scene, o, d, cfg, mask=mask)
        full = closest_hit(scene, o, d, cfg)
        m = np.asarray(mask)
        assert (np.asarray(hit.tri)[~m] == -1).all()
        assert (np.asarray(hit.t)[~m] == INF).all()
        assert (np.asarray(hit.tri)[m] == np.asarray(full.tri)[m]).all()


def _chain_scene(scene, depth):
    """`scene` with its BVH replaced by a chain: spine node i holds leaf i
    on its left and spine node i + 1 on its right, over triangles sorted
    along x, so the deepest leaf lies `depth` levels down and a ray coming
    from +x pushes a leaf at every level."""
    p = [np.asarray(x) for x in (scene.p1, scene.p2, scene.p3)]
    order = np.argsort((p[0] + p[1] + p[2])[:, 0], kind="stable")
    p = [x[order] for x in p]
    lo_tri = np.minimum(np.minimum(p[0], p[1]), p[2])
    hi_tri = np.maximum(np.maximum(p[0], p[1]), p[2])
    bounds = np.linspace(0, len(order), depth + 2).astype(int)
    assert (np.diff(bounds) >= 1).all() and (np.diff(bounds) <= 8).all()
    n_nodes = 1 + depth + depth + 1           # sentinel, spine, leaves
    left, right, count, first = (np.zeros(n_nodes, np.int32)
                                 for _ in range(4))
    lo = np.zeros((n_nodes, 3), np.float32)
    hi = np.zeros((n_nodes, 3), np.float32)
    for j in range(depth + 1):
        leaf, (a, b) = 1 + depth + j, bounds[j:j + 2]
        count[leaf], first[leaf] = b - a, a
        lo[leaf], hi[leaf] = lo_tri[a:b].min(0), hi_tri[a:b].max(0)
    for node in range(depth, 0, -1):
        left[node] = depth + node
        right[node] = node + 1 if node < depth else 2 * depth + 1
        lo[node] = np.minimum(lo[left[node]], lo[right[node]])
        hi[node] = np.maximum(hi[left[node]], hi[right[node]])
    dev = jnp.asarray
    return scene._replace(
        p1=dev(p[0]), p2=dev(p[1]), p3=dev(p[2]), bvh_left=dev(left),
        bvh_right=dev(right), bvh_count=dev(count), bvh_first=dev(first),
        bvh_min=dev(lo), bvh_max=dev(hi))


@pytest.mark.parametrize("tracer", TRACERS)
def test_tracer_on_deepest_tree(scene, tracer, request):
    """A chain as deep as build_bvh allows (STACK_DEPTH - 1 levels): the
    tracers' full stacks hold every pending node."""
    if tracer == "kernel":
        request.getfixturevalue("interpret_kernel")
    chain = _chain_scene(scene, STACK_DEPTH - 1)
    o, d = random_rays(np.random.default_rng(5), 1024)
    hit = closest_hit(chain, o, d, RenderConfig(tracer=tracer))
    assert_matches_oracle(chain, hit, o, d)


def test_kernel_short_stack_drops_pushes(scene):
    """With a stack shorter than the tree the kernel drops the pushes that
    do not fit: it loses some hits (so the chain's rays do need a deep
    stack) and never reports a hit closer than the true closest one. That
    a dropped push writes nothing outside its block's slots shows only on
    a GPU: the interpreter drops out-of-range stores itself."""
    chain = _chain_scene(scene, STACK_DEPTH - 1)
    o, d = random_rays(np.random.default_rng(5), 1024)
    short = closest_hit_kernel(chain, o, d, stack_depth=8, interpret=True)
    oracle = closest_hit_brute(o, d, chain.p1, chain.p2, chain.p3)
    hit, ref = np.asarray(short.tri) >= 0, np.asarray(oracle.tri) >= 0
    assert (hit & ~ref).sum() == 0
    assert (ref & ~hit).sum() > 0, "the rays never needed a deep stack"
    t, t_ref = np.asarray(short.t)[hit], np.asarray(oracle.t)[hit]
    assert (t >= t_ref - 1e-4 * (1 + np.abs(t_ref))).all()


def test_pair_cast_equals_two_casts(scene, interpret_kernel):
    """closest_hit_pair (one launch, per-ray any-hit flag) == an any-hit
    cast + a closest cast run separately, at 2048+2048 rays."""
    rng = np.random.default_rng(23)
    o_any, d_any = random_rays(rng, 2048)
    o_cls, d_cls = random_rays(rng, 2048)
    m_any = jnp.asarray(rng.random(2048) < 0.8)
    m_cls = jnp.asarray(rng.random(2048) < 0.8)
    cfg = RenderConfig(tracer="kernel")

    h_any, h_cls = closest_hit_pair(scene, o_any, d_any, m_any,
                                    o_cls, d_cls, m_cls, cfg)
    s_any = closest_hit(scene, o_any, d_any, cfg, mask=m_any, any_hit=True)
    s_cls = closest_hit(scene, o_cls, d_cls, cfg, mask=m_cls)

    assert (np.asarray(h_any.tri >= 0) == np.asarray(s_any.tri >= 0)).all()
    assert (np.asarray(h_cls.tri) == np.asarray(s_cls.tri)).all()
    np.testing.assert_array_equal(np.asarray(h_cls.t), np.asarray(s_cls.t))
    assert (np.asarray(h_cls.inside) == np.asarray(s_cls.inside)).all()


def test_kernel_render_matches_whileloop(scene, interpret_kernel):
    """End to end: a small render through the kernel equals the while-loop
    tracer's image (the full-integrator parity check)."""
    cam = Camera.make(position=(0.0, 0.5, -2.0), yaw=90.0, pitch=-8.0,
                      zoom=30.0, aspect=1.0)
    base = dict(width=24, height=24, max_bounce=3)
    img_kernel = render_radiance(
        scene, cam, RenderConfig(tracer="kernel", **base),
        spp=2, rays_per_tile=24 * 24)
    img_loop = render_radiance(
        scene, cam, RenderConfig(tracer="whileloop", **base), spp=2,
        rays_per_tile=24 * 24)
    np.testing.assert_allclose(np.asarray(img_kernel), np.asarray(img_loop),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_rays,block", [(37, 32), (300, 128)])
def test_kernel_ragged_batches(scene, n_rays, block):
    """Ray counts that are not a multiple of the block: the padding lanes
    are inactive and the real lanes match the oracle."""
    o, d = random_rays(np.random.default_rng(n_rays), n_rays)
    hit = closest_hit_kernel(scene, o, d, block_rays=block, interpret=True)
    assert hit.t.shape == hit.tri.shape == hit.inside.shape == (n_rays,)
    assert_matches_oracle(scene, hit, o, d)


def test_kernel_rejects_bad_block(scene):
    o, d = random_rays(np.random.default_rng(0), 64)
    with pytest.raises(ValueError, match="power of two"):
        closest_hit_kernel(scene, o, d, block_rays=48, interpret=True)


def test_dispatch_has_no_platform_branch():
    """The kernel is the default everywhere; the choice of tracer never
    looks at the backend's name, and interpretation is never implicit."""
    assert RenderConfig().tracer == "kernel"
    for mod in (config_mod, traverse, bvh_kernel):
        src = inspect.getsource(mod)
        assert "default_backend" not in src, mod.__name__
        assert ".platform" not in src, mod.__name__
    sig = inspect.signature(closest_hit_kernel)
    assert sig.parameters["interpret"].default is False
    for name in ("sweep", "kernel_interpret"):
        with pytest.raises(ValueError, match="unknown tracer"):
            RenderConfig(tracer=name)


@pytest.mark.parametrize("knob", [
    "use_pallas", "pallas_interpret", "pallas_backend", "sched_topk",
    "sweep_tile", "sweep_tile_secondary", "sweep_supertile",
    "sweep_prefetch_depth", "mxu_precision"])
def test_removed_knobs_raise(knob):
    with pytest.raises(TypeError, match=knob):
        RenderConfig(**{knob: 1})
