"""Test harness: two lanes.

CPU lane (the default): JAX is forced onto the CPU backend with 8 virtual
devices, so multi-device sharding paths run without hardware, and the
persistent compilation cache is off (every run compiles what it tests).

GPU lane (`python -m pytest tests/ -m gpu`, on a machine with a GPU): JAX
keeps its default backend. Tests marked `gpu` need the card; a fixture
skips them when the backend is not a GPU (tests/test_gpu.py).
"""

import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _gpu_lane(config) -> bool:
    expr = config.getoption("markexpr") or ""
    return "gpu" in expr and "not gpu" not in expr


def pytest_configure(config):
    if _gpu_lane(config):
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    if "collective" not in flags:
        # 8 device threads on few cores: raise the CPU collective
        # rendezvous timeouts (default 20s warn / 40s terminate aborts the
        # whole process) so uneven per-device runtimes under core
        # contention don't abort sharded tests spuriously.
        flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=600"
                  " --xla_cpu_collective_call_terminate_timeout_seconds=1200")
    os.environ["XLA_FLAGS"] = flags.strip()
    os.environ["ORTF_NO_CACHE"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker_needs_gpu(request):
    """Tests marked `gpu` skip off a GPU backend."""
    if request.node.get_closest_marker("gpu"):
        import jax
        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU backend")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Route tracer="kernel" casts through the Pallas interpreter, so the
    BVH kernel runs on a host without a GPU. Only tests ask for this; the
    package never interprets the kernel on its own."""
    from opengl_ray_tracing_framework_tpu.ops import bvh_kernel
    monkeypatch.setattr(bvh_kernel, "closest_hit_kernel", functools.partial(
        bvh_kernel.closest_hit_kernel, interpret=True))


@pytest.fixture(scope="session")
def test_scene():
    from opengl_ray_tracing_framework_tpu.models.scene import build_test_scene
    _, data = build_test_scene()
    return data


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
