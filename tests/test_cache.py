"""Where the persistent compilation cache lives (utils/cache.py).

Each case imports the package in a fresh CPU process, since JAX's cache
directory is process-wide configuration."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax, opengl_ray_tracing_framework_tpu as o; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(o.utils.cache.enable_compilation_cache())")


def _cache_dirs(tmp_path, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "ORTF_NO_CACHE")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env_over)
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_cache_dir_from_environment(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory and no other."""
    want = str(tmp_path / "xla-cache")
    assert _cache_dirs(tmp_path, JAX_COMPILATION_CACHE_DIR=want) \
        == [want, want]


def test_cache_dir_default_in_checkout(tmp_path):
    """Unset: the fixed, git-ignored <checkout>/.jax_cache/."""
    want = os.path.join(REPO, ".jax_cache")
    assert _cache_dirs(tmp_path) == [want, want]
    assert os.path.isdir(want)


def test_cache_can_be_switched_off(tmp_path):
    assert _cache_dirs(tmp_path, ORTF_NO_CACHE="1") == ["None", "None"]
