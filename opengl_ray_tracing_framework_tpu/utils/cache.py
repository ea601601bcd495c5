"""Persistent XLA compilation cache.

The render pass is one large fused program (traversal kernel + Disney
shading + media + MIS under a bounce loop); a cold compile of the flagship
1024x512x8 configuration takes a long time. The reference never pays this
(GLSL programs compile in milliseconds at startup,
src/core/Shader.h:21-108) — so to keep edit/re-render iteration
interactive the framework enables JAX's persistent compilation cache:
identical programs are served from disk across processes.

Enabled on package import (see __init__.py). Where the environment sets
JAX_COMPILATION_CACHE_DIR, JAX already reads it and that directory is the
only one used. Otherwise the cache lives at the fixed path
`<checkout>/.jax_cache/` (git-ignored): a fixed path keeps cache keys
stable from one run to the next. ORTF_NO_CACHE=1 turns it off.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> str | None:
    """Configure jax's persistent compilation cache (idempotent).

    Returns the cache directory in use, or None when disabled via
    ORTF_NO_CACHE=1."""
    if os.environ.get("ORTF_NO_CACHE") == "1":
        return None
    import jax

    cache_dir = jax.config.jax_compilation_cache_dir
    if not cache_dir:   # JAX_COMPILATION_CACHE_DIR unset
        cache_dir = DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache everything that took real compile effort
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
