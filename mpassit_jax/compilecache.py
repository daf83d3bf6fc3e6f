"""Persistent XLA compilation cache (the RegridStore-caching win applied
to compilation).

The reference pays no compile cost — its weights ARE the program and ESMF
is prebuilt. A JAX run re-lowers and re-compiles every jitted shape;
pointing ``jax_compilation_cache_dir`` at a persistent directory makes
every compile a one-time cost, exactly as weights/cache.py amortizes
weight generation (interp.F90:123-128, whose RegridStore cost the weight
cache amortizes the same way).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives at a fixed path inside
the checkout, ``<repo>/.jax_cache`` (listed in .gitignore): the path is
part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("mpassit_jax")

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache. Idempotent. Returns the
    directory in effect."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        if jax.config.jax_compilation_cache_dir != cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache every compile: the default 1 s floor would skip the many small
    # per-width shapes that still add up over a run
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    log.info("- compilation cache: %s", cache_dir)
    return cache_dir
