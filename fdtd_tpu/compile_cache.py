"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``): ``$JAX_COMPILATION_CACHE_DIR`` when it is set,
else ``<repo>/.jax_cache`` (gitignored).  The path is part of the cache
key, so it is fixed rather than per-run.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=None) -> str:
    env = os.environ if environ is None else environ
    return env.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; returns
    the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
