# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Where the scripts keep JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing is set in code.  Otherwise the cache goes to one fixed directory
inside the checkout (the directory is part of the cache key, so a path that
moved would never hit).
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "configure_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(default_dir: str) -> tuple[str, bool]:
    """``(directory, set_in_code)`` for the given fallback directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env, False
    return os.path.abspath(default_dir), True


def configure_compile_cache(default_dir: str) -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; return it.

    Call before the first compilation of the process.
    """
    path, set_in_code = compile_cache_dir(default_dir)
    if set_in_code:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
