"""Persistent compilation cache at a fixed place.

A process that compiles the same programs as an earlier one finds them
in JAX's persistent cache instead of compiling again.  The cache path is
part of what makes a hit, so it is fixed: the directory that
`JAX_COMPILATION_CACHE_DIR` names when it is set (JAX reads the
variable itself), else `.jax_cache` at the root of this checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The cache directory enable_compile_cache() uses."""
    env = os.environ.get(_ENV)
    if env:
        return env
    return str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and
    nothing is changed; otherwise jax_compilation_cache_dir is set to
    the checkout's .jax_cache.  Call before the first compilation.
    """
    path = compile_cache_dir()
    if not os.environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
