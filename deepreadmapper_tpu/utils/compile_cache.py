"""Persistent XLA compile cache at a fixed place.

The cache key includes the directory, so a directory that moves between
runs never hits.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing
else is set; otherwise the cache lives at ``<repo>/.jax_cache`` on the GPU.
"""

from __future__ import annotations

import os
import pathlib

REPO_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(platform: str | None = None) -> str | None:
    """Point JAX's persistent compile cache at its one directory; returns
    the directory in use.  Call before the first compilation.

    The CPU, which runs only the tests, keeps no cache: its compiles are
    cheap, and a cached CPU executable is tied to the host's features."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    if (platform or jax.default_backend()) == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
