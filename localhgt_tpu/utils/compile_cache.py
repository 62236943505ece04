"""One place that decides where JAX keeps its persistent compilation cache.

The cache directory is part of what makes a later process find an earlier
compile, so it must not move between runs: `JAX_COMPILATION_CACHE_DIR` when
the environment sets it (JAX reads that itself, and nothing here overrides
it), otherwise the fixed `.jax_cache` directory at the root of the checkout
(gitignored).
"""

from __future__ import annotations

import os

CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def configure() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path
