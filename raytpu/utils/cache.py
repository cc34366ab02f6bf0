"""JAX's persistent compilation cache, one rule for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache lives at ``<repo>/.jax_cache`` (listed in
``.gitignore``): a fixed path, so later runs from the same checkout find
what earlier ones compiled.
"""

from __future__ import annotations

import os

#: The checkout's root (raytpu/utils/ is two levels below it).
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Apply the rule above; returns the cache directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
