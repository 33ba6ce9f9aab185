"""JAX persistent compilation cache location.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and this
module sets nothing.  Otherwise the cache goes to ``.jax_cache`` at the root of
the checkout (listed in .gitignore): a fixed path, so a later process on the
same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``.

    Call before the first compilation.  Returns the directory in use.
    """
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
