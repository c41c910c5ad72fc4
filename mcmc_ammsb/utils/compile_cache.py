"""Where the persistent XLA compilation cache lives.

A cold process compiles every program it runs, which takes minutes at
the bench shapes; the persistent cache lets the next process load them
instead. JAX keys cache entries by the program, so the directory only
has to stay put: it is fixed inside the checkout, never derived from a
process id, a time or a temporary directory.
"""

from __future__ import annotations

import os
import pathlib

#: ``<checkout>/.jax_cache`` (listed in .gitignore).
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory before
    the first compile and return that directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself
    and nothing is set here. Otherwise the cache goes to
    ``DEFAULT_CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
