"""Where compiled programs are cached across processes.

`JAX_COMPILATION_CACHE_DIR`, when set, is the cache and JAX reads it itself:
nothing here sets another directory. Otherwise the cache is `.jax_cache` at
the root of the checkout (git-ignored), a fixed path so that a later process
finds what an earlier one compiled. The CPU backend is never cached: XLA:CPU
entries are specific to the host that wrote them.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=os.environ) -> Path:
    """The directory the persistent compilation cache uses."""
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else CHECKOUT_CACHE


def enable_compile_cache() -> Path | None:
    """Turn on the persistent cache for accelerator backends; returns its
    directory, or None on the CPU."""
    if jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
