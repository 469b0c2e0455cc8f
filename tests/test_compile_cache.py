"""Placement of the persistent compilation cache (utils/compile_cache.py)."""

from pathlib import Path

from gpmpc_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_cache_dir_follows_environment_variable():
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and no
    other is chosen in code."""
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/shared/cache"}
    assert compile_cache.compile_cache_dir(env) == Path("/some/shared/cache")


def test_cache_dir_defaults_to_checkout_and_skips_cpu():
    """Unset, the cache is the git-ignored `.jax_cache` at the checkout root
    (a fixed path, so a later process finds it); the CPU is never cached."""
    assert compile_cache.compile_cache_dir({}) == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
    assert compile_cache.enable_compile_cache() is None  # the tests run on CPU
