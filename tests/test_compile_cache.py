"""The one compile-cache rule: JAX_COMPILATION_CACHE_DIR if set, else a
fixed directory inside the checkout."""

import os

import jax

from ofdm_tpu.core import compile_cache


def test_env_dir_wins_and_code_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        assert path == os.path.join(root, ".jax_cache") == compile_cache.cache_dir()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
