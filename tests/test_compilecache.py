"""The persistent compile cache honours JAX_COMPILATION_CACHE_DIR."""

import os

import jax

from cvr_tpu.utils import compilecache


def test_env_dir_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compilecache.cache_dir() == str(tmp_path)
        compilecache.enable()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compilecache.cache_dir()
    assert os.path.isabs(d) and d.endswith(".jax_cache")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(d) == repo
