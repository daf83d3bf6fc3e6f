"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins and the code
then sets no directory of its own; unset, the cache sits at the fixed
path <repo>/.jax_cache."""

import os

import jax
import pytest

from mpassit_jax import compilecache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_used_and_not_overridden(tmp_path, monkeypatch,
                                            restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    updates = []
    real_update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: (
        updates.append(k), real_update(k, v)))
    assert compilecache.enable_compile_cache() == str(tmp_path / "jc")
    assert "jax_compilation_cache_dir" not in updates
    assert not os.path.exists(tmp_path / "jc")   # JAX creates it on use


def test_default_dir_inside_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compilecache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert compilecache.enable_compile_cache() == compilecache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == compilecache.DEFAULT_DIR
    assert os.path.isdir(compilecache.DEFAULT_DIR)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
