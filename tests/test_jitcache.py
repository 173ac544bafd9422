"""The persistent compile cache honours JAX_COMPILATION_CACHE_DIR and
otherwise sits at the fixed in-checkout path."""

import os

import jax
import pytest

from emsar_jax.utils import jitcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_default_is_fixed_checkout_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jitcache.DEFAULT_DIR == os.path.join(REPO, "bench_cache",
                                                "jit_cache")
    assert jitcache.enable() == jitcache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == jitcache.DEFAULT_DIR
    assert os.path.isdir(jitcache.DEFAULT_DIR)


def test_env_dir_is_used_and_nothing_set_in_code(monkeypatch, tmp_path,
                                                 restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/sentinel")
    assert jitcache.enable() == str(tmp_path)
    assert jitcache.cache_dir() == str(tmp_path)
    # the directory itself is JAX's to read from the environment
    assert jax.config.jax_compilation_cache_dir == "/sentinel"


def test_thresholds_keep_every_executable(restore_cache_dir):
    jitcache.enable()
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == -1
