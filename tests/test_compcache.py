"""Where the persistent compilation cache lives (utils/compcache.py)."""

import jax
import pytest

from another_raytracer.utils import compcache


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_standard_variable_wins(monkeypatch, tmp_path, restore_cache_config):
    # JAX_COMPILATION_CACHE_DIR is JAX's own: the module sets no other dir.
    monkeypatch.delenv("ART_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "std"))
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    assert compcache.enable() == str(tmp_path / "std")
    assert jax.config.jax_compilation_cache_dir == "sentinel"
    assert not (tmp_path / "std").exists()


def test_default_is_fixed_dir_in_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("ART_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compcache.enable()
    assert path == str(compcache.CHECKOUT_CACHE_DIR)
    assert compcache.CHECKOUT_CACHE_DIR.name == ".jax_cache"
    assert (compcache.CHECKOUT_CACHE_DIR.parent / "another_raytracer").is_dir()
    assert jax.config.jax_compilation_cache_dir == path
    gitignore = (compcache.CHECKOUT_CACHE_DIR.parent / ".gitignore").read_text()
    assert ".jax_cache/" in gitignore.split()


@pytest.mark.parametrize("value", ["0", "off", "none", "false", "OFF"])
def test_disable(monkeypatch, value, restore_cache_config):
    monkeypatch.setenv("ART_COMPILE_CACHE", value)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/x")
    assert compcache.cache_dir() is None
    assert compcache.enable() is None


def test_path_through_own_variable_is_gone(monkeypatch, tmp_path):
    # A path in ART_COMPILE_CACHE no longer chooses the directory.
    monkeypatch.setenv("ART_COMPILE_CACHE", str(tmp_path / "custom"))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == str(compcache.CHECKOUT_CACHE_DIR)
