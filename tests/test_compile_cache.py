"""Where the persistent compilation cache goes (utils/compile_cache.py)."""

import os

import jax
import pytest

from nxsearch_tpu.utils import compile_cache


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config updates instead of applying them (the test
    process must not start writing a persistent cache)."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_environment_variable_wins(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in config_updates


def test_default_is_the_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert config_updates["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)
