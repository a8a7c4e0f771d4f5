"""Compile-cache location rules (utils/cache.py)."""

import os

import jax

from pointcloudhookup_tpu.utils import cache


def test_env_dir_is_used_as_is(monkeypatch, tmp_path):
    want = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    before = jax.config.jax_compilation_cache_dir
    assert cache.compilation_cache_dir() == want
    assert cache.setup_compilation_cache() == want
    # JAX reads the variable itself: no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_env_uses_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(cache.__file__)))
    )
    want = os.path.join(checkout, ".jax_cache", cache.host_fingerprint())
    assert cache.compilation_cache_dir() == want
    assert cache.setup_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_host_fingerprint_is_stable():
    a = cache.host_fingerprint()
    assert a == cache.host_fingerprint()
    assert len(a) == 12 and all(c in "0123456789abcdef" for c in a)
