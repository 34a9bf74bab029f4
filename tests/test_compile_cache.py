"""Persistent compile-cache lifecycle: the directory rule (the env
directory exactly, else ``<checkout>/.jax_cache``), then configure ->
populate -> export -> import on a "fresh host" (another directory)."""

import os
import tarfile

import jax
import jax.numpy as jnp
import pytest

import adrates_tpu
from adrates_tpu.utils.compile_cache import (cache_dir, configure_cache,
                                             export_cache, import_cache)

ENV = "JAX_COMPILATION_CACHE_DIR"


def _populate():
    active = configure_cache(min_compile_secs=0.0)

    @jax.jit
    def f(x):
        return jnp.sin(x) * jnp.cos(x) + jnp.tanh(x @ x.T).sum()

    f(jnp.ones((16, 16))).block_until_ready()
    return active


class TestCompileCacheShipping:
    def test_configure_uses_env_dir_exactly(self, tmp_path, monkeypatch):
        want = str(tmp_path / "a")
        monkeypatch.setenv(ENV, want)
        active = configure_cache()
        assert active == want
        assert os.path.isdir(want)
        assert jax.config.jax_compilation_cache_dir == want

    def test_unset_resolves_inside_checkout(self, monkeypatch):
        monkeypatch.delenv(ENV, raising=False)
        checkout = os.path.dirname(os.path.dirname(
            os.path.abspath(adrates_tpu.__file__)))
        assert cache_dir() == os.path.join(checkout, ".jax_cache")

    def test_export_import_round_trip(self, tmp_path, monkeypatch):
        src = tmp_path / "build_host"
        monkeypatch.setenv(ENV, str(src))
        active = _populate()
        assert active == str(src)
        entries = os.listdir(active)
        assert entries, "jit compile produced no cache entry"

        tar = str(tmp_path / "cache.tar.gz")
        export_cache(tar)
        with tarfile.open(tar) as tf:
            names = {os.path.basename(n) for n in tf.getnames()}
        assert set(entries) <= names

        dst = tmp_path / "prod_host"
        monkeypatch.setenv(ENV, str(dst))
        dst_active = import_cache(tar)
        assert dst_active == str(dst)
        # the entries arrived and would be replayed
        assert set(entries) <= set(os.listdir(dst_active))
        # the process cache config now points at the imported dir
        assert jax.config.jax_compilation_cache_dir == dst_active

    def test_export_missing_root_raises(self, tmp_path, monkeypatch):
        monkeypatch.setenv(ENV, str(tmp_path / "nope"))
        with pytest.raises(FileNotFoundError):
            export_cache(str(tmp_path / "x.tar.gz"))
