"""The persistent compilation cache: the environment wins, otherwise a fixed
directory inside the checkout."""

import pathlib

import jax

from csgn_tpu.utils import compile_cache

ROOT = pathlib.Path(__file__).parent.parent


def test_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == str((ROOT / ".jax_cache").resolve())
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.enable_compile_cache() == got  # same path every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_gitignored():
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()
