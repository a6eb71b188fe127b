"""The persistent-compilation-cache helper: the environment's directory
when set, a fixed directory inside the checkout otherwise."""

import os

import jax
import pytest

from icpslam_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_unset_env_uses_repo_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.enable() == compile_cache.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == compile_cache.REPO_CACHE_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.REPO_CACHE_DIR == os.path.join(repo, ".jax_cache")


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    assert compile_cache.enable() == str(tmp_path)
    # nothing set in code: the value in force is whatever was there
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_repo_dir_is_fixed_and_ignored():
    # a fixed path (the cache key includes it) that git does not track
    assert "tmp" not in compile_cache.REPO_CACHE_DIR.split(os.sep)
    repo = os.path.dirname(compile_cache.REPO_CACHE_DIR)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
