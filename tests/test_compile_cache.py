"""The entry points' persistent compilation cache helper."""

import os

import jax
import pytest

from epivo_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_nothing_is_set(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_dir_at_checkout_root(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.enable() == path  # stable across calls


def test_package_import_enables_nothing():
    import subprocess
    import sys

    code = ("import jax, epivo_tpu.pipeline.runners; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"
