"""Placement of the persistent XLA compilation cache
(mcmc_ammsb/utils/compile_cache.py)."""

import os
import pathlib
import subprocess
import sys

import jax

from mcmc_ammsb.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_env_var_wins_and_nothing_is_set(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_inside_the_checkout():
    """Without the env var the cache is <checkout>/.jax_cache — the
    same path in every process, whatever its pid or start time."""
    assert compile_cache.DEFAULT_CACHE_DIR == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    code = ("import jax; from mcmc_ammsb.utils.compile_cache import "
            "enable_compile_cache as e; d = e(); "
            "print(d, jax.config.jax_compilation_cache_dir)")
    runs = [subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout.split()
            for _ in range(2)]
    want = str(REPO / ".jax_cache")
    assert runs[0] == runs[1] == [want, want]
