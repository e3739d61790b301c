"""Placement of JAX's persistent compilation cache: the directory that
JAX_COMPILATION_CACHE_DIR names when it is set, else ``.jax_cache`` at the
root of the checkout."""
import json
import os
import pathlib
import subprocess
import sys

import anyseq_tpu

ROOT = pathlib.Path(anyseq_tpu.__file__).resolve().parent.parent
PROBE = """
import json, jax, jax.numpy as jnp
import anyseq_tpu
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
print(json.dumps([jax.config.jax_compilation_cache_dir, anyseq_tpu.CACHE_DIR]))
"""


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd="/",
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_env_dir_is_the_only_cache(tmp_path):
    cache = tmp_path / "jaxcache"
    config_dir, pkg_dir = _probe(cache)
    assert config_dir == pkg_dir == str(cache)
    assert any(cache.iterdir())  # the compile landed there


def test_default_cache_is_inside_the_checkout():
    config_dir, pkg_dir = _probe(None)
    assert config_dir == pkg_dir == str(ROOT / ".jax_cache")


def test_cache_dir_is_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
