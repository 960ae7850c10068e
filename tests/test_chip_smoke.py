"""chip_smoke.py and the compile cache, as far as a CPU can check them.

The smoke run itself needs a GPU (it is the proof that the pipeline runs
compiled on the card); here it must refuse to run, and refuse without
the rest of the repository. The compile cache must land where
``JAX_COMPILATION_CACHE_DIR`` says, or at the fixed in-checkout path.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

from simplestereo_jax import utils

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            continue
    return False


def test_smoke_refuses_the_cpu():
    p = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    assert not _printed_result(p.stdout)


def test_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    p = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert p.returncode != 0
    assert not _printed_result(p.stdout)


@pytest.fixture()
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path,
                                               cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert utils.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = utils.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
