"""The package's former name stays importable as a deprecated alias."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# every other top-level simplestereo_* package is an alias of the real one
ALIASES = sorted(p.name for p in ROOT.glob("simplestereo_*")
                 if p.name != "simplestereo_jax"
                 and (p / "__init__.py").is_file())

_PROBE = """
import importlib, sys, warnings
import simplestereo_jax as ss
old = sys.argv[1]
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    pkg = importlib.import_module(old)
assert pkg is ss, pkg
assert any(issubclass(w.category, DeprecationWarning)
           and "simplestereo_jax" in str(w.message) for w in caught), caught
for sub in sys.argv[2:]:
    mod = importlib.import_module(old + "." + sub)
    assert mod is importlib.import_module("simplestereo_jax." + sub), sub
ns = {}
exec(f"from {old}.passive import StereoASW", ns)
assert ns["StereoASW"] is ss.passive.StereoASW
print("ok")
"""


def test_one_alias_exists():
    assert len(ALIASES) == 1, ALIASES


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("subs", [("passive",), ("passive.asw", "warp"),
                                  ("active.ftp", "parallel")])
def test_alias_resolves_to_the_same_modules(alias, subs):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _PROBE, alias, *subs],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
