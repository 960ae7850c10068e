"""Test configuration.

Tests run on a virtual 8-device CPU mesh: multi-device sharding logic is
validated without accelerators (the standard JAX recipe). JAX's own
``JAX_PLATFORMS`` variable, when set, picks the platform instead; the
tests marked ``gpu`` run only where it selects a GPU (see README).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture()
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import, so
    every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")


@pytest.fixture(scope="session")
def ref_res():
    """Path to the reference repo's example resources (golden data)."""
    p = REFERENCE / "examples" / "res"
    if not p.exists():
        pytest.skip("reference resources not available")
    return p


@pytest.fixture(scope="session")
def rig2(ref_res):
    import simplestereo_jax as ss
    return ss.StereoRig.fromFile(str(ref_res / "2" / "rig.json"))


@pytest.fixture(scope="session")
def tsukuba(ref_res):
    from simplestereo_jax.imgio import imread
    d = ref_res / "tsukuba"
    return {
        "left": imread(str(d / "tsukuba_l.png")),
        "right": imread(str(d / "tsukuba_r.png")),
        "gt": imread(str(d / "groundtruth.png"), grayscale=True),
        "nonocc": imread(str(d / "nonocc.png"), grayscale=True),
        "golden_asw": imread(str(d / "disparityASW.png"), grayscale=True),
    }


@pytest.fixture()
def rng():
    # Function-scoped on purpose: a shared session stream makes each
    # test's data depend on which tests ran before it (adding a test
    # silently reshuffles every later test's inputs).
    return np.random.default_rng(42)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The XLA CPU compiler aborts/segfaults (SIGSEGV/SIGABRT inside
    backend_compile) when a full-suite run accumulates ~250 live
    compiled programs and then compiles another large one — whichever
    test compiles late in the run dies, deterministically. Dropping the
    executable caches at module boundaries keeps the live-program count
    bounded; modules re-compile their own programs anyway (cross-module
    jit reuse is rare here)."""
    yield
    jax.clear_caches()
