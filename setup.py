"""Build configuration for the native C++ extensions.

Mirrors the reference's native build policy (its setup.py compiles
_passive/_unwrapping the same way); pure-Python fallbacks keep the
package functional without compilation (simplestereo_jax.native builds
in-tree on demand too).
"""

from setuptools import setup, Extension

setup(
    ext_modules=[
        Extension(
            "simplestereo_jax.native._ply",
            ["simplestereo_jax/native/_ply.cpp"],
            extra_compile_args=["-std=c++14", "-O2"],
            optional=True,
        ),
    ],
)
