"""Deprecated alias of :mod:`simplestereo_jax`, the package's former name.

Importing this package, or any of its submodules, warns once and yields
the ``simplestereo_jax`` module itself, so old imports keep working and
share state with new ones. It will be removed in a later release.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import simplestereo_jax

_ALIAS = __name__
_TARGET = simplestereo_jax.__name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<alias>.<sub>`` to the module ``simplestereo_jax.<sub>``."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_ALIAS + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        # the import system returns whatever sys.modules holds afterwards
        sys.modules[module.__name__] = importlib.import_module(
            _TARGET + module.__name__[len(_ALIAS):])


warnings.warn(f"{_ALIAS} is renamed {_TARGET}; import {_TARGET} instead",
              DeprecationWarning, stacklevel=2)
sys.meta_path.insert(0, _AliasFinder())
sys.modules[_ALIAS] = simplestereo_jax
