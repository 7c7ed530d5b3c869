"""Package-level names resolved at first use (PEP 562), so that importing
a package pulls in neither torch nor its executors until a name is
used: a light module of the package (``chaos``, ``serving.errors``,
``cli``) stays light in the processes that import only it, and the
package's ``__all__`` is what its JAX counterpart exports."""

from __future__ import annotations

import importlib
from typing import Dict


def exports(package: str, names: Dict[str, str]):
    """A module ``__getattr__`` for ``package``: each key of ``names``
    resolves to the attribute of that name of the submodule it maps to
    (relative to ``package``), or to the submodule itself where the name
    is the submodule's."""
    def __getattr__(name):
        mod = names.get(name)
        if mod is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        target = importlib.import_module(f"{package}.{mod}")
        return target if mod == name else getattr(target, name)
    return __getattr__
