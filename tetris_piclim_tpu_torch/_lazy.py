"""Lazy re-exports for the package ``__init__`` files (PEP 562).

Spawned producer processes import ``gen/_producers.py`` and ``env_api.py``,
and with them every package ``__init__`` on the way; those must not load
torch. So each ``__init__`` names its exports here, and a name's module is
imported when the name is first read."""

from __future__ import annotations

import importlib


def lazy_exports(package: str, exports: dict[str, list[str]]):
    """``(__getattr__, __dir__, __all__)`` for ``package``. ``exports`` maps a
    module (relative to the package, e.g. ``".engine"``) to the names it
    gives; an empty list exports the module itself under its own name."""
    where = {}
    for module, names in exports.items():
        for name in names or [module.lstrip(".")]:
            where[name] = (module, name if names else None)

    def __getattr__(name: str):
        if name not in where:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module, attr = where[name]
        mod = importlib.import_module(module, package)
        value = mod if attr is None else getattr(mod, attr)
        setattr(importlib.import_module(package), name, value)
        return value

    def __dir__():
        return sorted(set(vars(importlib.import_module(package))) | set(where))

    return __getattr__, __dir__, list(where)
