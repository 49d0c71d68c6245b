"""String-keyed registries for datasets / models (tasks) / archs, filled by
decorators (mirrors ``refid_tpu/core/registry.py``)."""

from __future__ import annotations

from typing import Callable, Dict

__all__ = ["Registry", "DATASETS", "MODELS", "ARCHS"]


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._map: Dict[str, Callable] = {}

    def register(self, name: str = None):
        def deco(cls):
            key = name or cls.__name__
            if key in self._map:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._map[key] = cls
            return cls
        return deco

    def get(self, name: str):
        if name not in self._map:
            raise KeyError(
                f"{name!r} not found in {self.name} registry; "
                f"available: {sorted(self._map)}")
        return self._map[name]

    def __contains__(self, name):
        return name in self._map

    def keys(self):
        return sorted(self._map)


DATASETS = Registry("datasets")
MODELS = Registry("models")
ARCHS = Registry("archs")
