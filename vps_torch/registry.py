"""Registry-by-name dispatch (the port's own copy of vps_tpu/registry.py's
``Registry`` and ``build_from_cfg``): configs say ``dict(type='ResNet',
depth=50)``, and ``type`` is looked up in the registry of its category."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """Maps a string name to a class (or factory callable). Reads like a
    mapping: ``REG[name]``, ``name in REG``, ``sorted(REG)``."""

    def __init__(self, name: str):
        self._name = name
        self._items: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def get(self, key: str) -> Optional[Callable]:
        return self._items.get(key)

    def __getitem__(self, key: str) -> Callable:
        return self._items[key]

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __iter__(self):
        return iter(self._items)

    def register(self, obj: Callable, name: Optional[str] = None):
        """Use as ``@REG.register``, or ``REG.register(cls, name='Alias')``."""
        key = name or obj.__name__
        if key in self._items:
            raise KeyError(f"{key} already registered in {self._name}")
        self._items[key] = obj
        return obj


def build_from_cfg(cfg: Dict[str, Any], registry: Registry,
                   default_args: Optional[Dict[str, Any]] = None,
                   default_type: Optional[str] = None):
    """``registry[cfg['type']](**cfg_without_type, **default_args)``;
    ``default_type`` names the class when the config has no ``type``."""
    args = dict(cfg)
    obj_type = args.pop("type", default_type)
    obj_cls = registry.get(obj_type)
    if obj_cls is None:
        raise KeyError(f"{obj_type!r} is not registered in {registry.name}; "
                       f"it has {sorted(registry)}")
    for k, v in (default_args or {}).items():
        args.setdefault(k, v)
    return obj_cls(**args)


BACKBONES = Registry("backbone")
NECKS = Registry("neck")
SHARED_HEADS = Registry("shared_head")
HEADS = Registry("head")
DETECTORS = Registry("detector")
