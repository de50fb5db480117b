"""Python-file configs as attribute-accessible dicts (the port's copy of
the JAX package's config system, same semantics): a config file is exec'd
and its module-level names become config entries, with ``_base_``
inheritance merged dict by dict. The port's configs live in
``vps_torch/configs/``.
"""

from __future__ import annotations

import copy
import importlib.util
import os
import sys
import types
from typing import Any, Dict


class ConfigDict(dict):
    """A dict with attribute access, applied recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict.wrap(v) for v in obj)
        return obj


class Config:
    """Loads python-file configs (``Config.fromfile``) or plain dicts."""

    def __init__(self, cfg_dict: Dict[str, Any] = None, filename: str = None):
        self._cfg = ConfigDict.wrap(cfg_dict or {})
        self._filename = filename

    @property
    def filename(self):
        return self._filename

    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if not filename.endswith(".py"):
            raise ValueError("only python-file configs are supported")
        spec = importlib.util.spec_from_file_location("_vps_cfg", filename)
        mod = importlib.util.module_from_spec(spec)
        # Isolate: don't leak into sys.modules permanently.
        sys.modules["_vps_cfg"] = mod
        try:
            spec.loader.exec_module(mod)
        finally:
            sys.modules.pop("_vps_cfg", None)
        cfg_dict = {
            k: v
            for k, v in mod.__dict__.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)
        }
        # Support `_base_ = '...'` inheritance (relative to the config file).
        base = cfg_dict.pop("_base_", None)
        if base is not None:
            bases = base if isinstance(base, (list, tuple)) else [base]
            merged: Dict[str, Any] = {}
            for b in bases:
                bcfg = cls.fromfile(os.path.join(os.path.dirname(filename), b))
                merged = _merge(merged, dict(bcfg._cfg))
            cfg_dict = _merge(merged, cfg_dict)
        return cls(cfg_dict, filename=filename)

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Merge flat dot-key overrides, e.g. {'optimizer.lr': 0.01}."""
        for full_key, v in options.items():
            d = self._cfg
            keys = full_key.split(".")
            for k in keys[:-1]:
                d = d.setdefault(k, ConfigDict())
            d[keys[-1]] = ConfigDict.wrap(v)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._cfg, name)

    def __getitem__(self, name):
        return self._cfg[name]

    def __contains__(self, name):
        return name in self._cfg

    def get(self, name, default=None):
        return self._cfg.get(name, default)

    def keys(self):
        return self._cfg.keys()

    @property
    def text(self) -> str:
        import pprint

        return pprint.pformat(dict(self._cfg))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.text)


def _merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out
