"""Python-file configs with ``_base_`` composition.

The port's own copy of erd_tpu/config.py's ``Config.fromfile`` and merge
rules: config files are plain python modules whose top-level names become
keys; ``_base_`` lists compose by recursive dict merge (child wins), and a
dict carrying ``_delete_=True`` replaces instead of merging.
"""
from __future__ import annotations

import copy
import os
import types
from typing import Any, Dict


class Config(dict):
    """dict with attribute access and deep merge."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config({k: Config._wrap(x) for k, x in v.items()})
        if isinstance(v, list):
            return [Config._wrap(x) for x in v]
        return v

    @classmethod
    def fromfile(cls, path: str) -> 'Config':
        path = os.path.abspath(path)
        module_vars = cls._exec_file(path)
        bases = module_vars.pop('_base_', [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            base_cfg = cls.fromfile(os.path.join(os.path.dirname(path), b))
            merged = cls._merge(merged, base_cfg)
        merged = cls._merge(merged, module_vars)
        return cls._wrap(merged)

    @staticmethod
    def _exec_file(path: str) -> Dict[str, Any]:
        with open(path) as f:
            src = f.read()
        mod = types.ModuleType('cfg')
        mod.__file__ = path
        exec(compile(src, path, 'exec'), mod.__dict__)
        return {k: v for k, v in vars(mod).items()
                if not k.startswith('__')}

    @staticmethod
    def _merge(base: Dict, override: Dict) -> Dict:
        out = copy.deepcopy(dict(base))
        for k, v in override.items():
            if isinstance(v, dict) and v.get('_delete_', False) is True:
                out[k] = copy.deepcopy(
                    {k2: x for k2, x in v.items() if k2 != '_delete_'})
            elif (k in out and isinstance(out[k], dict)
                  and isinstance(v, dict)):
                out[k] = Config._merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        return out
