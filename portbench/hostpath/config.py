"""Config system: executable python config files with attribute access.

Mirrors the reference's config surface (det3d/torchie/utils/config.py:51-160
Config.fromfile on an exec'd module + addict) without the registry soup: a
config file is plain python evaluated in an empty namespace; every top-level
non-dunder name becomes an entry of an attribute-dict. ``cfg.text`` holds
the raw source for checkpoint metadata, like the reference.
"""
from __future__ import annotations

import pathlib
from typing import Any


class ConfigDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return cls({k: cls._wrap(x) for k, x in v.items()})
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def get(self, k, default=None):
        return self[k] if k in self else default


class Config:
    def __init__(self, cfg_dict: dict, text: str = "", filename: str = ""):
        self._cfg = ConfigDict._wrap(cfg_dict)
        self.text = text
        self.filename = filename

    @classmethod
    def fromfile(cls, path) -> "Config":
        path = pathlib.Path(path)
        src = path.read_text()
        namespace: dict = {"__file__": str(path)}
        exec(compile(src, str(path), "exec"), namespace)
        cfg = {k: v for k, v in namespace.items()
               if not k.startswith("__") and not callable(v)
               and not isinstance(v, type(pathlib))}
        return cls(cfg, text=src, filename=str(path))

    def __getattr__(self, k):
        if k in ("_cfg", "text", "filename"):
            raise AttributeError(k)
        return getattr(self._cfg, k)

    def __getitem__(self, k):
        return self._cfg[k]

    def __contains__(self, k):
        return k in self._cfg

    def get(self, k, default=None):
        return self._cfg.get(k, default)

    def keys(self):
        return self._cfg.keys()
