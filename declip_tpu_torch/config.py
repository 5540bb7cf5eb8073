"""YAML config loading (copy of ``parse_config``, ``Cfg`` and ``override``
from declip_tpu/config.py).

The reference parses a single YAML into an EasyDict with no validation
(prototype/utils/misc.py:65-70). We load into an attribute-dict (`Cfg`) for
the same ergonomics; builders never mutate the config.
"""

from __future__ import annotations

import copy
import io
import os
from typing import Any, Mapping

import yaml


class Cfg(dict):
    """dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, key: str) -> Any:
        try:
            v = self[key]
        except KeyError:
            raise AttributeError(key) from None
        if isinstance(v, dict) and not isinstance(v, Cfg):
            v = Cfg(v)
            self[key] = v
        return v

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """cfg.get_path('model.kwargs.image_encode') with a default."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node


def _wrap(node: Any) -> Any:
    if isinstance(node, dict):
        return Cfg({k: _wrap(v) for k, v in node.items()})
    if isinstance(node, list):
        return [_wrap(v) for v in node]
    return node


def parse_config(path_or_str: str) -> Cfg:
    """Load a YAML config file (or literal YAML text) into a Cfg tree."""
    if os.path.exists(path_or_str):
        with open(path_or_str) as f:
            raw = yaml.safe_load(f)
        cfg = _wrap(raw or {})
        cfg["_config_path"] = os.path.abspath(path_or_str)
    else:
        if path_or_str.endswith((".yaml", ".yml")) and "\n" not in path_or_str:
            # a mistyped PATH, not literal YAML — yaml.safe_load would
            # silently wrap the path string and fail confusingly downstream
            raise FileNotFoundError(f"config file not found: {path_or_str}")
        cfg = _wrap(yaml.safe_load(io.StringIO(path_or_str)) or {})
    return cfg


def override(cfg: Cfg, dotted: str, value: Any) -> Cfg:
    """Return a copy of cfg with `a.b.c=value` applied (CLI override)."""
    out = _wrap(copy.deepcopy(dict(cfg)))
    parts = dotted.split(".")
    node = out
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = Cfg()
        node = node[p]
    node[parts[-1]] = value
    return out
