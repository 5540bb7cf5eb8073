"""Type/kwargs registries (copy of declip_tpu/utils/registry.py).

The reference resolves every `type:` string against module globals
(prototype/model/__init__.py:15-21). We keep the same `type:`/`kwargs:`
config convention but use explicit named registries so unknown types produce a
helpful error listing what is available.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A name -> constructor mapping with a decorator-based register API."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, fn: Callable = None, *, name: str = None):
        def _do(f, key):
            key = key or f.__name__
            if key in self._entries:
                raise KeyError(f"{self.name}: duplicate registration {key!r}")
            self._entries[key] = f
            return f

        if fn is None:
            return lambda f: _do(f, name)
        return _do(fn, name)

    def get(self, key: str) -> Callable:
        try:
            return self._entries[key]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(
                f"{self.name} registry has no entry {key!r}. Known: {known}"
            ) from None

    def build(self, cfg: Any, **extra):
        """Build from a `{type: ..., kwargs: {...}}` config node."""
        kwargs = dict(cfg.get("kwargs") or {})
        kwargs.update(extra)
        return self.get(cfg["type"])(**kwargs)

    def __contains__(self, key: str) -> bool:
        return key in self._entries


MODELS = Registry("model")
SCHEDULERS = Registry("lr_scheduler")
SAMPLERS = Registry("sampler")
EVALUATORS = Registry("evaluator")
DATASETS = Registry("dataset")
