"""Model zoo of the port — the slice-1 models (the NMT family).

Registry maps ModelConfig.name → constructor, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build_model(name: str, num_classes: int, dtype, **kwargs):
    from . import transformer_nmt  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes=num_classes, dtype=dtype, **kwargs)


def list_models():
    from . import transformer_nmt  # noqa: F401

    return sorted(_REGISTRY)
