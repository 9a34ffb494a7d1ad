"""Model zoo of the port — the NMT family (slices 1–2), the ResNets
(slice 5), BERT (slice 6), Mask R-CNN (slice 7), the GPT family (slice 8),
ViT, BERT and GPT with Mixture-of-Experts FFNs and the pipelined BERT
trunk (slice 10), and the long-context ``bert_long`` and ``gpt_long``
(slice 16).

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
    from . import (bert, bert_long, lm, maskrcnn, pipelined,  # noqa: F401
                   resnet, transformer_nmt, vit)

    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes=num_classes, dtype=dtype, **kwargs)


def list_models():
    from . import (bert, bert_long, lm, maskrcnn, pipelined,  # noqa: F401
                   resnet, transformer_nmt, vit)

    return sorted(_REGISTRY)
