"""Layer stacks as one stage — the port of
``deeplearning_cfn_tpu/ops/pipeline.py`` for one device.

``scan_layers`` lifts a one-layer function into a stage function over a
dict of parameters stacked on a leading layer dim [L, ...], as the JAX
``lax.scan`` does: a loop over the layers, each given its slice. The stack
is split once with ``unbind``, whose backward stacks the L slices'
gradients into one tensor (indexing it layer by layer would allocate a
zero-filled [L, ...] gradient per layer).

``gpipe`` is the multi-device GPipe schedule (stages over a ``pipe`` mesh
axis, activations hopping by ``ppermute``); it is registered and raises,
naming ROADMAP A.10. On one device the JAX ``PipeStack`` takes the plain
scan too.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


def gpipe(stage_fn, stage_params, xs, *, mesh, n_microbatches: int,
          axis_name: str = "pipe", batch_spec="data"):
    raise NotImplementedError(
        "gpipe, the GPipe schedule across the devices of a pipe mesh axis, "
        "is not ported yet (ROADMAP A.10); on one device PipeStack runs "
        "its layers as scan_layers")


def scan_layers(layer_fn: Callable[[Params, object], object]
                ) -> Callable[[Params, object], object]:
    """``stage_fn(params, state)``: ``layer_fn(layer_params, state)`` over
    every layer of ``params`` (each value [L, ...]) in order."""

    def stage_fn(params: Params, state):
        layers = {k: v.unbind(0) for k, v in params.items()}
        depth = len(next(iter(layers.values())))
        for i in range(depth):
            state = layer_fn({k: v[i] for k, v in layers.items()}, state)
        return state

    return stage_fn
