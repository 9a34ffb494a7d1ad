"""The tiny NMT's parameters for the port's fleet and serving tests.

Flax's eager ``init`` of the tiny model takes seconds on the CPU, once per
test module. Here the shapes come from ``jax.eval_shape`` and the values
from numpy, seeded, with Flax's init distributions: Glorot-uniform Dense
kernels, normal(0.02) embeddings, zero biases and unit norm scales.
"""

import functools

import jax
import numpy as np

from deeplearning_cfn_tpu.utils.trees import flatten_with_names


def tiny_nmt_params(model, src_len, seed=0, kernel_scale=1.0):
    """``{name: array}`` for the Flax NMT ``model``, its Dense kernels
    multiplied by ``kernel_scale`` (×3 keeps a random tiny model's greedy
    streams from collapsing onto one token)."""
    ids = np.zeros((1, src_len), np.int32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), ids, np.ones_like(ids), ids,
        train=False))["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for name, leaf in flatten_with_names(shapes)[0]:
        if name.endswith("kernel"):
            fan_in, fan_out = int(np.prod(leaf.shape[:-1])), leaf.shape[-1]
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            value = rng.uniform(-limit, limit, leaf.shape) * kernel_scale
        elif name.endswith("bias"):
            value = np.zeros(leaf.shape)
        elif name.endswith("scale"):
            value = np.ones(leaf.shape)
        else:
            value = rng.normal(0.0, 0.02, leaf.shape)
        flat[name] = value.astype(leaf.dtype)
    return flat



@functools.lru_cache(maxsize=None)
def _jax_bench_state(seed):
    from deeplearning_cfn_tpu.models.transformer_nmt import (
        transformer_nmt_tiny)
    from deeplearning_cfn_tpu_torch.convert import params_from_flax

    ids = np.zeros((1, 8), np.int32)
    params = transformer_nmt_tiny(vocab_size=96, max_len=64).init(
        jax.random.PRNGKey(seed), ids, np.ones_like(ids), ids,
        train=False)["params"]
    return params_from_flax(dict(flatten_with_names(params)[0]))


def bench_model_from_jax(monkeypatch, seed=0):
    """Make the port's benches build their tiny NMT with the JAX benches'
    weights: Flax's ``init`` of ``transformer_nmt_tiny(vocab_size=96,
    max_len=64)`` from ``PRNGKey(seed)``, as the JAX serve and fleet benches
    draw them, carried across by ``convert.params_from_flax``."""
    from deeplearning_cfn_tpu_torch.serve import bench

    state = _jax_bench_state(seed)
    build = bench.tiny_model

    def tiny_model(model_seed, device):
        model = build(model_seed, device)
        model.load_state_dict(state, strict=True)
        return model

    monkeypatch.setattr(bench, "tiny_model", tiny_model)
