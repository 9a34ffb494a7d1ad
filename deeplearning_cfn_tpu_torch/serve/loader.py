"""Experiment config → serving Engine on a device.

The port of ``deeplearning_cfn_tpu/serve/loader.py``: builds the model from
the preset (filling ``vocab_size``/``max_len`` as the JAX ``Seq2SeqTask``
does: ``data.vocab_size`` and ``max(data.seq_len, 64)``), loads its weights
and hands back a ready :class:`~.engine.Engine`. The weights come from a
committed JAX checkpoint of the experiment (``<workdir>/<preset>/ckpt``,
read with numpy through :mod:`..convert`) or, with ``allow_init``, from a
seeded init on the device with Flax's distributions.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple, Union

import torch

from ..config import ExperimentConfig
from ..convert import committed_steps, load_flax_checkpoint, params_from_flax
from ..models import build_model
from ..models.transformer_nmt import TransformerNMT, init_weights
from ..runtime.platform import resolve_device
from .engine import Engine


def _ckpt_dir(cfg: ExperimentConfig) -> str:
    """The JAX package's experiment layout (train/run.py)."""
    workdir = os.path.join(cfg.workdir, cfg.preset or cfg.model.name)
    return cfg.checkpoint.directory or os.path.join(workdir, "ckpt")


def build_nmt(cfg: ExperimentConfig, device: torch.device,
              attention_impl: Optional[str] = None) -> TransformerNMT:
    """The preset's model on ``device`` (weights uninitialized)."""
    dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" \
        else torch.float32
    kwargs = dict(cfg.model.kwargs)
    kwargs.setdefault("vocab_size", cfg.data.vocab_size)
    kwargs.setdefault("max_len", max(cfg.data.seq_len, 64))
    if attention_impl is not None:
        kwargs["attention_impl"] = attention_impl
    model = build_model(cfg.model.name, 0, dtype, device=device, **kwargs)
    if not isinstance(model, TransformerNMT):
        raise ValueError(
            f"model {cfg.model.name!r} is not an NMT encoder-decoder — "
            f"serve drives decode_step_at on the transformer_nmt family")
    return model


def load_engine(cfg: ExperimentConfig, *, capacity: int = 4,
                max_src_len: int = 0, queue_depth: int = 64,
                default_max_new_tokens: int = 64,
                length_penalty: Optional[float] = None,
                decode_window: int = 1,
                kv_block_size: int = 0, kv_blocks: int = 0,
                prefix_cache_size: int = 0,
                step: int = 0, allow_init: bool = False,
                device: Union[str, torch.device] = "gpu",
                attention_impl: Optional[str] = None,
                clock=time.monotonic, **later) -> Tuple[Engine, None, int]:
    """Build an Engine from an experiment config.

    Returns ``(engine, None, checkpoint_step)`` — the JAX loader's shape,
    whose second item is the tokenizer (not ported: requests arrive as
    token ids). ``checkpoint_step`` is -1 when ``allow_init`` served a
    seeded random init because no checkpoint was committed. ``device`` is
    ``"gpu"`` (the default; raises without a card) or ``"cpu"``. Engine
    options of later slices (``speculate_gamma``, ``radix_cache``, ...)
    are passed through ``later`` and raise ``NotImplementedError`` there.
    """
    dev = resolve_device(device)
    model = build_nmt(cfg, dev, attention_impl)
    ckpt_dir = _ckpt_dir(cfg)
    if committed_steps(ckpt_dir):
        flat, at_step = load_flax_checkpoint(ckpt_dir, step=step)
        model.load_state_dict(params_from_flax(flat), strict=True)
    elif allow_init:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.train.seed))
        init_weights(model, gen)
        at_step = -1
    else:
        raise FileNotFoundError(
            f"no committed checkpoint in {ckpt_dir} — train first, or "
            f"pass allow_init for a random-weights smoke engine")
    model.requires_grad_(False)
    engine = Engine(
        model, capacity=capacity,
        max_src_len=max_src_len or cfg.data.seq_len,
        queue_depth=queue_depth,
        default_max_new_tokens=default_max_new_tokens,
        length_penalty=cfg.eval.length_penalty
        if length_penalty is None else length_penalty,
        decode_window=decode_window,
        kv_block_size=kv_block_size, kv_blocks=kv_blocks,
        prefix_cache_size=prefix_cache_size, clock=clock, **later)
    engine.metrics.ckpt_load_retries = 0
    return engine, None, int(at_step)
