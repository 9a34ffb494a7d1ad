"""Experiment config → serving Engine on a device.

The port of ``deeplearning_cfn_tpu/serve/loader.py``: builds the model from
the preset (filling ``vocab_size``/``max_len`` as the JAX ``Seq2SeqTask``
does: ``data.vocab_size`` and ``max(data.seq_len, 64)``), loads its weights
and hands back a ready :class:`~.engine.Engine`. The weights come from a
committed JAX checkpoint of the experiment (``<workdir>/<preset>/ckpt``,
read with numpy through :mod:`..convert`) or, with ``allow_init``, from a
seeded init on the device with Flax's distributions. A speculative draft
comes the same way from a second experiment, or from a committed distilled
draft (:data:`DRAFT_PRESETS`, the npz files under ``serve/data/``). The f32
restore stays canonical: ``quantize``/``kv_quant`` are the engine's (it
quantizes, and requantizes on every ``swap_variables``). ``vocab`` binds
the BPE tokenizer (``data/bpe.py``) that text requests need.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import ExperimentConfig
from ..convert import committed_steps, load_flax_checkpoint, params_from_flax
from ..data.bpe import Bpe
from ..models import build_model
from ..models.transformer_nmt import (TransformerNMT, init_weights,
                                      transformer_nmt_tiny)
from ..runtime.platform import resolve_device
from .engine import Engine

# Committed distilled drafts for speculative serving, keyed by the
# ``draft_cfg`` string: (model kwargs, npz file). The npz is a flat
# {"a/b/c": array} Flax params tree (the JAX package's
# tools/distill_draft.py). "tiny-distilled" was distilled against the
# random-init tiny teacher of the JAX package's serving bench
# (``transformer_nmt_tiny(vocab_size=96, max_len=64)``, seed 0).
DRAFT_PRESETS = {
    "tiny-distilled": (
        dict(vocab_size=96, max_len=64, hidden_size=32, num_layers=1,
             num_heads=2, mlp_dim=64),
        "draft_tiny_distilled.npz"),
}


def distilled_draft(name: str = "tiny-distilled",
                    device: Union[str, torch.device] = "gpu"
                    ) -> TransformerNMT:
    """A committed distilled draft with its weights, on ``device``, for
    the engine's ``draft_model``."""
    if name not in DRAFT_PRESETS:
        raise ValueError(
            f"unknown draft preset {name!r}; have {sorted(DRAFT_PRESETS)}")
    kwargs, fname = DRAFT_PRESETS[name]
    model = transformer_nmt_tiny(device=resolve_device(device), **kwargs)
    path = os.path.join(os.path.dirname(__file__), "data", fname)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    model.load_state_dict(params_from_flax(flat), strict=True)
    return model.requires_grad_(False)


def checkpoint_dir(cfg: ExperimentConfig) -> str:
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


def _restore(cfg: ExperimentConfig, device: torch.device,
             attention_impl: Optional[str], step: int, allow_init: bool,
             what: str) -> Tuple[TransformerNMT, int]:
    """The experiment's model with its committed checkpoint (``step``, 0 =
    latest), or with a seeded init under ``allow_init`` (step -1)."""
    model = build_nmt(cfg, device, attention_impl)
    ckpt_dir = checkpoint_dir(cfg)
    if committed_steps(ckpt_dir):
        flat, at_step = load_flax_checkpoint(ckpt_dir, step=step)
        model.load_state_dict(params_from_flax(flat), strict=True)
    elif allow_init:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(cfg.train.seed))
        init_weights(model, gen)
        at_step = -1
    else:
        raise FileNotFoundError(
            f"no committed {what}checkpoint in {ckpt_dir} — train first, or "
            f"pass allow_init for a random-weights smoke engine")
    return model.requires_grad_(False), int(at_step)


def load_engine(cfg: ExperimentConfig, *, capacity: int = 4,
                max_src_len: int = 0, queue_depth: int = 64,
                default_max_new_tokens: int = 64,
                length_penalty: Optional[float] = None,
                decode_window: int = 1,
                kv_block_size: int = 0, kv_blocks: int = 0,
                prefix_cache_size: int = 0,
                speculate_gamma: int = 0,
                speculate_device: bool = False,
                draft_cfg: Union[ExperimentConfig, str, None] = None,
                quantize: str = "",
                kv_quant: str = "",
                radix_cache: bool = False,
                phase: str = "both",
                prefill_chunk: int = 0,
                step: int = 0, vocab: str = "", allow_init: bool = False,
                device: Union[str, torch.device] = "gpu",
                attention_impl: Optional[str] = None,
                clock=time.monotonic
                ) -> Tuple[Engine, Optional[Bpe], int]:
    """Build an Engine from an experiment config.

    Returns ``(engine, bpe_or_None, checkpoint_step)`` as the JAX loader
    does: the BPE tokenizer loaded from ``vocab`` (a ``vocab.json``), or
    None without one. ``checkpoint_step`` is -1 when ``allow_init`` served a
    seeded random init because no checkpoint was committed. ``device`` is
    ``"gpu"`` (the default; raises without a card) or ``"cpu"``.

    ``speculate_gamma > 0`` turns on speculative decoding: with
    ``draft_cfg`` a second (shrunk) experiment sharing the target's vocab,
    restored the same way (seeded init under ``allow_init``), or a
    :data:`DRAFT_PRESETS` name; without one the engine self-drafts.
    ``speculate_device`` chains the windows on the device. ``radix_cache``
    arms the radix prefix KV cache (needs ``kv_block_size > 0``);
    ``prefill_chunk > 0`` chunked prefill. ``quantize="int8"`` serves
    int8 weights (the engine quantizes the f32 restore); ``kv_quant="int8"``
    an int8 paged KV pool (needs ``kv_block_size > 0``). ``phase``
    (``"prefill"`` or ``"decode"``, paged only) builds one side of a
    disaggregated pair; the default ``"both"`` is the co-located engine.
    QoS classes are not taken here: the engine runs the default classes and
    turns QoS on at the first tenant-tagged submit.
    """
    dev = resolve_device(device)
    model, at_step = _restore(cfg, dev, attention_impl, step, allow_init,
                              "")
    draft_model = None
    if draft_cfg is not None:
        if speculate_gamma <= 0:
            raise ValueError("draft_cfg given but speculate_gamma is 0")
        if isinstance(draft_cfg, str):
            draft_model = distilled_draft(draft_cfg, dev)
        else:
            draft_model, _ = _restore(draft_cfg, dev, attention_impl, 0,
                                      allow_init, "draft ")
    bpe = Bpe.load(vocab) if vocab else None
    engine = Engine(
        model, capacity=capacity,
        max_src_len=max_src_len or cfg.data.seq_len,
        queue_depth=queue_depth,
        default_max_new_tokens=default_max_new_tokens,
        length_penalty=cfg.eval.length_penalty
        if length_penalty is None else length_penalty,
        decode_window=decode_window,
        kv_block_size=kv_block_size, kv_blocks=kv_blocks,
        prefix_cache_size=prefix_cache_size,
        speculate_gamma=speculate_gamma, speculate_device=speculate_device,
        draft_model=draft_model, quantize=quantize, kv_quant=kv_quant,
        radix_cache=radix_cache, phase=phase, prefill_chunk=prefill_chunk,
        clock=clock)
    engine.metrics.ckpt_load_retries = 0
    return engine, bpe, at_step
