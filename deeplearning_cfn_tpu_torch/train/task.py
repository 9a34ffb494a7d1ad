"""Task definitions: glue a model into the Trainer's loss_fn contract — the
port of ``deeplearning_cfn_tpu/train/task.py`` for the NMT and ResNet
workloads.

A task owns its model and gives the trainer
``loss_fn(batch, train, generator) -> (loss, aux)``: a global-batch mean loss
and a dict of scalar metrics (on eval, ``eval_weight`` too). The other
families' tasks (ViT classification, MLM, causal LM, detection) belong to
ROADMAP A.9 and A.11.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..models import build_model

Batch = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Per-position cross-entropy in f32, with optax's label smoothing: the
    true class gets ``1 − s`` and every other class ``s / (V − 1)``. (That
    is not ``F.cross_entropy(label_smoothing=s)``, which spreads ``s / V``
    over every class, the true one included.) Computed as
    ``−(on − off)·logp[label] − off·Σ logp`` without building the one-hot."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None]).squeeze(-1)
    if smoothing > 0:
        num_classes = logits.shape[-1]
        on = 1.0 - smoothing
        off = smoothing / (num_classes - 1)
        return (on - off) * nll - off * logp.sum(-1)
    return nll


def example_mask(batch: Batch, n: int) -> torch.Tensor:
    """Per-example validity [B]: the pipeline's eval-tail padding mask when
    present (drop_remainder=False), else all-ones."""
    mask = batch.get("eval_mask")
    if mask is None:
        device = next(iter(batch.values())).device
        return torch.ones((n,), dtype=torch.float32, device=device)
    return mask.float()


class Seq2SeqTask:
    """Transformer NMT (reference: Sockeye MXNet, dist_device_sync).

    Per-token label-smoothed cross-entropy, masked to real target positions,
    normalized by the batch's token count (Sockeye's per-token loss).
    """

    exact_eval = True

    def __init__(self, cfg: ExperimentConfig, device: torch.device,
                 attention_impl: Optional[str] = None):
        self.cfg = cfg
        self.device = device
        dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" \
            else torch.float32
        kwargs = dict(cfg.model.kwargs)
        kwargs.setdefault("vocab_size", cfg.data.vocab_size)
        kwargs.setdefault("max_len", max(cfg.data.seq_len, 64))
        if attention_impl is not None:
            kwargs["attention_impl"] = attention_impl
        self.model = build_model(cfg.model.name, 0, dtype, device=device,
                                 **kwargs)

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with Flax's distributions, on the model's device."""
        from ..models.transformer_nmt import init_weights

        init_weights(self.model, generator)

    def loss_fn(self, batch: Batch, train: bool,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = self.model(batch["src_ids"], batch["src_mask"],
                            batch["tgt_in_ids"], train=train,
                            generator=generator)
        ex_mask = example_mask(batch, batch["src_ids"].shape[0])
        mask = batch["tgt_mask"].float() * ex_mask[:, None]
        ce = cross_entropy(logits, batch["tgt_out_ids"],
                           self.cfg.train.label_smoothing)
        denom = torch.clamp(mask.sum(), min=1e-6)
        loss = (ce * mask).sum() / denom
        hits = (torch.argmax(logits, -1) == batch["tgt_out_ids"]).float()
        aux = {"token_accuracy": (hits * mask).sum() / denom}
        if not train:
            # Token-weighted: Sockeye's per-token loss convention.
            aux["eval_weight"] = mask.sum()
        return loss, aux

    def final_eval(self, state, eval_iter_fn: Callable[[], Iterator]
                   ) -> Dict[str, float]:
        """Decode the eval set with the KV-cached beam (or greedy,
        ``beam_size <= 1``) searcher and score corpus BLEU — the Sockeye
        workload's acceptance metric."""
        from ..data.pipeline import to_device
        from ..metrics.bleu import corpus_bleu
        from ..models.decoding import (beam_decode_cached,
                                       greedy_decode_cached, strip_special)

        ev = self.cfg.eval
        if not ev.enabled:
            return {}
        if not ev.use_kv_cache:
            raise NotImplementedError(
                "eval.use_kv_cache=false needs the recompute-mode searchers, "
                "not ported yet (ROADMAP A.4)")
        max_len = ev.max_decode_len or self.cfg.data.seq_len
        if max_len > self.model.max_len:
            raise ValueError(
                f"eval decode length {max_len} exceeds the model's "
                f"max_len {self.model.max_len}")
        hyps, refs = [], []
        with state.eval_weights() as model:
            for batch in eval_iter_fn():
                dev = to_device(batch, self.device)
                if ev.beam_size <= 1:
                    out = greedy_decode_cached(model, dev["src_ids"],
                                               dev["src_mask"], max_len)
                else:
                    out, _ = beam_decode_cached(
                        model, dev["src_ids"], dev["src_mask"], max_len,
                        ev.beam_size, ev.length_penalty)
                out = out.cpu().numpy()
                tgt = np.asarray(batch["tgt_out_ids"])
                emask = batch.get("eval_mask")
                for i in range(out.shape[0]):
                    if emask is not None and emask[i] == 0:
                        continue
                    hyps.append(strip_special(out[i]))
                    refs.append(strip_special(tgt[i]))
        return {"bleu": corpus_bleu(hyps, refs, smooth=True)}


class ClassificationTask:
    """Image classification (CIFAR ResNet-20, ImageNet ResNet-50).

    Batch contract: ``{"image": [B,H,W,C] float32, "label": [B] int}``.
    The model's BatchNorm running statistics are buffers, not parameters:
    a train-mode forward updates them (in microbatch order under gradient
    accumulation, as the JAX step threads ``batch_stats``), an eval-mode
    forward reads them, and the parameters' EMA does not cover them.
    """

    exact_eval = True  # consumes eval_mask; gets the padded full eval set

    def __init__(self, cfg: ExperimentConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        if cfg.model.name.startswith("vit"):
            raise NotImplementedError(
                f"model {cfg.model.name!r}: ViT's stats-free classification "
                f"path is not ported yet (ROADMAP A.9)")
        dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" \
            else torch.float32
        self.model = build_model(cfg.model.name, cfg.model.num_classes,
                                 dtype, device=device, **cfg.model.kwargs)

    def init(self, generator: torch.Generator) -> None:
        """Seeded init with Flax's distributions, on the model's device."""
        from ..models.resnet import init_weights

        init_weights(self.model, generator)

    def loss_fn(self, batch: Batch, train: bool,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        del generator  # no dropout in the ResNets
        logits = self.model(batch["image"], train=train)
        labels = batch["label"]
        mask = example_mask(batch, logits.shape[0])
        denom = torch.clamp(mask.sum(), min=1e-6)
        ce = cross_entropy(logits, labels, self.cfg.train.label_smoothing)
        loss = (ce * mask).sum() / denom
        correct = (torch.argmax(logits, -1) == labels).float()
        aux = {"accuracy": (correct * mask).sum() / denom}
        if not train:
            # Top-5 by a rank comparison (one reduction, no sort): the
            # label is in the top 5 when fewer than 5 logits beat it.
            label_logit = logits.gather(-1, labels.long()[:, None])
            rank = (logits > label_logit).sum(-1)
            aux["accuracy_top5"] = ((rank < 5).float() * mask).sum() / denom
            aux["eval_weight"] = mask.sum()
        return loss, aux


def build_task(cfg: ExperimentConfig, device: torch.device,
               attention_impl: Optional[str] = None):
    """Task registry keyed by model family (the NMT and ResNet families are
    ported)."""
    name = cfg.model.name
    if name.startswith("transformer_nmt"):
        return Seq2SeqTask(cfg, device, attention_impl)
    if name.startswith(("resnet", "vit")):
        return ClassificationTask(cfg, device)
    raise NotImplementedError(
        f"no task for model {name!r} in the port yet (ROADMAP A.9: "
        f"BERT/GPT/ViT, A.11: Mask R-CNN)")
