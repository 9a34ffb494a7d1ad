"""NMT text source — the part of ``deeplearning_cfn_tpu/data/text.py`` the
NMT training slice needs, copied (numpy only) so the port never imports the
JAX package.

- **Real data**: ``<data_dir>/{train,eval}.npz`` holding the NMT arrays
  (``src_ids``, ``src_mask``, ``tgt_in_ids``, ``tgt_out_ids``,
  ``tgt_mask``) — the files the JAX package's ``prepare_nmt_text`` writes.
- **Synthetic**: a deterministic, *learnable* seq2seq task (the target is the
  reversed source plus a fixed offset), the same arrays from the same seeds
  as the JAX package, so both packages train on identical batches.

Special ids: 0=[PAD], 1=[BOS], 2=[EOS]. The MLM and LM sources belong to the
slices that port BERT and the GPT family (ROADMAP A.9).
"""

from __future__ import annotations

import os

import numpy as np

from ..config import DataConfig
from .pipeline import ArraySource

_NMT_KEYS = ("src_ids", "src_mask", "tgt_in_ids", "tgt_out_ids", "tgt_mask")


def make_nmt_source(num_examples: int, seq_len: int, vocab_size: int,
                    seed: int) -> ArraySource:
    """Seq2seq pairs where the target is a deterministic transform of the
    source (reverse + fixed offset) — a transformer-base learns it to
    near-zero loss, giving convergence tests real signal."""
    rng = np.random.RandomState(seed)
    reserved = 3
    usable = vocab_size - reserved
    lengths = rng.randint(max(2, seq_len // 2), seq_len - 1, num_examples)

    src_ids = np.zeros((num_examples, seq_len), np.int32)
    src_mask = np.zeros((num_examples, seq_len), np.int32)
    tgt_in = np.zeros((num_examples, seq_len), np.int32)
    tgt_out = np.zeros((num_examples, seq_len), np.int32)
    tgt_mask = np.zeros((num_examples, seq_len), np.float32)
    for i in range(num_examples):
        n = lengths[i]
        src = rng.randint(0, usable, n)
        tgt = (src[::-1] + 7) % usable
        src_ids[i, :n] = src + reserved
        src_ids[i, n] = 2  # EOS
        src_mask[i, :n + 1] = 1
        tgt_in[i, 0] = 1  # BOS
        tgt_in[i, 1:n + 1] = tgt + reserved
        tgt_out[i, :n] = tgt + reserved
        tgt_out[i, n] = 2  # EOS
        tgt_mask[i, :n + 1] = 1.0
    return ArraySource({
        "src_ids": src_ids, "src_mask": src_mask, "tgt_in_ids": tgt_in,
        "tgt_out_ids": tgt_out, "tgt_mask": tgt_mask,
    })


def _load_npz_dir(data_dir: str, split: str, keys) -> ArraySource:
    """Real-data path: ``<data_dir>/<split>.npz`` holding the listed keys."""
    path = os.path.join(data_dir, f"{split}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found; expected an .npz with keys {list(keys)}"
        )
    with np.load(path) as z:
        missing = [k for k in keys if k not in z]
        if missing:
            raise KeyError(f"{path} missing keys {missing}")
        return ArraySource({k: np.asarray(z[k]) for k in keys})


def build_text_source(cfg: DataConfig, train: bool) -> ArraySource:
    """The ``wmt_en_de`` source of one split: the npz files under
    ``data.data_dir`` or, without one, the synthetic task (4096 train
    examples and max(256, n/8) eval examples unless overridden)."""
    if cfg.name != "wmt_en_de":
        raise NotImplementedError(
            f"text dataset {cfg.name!r} is not ported yet (ROADMAP A.9: "
            f"BERT and the GPT family bring wikipedia_mlm and lm_text)")
    split = "train" if train else "eval"
    if cfg.data_dir and not cfg.synthetic:
        return _load_npz_dir(cfg.data_dir, split, _NMT_KEYS)
    n = cfg.num_train_examples or 4096
    if not train:
        n = cfg.num_eval_examples or max(256, n // 8)
    seed = 41 if train else 43
    return make_nmt_source(n, cfg.seq_len, cfg.vocab_size, seed)
