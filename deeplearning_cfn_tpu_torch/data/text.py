"""Text sources — the NMT, BERT (MLM+NSP) and causal-LM parts of
``deeplearning_cfn_tpu/data/text.py``, copied (numpy only) so the port never
imports the JAX package.

- **Real data**: ``<data_dir>/{train,eval}.npz`` holding the arrays of the
  dataset — for ``wmt_en_de`` ``src_ids``, ``src_mask``, ``tgt_in_ids``,
  ``tgt_out_ids``, ``tgt_mask`` (the files the JAX package's
  ``prepare_nmt_text`` writes), for ``wikipedia_mlm`` the MLM contract below,
  for ``lm_text`` ``tokens`` and ``loss_mask`` (the files
  :func:`prepare_lm_text` writes).
- **Synthetic**: deterministic, *learnable* generators, the same arrays from
  the same seeds as the JAX package, so both packages train on identical
  batches: a seq2seq task (the target is the reversed source plus a fixed
  offset), pre-masked MLM+NSP examples and next-token sequences over a fixed
  Markov chain.

NMT ids: 0=[PAD], 1=[BOS], 2=[EOS]. MLM ids: 0=[PAD], 1=[CLS], 2=[SEP],
3=[MASK]; the MLM batch is ``input_ids``, ``input_mask``, ``segment_ids``
[N, S], ``mlm_positions``, ``mlm_ids``, ``mlm_weights`` [N, P] with
P = 0.2·S, and ``nsp_label`` [N]. The LM batch is ``tokens`` [N, S+1] and
``loss_mask`` [N, S]; the byte tokenizer shifts byte values past 4
reserved ids.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..config import DataConfig
from .pipeline import ArraySource

_MLM_KEYS = ("input_ids", "input_mask", "segment_ids", "mlm_positions",
             "mlm_ids", "mlm_weights", "nsp_label")
_NMT_KEYS = ("src_ids", "src_mask", "tgt_in_ids", "tgt_out_ids", "tgt_mask")
_LM_KEYS = ("tokens", "loss_mask")

MASK_RATE = 0.15
MAX_PRED_FRACTION = 0.2  # max_predictions_per_seq = fraction * seq_len


def _markov_tokens(rng: np.random.RandomState, n: int, seq_len: int,
                   vocab: int, reserved: int = 4) -> np.ndarray:
    """Token sequences from a sparse, fixed-transition Markov chain over the
    non-reserved vocab — structured enough that an MLM head can beat unigram
    entropy within a few hundred CPU steps."""
    usable = vocab - reserved
    # Each state deterministically prefers 2 successors (chosen per-seed).
    succ = np.stack([
        (np.arange(usable) * 7 + 3) % usable,
        (np.arange(usable) * 11 + 5) % usable,
    ], axis=1)
    tokens = np.empty((n, seq_len), np.int32)
    state = rng.randint(0, usable, n)
    for t in range(seq_len):
        tokens[:, t] = state + reserved
        pick = succ[state, rng.randint(0, 2, n)]
        noise = rng.rand(n) < 0.05
        state = np.where(noise, rng.randint(0, usable, n), pick)
    return tokens


def _build_mlm_examples(tokens: np.ndarray, vocab_size: int,
                        rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """Frame content token windows ``[N, seq_len-2]`` into the pre-masked
    MLM+NSP example contract (shared by the synthetic Markov source and the
    real-corpus BPE converter).

    Special ids: 0=[PAD], 1=[CLS], 2=[SEP], 3=[MASK].
    """
    num_examples, content = tokens.shape
    seq_len = content + 2
    max_pred = max(1, int(seq_len * MAX_PRED_FRACTION))

    input_ids = np.zeros((num_examples, seq_len), np.int32)
    input_ids[:, 0] = 1  # [CLS]
    input_ids[:, 1:-1] = tokens
    input_ids[:, -1] = 2  # [SEP]
    input_mask = np.ones((num_examples, seq_len), np.int32)
    # Two "segments" split at a random midpoint; NSP label = whether the
    # second half was swapped with another example's (learnable because
    # swapped halves break the Markov transitions at the boundary).
    split = seq_len // 2
    segment_ids = np.zeros((num_examples, seq_len), np.int32)
    segment_ids[:, split:] = 1
    nsp_label = rng.randint(0, 2, num_examples).astype(np.int32)
    swap = np.where(nsp_label == 1)[0]
    if len(swap) > 1:
        input_ids[swap[:, None], np.arange(split, seq_len)[None, :]] = \
            input_ids[np.roll(swap, 1)[:, None],
                      np.arange(split, seq_len)[None, :]]
    else:
        # A lone positive can't swap with anyone — relabel it negative
        # rather than train NSP on a contiguous "swapped" example.
        nsp_label[swap] = 0

    mlm_positions = np.zeros((num_examples, max_pred), np.int32)
    mlm_ids = np.zeros((num_examples, max_pred), np.int32)
    mlm_weights = np.zeros((num_examples, max_pred), np.float32)
    n_mask = max(1, int((seq_len - 2) * MASK_RATE))
    n_mask = min(n_mask, max_pred)
    for i in range(num_examples):
        pos = rng.choice(np.arange(1, seq_len - 1), n_mask, replace=False)
        pos.sort()
        mlm_positions[i, :n_mask] = pos
        mlm_ids[i, :n_mask] = input_ids[i, pos]
        mlm_weights[i, :n_mask] = 1.0
        # 80% [MASK], 10% random, 10% keep — the BERT masking recipe.
        r = rng.rand(n_mask)
        masked = input_ids[i, pos].copy()
        masked[r < 0.8] = 3
        rand_sel = (r >= 0.8) & (r < 0.9)
        masked[rand_sel] = rng.randint(4, vocab_size, rand_sel.sum())
        input_ids[i, pos] = masked

    return {
        "input_ids": input_ids, "input_mask": input_mask,
        "segment_ids": segment_ids, "mlm_positions": mlm_positions,
        "mlm_ids": mlm_ids, "mlm_weights": mlm_weights,
        "nsp_label": nsp_label,
    }


def make_mlm_source(num_examples: int, seq_len: int, vocab_size: int,
                    seed: int) -> ArraySource:
    """Pre-masked MLM+NSP examples (the reference pipeline also pre-masked
    offline via create_pretraining_data.py), from the synthetic Markov
    chain. Framing/masking shared with the real-corpus path
    (``_build_mlm_examples``)."""
    rng = np.random.RandomState(seed)
    tokens = _markov_tokens(rng, num_examples, seq_len - 2, vocab_size)
    return ArraySource(_build_mlm_examples(tokens, vocab_size, rng))


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


def make_lm_source(num_examples: int, seq_len: int, vocab_size: int,
                   seed: int) -> ArraySource:
    """Causal-LM examples: ``tokens [N, seq_len+1]`` (the model reads
    tokens[:, :-1] and predicts tokens[:, 1:]) and ``loss_mask [N, seq_len]``
    over the predicted positions. The tokens follow the MLM source's fixed
    Markov chain, so next-token loss falls fast below unigram entropy."""
    rng = np.random.RandomState(seed)
    tokens = _markov_tokens(rng, num_examples, seq_len + 1, vocab_size)
    return ArraySource({
        "tokens": tokens.astype(np.int32),
        "loss_mask": np.ones((num_examples, seq_len), np.float32),
    })


def prepare_lm_text(src_path: str, out_dir: str, seq_len: int,
                    eval_fraction: float = 0.05) -> Dict[str, int]:
    """Tokenize a raw text/bytes file into the ``lm_text`` npz files: byte
    values shifted past the 4 reserved ids (``data.vocab_size=260``), cut
    into non-overlapping ``seq_len + 1`` windows, the last
    ``eval_fraction`` of them (at least one) as ``eval.npz`` and the rest
    as ``train.npz`` under ``out_dir``. Returns the counts."""
    if not 0.0 < eval_fraction < 1.0:
        raise ValueError(
            f"eval_fraction must be in (0, 1), got {eval_fraction}")
    with open(src_path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    window = seq_len + 1
    n = len(raw) // window
    if n < 2:
        raise ValueError(
            f"{src_path}: need at least {2 * window} bytes for one train "
            f"and one eval window of seq_len+1={window}, got {len(raw)}")
    tokens = raw[:n * window].reshape(n, window).astype(np.int32) + 4
    n_eval = min(max(1, int(n * eval_fraction)), n - 1)
    os.makedirs(out_dir, exist_ok=True)
    splits = {"train": tokens[:-n_eval], "eval": tokens[-n_eval:]}
    for split, toks in splits.items():
        np.savez(os.path.join(out_dir, f"{split}.npz"), tokens=toks,
                 loss_mask=np.ones((len(toks), seq_len), np.float32))
    return {"train_examples": n - n_eval, "eval_examples": n_eval,
            "vocab_size": 260, "seq_len": seq_len}


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
    """The ``wmt_en_de``, ``wikipedia_mlm`` or ``lm_text`` source of one
    split: the npz files under ``data.data_dir`` or, without one, the
    synthetic data (4096 train examples and max(256, n/8) eval examples
    unless overridden; seeds 41 and 43)."""
    keys = {"wikipedia_mlm": _MLM_KEYS, "wmt_en_de": _NMT_KEYS,
            "lm_text": _LM_KEYS}.get(cfg.name)
    if keys is None:
        raise KeyError(f"unknown text dataset {cfg.name!r}")
    split = "train" if train else "eval"
    if cfg.data_dir and not cfg.synthetic:
        return _load_npz_dir(cfg.data_dir, split, keys)
    n = cfg.num_train_examples or 4096
    if not train:
        n = cfg.num_eval_examples or max(256, n // 8)
    seed = 41 if train else 43
    if cfg.name == "wikipedia_mlm":
        return make_mlm_source(n, cfg.seq_len, cfg.vocab_size, seed)
    if cfg.name == "lm_text":
        return make_lm_source(n, cfg.seq_len, cfg.vocab_size, seed)
    return make_nmt_source(n, cfg.seq_len, cfg.vocab_size, seed)
