"""Offline byte-level BPE: train, encode, decode, vocab files — a copy of
``deeplearning_cfn_tpu/data/bpe.py`` (pure Python), so the port never
imports the JAX package. ``cli generate --vocab`` encodes its prompt and
decodes its continuation with it.

- **Byte-level base**: the initial alphabet is the 256 byte values, so any
  input encodes with zero OOV.
- **Whitespace pre-tokenization with a space end-of-word marker**: each
  word is its bytes plus one trailing space byte; merges never cross word
  boundaries. Decoding concatenates token bytes, so whitespace runs come
  back as single spaces.
- **Deterministic training**: ties in pair frequency break on the pair's
  byte strings (lexicographic), so the same corpus and vocab size give the
  same merge table as the JAX package's.
- **Reserved specials first**: ids [0, reserved) are the task's special
  tokens, ids [reserved, reserved+256) the raw bytes, merge products follow.

Vocab file: JSON {"reserved": [names...], "merges": [[hexA, hexB], ...]}.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

MLM_SPECIALS = ("[PAD]", "[CLS]", "[SEP]", "[MASK]")
NMT_SPECIALS = ("[PAD]", "[BOS]", "[EOS]")


def _words(lines: Iterable[str]) -> Counter:
    """Corpus → {word bytes (incl. trailing space): count}."""
    counts: Counter = Counter()
    for line in lines:
        for w in line.split():
            counts[w.encode("utf-8") + b" "] += 1
    return counts


class Bpe:
    """A trained BPE: merge table + id mapping, encode/decode."""

    def __init__(self, merges: Sequence[Tuple[bytes, bytes]],
                 specials: Sequence[str]):
        self.specials = tuple(specials)
        self.merges = [tuple(m) for m in merges]
        self.rank = {m: i for i, m in enumerate(self.merges)}
        r = len(self.specials)
        # id table: specials, the 256 bytes, then merge products in order.
        self.id_of: Dict[bytes, int] = {
            bytes([b]): r + b for b in range(256)}
        for i, (a, b) in enumerate(self.merges):
            self.id_of[a + b] = r + 256 + i
        self.bytes_of: Dict[int, bytes] = {
            v: k for k, v in self.id_of.items()}
        self._cache: Dict[bytes, List[int]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.specials) + 256 + len(self.merges)

    # -- encode/decode ------------------------------------------------------

    def _encode_word(self, word: bytes) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = [bytes([b]) for b in word]
        # Classic BPE encode: repeatedly apply the lowest-rank adjacent
        # merge until none applies.
        while len(syms) > 1:
            best_i, best_r = -1, len(self.rank)
            for i in range(len(syms) - 1):
                r = self.rank.get((syms[i], syms[i + 1]), best_r)
                if r < best_r:
                    best_i, best_r = i, r
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        ids = [self.id_of[s] for s in syms]
        if len(self._cache) < 1_000_000:
            self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """Text → token ids (no specials added — callers own framing)."""
        out: List[int] = []
        for w in text.split():
            out.extend(self._encode_word(w.encode("utf-8") + b" "))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        """Token ids → text. Special ids render as their bracketed names;
        unknown ids are skipped. Trailing word-space is stripped."""
        parts: List[bytes] = []
        for i in ids:
            i = int(i)
            if 0 <= i < len(self.specials):
                parts.append(b" " + self.specials[i].encode() + b" ")
            elif i in self.bytes_of:
                parts.append(self.bytes_of[i])
        return b"".join(parts).decode("utf-8", "replace").strip()

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "reserved": list(self.specials),
                "merges": [[a.hex(), b.hex()] for a, b in self.merges],
            }, f)

    @classmethod
    def load(cls, path: str) -> "Bpe":
        with open(path) as f:
            d = json.load(f)
        merges = [(bytes.fromhex(a), bytes.fromhex(b))
                  for a, b in d["merges"]]
        return cls(merges, d["reserved"])


def train_bpe(lines: Iterable[str], vocab_size: int,
              specials: Sequence[str] = MLM_SPECIALS) -> Bpe:
    """Train a byte-level BPE to ``vocab_size`` total ids (specials + 256
    bytes + merges). Deterministic: most-frequent pair first, frequency
    ties broken lexicographically on the pair's bytes.

    Incremental: pair counts are maintained exactly across merges and each
    merge rescans only the unique words indexed as containing the merged
    pair — O(corpus + merges·affected), not O(merges·corpus), which is the
    difference between minutes and days at the default vocab 8192 on a
    real Wikipedia-scale corpus.
    """
    n_merges = vocab_size - len(specials) - 256
    if n_merges < 0:
        raise ValueError(
            f"vocab_size={vocab_size} smaller than the "
            f"{len(specials)}+256 reserved+byte base")
    word_counts = _words(lines)
    # Working state: per unique word, its current symbol list + count.
    words: List[Tuple[List[bytes], int]] = [
        ([bytes([b]) for b in w], c) for w, c in word_counts.items()]

    pair_counts: Counter = Counter()
    # pair → indices of words that contained it when last scanned. Entries
    # go stale when later merges rewrite a word; stale indices are handled
    # at use (re-scan finds no occurrence → net-zero update).
    pair_words: Dict[Tuple[bytes, bytes], set] = {}
    for wi, (syms, c) in enumerate(words):
        for i in range(len(syms) - 1):
            p = (syms[i], syms[i + 1])
            pair_counts[p] += c
            pair_words.setdefault(p, set()).add(wi)

    merges: List[Tuple[bytes, bytes]] = []
    for _ in range(n_merges):
        if not pair_counts:
            break
        best = min(pair_counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        if pair_counts[best] < 2:
            break  # nothing left worth merging
        merges.append(best)
        a, b = best
        ab = a + b
        # sorted() for determinism: the rewrite order doesn't affect counts
        # (each word's contribution is removed then re-added atomically),
        # but iterating a set would make any future tie-sensitive change
        # platform-dependent.
        for wi in sorted(pair_words.pop(best, ())):
            syms, c = words[wi]
            if len(syms) < 2:
                continue
            # Remove this word's contribution entirely, rewrite, re-add —
            # exact counts even for overlapping repeats (e.g. b"aaa").
            for i in range(len(syms) - 1):
                p = (syms[i], syms[i + 1])
                pair_counts[p] -= c
                if pair_counts[p] <= 0:
                    del pair_counts[p]
            i = 0
            while i < len(syms) - 1:
                if syms[i] == a and syms[i + 1] == b:
                    syms[i:i + 2] = [ab]
                else:
                    i += 1
            for i in range(len(syms) - 1):
                p = (syms[i], syms[i + 1])
                pair_counts[p] += c
                pair_words.setdefault(p, set()).add(wi)
    return Bpe(merges, specials)
