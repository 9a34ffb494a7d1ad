"""Encoder prefix cache: skip re-encoding sources seen recently.

NMT serving traffic repeats sources (retries, fan-out to multiple decode
configs, popular sentences), and the engine re-ran the full encoder stack
for every admission. This is a small host-side LRU over encoder outputs,
keyed on the **unpadded source-token tuple** (trailing PAD stripped), so
identical prompts arriving at different pad widths hit the same entry.
Encoder padding invariance guarantees the padded-width [S, H] value is
the same rows beyond pad either way, so a hit is bit-identical to
re-encoding (see docs/SERVING.md).

In the port the values are encoder output rows ([S, H] tensors) kept on
the engine's device, so a hit costs no host round trip. The engine owns the
metrics mirror (ServeMetrics ``serve_prefix_*``); this class just counts.
"""

from __future__ import annotations

import collections
from typing import Hashable, Optional, Sequence, Tuple


def unpadded_key(tokens: Sequence[int], pad_id: int) -> Tuple[int, ...]:
    """Canonical cache key: the token tuple with trailing padding
    stripped, so identical prompts arriving at different pad widths
    (explicitly padded or not, engines with different max_src_len)
    collide on the same entry. Interior padding is preserved — only the
    trailing run is cosmetic."""
    n = len(tokens)
    while n > 0 and int(tokens[n - 1]) == pad_id:
        n -= 1
    return tuple(int(t) for t in tokens[:n])


class PrefixCache:
    """Bounded LRU of encoder outputs, keyed on padded source tuples."""

    def __init__(self, max_entries: int):
        if max_entries <= 0:
            raise ValueError(
                f"max_entries must be positive, got {max_entries}")
        self.max_entries = max_entries
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def get(self, key: Hashable):
        """Cached value or None; counts the lookup and refreshes LRU."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def put(self, key: Hashable, value) -> int:
        """Insert (or refresh) an entry; returns how many were evicted."""
        self._entries[key] = value
        self._entries.move_to_end(key)
        evicted = 0
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            evicted += 1
        self.evictions += evicted
        return evicted

    @property
    def hit_rate(self) -> Optional[float]:
        lookups = self.hits + self.misses
        if lookups == 0:
            return None
        return self.hits / lookups
