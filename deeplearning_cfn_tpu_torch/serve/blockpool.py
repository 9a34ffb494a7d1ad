"""Host-side KV block allocator for the paged serving cache.

The paged engine (serve/engine.py ``kv_block_size > 0``) replaces one dense
[capacity, H, max_len, D] KV row per slot with a shared pool
[num_blocks, H, block_size, D]; this module is the host bookkeeping that
hands pool blocks to rows as their decode position crosses block
boundaries — the vLLM/PagedAttention allocator, sized for this engine:

- **Block 0 is the null sentinel.** It is never handed out; unbound block-
  table entries point at it, so writes from idle or finished rows land
  there harmlessly (the step bias masks everything above a row's position,
  so null-block garbage is never attended).
- **Refcounted blocks.** Beam search shares fully-written prefix blocks
  between sibling beams (copy-on-write: only the partial tail block is
  physically copied on a fork), so a block is freed back to the pool only
  when its last referencing row releases it.
- **Commit-then-allocate.** Admission reserves a request's worst-case
  block count up front (:meth:`commit`); per-window :meth:`alloc` calls
  then draw from that reservation, which is what guarantees an admitted
  request can never hit pool exhaustion mid-flight. Exhaustion therefore
  surfaces exactly once, at the admission edge, as
  :class:`BlockPoolExhausted` — an :class:`~.queue.OverloadError`, never a
  silent budget clamp.
"""

from __future__ import annotations

from typing import Dict, List

from .queue import OverloadError


def is_pool_leaf(leaf, num_blocks: int) -> bool:
    """True for cache-tree leaves that are indexed by pool block id: the
    4-D [num_blocks, H, block_size, D] K/V pools themselves AND (with
    ``--kv-quant``) their 2-D [num_blocks, H] per-block scale sidecars.
    Every block-id-keyed operation — beam copy-on-write forks, handoff
    export/import — must move both together, or a forked/imported block's
    codes land under the wrong scale."""
    nd = getattr(leaf, "ndim", 0)
    if nd not in (2, 4):
        return False
    shape = getattr(leaf, "shape", ())
    return bool(shape) and shape[0] == num_blocks


class BlockPoolExhausted(OverloadError):
    """The KV block pool cannot cover a reservation or allocation.

    An :class:`OverloadError` so callers' backpressure handling (retry /
    shed) applies unchanged; ``depth``/``max_depth`` are expressed in
    blocks (committed vs usable).
    """

    def __init__(self, needed: int, available: int, total: int):
        # Skip OverloadError.__init__ — its message talks about the
        # request queue; attrs are kept shape-compatible.
        RuntimeError.__init__(
            self, f"KV block pool exhausted: need {needed} blocks, "
                  f"{available} of {total} usable blocks uncommitted")
        self.needed = needed
        self.available = available
        self.total = total
        self.depth = total - available
        self.max_depth = total
        self.retry_after_s = None


class BlockAllocator:
    """Fixed pool of ``num_blocks`` KV blocks of ``block_size`` positions.

    Not thread-safe by design: only the engine thread touches it, between
    device calls (the same discipline as the rest of the scheduler state).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (null sentinel + one usable), "
                f"got {num_blocks}")
        if block_size <= 0:
            raise ValueError(
                f"block_size must be positive, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # Block 0 is the null sentinel — never on the free list. Low ids
        # first purely for test determinism.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._committed = 0

    # -- accounting --------------------------------------------------------

    @property
    def usable_blocks(self) -> int:
        """Pool size minus the null sentinel."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.usable_blocks - len(self._free)

    @property
    def committed_blocks(self) -> int:
        return self._committed

    def blocks_for_tokens(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` KV positions (ceil)."""
        return -(-tokens // self.block_size)

    # -- admission reservation ---------------------------------------------

    def can_commit(self, n: int) -> bool:
        return self._committed + n <= self.usable_blocks

    def commit(self, n: int) -> None:
        """Reserve ``n`` blocks for a request being admitted. Because every
        running request stays within its reservation, ``alloc`` can never
        run dry while commitments are honored."""
        if not self.can_commit(n):
            raise BlockPoolExhausted(
                n, self.usable_blocks - self._committed, self.usable_blocks)
        self._committed += n

    def uncommit(self, n: int) -> None:
        if n > self._committed:
            raise ValueError(
                f"uncommit {n} exceeds committed {self._committed}")
        self._committed -= n

    # -- block lifecycle ---------------------------------------------------

    def alloc(self) -> int:
        """Hand out a free block (refcount 1). Never returns the null
        block. Raises :class:`BlockPoolExhausted` if the free list is
        empty — unreachable for callers that respect commit()."""
        if not self._free:
            raise BlockPoolExhausted(1, 0, self.usable_blocks)
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def ref(self, block: int) -> None:
        """Add a reference (beam prefix sharing)."""
        if block not in self._ref:
            raise ValueError(f"ref on unallocated block {block}")
        self._ref[block] += 1

    def free(self, block: int) -> None:
        """Drop a reference; the block returns to the pool at zero."""
        n = self._ref.get(block)
        if n is None:
            raise ValueError(f"free on unallocated block {block}")
        if n == 1:
            del self._ref[block]
            self._free.append(block)
        else:
            self._ref[block] = n - 1

    def is_allocated(self, block: int) -> bool:
        return block in self._ref

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def refcounts(self) -> Dict[int, int]:
        """Snapshot of live block refcounts (block id -> count). For
        conservation audits: after every stream retires, each remaining
        allocated block must be explained by exactly its holders (e.g.
        radix-tree nodes), and a full cache reset must empty this."""
        return dict(self._ref)
