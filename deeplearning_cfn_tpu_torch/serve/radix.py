"""Radix token-prefix cache over decoder KV blocks.

SGLang-style RadixAttention adapted to the encoder–decoder NMT engine.
Decoder KV depends on the source through cross-attention at every layer,
so decoder blocks are shareable **only between requests with the same
unpadded source**; under greedy decoding the same source deterministically
produces the same token stream, so every cached generation is a valid
prefix of what a new same-source request *will* generate. The cache is
therefore a forest: one root per unpadded source tuple, whose descendants
each own one refcounted pool block (``block_size`` KV positions) plus the
token segment those positions hold. Determinism collapses each source's
subtree to a chain in practice (budget-truncated streams are prefixes of
EOS-terminated ones); the structure stays a general tree defensively and
lookups descend the most-recently-used child.

Sharing is at full-block granularity: only fully-written blocks of a
finished stream are inserted, so a resumed request re-decodes from the
last block boundary and shared blocks are never mutated in place — the
first divergent write (there is none under greedy determinism, but beam
forks reuse the same pool) lands in a freshly allocated tail block, the
same copy-on-write discipline the beam fork path established.

Pool accounting: the tree holds one allocator reference per node. Blocks
referenced *only* by the tree occupy the pool without backing any
admission commitment, so the engine calls :meth:`ensure_free` before
reserving peak blocks; it evicts least-recently-used unreferenced leaves
(deepest first) until ``committed + need + tree-exclusive <= usable``.
Eviction is tenant-aware: the requesting tenant's own cold leaves go
first (cause ``pressure``), cross-tenant LRU only as a last resort
(cause ``cross_tenant_pressure``), and blocks still referenced by a
running stream are never evicted at all — one tenant's cache pressure
cannot evict another tenant's hot pinned prefix.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .blockpool import BlockAllocator


class RadixNode:
    """One cached block: ``segment`` is the ``block_size`` tokens whose KV
    the pool block ``block`` holds. Roots carry ``block is None``."""

    __slots__ = ("segment", "block", "children", "parent", "last_used",
                 "tenant", "depth")

    def __init__(self, segment: Optional[Tuple[int, ...]],
                 block: Optional[int], parent: Optional["RadixNode"],
                 last_used: float, tenant: Optional[str]):
        self.segment = segment
        self.block = block
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.parent = parent
        self.last_used = last_used
        self.tenant = tenant
        self.depth = 0 if parent is None else parent.depth + 1


class RadixCache:
    """Forest of per-source block chains with LRU leaf eviction."""

    def __init__(self, block_size: int):
        if block_size <= 0:
            raise ValueError(
                f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self._roots: Dict[Tuple[int, ...], RadixNode] = {}
        self.evictions: Dict[str, int] = {}
        self.inserted_blocks = 0

    # -- introspection ----------------------------------------------------

    @property
    def node_count(self) -> int:
        """Cached block nodes (roots excluded — they own no block)."""
        return sum(1 for _ in self._iter_nodes())

    @property
    def block_count(self) -> int:
        """Pool blocks the tree holds a reference on (== node_count)."""
        return self.node_count

    @property
    def source_count(self) -> int:
        return len(self._roots)

    def _iter_nodes(self):
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.block is not None:
                yield node

    def tree_exclusive_blocks(self, allocator: BlockAllocator) -> int:
        """Blocks held only by the tree (refcount 1): pool occupancy not
        covered by any admission commitment — the quantity
        :meth:`ensure_free` keeps bounded."""
        return sum(1 for n in self._iter_nodes()
                   if allocator.refcount(n.block) == 1)

    # -- lookup / insert --------------------------------------------------

    def lookup(self, src_key: Tuple[int, ...],
               now: float) -> Tuple[List[int], List[int]]:
        """Deepest cached chain for ``src_key``: ``(tokens, blocks)`` with
        ``len(tokens) == block_size * len(blocks)``; empty on a miss. The
        whole matched path is LRU-touched (ties to multiple children are
        broken most-recently-used)."""
        root = self._roots.get(src_key)
        if root is None:
            return [], []
        tokens: List[int] = []
        blocks: List[int] = []
        node = root
        while node.children:
            node = max(node.children.values(), key=lambda c: c.last_used)
            tokens.extend(node.segment)
            blocks.append(node.block)
            node.last_used = now
        return tokens, blocks

    def insert(self, src_key: Tuple[int, ...], tokens: List[int],
               blocks: List[int], allocator: BlockAllocator, now: float,
               tenant: Optional[str] = None) -> int:
        """Record a finished stream's fully-written prefix blocks.

        ``blocks[d]`` must hold the KV of ``tokens[d*bs:(d+1)*bs]``. Each
        *new* node takes an allocator reference on its block (released on
        eviction/reset); segments already present are only LRU-touched —
        a concurrent same-source finisher's duplicate blocks stay owned
        by (and are freed with) that finisher. Returns nodes created."""
        bs = self.block_size
        node = self._roots.get(src_key)
        if node is None:
            node = RadixNode(None, None, None, now, tenant)
            self._roots[src_key] = node
        created = 0
        for d, block in enumerate(blocks):
            seg = tuple(int(t) for t in tokens[d * bs:(d + 1) * bs])
            child = node.children.get(seg)
            if child is None:
                allocator.ref(block)
                child = RadixNode(seg, block, node, now, tenant)
                node.children[seg] = child
                created += 1
                self.inserted_blocks += 1
            child.last_used = now
            node = child
        return created

    # -- eviction ----------------------------------------------------------

    def _evictable_leaves(self, allocator: BlockAllocator) -> List[RadixNode]:
        return [n for n in self._iter_nodes()
                if not n.children and allocator.refcount(n.block) == 1]

    def _evict_node(self, node: RadixNode, allocator: BlockAllocator,
                    cause: str) -> None:
        allocator.free(node.block)
        parent = node.parent
        del parent.children[node.segment]
        node.parent = None
        self.evictions[cause] = self.evictions.get(cause, 0) + 1
        # Drop roots that no longer lead anywhere.
        while parent is not None and parent.block is None \
                and not parent.children:
            for key, root in list(self._roots.items()):
                if root is parent:
                    del self._roots[key]
                    break
            parent = None

    def ensure_free(self, allocator: BlockAllocator, need: int,
                    tenant: Optional[str] = None) -> Dict[str, int]:
        """Evict cold tree-exclusive leaves until a ``need``-block
        commitment fits beside the tree's uncommitted pool occupancy
        (``committed + need + tree-exclusive <= usable``). Requesting
        tenant's leaves first (LRU, deepest first), then cross-tenant
        LRU; blocks referenced by running streams are never touched.
        Returns evictions performed this call, by cause."""
        evicted: Dict[str, int] = {}
        while (allocator.committed_blocks + need
                + self.tree_exclusive_blocks(allocator)
                > allocator.usable_blocks):
            leaves = self._evictable_leaves(allocator)
            if not leaves:
                break
            own = [n for n in leaves if n.tenant == tenant]
            pool = own or leaves
            victim = min(pool, key=lambda n: (n.last_used, -n.depth))
            cause = "pressure" if (own or victim.tenant == tenant) \
                else "cross_tenant_pressure"
            self._evict_node(victim, allocator, cause)
            evicted[cause] = evicted.get(cause, 0) + 1
        return evicted

    def reset(self, allocator: BlockAllocator) -> int:
        """Drop every cached block (weight swap / bench sweep boundary).
        Tree references are released; blocks shared with still-running
        streams survive until those streams retire."""
        dropped = 0
        for node in list(self._iter_nodes()):
            allocator.free(node.block)
            dropped += 1
        self._roots.clear()
        if dropped:
            self.evictions["reset"] = \
                self.evictions.get("reset", 0) + dropped
        return dropped
