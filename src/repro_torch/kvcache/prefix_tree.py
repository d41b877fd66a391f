"""Block-granular radix trie for KV prefix reuse.

The chained-hash prefix cache (``block_hash_chain``) already gives every
(prefix, block) pair a unique key: ``key_j`` covers *all* tokens up to
the end of block ``j``, so a flat ``key → block`` map answers point
lookups.  What the flat map cannot answer is *structural* questions —
which parked blocks are safe to evict without stranding cached
descendants, and how long a prefix chain has been cold.  The trie keeps
the same keys as node identities (point lookup stays O(1), a
longest-prefix walk over a prompt's key chain is O(L)) and adds the
parent/child structure on top:

* **Leaf-first LRU eviction.**  Evicting a parked interior node breaks
  the longest-prefix walk for every cached descendant (the walk stops at
  the first missing key), so those blocks keep pool space while being
  unreachable through prefix matching.  ``pop_eviction`` therefore
  prefers parked *leaves* (LRU among them) and falls back to the oldest
  parked node only when every parked node still has cached children
  (e.g. a parked parent under an in-use child).
* **TTL aging on a pluggable clock.**  Parked nodes carry their park
  timestamp; ``expired(ttl)`` returns everything parked longer than
  ``ttl`` clock units, deepest-first so chains unwind leaf-to-root.  The
  serving scheduler wires :meth:`set_clock` to its virtual token clock,
  so stale prefixes age out deterministically (same trace → same
  evictions) instead of squatting until free-list pressure.
* **Ref-count awareness by construction.**  Only *parked* (ref == 0)
  nodes appear in the eviction/TTL structures — the allocator parks a
  block exactly when its ref count drops to zero and revives it on the
  next reference, so an in-use block can never be evicted.

The trie never touches device memory: it is host-side bookkeeping owned
by :class:`~repro_torch.kvcache.paged.BlockAllocator`, and the eviction log it
feeds (``BlockAllocator.take_evicted``) is what a host-DRAM offload tier
consumes (not ported yet: ROADMAP Queue 1 item 8).

A copy of ``repro.kvcache.prefix_tree`` (standard library only).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable

__all__ = ["PrefixTree", "TrieNode"]


@dataclasses.dataclass
class TrieNode:
    """One cached block: a node of the radix trie.

    ``key`` is the chained content hash identifying the whole prefix up
    to this block (the ``block_hash_chain`` key), ``bid`` the physical
    pool block holding its K/V rows.  ``parent`` is None for children of
    the root (legacy two-arg ``register`` calls land there and behave
    exactly like the flat chained-hash map).  ``parked_at`` is the clock
    reading when the block's ref count dropped to zero — None while the
    block is referenced.
    """

    key: int
    bid: int
    parent: "TrieNode | None" = None
    children: dict[int, "TrieNode"] = dataclasses.field(default_factory=dict)
    parked_at: float | None = None
    last_use: float = 0.0

    @property
    def parent_key(self) -> int | None:
        return None if self.parent is None else self.parent.key

    def is_leaf(self) -> bool:
        return not self.children


class PrefixTree:
    """Radix trie over chained block-hash keys.

    The allocator drives five lifecycle transitions:

        insert(key, bid, parent_key)   block registered while in use
        park(bid)                      ref count hit zero (evictable)
        revive(bid)                    parked block re-referenced
        pop_eviction()                 LRU pressure: reclaim one parked
        remove(bid)                    unregister (evicted / offloaded)

    ``match_longest(keys)`` is the admission-time longest-shared-prefix
    walk: node bids for the longest registered prefix of ``keys``.
    """

    def __init__(self, clock: Callable[[], float] | None = None):
        self._clock: Callable[[], float] = clock if clock is not None else (
            lambda: 0.0
        )
        self._by_key: dict[int, TrieNode] = {}
        self._by_bid: dict[int, TrieNode] = {}
        # parked nodes in park order (OrderedDict as LRU: re-park lands
        # at the end).  Values are nodes; keys are bids.
        self._parked: OrderedDict[int, TrieNode] = OrderedDict()
        self._roots: dict[int, TrieNode] = {}   # parentless top-level nodes
        self.leaf_evictions = 0       # pop_eviction served by a parked leaf
        self.interior_evictions = 0   # fallback: oldest parked non-leaf
        self.ttl_evictions = 0        # removals via expired()
        self.reparented = 0           # children re-hung on a removed node's
                                      # parent (their prefix walk now stops
                                      # one block earlier)

    # ------------------------------------------------------------- clock
    def set_clock(self, clock: Callable[[], float]) -> None:
        """Point the trie at an external monotone clock (the scheduler's
        virtual token clock) — TTL expiry and age percentiles read it."""
        self._clock = clock

    def now(self) -> float:
        return float(self._clock())

    # ----------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._by_key)

    def __contains__(self, key: int) -> bool:
        return key in self._by_key

    @property
    def n_parked(self) -> int:
        return len(self._parked)

    def get(self, key: int) -> int | None:
        """Point lookup: the block registered under ``key`` (no state
        change — the allocator's ``lookup`` handles revival)."""
        node = self._by_key.get(key)
        return None if node is None else node.bid

    def node_of(self, bid: int) -> TrieNode | None:
        return self._by_bid.get(bid)

    def key_of(self, bid: int) -> int | None:
        node = self._by_bid.get(bid)
        return None if node is None else node.key

    def match_longest(self, keys: list[int]) -> list[int]:
        """Longest registered prefix of the key chain: bids of nodes
        ``keys[0..j)`` where ``j`` is the first miss.  O(len(keys))."""
        bids: list[int] = []
        for key in keys:
            node = self._by_key.get(key)
            if node is None:
                break
            bids.append(node.bid)
        return bids

    # --------------------------------------------------------- lifecycle
    def insert(self, key: int, bid: int, parent_key: int | None = None) -> bool:
        """Register ``bid`` under ``key``.  First writer wins: False when
        the key is already registered (the existing node keeps its block).
        ``parent_key`` links the node under its prefix parent; an unknown
        or omitted parent attaches at the root — exactly the flat
        chained-hash behaviour, so legacy ``register(bid, key)`` callers
        see no change."""
        if key in self._by_key:
            return False
        if bid in self._by_bid:
            raise ValueError(
                f"block {bid} already registered under key "
                f"{self._by_bid[bid].key}"
            )
        parent = self._by_key.get(parent_key) if parent_key is not None else None
        node = TrieNode(key=key, bid=bid, parent=parent, last_use=self.now())
        if parent is not None:
            parent.children[key] = node
        else:
            self._roots[key] = node
        self._by_key[key] = node
        self._by_bid[bid] = node
        return True

    def touch(self, bid: int) -> None:
        node = self._by_bid.get(bid)
        if node is not None:
            node.last_use = self.now()

    def park(self, bid: int) -> None:
        """Block's ref count dropped to zero: it becomes an eviction/TTL
        candidate while staying fully matchable."""
        node = self._by_bid[bid]
        assert node.parked_at is None, f"block {bid} parked twice"
        node.parked_at = self.now()
        self._parked[bid] = node

    def revive(self, bid: int) -> None:
        """Parked block re-referenced: leaves the eviction candidates."""
        node = self._by_bid[bid]
        assert node.parked_at is not None, f"block {bid} not parked"
        node.parked_at = None
        node.last_use = self.now()
        del self._parked[bid]

    def remove(self, bid: int) -> tuple[int, int | None]:
        """Unregister a (parked or in-use) block entirely.  Children are
        re-hung on the removed node's parent so the tree stays connected;
        their longest-prefix walk now stops at the removed key (counted
        in ``reparented``).  Returns (key, parent_key) — the offload tier
        needs both to re-insert the chain on recall."""
        node = self._by_bid.pop(bid)
        del self._by_key[node.key]
        if node.parked_at is not None:
            del self._parked[bid]
        parent = node.parent
        if parent is not None:
            del parent.children[node.key]
        else:
            del self._roots[node.key]
        for child in node.children.values():
            child.parent = parent
            if parent is not None:
                parent.children[child.key] = child
            else:
                self._roots[child.key] = child
            self.reparented += 1
        return node.key, node.parent_key

    # ---------------------------------------------------------- eviction
    def pop_eviction(self) -> tuple[int, int, int | None] | None:
        """Reclaim one parked block for a fresh allocation: the LRU
        parked *leaf* when one exists (evicting it strands nothing), else
        the oldest parked node outright (every parked node shields cached
        children — old flat-map behaviour).  Returns
        (bid, key, parent_key) or None when nothing is parked."""
        victim = None
        for node in self._parked.values():
            if node.is_leaf():
                victim = node
                break
        if victim is None:
            if not self._parked:
                return None
            victim = next(iter(self._parked.values()))
            self.interior_evictions += 1
        else:
            self.leaf_evictions += 1
        bid = victim.bid
        key, parent_key = self.remove(bid)
        return bid, key, parent_key

    def expired(self, ttl: float) -> list[int]:
        """Bids parked longer than ``ttl`` clock units, deepest-first so
        chains unwind leaf-to-root (a parent expelled before its cached
        child would strand it).  Callers remove() each returned bid."""
        now = self.now()
        out = [
            node for node in self._parked.values()
            if now - node.parked_at >= ttl
        ]
        out.sort(key=lambda n: -self._depth(n))
        return [n.bid for n in out]

    @staticmethod
    def _depth(node: TrieNode) -> int:
        d = 0
        while node.parent is not None:
            node = node.parent
            d += 1
        return d

    # ------------------------------------------------------------- stats
    def parked_ages(self) -> list[float]:
        """Age (clock units) of every parked block — the pool_stats
        percentile source."""
        now = self.now()
        return [now - n.parked_at for n in self._parked.values()]

    def stats(self) -> dict[str, float]:
        return dict(
            trie_nodes=len(self._by_key),
            trie_parked=len(self._parked),
            trie_leaf_evictions=self.leaf_evictions,
            trie_interior_evictions=self.interior_evictions,
            trie_ttl_evictions=self.ttl_evictions,
            trie_reparented=self.reparented,
        )

    # ------------------------------------------------------------- audit
    def audit(self) -> list[str]:
        """Internal invariant sweep; returns violation strings (empty =
        clean).  The allocator folds these into its own audit."""
        errs: list[str] = []
        if set(self._by_key) != {n.key for n in self._by_bid.values()}:
            errs.append("key/bid index mismatch")
        for key, node in self._by_key.items():
            if node.key != key or self._by_bid.get(node.bid) is not node:
                errs.append(f"index asymmetry at key {key}")
            if node.parent is None:
                if self._roots.get(key) is not node:
                    errs.append(f"parentless node {key} missing from roots")
            elif node.parent.children.get(key) is not node:
                errs.append(f"parent/child asymmetry at key {key}")
        for bid, node in self._parked.items():
            if node.parked_at is None or self._by_bid.get(bid) is not node:
                errs.append(f"parked index inconsistent at block {bid}")
        for node in self._by_key.values():
            if node.parked_at is None and node.bid in self._parked:
                errs.append(f"unparked node {node.key} in parked set")
        return errs
