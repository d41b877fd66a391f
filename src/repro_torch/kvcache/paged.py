"""Paged KV cache: device-side block pool + host-side block allocator
(port of ``repro.kvcache.paged``).

Instead of one dense ``[L, B, capacity, Hkv, D]`` slab per engine slot,
the paged cache keeps a single pool of fixed-size blocks

    k, v     [L, n_blocks, block_size, Hkv, D]      (bf16)
    meta     codes [L, n_blocks, block_size//8,  Hkv, D]  uint8
             scale [L, n_blocks, block_size//g,  Hkv, D]  bf16
             zero  [L, n_blocks, block_size//g,  Hkv, D]  bf16

and a per-request **block table** ``[B, capacity // block_size]`` int32
mapping logical block ``j`` of request ``b`` to a physical pool block.
Logical token ``t`` lives at ``(block_table[b, t // bs], t % bs)``.  The
FIER 1-bit code side-car pages at the same granularity as the K/V rows it
summarizes (``block_size`` is a multiple of 8 and of the group ``g``).

Block id 0 is the reserved **null block**: it is never allocated, every
block-table row starts as all-zeros, and out-of-range / inactive-slot
writes are routed to it.  Consumers mask by ``length``, so null-block
garbage is never read into a result.

Unlike the JAX package, whose arrays are immutable, the device primitives
here update the pool **in place** (``paged_append_kv``,
``paged_append_token_metadata``): an append writes one row and one group
of the side-car and never copies a pool.  The arithmetic per token is that
of ``kvcache.cache``; only the addressing differs, so a paged decode equals
the slab decode on the same logical cache contents.

Host side, :class:`BlockAllocator` (a copy of the JAX package's: pure
Python) owns the free list, the ref counts and the radix-trie prefix cache;
see its docstring.  Its eviction records feed the engine's host-DRAM
offload tier (:mod:`repro_torch.kvcache.offload`).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.core.quantize import QuantizedKeys

from .cache import _check_capacity
from .prefix_tree import PrefixTree

NULL_BLOCK = 0  # reserved trash block: never allocated, masked everywhere


def check_block_size(block_size: int, group: int = 0) -> None:
    """A block must hold whole code bytes (8 tokens) and whole (scale,
    zero) group cells, or the ``// 8`` / ``// group`` side-car shapes
    silently truncate."""
    _check_capacity(block_size, group, what="block_size")


def init_paged_pool(
    n_layers: int,
    n_blocks: int,
    block_size: int,
    n_kv: int,
    d_head: int,
    cfg: PolicyConfig | None,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> dict[str, Any]:
    """Block-pool K/V slabs [L, N, bs, Hkv, D] (+ paged FIER side-car)."""
    check_block_size(
        block_size, cfg.group if cfg is not None and cfg.kind == "fier" else 0
    )
    if n_blocks < 2:
        raise ValueError(
            f"pool needs >= 2 blocks (block 0 is the reserved null block), "
            f"got {n_blocks}"
        )
    shape = (n_layers, n_blocks, block_size, n_kv, d_head)
    kv = dict(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )
    if cfg is not None and cfg.kind == "fier":
        g = cfg.group
        side = lambda rows, dt: torch.zeros(
            (n_layers, n_blocks, rows, n_kv, d_head), dtype=dt, device=device
        )
        kv["meta"] = QuantizedKeys(
            side(block_size // 8, torch.uint8),
            side(block_size // g, torch.bfloat16),
            side(block_size // g, torch.bfloat16),
            g,
        )
    elif cfg is not None and cfg.kind != "full":
        raise ValueError(f"paged cache does not support policy {cfg.kind!r}")
    return kv


# ---------------------------------------------------------------- addressing

def _write_target(
    block_table: torch.Tensor, length: torch.Tensor, block_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(physical block, offset) of each sequence's append slot ``length``.

    Out-of-range positions (length beyond the table) are routed to the
    null block, so scratch writes from frozen/inactive slots land in trash
    instead of onto live data."""
    n_btab = block_table.shape[1]
    length = length.to(torch.int64)
    bidx = torch.clamp(length // block_size, 0, n_btab - 1)
    phys = torch.gather(block_table.to(torch.int64), 1, bidx[:, None])[:, 0]
    in_range = length < n_btab * block_size
    return torch.where(in_range, phys, torch.zeros_like(phys)), length % block_size


def _last_writer(phys: torch.Tensor, off: torch.Tensor, block_size: int) -> torch.Tensor:
    """For each sequence, the last sequence whose append targets the same
    pool row.  Scratch writes of several inactive slots can share a
    null-block row, and a CUDA scatter with repeated indices leaves the
    winner unspecified; writing the last writer's value at every repeat
    makes the result the serial scatter's (last write wins) on any device."""
    flat = phys * block_size + off
    seq = torch.arange(flat.shape[0], device=flat.device)
    same = flat[:, None] == flat[None, :]
    return torch.where(same, seq[None, :], -1).amax(dim=1)


def gather_block_rows(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Materialise the logical per-request view of a pool leaf.

    pool [N, pb, ...] × block_table [B, n_btab] → [B, n_btab * pb, ...]
    (pb = rows per block for this leaf: bs for K/V, bs//8 for codes,
    bs//g for scale/zero).  The plain path; the paged kernels walk the
    table in-kernel instead of materialising this."""
    B, n_btab = block_table.shape
    pb = pool.shape[1]
    g = pool.index_select(0, block_table.reshape(-1).to(torch.int64))
    return g.reshape(B, n_btab * pb, *pool.shape[2:])


def gather_paged_kv(
    k_pool: torch.Tensor, v_pool: torch.Tensor, meta: Any, block_table: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, Any]:
    """Logical [B, S, Hkv, D] slab views of the pool (+ side-car)."""
    K = gather_block_rows(k_pool, block_table)
    V = gather_block_rows(v_pool, block_table)
    if meta is None:
        return K, V, None
    m = QuantizedKeys(
        gather_block_rows(meta.codes, block_table),
        gather_block_rows(meta.scale, block_table),
        gather_block_rows(meta.zero, block_table),
        meta.group,
    )
    return K, V, m


# -------------------------------------------------------------- append paths

def paged_append_kv(
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    block_table: torch.Tensor,
    length: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one new token per sequence through the block table, in place.

    k_pool/v_pool [N, bs, Hkv, D]; k_new/v_new [B, 1, Hkv, D] (or
    [B, Hkv, D]); length [B] → the same pools, updated.  The engine
    guarantees each *running* request's table has a writable tail block at
    ``length`` (allocated / copy-on-write'd before the decode step);
    retired slots have zeroed rows, so their scratch writes hit the null
    block, where the last slot's write wins (``_last_writer``)."""
    if k_new.dim() == 4:
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    bs = k_pool.shape[1]
    phys, off = _write_target(block_table, length, bs)
    src = _last_writer(phys, off, bs)
    k_pool[phys, off] = k_new[src].to(k_pool.dtype)
    v_pool[phys, off] = v_new[src].to(v_pool.dtype)
    return k_pool, v_pool


def paged_append_token_metadata(
    meta: Any,
    k_pool: torch.Tensor,
    block_table: torch.Tensor,
    length: torch.Tensor,
    cfg: PolicyConfig,
) -> Any:
    """Incremental FIER side-car refresh after a paged 1-token append, in
    place.

    The math of ``cache.append_token_metadata`` (group min/max → (scale,
    zero) → packed sign bits, recomputed for the one group containing the
    written slot); only the addressing changes: the group lives inside the
    sequence's tail block, so one [bs, Hkv, D] block is gathered per
    sequence and one group's side-car rows are scattered back at the
    block's pool row.  Sequences whose writes share a group compute it
    from the same rows, so their repeated scatters carry equal values."""
    if meta is None or cfg.kind == "full":
        return meta
    if cfg.kind != "fier":
        raise ValueError(f"paged metadata refresh: unsupported policy {cfg.kind!r}")
    g = cfg.group
    bs = k_pool.shape[1]
    B = length.shape[0]
    dev = k_pool.device
    phys, off = _write_target(block_table, length, bs)
    blk = k_pool.index_select(0, phys)                         # [B, bs, H, D]
    start = (off // g) * g                                     # [B]
    rows = torch.arange(B, device=dev)[:, None]
    grp = blk[rows, start[:, None] + torch.arange(g, device=dev)[None, :]]  # [B, g, H, D]
    kmax, kmin = grp.amax(dim=1), grp.amin(dim=1)
    # midpoint and half-range in the pool dtype, the sign test against that
    # bf16 midpoint: bit for bit repro/kvcache/paged.py:215-221
    z, s = (kmax + kmin) * 0.5, (kmax - kmin) * 0.5
    bits = (grp >= z[:, None].to(grp.dtype)).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev).reshape(1, 1, 8, 1, 1)
    packed = (bits.reshape(B, g // 8, 8, *bits.shape[2:]) << shifts).sum(dim=2)
    rows8 = (start // 8)[:, None] + torch.arange(g // 8, device=dev)[None, :]
    meta.codes[phys[:, None], rows8] = packed.to(torch.uint8)
    meta.scale[phys, start // g] = s.to(meta.scale.dtype)
    meta.zero[phys, start // g] = z.to(meta.zero.dtype)
    return meta


# -------------------------------------------------------------- host allocator

def block_hash_chain(tokens, block_size: int) -> list[int]:
    """Chained content hashes, one per (possibly partial) prompt block.

    ``key_j`` covers *all* tokens up to the end of block ``j``, so equal
    keys ⇒ equal prefixes ⇒ equal K/V contents (causal attention,
    absolute positions).  The final key identifies the whole prompt and
    doubles as the full-prompt logits-cache key.
    """
    keys, prev = [], 0x9E3779B9
    for i in range(0, len(tokens), block_size):
        prev = hash((prev, tuple(int(t) for t in tokens[i : i + block_size])))
        keys.append(prev)
    return keys


@dataclasses.dataclass
class SeqBlocks:
    """Host-side view of one request's block table row."""

    blocks: list[int] = dataclasses.field(default_factory=list)
    length: int = 0  # next write position (== tokens resident)


class AllocatorAuditError(AssertionError):
    """A :meth:`BlockAllocator.audit` invariant violation (leak, ref-count
    drift, free-list/table overlap, or hash-index inconsistency)."""


@dataclasses.dataclass(frozen=True)
class EvictedBlock:
    """One block demoted out of the device prefix cache (LRU pressure or
    TTL expiry) while its contents were still valid — the record the
    engine's host-offload hook consumes.
    ``parent_key`` preserves the trie linkage so a recall re-inserts the
    node under its original prefix parent."""

    bid: int
    key: int
    parent_key: int | None
    reason: str  # "lru" | "ttl"


class BlockAllocator:
    """Free-list block allocator with ref counts and a radix-trie prefix
    cache (:class:`~repro_torch.kvcache.prefix_tree.PrefixTree`).

    States of a block id (> 0):
      * in use:        ref >= 1 (possibly shared; possibly hash-registered)
      * free-cached:   ref == 0 but hash-registered (a *parked* trie
                       node); contents still valid for prefix hits,
                       evicted leaf-first LRU when the free list runs
                       dry, or by TTL (``park_ttl`` clock units on the
                       trie's pluggable clock — the serving scheduler
                       wires its virtual token clock in)
      * free:          ref == 0, no hash; next to be handed out

    Block 0 (the null block) is never handed out.

    Evictions of still-valid cached blocks are observable: with
    ``record_evictions`` set, every LRU/TTL demotion lands in an internal
    log drained via :meth:`take_evicted`, which the engine's host offload
    tier consumes (the engine turns recording on only with a tier).
    """

    def __init__(self, n_blocks: int, block_size: int,
                 park_ttl: float | None = None):
        if n_blocks < 2:
            raise ValueError(f"pool needs >= 2 blocks, got {n_blocks}")
        check_block_size(block_size)
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.ref = [0] * n_blocks
        self._free: deque[int] = deque(range(1, n_blocks))
        self.tree = PrefixTree()
        self.park_ttl = park_ttl
        self._in_use = 0
        self._fail_next = 0  # fault injection: fail the next N alloc() calls
        self.peak_in_use = 0
        self.cow_copies = 0
        self.prefix_block_hits = 0
        self.injected_alloc_failures = 0
        self.ttl_evictions = 0
        # eviction log for the offload hook (bounded by its consumer: the
        # engine drains it inside the same operation that evicted)
        self.record_evictions = False
        self._evicted: list[EvictedBlock] = []

    # ------------------------------------------------------------- accounting
    def set_clock(self, clock) -> None:
        """Wire the trie's park/TTL clock to an external monotone clock
        (the scheduler's virtual token clock)."""
        self.tree.set_clock(clock)

    def key_of(self, bid: int) -> int | None:
        """The prefix-cache key ``bid`` is registered under (None when
        unregistered) — the trie-era spelling of the old ``_hash_of``."""
        return self.tree.key_of(bid)

    def key_resident(self, key: int) -> bool:
        """Whether ``key`` is registered in the device-tier prefix cache
        (in use or parked).  The engine's eviction drain asks this before
        offloading: under a sharded pool the same content key can be
        registered on several shards, and a key still resident anywhere
        on device must not be handed to the host tier (cross-tier
        single-ownership)."""
        return key in self.tree

    @property
    def usable(self) -> int:
        return self.n_blocks - 1

    @property
    def n_in_use(self) -> int:
        return self._in_use

    @property
    def n_parked(self) -> int:
        """Free-but-cached blocks (parked trie nodes)."""
        return self.tree.n_parked

    @property
    def n_free(self) -> int:
        """Blocks available to a fresh allocation (evictable cached ones
        included — alloc() reclaims them leaf-first LRU)."""
        return len(self._free) + self.tree.n_parked

    def utilization(self) -> float:
        """Blocks resident (referenced) / blocks allocated (pool size)."""
        return self.n_in_use / self.usable

    @staticmethod
    def _percentile(sorted_vals: list[float], q: float) -> float:
        """Nearest-rank percentile over a pre-sorted list (0 when empty) —
        keeps paged.py numpy-free."""
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
        return float(sorted_vals[idx])

    def stats(self) -> dict[str, float]:
        """The canonical pool-accounting snapshot, one ``pool_*`` name per
        quantity.  This is the *single* naming scheme: the metrics
        registry gauges use these names verbatim, and
        ``Engine.pool_stats()`` merges them with the engine's own."""
        ages = sorted(self.tree.parked_ages())
        return dict(
            pool_blocks_total=self.n_blocks,
            pool_blocks_usable=self.usable,
            pool_blocks_in_use=self.n_in_use,
            pool_blocks_free=len(self._free),
            pool_blocks_cached=self.tree.n_parked,
            pool_utilization=self.utilization(),
            pool_peak_in_use=self.peak_in_use,
            pool_prefix_block_hits=self.prefix_block_hits,
            pool_cow_copies=self.cow_copies,
            pool_injected_alloc_failures=self.injected_alloc_failures,
            # parked-block age percentiles on the trie clock: how long
            # free-but-cached prefixes have been cold (satellite: stale
            # prefixes must age out deterministically, and their age is
            # the evidence)
            pool_parked_age_p50=self._percentile(ages, 0.50),
            pool_parked_age_p90=self._percentile(ages, 0.90),
            pool_parked_age_max=ages[-1] if ages else 0.0,
            pool_ttl_evictions=self.ttl_evictions,
            pool_leaf_evictions=self.tree.leaf_evictions,
            pool_interior_evictions=self.tree.interior_evictions,
        )

    # -------------------------------------------------------------- alloc/free
    def fail_next(self, n: int = 1) -> None:
        """Chaos hook: make the next ``n`` :meth:`alloc` calls report an
        empty pool (a transient exhaustion burst).  Callers already handle
        None, so the failure exercises the real degradation/preemption
        paths with no allocator state change."""
        self._fail_next += int(n)

    def alloc(self, shard: int = 0) -> int | None:
        """Hand out a free block (ref=1), evicting the LRU free-cached
        trie leaf if the plain free list is empty (oldest parked node as
        a fallback when every parked node shields cached children).
        None when dry.  ``shard`` (here and in ``lookup`` / ``peek``) is
        ignored: one pool takes the signature of
        ``kvcache.sharded.ShardedBlockAllocator``, so the engine calls both
        alike."""
        if self._fail_next > 0:
            self._fail_next -= 1
            self.injected_alloc_failures += 1
            return None
        if self._free:
            bid = self._free.popleft()
        else:
            ev = self.tree.pop_eviction()
            if ev is None:
                return None
            bid, key, parent_key = ev
            if self.record_evictions:
                self._evicted.append(EvictedBlock(bid, key, parent_key, "lru"))
        self.ref[bid] = 1
        self._in_use += 1
        self.peak_in_use = max(self.peak_in_use, self._in_use)
        return bid

    def free(self, bid: int) -> None:
        """Drop one reference; at zero the block parks in the prefix cache
        (if registered) or returns to the free list."""
        assert bid != NULL_BLOCK and self.ref[bid] > 0, (bid, self.ref[bid])
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            self._in_use -= 1
            if self.tree.key_of(bid) is not None:
                # parks at the LRU end — a block cannot already be parked
                # while its ref count was > 0
                self.tree.park(bid)
            else:
                self._free.append(bid)

    # ------------------------------------------------------------ prefix cache
    def register(self, bid: int, key: int, parent_key: int | None = None) -> None:
        """Publish an in-use block's content hash for future prefix hits.
        First writer wins: an already-registered key keeps its block.
        ``parent_key`` (the previous key of the ``block_hash_chain``)
        links the trie node under its prefix parent — omitted, the node
        attaches at the root and behaves exactly like the old flat
        chained-hash map."""
        assert self.ref[bid] > 0, bid
        if key in self.tree:
            return
        if self.tree.key_of(bid) is not None:
            return  # block already published under its own (older) key
        self.tree.insert(key, bid, parent_key)

    def lookup(self, key: int, shard: int = 0) -> int | None:
        """Prefix hit: take a reference on the block registered under
        ``key`` (reviving it from the free-cached pool if parked)."""
        bid = self.tree.get(key)
        if bid is None:
            return None
        if self.ref[bid] == 0:
            self.tree.revive(bid)
            self._in_use += 1
        else:
            self.tree.touch(bid)
        self.ref[bid] += 1
        self.peak_in_use = max(self.peak_in_use, self._in_use)
        self.prefix_block_hits += 1
        return bid

    def peek(self, keys: list[int], shard: int = 0) -> tuple[int, int]:
        """(hit prefix length, hits currently parked free-cached) for an
        admission-time block budget — no state change."""
        flags = self.peek_prefix(keys)
        return len(flags), sum(flags)

    def peek_prefix(self, keys: list[int]) -> list[bool]:
        """Per-block 'hit is parked free-cached' flags for the longest
        registered prefix of ``keys`` — chunked-admission accounting needs
        the per-block breakdown (tail hits past the resume cap are
        dropped, and only *their* revivals must be uncharged).  No state
        change."""
        flags: list[bool] = []
        for key in keys:
            bid = self.tree.get(key)
            if bid is None:
                break
            flags.append(self.ref[bid] == 0)
        return flags

    # ---------------------------------------------------- eviction / offload
    def expire_parked(self) -> int:
        """TTL sweep: demote every parked block older than ``park_ttl``
        (trie clock units) back to the plain free list, logging each for
        the offload hook.  Returns the number demoted; no-op without a
        TTL.  The scheduler runs this once per step, so on its virtual
        token clock stale prefixes age out deterministically."""
        if self.park_ttl is None:
            return 0
        n = 0
        for bid in self.tree.expired(self.park_ttl):
            key, parent_key = self.tree.remove(bid)
            self.tree.ttl_evictions += 1
            self.ttl_evictions += 1
            if self.record_evictions:
                self._evicted.append(EvictedBlock(bid, key, parent_key, "ttl"))
            self._free.append(bid)
            n += 1
        return n

    def take_evicted(self) -> list[EvictedBlock]:
        """Drain the pending eviction log (records appear only while
        ``record_evictions`` is set).  The engine calls this immediately
        after any operation that can evict — before the evicted blocks'
        pool rows are overwritten — and snapshots them to the host tier."""
        out, self._evicted = self._evicted, []
        return out

    def drop_key(self, key: int) -> int | None:
        """Unregister a *parked* prefix-cache entry and return its block
        to the plain free list (None when the key is absent or in use) —
        the chaos harness's host-tier drop needs the device analogue."""
        bid = self.tree.get(key)
        if bid is None or self.ref[bid] != 0:
            return None
        self.tree.remove(bid)
        self._free.append(bid)
        return bid

    def blocks_needed(self, n_tokens: int, keys: list[int] | None = None) -> int:
        """Fresh blocks a prompt admission would consume (prefix-cache
        revivals also come out of the free pool, so they count)."""
        nb = -(-n_tokens // self.block_size)
        if keys is None:
            return nb
        n_hit, revivals = self.peek(keys[:nb])
        return nb - n_hit + revivals

    # ------------------------------------------------------------------- audit
    def audit(
        self,
        owners: dict[int, int] | None = None,
        host_keys: "set[int] | None" = None,
    ) -> None:
        """Invariant checker; raises :class:`AllocatorAuditError` on the
        first violation, returns None when clean.

        Checks: (a) every block id is in exactly one state — in use
        (ref > 0), free, or free-cached (parked trie node) — i.e. the
        free structures are disjoint from each other and from referenced
        blocks, with no duplicates and no leaked ids; (b) ``_in_use``
        matches the ref counts; (c) the trie's internal indices agree
        (key↔bid symmetry, parent/child symmetry, parked bookkeeping) and
        every parked block has ref == 0; (d) with ``owners`` (bid →
        expected ref count from the engine's live sequences), ref-count
        conservation holds *exactly* — a double free or a leaked
        reference cannot hide; (e) with ``host_keys`` (the offload
        tier's resident keys), no key is owned by both tiers — a
        double-owned block would let a recall clobber a live device
        registration.
        """
        def fail(msg: str) -> None:
            raise AllocatorAuditError(f"allocator audit: {msg}")

        if self.ref[NULL_BLOCK] != 0:
            fail(f"null block has ref {self.ref[NULL_BLOCK]}")
        free = list(self._free)
        cached = list(self.tree._parked)
        if NULL_BLOCK in free or NULL_BLOCK in cached:
            fail("null block on a free list")
        if len(set(free)) != len(free):
            fail("duplicate ids on the free list (double free)")
        if set(free) & set(cached):
            fail(f"free list and free-cached overlap: {set(free) & set(cached)}")
        in_use = {b for b in range(1, self.n_blocks) if self.ref[b] > 0}
        for b in free + cached:
            if b in in_use:
                fail(f"block {b} is both referenced (ref={self.ref[b]}) and free")
        if len(in_use) + len(free) + len(cached) != self.n_blocks - 1:
            unaccounted = (
                set(range(1, self.n_blocks)) - in_use - set(free) - set(cached)
            )
            fail(f"leaked blocks (in no state): {sorted(unaccounted)}")
        if self._in_use != len(in_use):
            fail(f"_in_use counter {self._in_use} != referenced blocks {len(in_use)}")
        for err in self.tree.audit():
            fail(f"prefix trie: {err}")
        for bid in cached:
            if self.ref[bid] != 0:
                fail(f"free-cached block {bid} has ref {self.ref[bid]}")
        for bid in self.tree._by_bid:
            if bid in free:
                fail(f"registered block {bid} sits on the plain free list")
        if owners is not None:
            for b in range(1, self.n_blocks):
                expect = owners.get(b, 0)
                if self.ref[b] != expect:
                    fail(
                        f"ref-count drift on block {b}: allocator says "
                        f"{self.ref[b]}, owners hold {expect}"
                    )
        if host_keys is not None:
            both = host_keys & set(self.tree._by_key)
            if both:
                fail(
                    f"keys owned by both tiers (device trie AND host "
                    f"offload): {sorted(both)[:8]}"
                )
