"""Host-DRAM KV offload tier: the second level of the two-tier prefix
cache.  Port of ``repro.kvcache.offload``.

The device pool's free-but-cached blocks are the first tier.  With an
offload tier attached, the engine snapshots each block the allocator
evicts — its ``[L, bs, …]`` rows in every pool leaf (K/V and the side-car)
— into host memory *before* the pool row is overwritten, keyed by the same
chained block hash the trie uses.  A later admission whose prefix walk runs
off the device trie extends the match through this tier: fresh device
blocks are filled by a two-deep recall (block i+1's host-to-device copy in
flight while block i is written into the pool) and re-registered under
their original parent linkage — bit-identical to never having been evicted.

On a CUDA pool the host copies live in one **pinned** buffer allocated
once, at the tier's capacity: a row of bytes per block, holding every pool
leaf's rows back to back, so a block crosses the bus in one copy each way.
Every transfer runs on one side stream with ``non_blocking=True``;
``torch.cuda.Event``s order it against the compute stream in both
directions:

* a save waits for the compute stream's work so far (the block's last
  writes), gathers the block's leaves into a device staging row and copies
  that row to the host; the compute stream waits for the save before it can
  write the reclaimed pool row;
* a recalled block's host-to-device copy lands in one of two device
  staging rows; the compute stream waits for it before the commit (the
  scatter of the row's leaves into the pool), and the side stream waits for
  that commit before it refills the same staging row.

Since every transfer touching a pinned slot runs on the side stream, a
slot can be reused in program order with no host synchronisation.  On the
CPU the same code runs synchronously.

Ownership invariant: a key lives in exactly one tier.  ``save`` is called
only for keys just removed from the trie; a recall ``pop``s the host entry
before the device re-registration.  ``BlockAllocator.audit`` cross-checks
the two key sets every time the engine audits.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Iterable, Sequence

import torch

__all__ = ["HostBlock", "HostOffloadTier", "payload_nbytes", "timed"]


def payload_nbytes(payload: Sequence[torch.Tensor]) -> int:
    """Total bytes of a block payload (one tensor per pool leaf)."""
    return sum(int(t.numel() * t.element_size()) for t in payload)


@dataclasses.dataclass
class HostBlock:
    """One offloaded block: its prefix-cache identity plus the host copy of
    every pool leaf's ``[L, bs, …]`` slice for that block (views into the
    tier's host row ``slot``)."""

    key: int
    parent_key: int | None
    payload: list[torch.Tensor]
    nbytes: int
    saved_at: float                 # tier clock (scheduler vtime when wired)
    reason: str = "lru"             # "lru" | "ttl"
    slot: int = -1


class HostOffloadTier:
    """Bounded LRU store of evicted KV blocks in host memory.

    ``capacity_blocks`` bounds residency (0 disables saves).  The tier is
    passive: the engine decides what to save (the allocator's eviction log)
    and what to recall (the admission-time prefix walk); the tier owns the
    host copies, their transfers and their LRU/accounting.  Its buffers are
    allocated at the first save, from that payload's leaf shapes, and kept
    across :meth:`clear`.
    """

    def __init__(self, capacity_blocks: int, clock: Callable[[], float] | None = None):
        self.capacity_blocks = int(capacity_blocks)
        self._clock: Callable[[], float] = clock if clock is not None else (lambda: 0.0)
        self._host: torch.Tensor | None = None   # uint8 [capacity, row bytes]
        self._layout: list[tuple] = []           # (offset, bytes, dtype, shape) per leaf
        self._staging: list[torch.Tensor] = []   # device rows: recall ×2, save
        self._cuda = False
        self._side = None                                # side stream (CUDA only)
        self._staging_free: list = [None, None]          # commit events of the staging buffers
        self.timing = False   # record CUDA timing events around every transfer
        self.clear()

    def clear(self) -> None:
        """Empty the tier and zero its counters, as a fresh tier; buffers,
        streams and the ``timing`` switch are kept."""
        self._store: OrderedDict[int, HostBlock] = OrderedDict()
        self._free_slots = list(range(max(self.capacity_blocks, 0)))[::-1]
        self.nbytes = 0
        self.saves = 0
        self.recalls = 0
        self.lru_evictions = 0      # host-capacity pressure
        self.dropped = 0            # chaos-injected losses
        self.recall_wall_s = 0.0    # cumulative wall time inside recalls
        self.events: dict[str, list] = {"d2h": [], "h2d": [], "commit": []}
        self._t0 = None

    # ------------------------------------------------------------- clock
    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def now(self) -> float:
        return float(self._clock())

    # ----------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: int) -> bool:
        return key in self._store

    def keys(self) -> set[int]:
        return set(self._store)

    def match_extension(self, keys: list[int], start: int) -> list[int]:
        """How far the host tier extends a device prefix match: the keys
        ``keys[start:start+n]`` resident here, stopping at the first miss.
        No state change."""
        out: list[int] = []
        for key in keys[start:]:
            if key not in self._store:
                break
            out.append(key)
        return out

    # ----------------------------------------------------------- buffers
    def _bind(self, leaves: Sequence[torch.Tensor]) -> None:
        dev = leaves[0].device
        self._cuda = dev.type == "cuda"
        off = 0
        for t in leaves:
            n = t.numel() * t.element_size()
            self._layout.append((off, n, t.dtype, tuple(t.shape)))
            off += -(-n // 16) * 16  # each leaf 16-byte aligned in the row
        self._host = torch.empty((self.capacity_blocks, off), dtype=torch.uint8,
                                 pin_memory=self._cuda)
        self._staging = [torch.empty((off,), dtype=torch.uint8, device=dev) for _ in range(3)]
        if self._cuda:
            self._side = torch.cuda.Stream(device=dev)

    def _leaves(self, row: torch.Tensor) -> list[torch.Tensor]:
        """One block's leaves as views of a byte row (host or staging)."""
        return [row[o:o + n].view(dt).view(shape) for o, n, dt, shape in self._layout]

    def _event(self):
        return torch.cuda.Event(enable_timing=self.timing)

    def _stamp(self, kind: str, stream, fn) -> None:
        """Run ``fn`` on ``stream``, bracketed by timing events when on."""
        if not self.timing:
            fn()
            return
        if self._t0 is None:
            self._t0 = self._event()
            self._t0.record(torch.cuda.current_stream())
        a, b = self._event(), self._event()
        a.record(stream)
        fn()
        b.record(stream)
        self.events[kind].append((a, b))

    # --------------------------------------------------------- save/recall
    def save(self, key: int, parent_key: int | None, leaves: Sequence[torch.Tensor],
             reason: str = "lru") -> bool:
        """Admit one evicted block: copy its pool rows ``leaves`` (one
        ``[L, bs, …]`` view per pool leaf) into a host slot.  False when the
        tier is disabled or the key is already resident (first writer wins,
        as in the trie).  At capacity the LRU entry is dropped first."""
        if self.capacity_blocks <= 0 or key in self._store:
            return False
        if self._host is None:
            self._bind(leaves)
        if not self._free_slots:
            _, old = self._store.popitem(last=False)
            self.nbytes -= old.nbytes
            self.lru_evictions += 1
            self._free_slots.append(old.slot)
        slot = self._free_slots.pop()
        row = self._host[slot]
        if self._cuda:
            cur = torch.cuda.current_stream(leaves[0].device)
            self._side.wait_stream(cur)   # the block's last writes are in
            stage = self._staging[2]
            with torch.cuda.stream(self._side):
                for d, s in zip(self._leaves(stage), leaves):
                    d.copy_(s)
                self._stamp("d2h", self._side, lambda: row.copy_(stage, non_blocking=True))
                done = torch.cuda.Event()
                done.record(self._side)
            cur.wait_event(done)          # no write to the pool row before the copy
        else:
            for d, s in zip(self._leaves(row), leaves):
                d.copy_(s)
        payload = self._leaves(row)
        hb = HostBlock(key=key, parent_key=parent_key, payload=payload,
                       nbytes=payload_nbytes(payload), saved_at=self.now(), reason=reason,
                       slot=slot)
        self._store[key] = hb
        self.nbytes += hb.nbytes
        self.saves += 1
        return True

    def pop(self, key: int) -> HostBlock | None:
        """Recall: remove and return the host entry (ownership moves back to
        the device tier — the caller re-registers it in the trie).  Its slot
        stays reserved until :meth:`recall` has issued its copy."""
        hb = self._store.pop(key, None)
        if hb is not None:
            self.nbytes -= hb.nbytes
            self.recalls += 1
        return hb

    def _put(self, j: int, hb: HostBlock):
        """Issue the host-to-device copy of ``hb``'s row into staging row
        ``j``; returns the event the commit waits on (None on the CPU)."""
        buf, row = self._staging[j], self._host[hb.slot]
        ev = None
        if self._cuda:
            if self._staging_free[j] is not None:
                self._side.wait_event(self._staging_free[j])  # its last commit read it
            with torch.cuda.stream(self._side):
                self._stamp("h2d", self._side, lambda: buf.copy_(row, non_blocking=True))
                ev = torch.cuda.Event()
                ev.record(self._side)
        else:
            buf.copy_(row)
        self._free_slots.append(hb.slot)  # later copies into it queue behind this one
        return ev

    def recall(self, entries: Iterable[tuple[int, HostBlock]],
               commit: Callable[[int, list[torch.Tensor]], None]) -> int:
        """Two-deep host→device pipeline over ``(bid, HostBlock)`` entries
        (popped already): block i+1's copy is issued before block i's
        ``commit(bid, device_payload)`` (the engine's write into the pool,
        on the compute stream).  Returns the number of blocks committed."""
        pending = None
        n = 0
        cur = torch.cuda.current_stream() if self._cuda else None
        for i, (bid, hb) in enumerate(entries):
            staged = (bid, i % 2, self._put(i % 2, hb))
            if pending is not None:
                self._commit(pending, commit, cur)
                n += 1
            pending = staged
        if pending is not None:
            self._commit(pending, commit, cur)
            n += 1
        return n

    def _commit(self, pending, commit, cur) -> None:
        bid, j, ev = pending
        payload = self._leaves(self._staging[j])
        if ev is not None:
            cur.wait_event(ev)
            self._stamp("commit", cur, lambda: commit(bid, payload))
            done = torch.cuda.Event()
            done.record(cur)
            self._staging_free[j] = done
        else:
            commit(bid, payload)

    def drop_lru(self, n: int = 1) -> int:
        """Chaos hook: lose ``n`` LRU entries (host memory reclaim / a
        dropped transfer).  Recalls that would have hit now miss and fall
        back to recompute — outputs must not change."""
        dropped = 0
        while self._store and dropped < n:
            _, hb = self._store.popitem(last=False)
            self.nbytes -= hb.nbytes
            self._free_slots.append(hb.slot)
            dropped += 1
        self.dropped += dropped
        return dropped

    def transfer_times(self) -> dict[str, list[tuple[float, float]]]:
        """With ``timing`` on: each recorded transfer/commit as (start, end)
        in ms after the first stamp's base event (synchronises them)."""
        out = {k: [] for k in self.events}
        if self._t0 is None:
            return out
        for k, v in self.events.items():
            for a, b in v:
                b.synchronize()
                out[k].append((self._t0.elapsed_time(a), self._t0.elapsed_time(b)))
        return out

    # ------------------------------------------------------------- stats
    def stats(self) -> dict[str, float]:
        """Canonical ``offload_*`` accounting (registry-gauge names)."""
        return dict(
            offload_capacity_blocks=self.capacity_blocks,
            offload_blocks=len(self._store),
            offload_bytes=self.nbytes,
            offload_saves=self.saves,
            offload_recalls=self.recalls,
            offload_lru_evictions=self.lru_evictions,
            offload_dropped=self.dropped,
            offload_recall_wall_s=self.recall_wall_s,
        )

    def audit(self) -> list[str]:
        """Internal invariants; returns violation strings (empty = clean)."""
        errs: list[str] = []
        if len(self._store) > max(self.capacity_blocks, 0):
            errs.append(f"host tier over capacity: {len(self._store)} > {self.capacity_blocks}")
        nbytes = sum(hb.nbytes for hb in self._store.values())
        if nbytes != self.nbytes:
            errs.append(f"byte accounting drift: {self.nbytes} != {nbytes}")
        for key, hb in self._store.items():
            if hb.key != key:
                errs.append(f"store key mismatch at {key}")
        slots = [hb.slot for hb in self._store.values()] + self._free_slots
        if self.capacity_blocks > 0 and sorted(slots) != list(range(self.capacity_blocks)):
            errs.append("host slots leaked or double-owned")
        return errs


def timed(fn, tier: HostOffloadTier):
    """Run ``fn()`` accumulating its wall time into the tier's recall clock
    (kept out of the virtual clock: wall time is information only)."""
    t0 = time.monotonic()
    try:
        return fn()
    finally:
        tier.recall_wall_s += time.monotonic() - t0
