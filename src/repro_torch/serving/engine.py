"""Serving engine: prefill/decode around a ModelBundle, with slot-based
continuous batching (port of ``repro.serving.engine`` for the slab and
paged layouts).

The default serving policy (``serving_policy`` / ``Engine.build``) is the
one-pass FIER pipeline: the CUDA retrieval kernel (1-bit score scan +
group-reduce + masking + exact radix threshold top-k, per-token scores
never in device memory) chained into the CUDA select-and-attend kernel
(rows gathered in-kernel, no K'/V' copies); on a paged cache their
block-table variants.

The cache lives on the engine's device and is updated in place by every
call: the cache a call returns aliases the one it was given.  Slab
``insert`` prefills one request (B=1) and copies its cache into one slot.

Paged mode (``Engine.build(..., layout='paged')``): the cache is a shared
block pool + per-request block tables.  The engine owns the host-side
``BlockAllocator`` (radix-trie prefix cache, full-prompt hits replay the
cached first-token logits and skip prefill, copy-on-write on shared tails),
and insertion scatters the prefilled slab block-wise into the pool, so
device memory is bounded by tokens resident, not slots × capacity.  Under
pool pressure the budget-degradation ladder halves the retrieval budget
and sheds middle blocks.  The host-DRAM offload tier, TTL expiry and the
fault hooks wait for ROADMAP Queue 1 item 8; mesh sharding for item 10.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import Counter, OrderedDict

import torch

from repro_torch import resolve_device
from repro_torch.core.policy import DecodePlan, PolicyConfig
from repro_torch.kvcache.paged import (
    NULL_BLOCK,
    AllocatorAuditError,
    BlockAllocator,
    SeqBlocks,
    block_hash_chain,
)
from repro_torch.models.model_zoo import ModelBundle, build_model
from repro_torch.obs import Observability

MAX_CACHED_PROMPT_LOGITS = 1024  # LRU bound on the full-prompt logits cache
# graceful-degradation budget ladder: under pool pressure the scheduler
# halves the retrieval budget down to DEGRADE_FLOOR, and the full budget
# comes back once the free pool recovers past RESTORE_FREE_FRAC of it
DEGRADE_FLOOR = 64
RESTORE_FREE_FRAC = 0.5

__all__ = [
    "AllocatorAuditError", "Engine", "PoolExhausted", "SamplingConfig",
    "sample_token", "serving_policy",
]


class PoolExhausted(RuntimeError):
    """The block pool ran dry mid-operation.  The operation has been rolled
    back — the caller can re-queue and retry."""


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def serving_policy(
    budget: int = 1024,
    group: int = 32,
    *,
    skip_layers: int = 2,
    sink: int = 4,
    recent: int = 64,
    pipeline: str = "one_pass",
    layout: str = "slab",
) -> PolicyConfig:
    """The serving-default FIER policy: the ``one_pass`` pipeline with the
    standard sink/recent guard-rails.  ``pipeline='reference'`` is the
    plain top-k + gather oracle, which runs no custom kernel.
    ``layout='paged'`` serves from the block-pool cache."""
    return PolicyConfig(
        kind="fier", budget=budget, group=group, skip_layers=skip_layers,
        sink=sink, recent=recent, pipeline=pipeline, layout=layout,
    )


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0   # 0 → greedy
    top_k: int = 0             # 0 → no truncation


def sample_token(
    logits: torch.Tensor, cfg: SamplingConfig, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Greedy argmax (first maximum) or temperature/top-k sampling drawn
    from ``generator``.  logits [B, V] → int32 [B]."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.to(torch.float32) / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(lg, cfg.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def _pool_leaves(part: dict) -> list[torch.Tensor]:
    """Every stacked pool tensor [L, N, pb, ...] of one cache part."""
    leaves = [part["k"], part["v"]]
    if "meta" in part:
        m = part["meta"]
        leaves += [m.codes, m.scale, m.zero]
    return leaves


class Engine:
    """Batched generation engine with continuous-batching slot management."""

    def __init__(
        self,
        bundle: ModelBundle,
        *,
        n_slots: int,
        capacity: int,
        sampling: SamplingConfig = SamplingConfig(),
        seed: int = 0,
        obs: Observability | None = None,
        offload_blocks: int = 0,
    ):
        if offload_blocks > 0:
            raise _not_ported("the host-DRAM offload tier (offload_blocks > 0)", "8")
        self.bundle = bundle
        self.device = bundle.device
        # observability bundle: shared metrics registry + tracer; the default
        # is the disabled bundle (no-op instruments, null tracer)
        self.obs = obs if obs is not None else Observability.disabled()
        self.n_slots = n_slots
        self.capacity = capacity
        self.sampling = sampling
        # sampling generator: each decode call draws fresh numbers from it
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        pol = bundle.policy
        self.paged = bool(pol is not None and pol.layout == "paged")
        if bundle.plan is not None:
            bundle.plan.validate_capacity(capacity)
        self._decode_step = bundle.decode_step

        self.base_budget = pol.budget if pol is not None else 0
        self.current_budget = self.base_budget
        self.downshifts = 0
        self.restores = 0
        self.blocks_shed = 0
        self.prefill_count = 0
        self.prefix_hits = 0
        self._budget_fns = {self.base_budget: self._decode_step}
        self._chunk_keys: dict[int, list[int]] = {}

        if self.paged:
            self.block_size = pol.block_size
            if capacity % self.block_size:
                raise ValueError(
                    f"capacity {capacity} not divisible by block_size {self.block_size}"
                )
            self.n_btab = capacity // self.block_size
            self.pool_blocks = pol.pool_blocks or (n_slots * self.n_btab + 1)
            if self.pool_blocks - 1 < self.n_btab:
                # the scheduler retires requests outgrowing the pool as
                # `rejected` (livelock detection + admission-time bound)
                warnings.warn(
                    f"pool_blocks={self.pool_blocks} cannot hold one "
                    f"worst-case context ({self.n_btab} blocks + null): "
                    f"requests outgrowing the pool will be retired as "
                    f"rejected instead of running to capacity"
                )
            self.allocator = BlockAllocator(self.pool_blocks, self.block_size)
            self._pool_clock = None
            self.prefix_partial_hits = 0
            self.tokens_recomputed = 0
            self._seq: dict[int, SeqBlocks] = {}
            self._prompt_logits: OrderedDict[int, torch.Tensor] = OrderedDict()

    @classmethod
    def build(
        cls,
        cfg,
        *,
        n_slots: int,
        capacity: int,
        policy: PolicyConfig | None = None,
        sampling: SamplingConfig = SamplingConfig(),
        layout: str | None = None,
        obs: Observability | None = None,
        offload_blocks: int = 0,
        mesh=None,
        device="cuda",
        seed: int = 0,
    ) -> "Engine":
        """Build bundle + engine with the serving defaults: when ``policy``
        is None the one-pass FIER fast path (``serving_policy()``) with the
        budget clamped to ``capacity``.  ``layout='paged'`` switches the
        cache to the block pool; its block size and pool size are the
        policy's (``PolicyConfig.block_size`` / ``pool_blocks``, where 0
        keeps the worst-case pool).  ``device`` defaults to CUDA;
        a machine without a card raises unless ``device='cpu'`` is passed."""
        dev = resolve_device(device)
        if mesh is not None:
            raise _not_ported("mesh-sharded serving", "10")
        if policy is not None:
            pol = policy
        else:
            base = serving_policy()
            pol = dataclasses.replace(base, budget=min(base.budget, capacity))
        if layout is not None and layout != pol.layout:
            pol = dataclasses.replace(pol, layout=layout)
        bundle = build_model(cfg, pol, device=dev)
        return cls(
            bundle, n_slots=n_slots, capacity=capacity, sampling=sampling, seed=seed,
            obs=obs, offload_blocks=offload_blocks,
        )

    # ------------------------------------------------------------ lifecycle
    def compute_params(self, params: dict) -> dict:
        """Params with one bf16 copy of each layer weight, so calls stop
        casting them (the numbers do not change)."""
        return self.bundle.compute_params(params)

    def new_cache(self, length: int = 0) -> dict:
        if self.current_budget != self.base_budget:
            # a degraded budget never outlives its serving session
            self.restore_budget()
        if self.paged:
            # the pool restarts empty: a fresh allocator, no prompt caches
            self.allocator = BlockAllocator(self.pool_blocks, self.block_size)
            if self._pool_clock is not None:
                self.set_pool_clock(self._pool_clock)
            self._seq = {}
            self._prompt_logits = OrderedDict()
        return self.bundle.init_cache(self.n_slots, self.capacity, length)

    def prefill_batch(self, params, batch):
        """Whole-batch prefill: (logits [B, Vp], slab cache of B slots)."""
        if self.paged:
            raise NotImplementedError(
                "paged engines insert requests one by one (Engine.insert / "
                "ContinuousScheduler); whole-batch prefill returns a slab "
                "cache the paged decode step cannot consume"
            )
        return self.bundle.prefill(params, batch, capacity=self.capacity)

    def _prefill_one(self, params, tokens_1xS, length: int):
        batch = {
            "tokens": tokens_1xS,
            "lengths": torch.tensor([length], dtype=torch.int32, device=self.device),
        }
        logits, single = self.bundle.prefill(params, batch, capacity=self.capacity)
        self.prefill_count += 1
        return logits, single

    def insert(self, params, batched_cache, tokens_1xS, length: int, slot: int):
        """Prefill one request and place it into ``slot``.  Returns (its
        first-token logits [1, Vp], the batched cache, updated in place).

        Paged mode: allocates/shares blocks through the allocator; a
        full-prompt prefix hit skips the prefill entirely (the first-token
        logits are replayed from the prompt cache)."""
        if self.paged:
            return self._insert_paged(params, batched_cache, tokens_1xS, length, slot)
        logits, single = self._prefill_one(params, tokens_1xS, length)
        for part in ("front", "rest"):
            dst, src = batched_cache[part], single[part]
            for name in ("k", "v"):
                dst[name][:, slot] = src[name][:, 0]
            if "meta" in dst:
                for name in ("codes", "scale", "zero"):
                    getattr(dst["meta"], name)[:, slot] = getattr(src["meta"], name)[:, 0]
        batched_cache["length"][slot] = length
        return logits, batched_cache

    # ------------------------------------------------------- paged lifecycle
    def _paged_scatter(self, cache, single, row: list[int], first: int, slot: int, length: int):
        """Scatter a prefilled single-request slab cache into the pool:
        logical blocks ``first..len(row)-1`` go to pool blocks ``row[first:]``
        (blocks before ``first`` are prefix hits whose identical contents
        are resident already), then publish the slot's table row and
        length."""
        ids = torch.tensor(row[first:], dtype=torch.int64, device=self.device)
        nb = len(row)
        for part in ("front", "rest"):
            for pool, slab in zip(_pool_leaves(cache[part]), _pool_leaves(single[part])):
                L, _, pb = pool.shape[:3]
                if L == 0 or first == nb:
                    continue
                blocks = slab[:, 0, : nb * pb].reshape(L, nb, pb, *pool.shape[3:])
                pool[:, ids] = blocks[:, first:].to(pool.dtype)
        self._set_slot_state(cache, slot, row, length)

    def _set_slot_state(self, cache, slot: int, row: list[int], length: int):
        full = torch.zeros((self.n_btab,), dtype=torch.int32)
        full[: len(row)] = torch.tensor(row, dtype=torch.int32)
        cache["block_table"][slot] = full.to(self.device)
        cache["length"][slot] = length

    def _set_table_entry(self, cache, slot: int, j: int, bid: int):
        cache["block_table"][slot, j] = bid

    def _copy_block(self, cache, src: int, dst: int):
        """Copy-on-write: duplicate pool block ``src`` into ``dst`` across
        every layer of every pool leaf (K/V and the code side-car)."""
        for part in ("front", "rest"):
            for pool in _pool_leaves(cache[part]):
                pool[:, dst] = pool[:, src]

    def _zero_block(self, cache, bid: int):
        """Scrub a recycled block before a decode-time append lands in it:
        the append-time metadata refresh merges with the group stats already
        in the block, so stale stats would leak into the new tokens'
        quantization — zeroing makes decode independent of pool history."""
        for part in ("front", "rest"):
            for pool in _pool_leaves(cache[part]):
                pool[:, bid].zero_()

    def _drain_evictions(self, cache):
        """Snapshot just-evicted prefix blocks into the host tier.  The port
        has no host tier yet (ROADMAP Queue 1 item 8), so this does nothing,
        as the JAX package's does without one."""
        return cache

    def sweep_parked(self, cache):
        """TTL sweep of parked prefix blocks into the host tier."""
        raise _not_ported("the TTL sweep of parked prefix blocks (sweep_parked)", "8")

    def set_pool_clock(self, clock) -> None:
        """Point the allocator trie at an external monotone clock (the
        scheduler's virtual token clock); remembered across ``new_cache``."""
        self._pool_clock = clock
        self.allocator.set_clock(clock)

    def _remember_logits(self, key: int, logits: torch.Tensor) -> None:
        self._prompt_logits[key] = logits.detach().to("cpu", copy=True)
        while len(self._prompt_logits) > MAX_CACHED_PROMPT_LOGITS:
            self._prompt_logits.popitem(last=False)

    def try_prefix_replay(self, cache, tokens, slot: int):
        """Full-prompt prefix hit: every block resident AND the first-token
        logits cached under the full-prompt key — place the slot with zero
        prefill FLOPs.  Returns (logits | None, cache); None means no full
        hit and nothing was changed."""
        if not self.paged:
            return None, cache
        toks = [int(t) for t in tokens]
        keys = block_hash_chain(toks, self.block_size)
        if not keys or keys[-1] not in self._prompt_logits:
            return None, cache
        n_hit, _ = self.allocator.peek(keys)
        if n_hit < len(keys):
            return None, cache
        blocks = [self.allocator.lookup(key) for key in keys]
        self.prefix_hits += 1
        self._prompt_logits.move_to_end(keys[-1])
        self._set_slot_state(cache, slot, blocks, len(toks))
        self._seq[slot] = SeqBlocks(blocks=blocks, length=len(toks))
        return self._prompt_logits[keys[-1]].to(self.device), cache

    def _insert_paged(self, params, cache, tokens_1xS, length: int, slot: int):
        toks = [int(t) for t in tokens_1xS[0, :length].tolist()]
        keys = block_hash_chain(toks, self.block_size)
        nb = len(keys)
        if nb > self.n_btab:
            raise ValueError(f"prompt of {length} tokens exceeds capacity {self.capacity}")
        if slot in self._seq:
            raise ValueError(f"slot {slot} still holds blocks; release first")
        logits, cache = self.try_prefix_replay(cache, toks, slot)
        if logits is not None:
            return logits, cache
        # longest shared prefix: take a reference on every hit block
        blocks: list[int] = []
        for key in keys:
            bid = self.allocator.lookup(key)
            if bid is None:
                break
            blocks.append(bid)
        n_hit = len(blocks)
        for _ in range(n_hit, nb):
            bid = self.allocator.alloc()
            if bid is None:
                for b in blocks:
                    self.allocator.free(b)
                raise PoolExhausted(
                    "block pool exhausted during insert — admit on "
                    "Engine.blocks_needed() <= Engine.free_blocks first"
                )
            blocks.append(bid)
        cache = self._drain_evictions(cache)
        logits, single = self._prefill_one(params, tokens_1xS, length)
        # monolithic prefill recomputes the whole prompt (hit blocks only
        # skip their writes); chunked admission turns hits into skipped work
        self.tokens_recomputed += length
        self._paged_scatter(cache, single, blocks, n_hit, slot, length)
        for i in range(n_hit, nb):
            self.allocator.register(blocks[i], keys[i], parent_key=keys[i - 1] if i else None)
        if keys:
            self._remember_logits(keys[-1], logits)
        self._seq[slot] = SeqBlocks(blocks=blocks, length=length)
        return logits, cache

    @property
    def free_blocks(self) -> int:
        return self.allocator.n_free

    def blocks_needed(self, tokens) -> int:
        """Fresh pool blocks an admission of ``tokens`` would consume
        (prefix-cache hits subtracted, free-cached revivals charged)."""
        keys = block_hash_chain(tokens, self.block_size)
        return self.allocator.blocks_needed(len(tokens), keys)

    # ------------------------------------------------------- chunked prefill
    def blocks_needed_chunk(self, tokens, chunk_tokens: int) -> int:
        """Fresh pool blocks needed to *begin* a chunked admission of
        ``tokens`` and run its first chunk (resume-prefix hits discounted,
        free-cached revivals charged)."""
        L = len(tokens)
        keys = block_hash_chain(tokens, self.block_size)
        flags = self.allocator.peek_prefix(keys)
        # begin_chunked never resumes past L-1 (the final chunk must run at
        # least one token to produce logits): drop tail hits
        while flags and len(flags) * self.block_size >= L:
            flags.pop()
        end = min(len(flags) * self.block_size + chunk_tokens, L)
        nb = -(-end // self.block_size)
        return (nb - len(flags)) + sum(flags)

    def begin_chunked(self, cache, slot: int, tokens):
        """Open a chunked insertion of the full prompt ``tokens`` into
        ``slot``.  Returns (resume, cache): the position the first
        ``prefill_chunk`` call starts from.

        Paged: takes references on prefix-cache hit blocks (capped at the
        last whole block *before* the prompt end, so the final chunk always
        computes logits); the device table row stays zeroed until the final
        chunk, so interleaved decode steps route this slot's scratch writes
        to the null block.  Slab: parks the slot's length at ``capacity`` so
        the scratch writes clamp onto the last row (masked, and rewritten by
        the final chunk when the prompt fills the slab)."""
        if not self.paged:
            cache["length"][slot] = self.capacity
            return 0, cache
        if slot in self._seq:
            raise ValueError(f"slot {slot} still holds blocks; release first")
        toks = [int(t) for t in tokens]
        keys = block_hash_chain(toks, self.block_size)
        if len(keys) > self.n_btab:
            raise ValueError(f"prompt of {len(toks)} tokens exceeds capacity {self.capacity}")
        L = len(toks)
        blocks: list[int] = []
        for key in keys:
            bid = self.allocator.lookup(key)
            if bid is None:
                break
            blocks.append(bid)
        while blocks and len(blocks) * self.block_size >= L:
            self.allocator.free(blocks.pop())
        resume = len(blocks) * self.block_size
        if resume:
            self.prefix_partial_hits += 1
        self._seq[slot] = SeqBlocks(blocks=blocks, length=resume)
        self._chunk_keys[slot] = keys
        return resume, cache

    def prefill_chunk(self, params, cache, slot: int, tokens, start: int, n: int):
        """Run one chunk — prompt positions [start, start+n) — of an open
        chunked insertion.  Returns (ok, logits | None, cache): ok=False
        means the paged pool could not grow the allocation (nothing
        changed); logits come only from the final chunk.

        Paged bookkeeping per chunk: fresh blocks are allocated
        all-or-nothing, and every block fully covered by completed chunks is
        hash-registered at once, so an aborted half-prefilled request
        re-admits from the completed-chunk boundary instead of token 0."""
        toks = torch.as_tensor(tokens, dtype=torch.int64).reshape(-1)
        L = int(toks.shape[0])
        end = start + n
        if not (0 < n and end <= L <= self.capacity):
            raise ValueError(f"bad chunk [{start}, {end}) of {L} tokens")
        final = end == L
        batch = {
            "tokens": toks[None, start:end].to(self.device),
            "start": start, "slot": slot, "total": L,
        }
        if self.paged:
            seq = self._seq[slot]
            if start != seq.length:
                raise ValueError(f"chunk starts at {start}, slot resident to {seq.length}")
            nb_needed = -(-end // self.block_size)
            fresh: list[int] = []
            while len(seq.blocks) + len(fresh) < nb_needed:
                bid = self.allocator.alloc()
                if bid is None:
                    for b in fresh:
                        self.allocator.free(b)
                    return False, None, cache
                fresh.append(bid)
            seq.blocks.extend(fresh)
            if fresh:
                cache = self._drain_evictions(cache)
            row = torch.zeros((self.n_btab,), dtype=torch.int32)
            row[: len(seq.blocks)] = torch.tensor(seq.blocks, dtype=torch.int32)
            batch["table_row"] = row.to(self.device)
        logits, cache = self.bundle.prefill_chunk(params, batch, cache, final=final)
        if self.paged:
            seq.length = end
            self.tokens_recomputed += n
            keys = self._chunk_keys[slot]
            for j in range(end // self.block_size):
                self.allocator.register(
                    seq.blocks[j], keys[j], parent_key=keys[j - 1] if j else None
                )
            if final:
                if L % self.block_size:
                    self.allocator.register(
                        seq.blocks[-1], keys[-1],
                        parent_key=keys[-2] if len(keys) > 1 else None,
                    )
                self.prefill_count += 1
                self._remember_logits(keys[-1], logits)
                del self._chunk_keys[slot]
        return True, logits, cache

    def abort_chunked(self, cache, slot: int):
        """Abandon an open chunked insertion: drop the slot's block
        references (registered completed-chunk blocks park free-cached, so
        a re-admission resumes from the boundary)."""
        self._chunk_keys.pop(slot, None)
        if self.paged:
            cache = self.release_slot(cache, slot)
        return cache

    def advance_slot(self, cache, slot: int):
        """Guarantee the next decode write of ``slot`` lands in a private,
        allocated block: a fresh (zeroed) tail block on a block boundary, or
        copy-on-write of a shared tail.  Returns (ok, cache); ok=False means
        the pool is dry — the caller degrades or preempts and retries.  Call
        once per running slot before every decode step."""
        seq = self._seq[slot]
        pos = seq.length
        if pos >= self.capacity:
            # at capacity the write routes to the null block; the scheduler
            # retires the request at this boundary
            return True, cache
        j, off = divmod(pos, self.block_size)
        if off == 0:
            bid = self.allocator.alloc()
            if bid is None:
                return False, cache
            cache = self._drain_evictions(cache)
            self._zero_block(cache, bid)
            seq.blocks.append(bid)
            self._set_table_entry(cache, slot, j, bid)
        else:
            b = seq.blocks[j]
            if self.allocator.ref[b] > 1:
                bid = self.allocator.alloc()
                if bid is None:
                    return False, cache
                cache = self._drain_evictions(cache)
                self._copy_block(cache, b, bid)
                self.allocator.free(b)
                self.allocator.cow_copies += 1
                seq.blocks[j] = bid
                self._set_table_entry(cache, slot, j, bid)
        seq.length = pos + 1
        return True, cache

    def release_slot(self, cache, slot: int):
        """Free a retired/preempted slot: drop the block references (hash-
        registered blocks park in the prefix cache) and zero the table row,
        so the slot's scratch decode writes hit the null block."""
        seq = self._seq.pop(slot, None)
        if seq is not None:
            for b in seq.blocks:
                if b != NULL_BLOCK:  # shed middle blocks leave null holes
                    self.allocator.free(b)
            self._set_slot_state(cache, slot, [], 0)
        return cache

    def engine_stats(self) -> dict:
        """Engine-level serving counters under their canonical (registry)
        names — the companion of ``BlockAllocator.stats()``."""
        out = dict(
            engine_prefills=self.prefill_count,
            engine_prefix_hits=self.prefix_hits,
            engine_budget_downshifts=self.downshifts,
            engine_budget_restores=self.restores,
            engine_blocks_shed=self.blocks_shed,
            engine_current_budget=self.current_budget,
        )
        if self.paged:
            out.update(
                engine_prefix_partial_hits=self.prefix_partial_hits,
                engine_tokens_recomputed=self.tokens_recomputed,
            )
        return out

    def pool_stats(self) -> dict:
        """One snapshot of ``BlockAllocator.stats()`` and ``engine_stats()``,
        under their canonical names."""
        return {**self.allocator.stats(), **self.engine_stats()}

    def sample_pool_gauges(self) -> None:
        """Push the canonical pool + engine counters into the metrics
        registry as gauges (no-op when observability is disabled)."""
        if not self.obs.metrics.enabled:
            return
        m = self.obs.metrics
        if self.paged:
            m.set_gauges(self.allocator.stats())
        m.set_gauges(self.engine_stats())

    # --------------------------------------------- graceful budget degradation
    @property
    def degradable(self) -> bool:
        """Whether this engine's policy has a retrieval budget the ladder
        can downshift ('full' reads everything by definition)."""
        pol = self.bundle.policy
        return pol is not None and pol.kind == "fier"

    def _swap_budget(self, budget: int) -> None:
        """Point decode at a bundle rebuilt with ``budget``: the policy goes
        through ``DecodePlan.build`` (an invalid rung fails here, not in a
        kernel), rungs are cached, and the cache does not depend on the
        budget, so the live cache carries across the swap."""
        fn = self._budget_fns.get(budget)
        if fn is None:
            pol2 = dataclasses.replace(self.bundle.policy, budget=budget)
            DecodePlan.build(pol2, capacity=self.capacity)
            bundle2 = build_model(self.bundle.cfg, pol2, device=self.device)
            fn = self._budget_fns[budget] = bundle2.decode_step
        self._decode_step = fn
        self.current_budget = budget

    def downshift_budget(self) -> bool:
        """One rung down the ladder (halve, floored at ``DEGRADE_FLOOR``).
        False when already at the floor / not degradable."""
        if not self.degradable:
            return False
        new = max(DEGRADE_FLOOR, self.current_budget // 2)
        if new >= self.current_budget:
            return False
        prev = self.current_budget
        self._swap_budget(new)
        self.downshifts += 1
        if self.obs.enabled:
            self.obs.tracer.instant(
                "budget_downshift", cat="degradation", from_budget=prev, to_budget=new)
            self.obs.metrics.counter(
                "budget_downshifts_total", "degradation-ladder budget halvings").inc()
        return True

    def restore_budget(self) -> bool:
        """Back to the full configured budget (pressure cleared)."""
        if self.current_budget == self.base_budget:
            return False
        prev = self.current_budget
        self._swap_budget(self.base_budget)
        self.restores += 1
        if self.obs.enabled:
            self.obs.tracer.instant(
                "budget_restore", cat="degradation", from_budget=prev,
                to_budget=self.base_budget)
            self.obs.metrics.counter(
                "budget_restores_total", "degradation-ladder full-budget restores").inc()
        return True

    def maybe_restore_budget(self) -> bool:
        """Restore the full budget iff degraded and the free pool has
        recovered past ``RESTORE_FREE_FRAC`` of the usable blocks."""
        if self.current_budget == self.base_budget or not self.paged:
            return False
        if self.allocator.n_free < RESTORE_FREE_FRAC * self.allocator.usable:
            return False
        return self.restore_budget()

    def shed_middle_blocks(self, cache, slot: int):
        """Free the *middle* blocks of a running slot — the memory half of a
        budget downshift.  Keeps the sink blocks at the front and the
        recent-window + writable-tail blocks at the back and replaces each
        shed entry with the null block (scored like any block, read only if
        selected).  Shared blocks are skipped (dropping one ref of a ref>1
        block frees nothing); hash-registered blocks park free-cached with
        their contents intact.  Returns (blocks freed, cache)."""
        seq = self._seq.get(slot)
        pol = self.bundle.policy
        if seq is None or pol is None:
            return 0, cache
        bs = self.block_size
        keep_front = max(1, -(-pol.sink // bs))
        keep_tail = max(2, -(-(pol.recent + 1) // bs))
        freed = 0
        for j in range(keep_front, len(seq.blocks) - keep_tail):
            b = seq.blocks[j]
            if b == NULL_BLOCK or self.allocator.ref[b] > 1:
                continue
            seq.blocks[j] = NULL_BLOCK
            self._set_table_entry(cache, slot, j, NULL_BLOCK)
            self.allocator.free(b)
            freed += 1
        self.blocks_shed += freed
        if freed and self.obs.enabled:
            self.obs.tracer.instant("blocks_shed", cat="degradation", slot=slot, freed=freed)
            self.obs.metrics.counter(
                "blocks_shed_total", "middle blocks freed by budget degradation").inc(freed)
        return freed, cache

    # ----------------------------------------------------- faults & auditing
    def corrupt_slot_metadata(self, cache, slot: int):
        """Chaos hook of the fault injector."""
        raise _not_ported("the serving fault hooks (corrupt_slot_metadata)", "8")

    def audit(self) -> None:
        """Cross-check the allocator against the engine's live sequences:
        every block reference the engine holds must be counted exactly by
        the allocator, on top of its internal invariants.  Raises
        ``AllocatorAuditError``; no-op for slab engines."""
        if not self.paged:
            return
        owners: Counter[int] = Counter()
        for seq in self._seq.values():
            for b in seq.blocks:
                if b != NULL_BLOCK:
                    owners[b] += 1
        self.allocator.audit(dict(owners))

    def decode(self, params, tokens, cache, active=None, generator=None):
        """One decode step for all slots; inactive slots don't advance (their
        cache writes land beyond their length or, paged, in the null block).
        tokens [n_slots] → (next_tokens [n_slots] int32, logits, cache)."""
        old_len = cache["length"]
        logits, new_cache = self._decode_step(params, tokens, cache)
        if active is not None:
            new_cache["length"] = torch.where(active, new_cache["length"], old_len)
        nxt = sample_token(logits, self.sampling, generator or self._gen)
        return nxt, logits, new_cache

    # --------------------------------------------------------- conveniences
    def generate(
        self, params, prompts: torch.Tensor, lengths: torch.Tensor, max_new: int,
        generator: torch.Generator | None = None, return_cache: bool = False,
    ):
        """Static-batch generate: prefill the whole batch then decode
        ``max_new - 1`` steps.  prompts [B, S]; returns tokens [B, max_new]
        (and the cache, when ``return_cache``, for continuing the session)."""
        if self.paged:
            raise NotImplementedError(
                "paged engines generate through the ContinuousScheduler "
                "(per-request insert + block accounting), not the "
                "static-batch generate path"
            )
        gen = generator or self._gen
        logits, cache = self.prefill_batch(params, {"tokens": prompts, "lengths": lengths})
        tok = sample_token(logits, self.sampling, gen)
        outs = [tok]
        for _ in range(max_new - 1):
            tok, _, cache = self.decode(params, tok, cache, generator=gen)
            outs.append(tok)
        toks = torch.stack(outs, dim=1)
        return (toks, cache) if return_cache else toks
