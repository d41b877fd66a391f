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
``insert`` prefills one request (B=1) and copies its cache into one slot
along each leaf's batch axis, found by diffing the shapes of two empty
caches (any family's tree: the transformer's front/rest slabs, a Mamba2
state, the hybrid's per-application KV, the encoder-decoder's cross K/V).
``insert`` and ``generate`` merge ``extras`` into the prefill batch (an
encdec model's ``frames``, a vlm's ``vision_embeds``).

Paged mode (``Engine.build(..., layout='paged')``): the cache is a shared
block pool + per-request block tables.  The engine owns the host-side
``BlockAllocator`` (radix-trie prefix cache, full-prompt hits replay the
cached first-token logits and skip prefill, copy-on-write on shared tails),
and insertion scatters the prefilled slab block-wise into the pool, so
device memory is bounded by tokens resident, not slots × capacity.  Under
pool pressure the budget-degradation ladder halves the retrieval budget
and sheds middle blocks.  Two-tier KV reuse: parked prefix blocks age out
by TTL (``prefix_ttl``, on the scheduler's virtual clock) and, with
``offload_blocks > 0``, every evicted block is saved to a pinned host tier
(``kvcache.offload``) and recalled bit-identically when a later prompt's
prefix walk runs off the device trie.  ``corrupt_slot_metadata`` is the
fault injector's side-car scrambler.  The paper's baselines (``quest``,
``slm``) serve through ``Engine.build(..., policy=...)`` on the slab
layout.

Mesh sharding (``Engine.build(..., layout='paged', mesh=...)``): the pool
splits over the mesh — axes named ``'model'`` run KV-head tensor
parallelism, axes named ``'data'`` slot data parallelism
(``kvcache.sharded``).  Slots split into contiguous per-shard ranges, each
slot's blocks come from its home DP shard (``ShardedBlockAllocator``, one
allocator and prefix trie per shard), prefill runs once unsharded and its
K/V scatter into the owning shards, and the decode step runs the plan on
every shard.  The engine's own code stays single-controller: it addresses
blocks by global id, and the sharded pool leaves route each access.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import Counter, OrderedDict

import torch

from repro_torch import resolve_device
from repro_torch.core.policy import DecodePlan, PolicyConfig
from repro_torch.core.quantize import QuantizedKeys
from repro_torch.kvcache.offload import HostOffloadTier
from repro_torch.kvcache.paged import (
    NULL_BLOCK,
    AllocatorAuditError,
    BlockAllocator,
    SeqBlocks,
    block_hash_chain,
)
from repro_torch.kvcache.sharded import ShardedBlockAllocator, ShardSpec, shard_cache
from repro_torch.models.attention import DistConfig
from repro_torch.models.model_zoo import ModelBundle, build_model
from repro_torch.obs import Observability

MAX_CACHED_PROMPT_LOGITS = 1024  # LRU bound on the full-prompt logits cache
# graceful-degradation budget ladder: under pool pressure the scheduler
# halves the retrieval budget down to DEGRADE_FLOOR, and the full budget
# comes back once the free pool recovers past RESTORE_FREE_FRAC of it
DEGRADE_FLOOR = 64
RESTORE_FREE_FRAC = 0.5
# virtual-clock units a host-tier recall of one block costs (a prefill of the
# block would cost block_size units)
RECALL_COST = 1.0

__all__ = [
    "AllocatorAuditError", "Engine", "PoolExhausted", "SamplingConfig",
    "sample_token", "serving_policy",
]


class PoolExhausted(RuntimeError):
    """The block pool ran dry mid-operation.  The operation has been rolled
    back — the caller can re-queue and retry."""


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


def cache_leaves(tree) -> list[torch.Tensor]:
    """Every tensor of a cache tree in a fixed order: dict keys sorted, a
    side-car (``QuantizedKeys`` / ``PageMeta``) by its ``FIELDS``."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in cache_leaves(tree[k])]
    if hasattr(tree, "FIELDS"):
        return [getattr(tree, name) for name in tree.FIELDS]
    return [tree]


def cache_batch_axes(bundle: ModelBundle, capacity: int) -> list[int]:
    """The batch axis of each ``cache_leaves`` entry of the bundle's cache,
    found by diffing the shapes of ``init_cache(2)`` and ``init_cache(3)``
    (built on the meta device: no memory), as the reference's
    ``_cache_batch_axes`` does."""
    c2 = cache_leaves(bundle.init_cache(2, capacity, 0, device="meta"))
    c3 = cache_leaves(bundle.init_cache(3, capacity, 0, device="meta"))
    axes = []
    for a, b in zip(c2, c3):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diffs) != 1:
            raise ValueError(f"ambiguous batch axis: {tuple(a.shape)} vs {tuple(b.shape)}")
        axes.append(diffs[0])
    return axes


def _pool_leaves(part: dict) -> list[torch.Tensor]:
    """Every stacked pool tensor [L, N, pb, ...] of one cache part (K, V and
    the side-car's tensors)."""
    leaves = [part["k"], part["v"]]
    if "meta" in part:
        m = part["meta"]
        leaves += [getattr(m, name) for name in m.FIELDS]
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
        prefix_ttl: float | None = None,
        degrade_floor: int | None = None,
    ):
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
        # mesh sharding: the ShardSpec the bundle's plans carry (the ladder's
        # rebuilds keep it through the bundle's DistConfig)
        self.shard = shard = bundle.plan.shard if bundle.plan is not None else None
        self._n_dp = shard.n_dp if shard is not None else 1
        if n_slots % self._n_dp:
            raise ValueError(f"n_slots {n_slots} not divisible by {self._n_dp} DP shards")
        self._slots_per_shard = n_slots // self._n_dp
        if bundle.plan is not None:
            bundle.plan.validate_capacity(capacity)
        self._decode_step = bundle.decode_step

        self.base_budget = pol.budget if pol is not None else 0
        self.current_budget = self.base_budget
        # the ladder's floor (None: DEGRADE_FLOOR); a floor at the budget
        # turns the ladder off, so pool pressure preempts instead
        self.degrade_floor = degrade_floor
        self.downshifts = 0
        self.restores = 0
        self.blocks_shed = 0
        self.prefill_count = 0
        self.prefix_hits = 0
        self._budget_fns = {self.base_budget: self._decode_step}
        self._chunk_keys: dict[int, list[int]] = {}
        self._batch_axes: list[int] | None = None  # cache_batch_axes, at first insert

        if self.paged:
            self.block_size = pol.block_size
            if capacity % self.block_size:
                raise ValueError(
                    f"capacity {capacity} not divisible by block_size {self.block_size}"
                )
            self.n_btab = capacity // self.block_size
            # a sharded pool reserves one null block per DP shard
            self.pool_blocks = pol.pool_blocks or (n_slots * self.n_btab + self._n_dp)
            if self.pool_blocks % self._n_dp:
                raise ValueError(f"pool_blocks {self.pool_blocks} not divisible by "
                                 f"{self._n_dp} DP shards")
            if self.pool_blocks // self._n_dp - 1 < self.n_btab:
                # the scheduler retires requests outgrowing the pool as
                # `rejected` (livelock detection + admission-time bound)
                warnings.warn(
                    f"pool_blocks={self.pool_blocks} cannot hold one "
                    f"worst-case context ({self.n_btab} blocks + null): "
                    f"requests outgrowing the pool will be retired as "
                    f"rejected instead of running to capacity"
                )
            # two-tier KV reuse: the trie-backed allocator is tier 1 (free-
            # but-cached device blocks, TTL-aged on the scheduler's virtual
            # clock); an optional host tier receives LRU/TTL-evicted blocks
            # and recalls them bit-identically at admission time
            self.prefix_ttl = prefix_ttl
            self.recall_cost = RECALL_COST
            self.allocator = self._make_allocator()
            self.offload: HostOffloadTier | None = (
                HostOffloadTier(offload_blocks) if offload_blocks > 0 else None
            )
            self.allocator.record_evictions = self.offload is not None
            self._pool_clock = None
            self.prefix_partial_hits = 0
            self.blocks_recalled = 0
            self.tokens_recalled = 0
            self.tokens_recomputed = 0
            self._recall_units = 0.0
            self._seq: dict[int, SeqBlocks] = {}
            self._prompt_logits: OrderedDict[int, torch.Tensor] = OrderedDict()
        else:
            self.offload = None

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
        prefix_ttl: float | None = None,
        mesh=None,
        shard_mode: str = "exact",
        device="cuda",
        seed: int = 0,
        max_positions: int | None = None,
    ) -> "Engine":
        """Build bundle + engine with the serving defaults: when ``policy``
        is None the one-pass FIER fast path (``serving_policy()``) with the
        budget clamped to ``capacity``.  ``layout='paged'`` switches the
        cache to the block pool; its block size and pool size are the
        policy's (``PolicyConfig.block_size`` / ``pool_blocks``, where 0
        keeps the worst-case pool).  ``offload_blocks`` attaches a host tier
        of that many blocks and ``prefix_ttl`` ages parked prefix blocks out
        after that many virtual-clock units (paged layout).  ``device``
        defaults to CUDA; a machine without a card raises unless
        ``device='cpu'`` is passed.  ``max_positions`` goes to
        ``build_model`` (an encdec decoder's position table).

        ``mesh`` (a ``launch.mesh.Mesh``) shards the paged pool over it:
        axes named ``'model'`` run KV-head tensor parallelism, axes named
        ``'data'`` slot data parallelism.  The spec rides on the
        ``DecodePlan`` (checked against each backend's
        ``supports_sharding`` for ``shard_mode``), the allocator becomes
        per-shard (``kvcache.sharded.ShardedBlockAllocator``), and the
        pool's default size gets one null block per DP shard.  The bundle,
        the block tables and the host state stay on ``device``."""
        dev = resolve_device(device)
        if policy is not None:
            pol = policy
        else:
            base = serving_policy()
            pol = dataclasses.replace(base, budget=min(base.budget, capacity))
        if layout is not None and layout != pol.layout:
            pol = dataclasses.replace(pol, layout=layout)
        dcfg = None
        if mesh is not None:
            if pol.layout != "paged":
                raise ValueError(
                    "Engine.build(mesh=...) shards the paged pool; pass "
                    "layout='paged'"
                )
            names = tuple(mesh.axis_names)
            unknown = [a for a in names if a not in ("model", "data")]
            if unknown:
                raise ValueError(
                    f"mesh axes must be named 'model' (TP over KV heads) "
                    f"or 'data' (DP over slots); got {unknown}"
                )
            spec = ShardSpec(
                mesh=mesh,
                tp_axes=tuple(a for a in names if a == "model"),
                dp_axes=tuple(a for a in names if a == "data"),
                mode=shard_mode,
            )
            if cfg.n_kv_heads % spec.n_tp:
                raise ValueError(
                    f"n_kv_heads {cfg.n_kv_heads} not divisible by TP "
                    f"degree {spec.n_tp} (mesh axes "
                    f"{spec.tp_axes!r})"
                )
            if not pol.pool_blocks and capacity % pol.block_size == 0:
                # the engine's default pool (one null block per DP shard),
                # so the cache the bundle builds splits evenly over the shards
                n_btab = capacity // pol.block_size
                pol = dataclasses.replace(pol, pool_blocks=n_slots * n_btab + spec.n_dp)
            # DistConfig.mesh stays None: the paged path carries its mesh
            # on the spec, and seq_axes would arm the slab sequence sharding
            dcfg = DistConfig(shard=spec)
        bundle = build_model(cfg, pol, dcfg, device=dev, max_positions=max_positions)
        return cls(
            bundle, n_slots=n_slots, capacity=capacity, sampling=sampling, seed=seed,
            obs=obs, offload_blocks=offload_blocks, prefix_ttl=prefix_ttl,
        )

    # ------------------------------------------------------- shard routing
    def _make_allocator(self):
        """The host-side allocator for the layout: one pool, or one pool per
        DP shard behind the global-id wrapper."""
        if self._n_dp > 1:
            return ShardedBlockAllocator(
                self.pool_blocks, self.block_size, self._n_dp, park_ttl=self.prefix_ttl)
        return BlockAllocator(self.pool_blocks, self.block_size, park_ttl=self.prefix_ttl)

    def slot_shard(self, slot: int) -> int:
        """Home DP shard of ``slot`` (0 on unsharded engines).  Slots split
        into contiguous per-shard ranges matching the DP split of the slot
        axis, so a slot's blocks always come from — and its decode reads
        always stay on — one shard."""
        return slot // self._slots_per_shard

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
            # the pool restarts empty: a fresh allocator, no prompt caches; the
            # host tier restarts empty too (a session must not see KV made
            # under another session's params), keeping its pinned buffers
            self.allocator = self._make_allocator()
            if self.offload is not None:
                self.offload.clear()
            self.allocator.record_evictions = self.offload is not None
            if self._pool_clock is not None:
                self.set_pool_clock(self._pool_clock)
            self._recall_units = 0.0
            self._seq = {}
            self._prompt_logits = OrderedDict()
        cache = self.bundle.init_cache(self.n_slots, self.capacity, length)
        if self.shard is not None:
            cache = shard_cache(cache, self.shard)
        return cache

    def prefill_batch(self, params, batch):
        """Whole-batch prefill: (logits [B, Vp], slab cache of B slots)."""
        if self.paged:
            raise NotImplementedError(
                "paged engines insert requests one by one (Engine.insert / "
                "ContinuousScheduler); whole-batch prefill returns a slab "
                "cache the paged decode step cannot consume"
            )
        return self.bundle.prefill(params, batch, capacity=self.capacity)

    def _prefill_one(self, params, tokens_1xS, length: int, extras=None):
        batch = {
            "tokens": tokens_1xS,
            "lengths": torch.tensor([length], dtype=torch.int32, device=self.device),
        }
        if extras:
            batch.update(extras)
        logits, single = self.bundle.prefill(params, batch, capacity=self.capacity)
        self.prefill_count += 1
        return logits, single

    def insert(self, params, batched_cache, tokens_1xS, length: int, slot: int, extras=None):
        """Prefill one request and place it into ``slot``.  Returns (its
        first-token logits [1, Vp], the batched cache, updated in place).
        ``extras`` (e.g. ``{"frames": [1, enc_ctx, d]}``) joins the prefill
        batch.

        Slab mode copies every leaf of the single-request cache into the
        slot along its batch axis (``cache_batch_axes``).  Paged mode:
        allocates/shares blocks through the allocator; a full-prompt prefix
        hit skips the prefill entirely (the first-token logits are replayed
        from the prompt cache)."""
        if self.paged:
            return self._insert_paged(params, batched_cache, tokens_1xS, length, slot, extras)
        logits, single = self._prefill_one(params, tokens_1xS, length, extras)
        if self._batch_axes is None:
            self._batch_axes = cache_batch_axes(self.bundle, self.capacity)
        for dst, src, ax in zip(cache_leaves(batched_cache), cache_leaves(single),
                                self._batch_axes):
            dst.select(ax, slot).copy_(src.select(ax, 0))
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
                pool[:, bid] = 0

    def _read_block(self, cache, bid: int) -> list[torch.Tensor]:
        """A copy of block ``bid``'s rows in every pool leaf (front then rest:
        K/V and the side-car), each [L, bs, …] — the payload layout of the
        host tier."""
        return [pool[:, bid].clone() for part in ("front", "rest")
                for pool in _pool_leaves(cache[part])]

    def _block_views(self, cache, bid: int) -> list[torch.Tensor]:
        """Block ``bid`` of every pool leaf: views (a copy, on a sharded
        pool)."""
        return [pool[:, bid] for part in ("front", "rest") for pool in _pool_leaves(cache[part])]

    def _write_block(self, cache, payload, bid: int):
        """Commit a block payload (``_read_block``'s layout) into pool row
        ``bid`` — the device half of a recall; a round trip is bit-identical."""
        leaves = [pool for part in ("front", "rest") for pool in _pool_leaves(cache[part])]
        for pool, src in zip(leaves, payload):
            pool[:, bid] = src
        return cache

    # ----------------------------------------------------- host offload tier
    def _drain_evictions(self, cache):
        """Save just-evicted prefix blocks into the host tier.  Runs after
        the allocator operation that evicted and *before* any device write
        to the reclaimed rows: the rows still hold the evicted contents, and
        the tier's copy is ordered before any later write (``kvcache.offload``)."""
        if self.offload is None:
            return cache
        for ev in self.allocator.take_evicted():
            if self.allocator.key_resident(ev.key):
                continue  # single ownership: a key resident on the device stays there
            self.offload.save(ev.key, ev.parent_key, self._block_views(cache, ev.bid),
                              reason=ev.reason)
            if self.obs.enabled:
                self.obs.metrics.counter(
                    "offload_saves_total", "blocks demoted to the host tier").inc()
        return cache

    def sweep_parked(self, cache):
        """TTL sweep of tier-1 parked blocks — the scheduler calls this once
        per step on its virtual clock.  Expired blocks go to the host tier
        (when attached) before their rows become reusable.  Returns
        (n_expired, cache)."""
        if not self.paged or self.allocator.park_ttl is None:
            return 0, cache
        n = self.allocator.expire_parked()
        if n:
            cache = self._drain_evictions(cache)
        return n, cache

    def _recall_extension(self, cache, keys, blocks, L: int, slot: int):
        """Extend a device prefix match through the host tier: allocate a
        fresh device block per resident host key (capped so the final chunk
        still computes ≥ 1 token), stream the payloads back two-deep, and
        re-register each block under its original parent linkage.  Partial
        recall is fine: an alloc failure mid-walk keeps what was recalled and
        recomputes the rest.  Mutates ``blocks``; returns the cache."""
        if self.offload is None:
            return cache
        max_blocks = (L - 1) // self.block_size
        ext = self.offload.match_extension(keys, len(blocks))
        ext = ext[: max_blocks - len(blocks)]
        if not ext:
            return cache
        fresh: list[int] = []
        for _ in ext:
            bid = self.allocator.alloc(self.slot_shard(slot))
            if bid is None:
                break
            fresh.append(bid)
        # evictions caused by the recall allocations themselves are saved
        # before the reclaimed rows receive recalled payloads
        cache = self._drain_evictions(cache)
        if not fresh:
            return cache
        hbs = [self.offload.pop(k) for k in ext[: len(fresh)]]

        def commit(bid, payload):
            self._write_block(cache, payload, bid)

        t0 = time.monotonic()
        n_done = self.offload.recall(zip(fresh, hbs), commit)
        for bid, hb in zip(fresh, hbs):
            self.allocator.register(bid, hb.key, parent_key=hb.parent_key)
            blocks.append(bid)
        wall = time.monotonic() - t0
        self.offload.recall_wall_s += wall
        self.blocks_recalled += n_done
        self.tokens_recalled += n_done * self.block_size
        self._recall_units += self.recall_cost * n_done
        if self.obs.enabled:
            self.obs.tracer.instant("blocks_recalled", cat="offload", blocks=n_done)
            self.obs.metrics.histogram(
                "offload_recall_seconds", "wall time of host-tier block recalls").observe(wall)
        return cache

    def set_pool_clock(self, clock) -> None:
        """Point the allocator trie and the host tier at an external
        monotone clock (the scheduler's virtual token clock); remembered
        across ``new_cache``."""
        self._pool_clock = clock
        self.allocator.set_clock(clock)
        if self.offload is not None:
            self.offload.set_clock(clock)

    def take_recall_units(self) -> float:
        """Drain the virtual-clock cost of recalls since the last call: a
        recalled block costs ``recall_cost`` units against the
        ``block_size`` prefill-token units it saved."""
        u, self._recall_units = self._recall_units, 0.0
        return u

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
        n_hit, _ = self.allocator.peek(keys, self.slot_shard(slot))
        if n_hit < len(keys):
            return None, cache
        blocks = [self.allocator.lookup(key, self.slot_shard(slot)) for key in keys]
        self.prefix_hits += 1
        self._prompt_logits.move_to_end(keys[-1])
        self._set_slot_state(cache, slot, blocks, len(toks))
        self._seq[slot] = SeqBlocks(blocks=blocks, length=len(toks))
        return self._prompt_logits[keys[-1]].to(self.device), cache

    def _insert_paged(self, params, cache, tokens_1xS, length: int, slot: int, extras=None):
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
            bid = self.allocator.lookup(key, self.slot_shard(slot))
            if bid is None:
                break
            blocks.append(bid)
        n_hit = len(blocks)
        for _ in range(n_hit, nb):
            bid = self.allocator.alloc(self.slot_shard(slot))
            if bid is None:
                for b in blocks:
                    self.allocator.free(b)
                raise PoolExhausted(
                    "block pool exhausted during insert — admit on "
                    "Engine.blocks_needed() <= Engine.free_blocks first"
                )
            blocks.append(bid)
        cache = self._drain_evictions(cache)
        logits, single = self._prefill_one(params, tokens_1xS, length, extras)
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
        # host-tier extension: each recalled block needs a fresh device
        # block (counted in nb - len(flags), since the resume point moves)
        n_host = 0
        if self.offload is not None:
            ext = self.offload.match_extension(keys, len(flags))
            cap = (L - 1) // self.block_size - len(flags)
            n_host = min(len(ext), max(0, cap))
        end = min((len(flags) + n_host) * self.block_size + chunk_tokens, L)
        nb = -(-end // self.block_size)
        return (nb - len(flags)) + sum(flags)

    def _require_chunked(self) -> None:
        if self.bundle.prefill_chunk is None:
            raise NotImplementedError(
                f"model family {self.bundle.cfg.family!r} has no chunked "
                f"prefill; use monolithic Engine.insert"
            )

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
        self._require_chunked()
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
            bid = self.allocator.lookup(key, self.slot_shard(slot))
            if bid is None:
                break
            blocks.append(bid)
        while blocks and len(blocks) * self.block_size >= L:
            self.allocator.free(blocks.pop())
        # where the device trie runs out, the host tier may extend the match:
        # recalled blocks push the resume point further right
        cache = self._recall_extension(cache, keys, blocks, L, slot)
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
        self._require_chunked()
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
                bid = self.allocator.alloc(self.slot_shard(slot))
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
            bid = self.allocator.alloc(self.slot_shard(slot))
            if bid is None:
                return False, cache
            cache = self._drain_evictions(cache)
            self._zero_block(cache, bid)
            seq.blocks.append(bid)
            self._set_table_entry(cache, slot, j, bid)
        else:
            b = seq.blocks[j]
            if self.allocator.ref[b] > 1:
                bid = self.allocator.alloc(self.slot_shard(slot))
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
                engine_blocks_recalled=self.blocks_recalled,
                engine_tokens_recalled=self.tokens_recalled,
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
            if self._n_dp > 1:
                # per-shard series beside the unlabelled aggregate
                for i, st in enumerate(self.allocator.shard_stats()):
                    m.set_gauges(st, shard=str(i))
            if self.offload is not None:
                m.set_gauges(self.offload.stats())
        m.set_gauges(self.engine_stats())

    # --------------------------------------------- graceful budget degradation
    @property
    def degradable(self) -> bool:
        """Whether this engine's policy has a retrieval budget the ladder
        can downshift (fier/quest; 'full' reads everything by definition)."""
        pol = self.bundle.policy
        return pol is not None and pol.kind in ("fier", "quest")

    def _swap_budget(self, budget: int) -> None:
        """Point decode at a bundle rebuilt with ``budget``: the policy goes
        through ``DecodePlan.build`` (an invalid rung fails here, not in a
        kernel), rungs are cached, and the cache does not depend on the
        budget, so the live cache carries across the swap."""
        fn = self._budget_fns.get(budget)
        if fn is None:
            pol2 = dataclasses.replace(self.bundle.policy, budget=budget)
            DecodePlan.build(pol2, capacity=self.capacity,
                             shard=self.shard if pol2.layout == "paged" else None)
            # the DistConfig rides along so a degraded bundle keeps the mesh
            # sharding (without it the sharded pool would meet the one-device step)
            bundle2 = build_model(self.bundle.cfg, pol2, self.bundle.dcfg, device=self.device)
            fn = self._budget_fns[budget] = bundle2.decode_step
        self._decode_step = fn
        self.current_budget = budget

    def downshift_budget(self) -> bool:
        """One rung down the ladder (halve, floored at ``degrade_floor``).
        False when already at the floor / not degradable."""
        if not self.degradable:
            return False
        floor = DEGRADE_FLOOR if self.degrade_floor is None else self.degrade_floor
        new = max(floor, self.current_budget // 2)
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
    def _corrupt_meta(self, cache, idx: int):
        """Scramble the FIER side-car at axis-1 index ``idx`` of the rest
        pool — a physical block id (paged) or a slot's batch row (slab), in
        place: codes ^ 0xA5, scale → -scale - 1, zero → -zero + 1 (bf16).
        Everything stays finite (silent retrieval-quality corruption, not
        the NaN watchdog's).  A cache without a FIER side-car is left as
        it is.  (The hybrid keeps its side-car under ``attn``.)"""
        meta = cache.get("rest", cache.get("attn", {})).get("meta")
        if not isinstance(meta, QuantizedKeys):
            return cache
        meta.codes[:, idx] ^= 0xA5
        meta.scale[:, idx] = -meta.scale[:, idx] - 1.0
        meta.zero[:, idx] = -meta.zero[:, idx] + 1.0
        return cache

    def corrupt_slot_metadata(self, cache, slot: int):
        """Chaos hook: corrupt the FIER metadata backing ``slot``.

        Paged mode targets a *privately held, unregistered* block (ref 1, no
        prefix-cache hash) so the corruption cannot bleed into prefix-sharing
        requests or future prefix hits; when the slot holds no such block yet,
        nothing happens and the caller retries later.  Slab mode scrambles
        the slot's own batch row.  Returns (corrupted?, cache)."""
        if not self.paged:
            if 0 <= slot < self.n_slots:
                return True, self._corrupt_meta(cache, slot)
            return False, cache
        seq = self._seq.get(slot)
        if seq is None:
            return False, cache
        for b in reversed(seq.blocks):
            if (
                b != NULL_BLOCK
                and self.allocator.ref[b] == 1
                and self.allocator.key_of(b) is None
            ):
                return True, self._corrupt_meta(cache, b)
        return False, cache

    def audit(self) -> None:
        """Cross-check the allocator against the engine's live sequences:
        every block reference the engine holds must be counted exactly by
        the allocator, on top of its internal invariants, and (with a host
        tier) the tier's own invariants and host ∩ device = ∅.  Raises
        ``AllocatorAuditError``; no-op for slab engines."""
        if not self.paged:
            return
        owners: Counter[int] = Counter()
        for seq in self._seq.values():
            for b in seq.blocks:
                if b != NULL_BLOCK:
                    owners[b] += 1
        host_keys = None
        if self.offload is not None:
            errs = self.offload.audit()
            if errs:
                raise AllocatorAuditError("host tier audit failed: " + "; ".join(errs))
            host_keys = self.offload.keys()
        self.allocator.audit(dict(owners), host_keys=host_keys)

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
        extras=None, generator: torch.Generator | None = None, return_cache: bool = False,
    ):
        """Static-batch generate: prefill the whole batch then decode
        ``max_new - 1`` steps.  prompts [B, S]; ``extras`` joins the prefill
        batch (``{"frames": ...}``, ``{"vision_embeds": ...}``); returns
        tokens [B, max_new] (and the cache, when ``return_cache``, for
        continuing the session)."""
        if self.paged:
            raise NotImplementedError(
                "paged engines generate through the ContinuousScheduler "
                "(per-request insert + block accounting), not the "
                "static-batch generate path"
            )
        gen = generator or self._gen
        batch = {"tokens": prompts, "lengths": lengths}
        if extras:
            batch.update(extras)
        logits, cache = self.prefill_batch(params, batch)
        tok = sample_token(logits, self.sampling, gen)
        outs = [tok]
        for _ in range(max_new - 1):
            tok, _, cache = self.decode(params, tok, cache, generator=gen)
            outs.append(tok)
        toks = torch.stack(outs, dim=1)
        return (toks, cache) if return_cache else toks
