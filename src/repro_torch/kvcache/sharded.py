"""Mesh-partitioned paged KV pool: TP×DP sharded decode + allocator (port
of ``repro.kvcache.sharded``).

The single-device paged subsystem (``kvcache/paged.py``) split over a
mesh along two axis groups:

* **TP (KV-head parallel)** — every pool leaf is split on its KV-head axis
  and the query heads in matching contiguous chunks, so with GQA the local
  query head ``h`` attends to local KV head ``h // rep`` exactly as on one
  device: each shard runs the *unchanged* single-device backend decode
  (``decode_attention``) over its local heads, and the outputs concatenate
  along the head axis in shard order.  No LSE merge: heads partition the
  output exactly.  Requires ``n_kv_heads % n_tp == 0``.
* **DP (batch parallel)** — the pool's block axis splits into contiguous
  per-shard ranges of ``n_local`` blocks, and the slot axis (block table
  rows, lengths) in matching ranges, so a slot's blocks always live on its
  *home shard*.  Block tables hold **global** block ids; each shard
  localizes its rows with a range test (``start <= bid < start +
  n_local``) that maps every foreign or null id to the shard's local null
  block.  Host side, :class:`ShardedBlockAllocator` keeps one
  :class:`~repro_torch.kvcache.paged.BlockAllocator` per DP shard behind
  global ids ``gid = shard · n_local + local``; each shard's local block 0
  is its null block.

Selection on this layout is **exact by construction**: TP shards score
their own KV heads over the whole sequence, DP shards their own slots over
their whole sequence, so FIER's top-k needs no threshold exchange.  The
``local``/``exact`` mode on :class:`ShardSpec` matters for the
sequence-sharded slab path (``core/distributed.py``); it rides on the spec
so ``DecodePlan.build`` checks it against each backend's
``supports_sharding`` uniformly.

The port is single-controller, as the reference is.  The reference's pool
is one global array with a ``NamedSharding``; here each pool leaf becomes a
:class:`ShardedPool` — one contiguous tensor per (DP, TP) shard on the
shard's device — which reads and writes whole blocks or token rows by
*global* id, so the engine's host-side block operations (prefill scatter,
copy-on-write, the host tier's save and recall, chunked prefill's gather)
keep their single-device code.  Block tables and lengths stay whole on the
engine's device; the decode step hands each shard its rows.

Prefix sharing is shard-local: a prompt admitted to a slot on DP shard 1
cannot revive blocks parked on shard 0, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core import policy as core_policy
from repro_torch.core.placement import axis_coords

from .paged import BlockAllocator, EvictedBlock, paged_append_kv, paged_append_token_metadata

__all__ = [
    "SHARD_MODES",
    "ShardSpec",
    "ShardedBlockAllocator",
    "ShardedPool",
    "localize_block_table",
    "shard_cache",
    "sharded_paged_decode_step",
]

SHARD_MODES = ("local", "exact")


@dataclass(frozen=True)
class ShardSpec:
    """How the paged pool and decode step split over a mesh.

    ``tp_axes`` shard KV heads (tensor parallel), ``dp_axes`` shard the
    slot axis (data parallel); ``mode`` is the FIER selection mode checked
    against the backend's ``supports_sharding`` (``exact`` reproduces the
    single-device top-k on this layout; see the module docstring)."""

    mesh: Any
    tp_axes: tuple[str, ...] = ()
    dp_axes: tuple[str, ...] = ()
    mode: str = "exact"

    def __post_init__(self):
        object.__setattr__(self, "tp_axes", tuple(self.tp_axes))
        object.__setattr__(self, "dp_axes", tuple(self.dp_axes))
        if self.mode not in SHARD_MODES:
            raise ValueError(
                f"shard mode must be one of {SHARD_MODES}, got {self.mode!r}"
            )
        if not self.tp_axes and not self.dp_axes:
            raise ValueError("ShardSpec needs at least one tp or dp mesh axis")
        names = tuple(self.mesh.axis_names)
        for ax in self.tp_axes + self.dp_axes:
            if ax not in names:
                raise ValueError(
                    f"mesh axis {ax!r} not in mesh axes {names!r}"
                )
        overlap = set(self.tp_axes) & set(self.dp_axes)
        if overlap:
            raise ValueError(f"axes in both tp and dp groups: {sorted(overlap)}")

    @property
    def n_tp(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.tp_axes)

    @property
    def n_dp(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    def device(self, d: int, t: int) -> torch.device:
        """The device of the shard with DP index ``d`` and TP index ``t``
        (each row-major over its axes; other mesh axes at index 0)."""
        return self.mesh.device_at({**axis_coords(self.mesh, self.dp_axes, d),
                                    **axis_coords(self.mesh, self.tp_axes, t)})


def localize_block_table(block_table: torch.Tensor, d: int, n_local: int,
                         n_dp: int) -> torch.Tensor:
    """Map a global-id block table to DP shard ``d``'s local ids.

    A slot's blocks all come from its home shard's range ``[start, start +
    n_local)``, so ``bid - start`` is exact for every block this shard will
    read; ids outside the range — the global null block, shed-middle holes
    and every other shard's rows — collapse to the local null block 0 (each
    inner allocator reserves its local row 0, so global ids ``shard ·
    n_local`` are never handed out)."""
    if n_dp == 1:
        return block_table
    start = d * n_local
    ok = (block_table >= start) & (block_table < start + n_local)
    return torch.where(ok, block_table - start, torch.zeros_like(block_table))


# --------------------------------------------------------------- pool leaves

class ShardedPool:
    """One pool leaf split over a :class:`ShardSpec`'s shards.

    The global leaf is ``[L, N, pb, H, ...]`` (layer-stacked, block axis 1)
    or ``[N, pb, H, ...]`` (one layer, block axis 0); ``parts[d][t]`` holds
    DP shard d's blocks ``[d·n_local, (d+1)·n_local)`` and TP shard t's
    heads, contiguous, on ``spec.device(d, t)``.

    It answers the few index forms the engine and chunked prefill use on a
    pool leaf, with global block ids (reads return a new tensor on the
    engine's device, ``home``; writes go to the owning shards):

    * stacked: ``pool[i]`` (layer i's leaf), ``pool[:, ids]`` and
      ``pool[:, ids] = value`` (whole blocks, ``ids`` an int or 1-D ids);
    * one layer: ``pool.index_select(0, ids)``, ``pool.index_put_((ids,),
      value)`` (whole blocks) and ``pool[phys, offs] = rows`` (token rows).

    A block id's shard is found on the host, so an id on the card costs a
    synchronisation; the decode step never goes through here."""

    def __init__(self, parts: list[list[torch.Tensor]], spec: ShardSpec,
                 block_axis: int, home: torch.device):
        self.parts, self.spec, self.block_axis, self.home = parts, spec, block_axis, home
        p = parts[0][0]
        self.n_local = p.shape[block_axis]
        self.n_heads = p.shape[block_axis + 2]  # per TP shard
        shape = list(p.shape)
        shape[block_axis] *= spec.n_dp
        shape[block_axis + 2] *= spec.n_tp
        self.shape = torch.Size(shape)
        self.dtype = p.dtype

    def clone(self) -> "ShardedPool":
        """A copy, each part on its shard's device."""
        return ShardedPool([[p.clone() for p in row] for row in self.parts], self.spec,
                           self.block_axis, self.home)

    def __repr__(self) -> str:
        return (f"ShardedPool({tuple(self.shape)}, {self.dtype}, "
                f"dp={self.spec.n_dp}, tp={self.spec.n_tp})")

    def _by_shard(self, ids):
        """(d, positions in ids, local ids) for each DP shard ids touch."""
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1).cpu()
        n = self.shape[self.block_axis]
        if ids.numel() and not (0 <= int(ids.min()) and int(ids.max()) < n):
            raise IndexError(f"block id out of range for a pool of {n} blocks")
        home = ids // self.n_local
        for d in range(self.spec.n_dp):
            sel = torch.nonzero(home == d).reshape(-1)
            if sel.numel():
                yield d, sel, ids[sel] - d * self.n_local

    def _heads(self, x: torch.Tensor, t: int, axis: int) -> torch.Tensor:
        return x.narrow(axis, t * self.n_heads, self.n_heads)

    def read(self, ids) -> torch.Tensor:
        """The blocks ``ids`` (1-D), block axis of length len(ids), on ``home``."""
        ba = self.block_axis
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
        shape = list(self.shape)
        shape[ba] = ids.numel()
        out = torch.empty(shape, dtype=self.dtype, device=self.home)
        for d, sel, lid in self._by_shard(ids):
            for t, part in enumerate(self.parts[d]):
                piece = part.index_select(ba, lid.to(part.device)).to(self.home)
                self._heads(out, t, ba + 2).index_copy_(ba, sel.to(self.home), piece)
        return out

    def write(self, ids, value) -> None:
        """Blocks ``ids`` (1-D) ← ``value`` (``read(ids)``'s shape, or a
        scalar that fills them)."""
        ba = self.block_axis
        ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
        fill = not torch.is_tensor(value) or value.dim() == 0
        for d, sel, lid in self._by_shard(ids):
            for t, part in enumerate(self.parts[d]):
                lid_p = lid.to(part.device)
                if fill:
                    part.index_fill_(ba, lid_p, value)
                    continue
                v = self._heads(value, t, ba + 2).index_select(ba, sel.to(value.device))
                part.index_copy_(ba, lid_p, v.to(part.device, part.dtype))

    def write_rows(self, phys, offs, rows: torch.Tensor) -> None:
        """Token rows: block ``phys[i]``, offset ``offs[i]`` ← ``rows[i]``
        ([n, H, ...]) on one layer's leaf."""
        if self.block_axis != 0:
            raise TypeError("token rows are written to one layer's leaf")
        offs = torch.as_tensor(offs, dtype=torch.int64).reshape(-1).cpu()
        for d, sel, lid in self._by_shard(phys):
            for t, part in enumerate(self.parts[d]):
                v = self._heads(rows, t, 1)[sel.to(rows.device)]
                part[lid.to(part.device), offs[sel].to(part.device)] = v.to(part.device, part.dtype)

    # the index forms of a plain pool tensor the engine and prefill use
    def __getitem__(self, key):
        if isinstance(key, int) and self.block_axis == 1:
            return ShardedPool([[p[key] for p in row] for row in self.parts],
                               self.spec, 0, self.home)
        if (isinstance(key, tuple) and len(key) == 2 and isinstance(key[0], slice)
                and key[0] == slice(None) and self.block_axis == 1):
            if isinstance(key[1], int):
                return self.read([key[1]]).squeeze(1)
            return self.read(key[1])
        raise TypeError(f"ShardedPool does not take the index {key!r}")

    def __setitem__(self, key, value) -> None:
        if not (isinstance(key, tuple) and len(key) == 2):
            raise TypeError(f"ShardedPool does not take the index {key!r}")
        if isinstance(key[0], slice) and key[0] == slice(None) and self.block_axis == 1:
            ids = key[1]
            if isinstance(ids, int):
                ids = [ids]
                if torch.is_tensor(value) and value.dim():
                    value = value.unsqueeze(1)
            self.write(ids, value)
        else:
            self.write_rows(key[0], key[1], value)

    def index_select(self, dim: int, ids) -> torch.Tensor:
        if dim != self.block_axis:
            raise TypeError("ShardedPool selects along its block axis only")
        return self.read(ids)

    def index_put_(self, indices, values) -> "ShardedPool":
        if len(indices) != 1 or self.block_axis != 0:
            raise TypeError("ShardedPool puts whole blocks of one layer's leaf")
        self.write(indices[0], values)
        return self


def _split_leaf(leaf: torch.Tensor, spec: ShardSpec, home) -> ShardedPool:
    """A stacked pool leaf [L, N, pb, H, ...] copied into its shards."""
    n_local, h = leaf.shape[1] // spec.n_dp, leaf.shape[3] // spec.n_tp
    parts = []
    for d in range(spec.n_dp):
        row = []
        for t in range(spec.n_tp):
            src = leaf[:, d * n_local:(d + 1) * n_local, :, t * h:(t + 1) * h]
            dst = torch.empty(src.shape, dtype=leaf.dtype, device=spec.device(d, t))
            row.append(dst.copy_(src))
        parts.append(row)
    return ShardedPool(parts, spec, 1, home)


def shard_cache(cache: dict, spec: ShardSpec) -> dict:
    """Place a freshly initialised paged cache onto the mesh: every pool
    leaf (K, V and the side-car's tensors) split DP-on-blocks ×
    TP-on-KV-heads into a :class:`ShardedPool`; the block table and lengths
    stay whole on the cache's device (the controller's)."""
    n_blocks = cache["rest"]["k"].shape[1]
    n_kv = cache["rest"]["k"].shape[3]
    if n_blocks % spec.n_dp:
        raise ValueError(f"pool blocks {n_blocks} not divisible by {spec.n_dp} DP shards")
    if n_kv % spec.n_tp:
        raise ValueError(f"n_kv_heads {n_kv} not divisible by TP degree {spec.n_tp}")
    home = cache["block_table"].device
    out = dict(cache)
    for name, part in cache.items():
        if name in ("block_table", "length"):
            continue
        new = dict(part)
        new["k"] = _split_leaf(part["k"], spec, home)
        new["v"] = _split_leaf(part["v"], spec, home)
        if "meta" in part:
            meta = part["meta"]
            new["meta"] = dataclasses.replace(
                meta, **{f: _split_leaf(getattr(meta, f), spec, home) for f in meta.FIELDS})
        out[name] = new
    return out


# ------------------------------------------------------------------ decode

def sharded_paged_decode_step(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: ShardedPool,
    v_pool: ShardedPool,
    meta: Any,
    block_table: torch.Tensor,
    length: torch.Tensor,
    pol,
    plan,
    spec: ShardSpec,
) -> torch.Tensor:
    """One decode step of one layer on the mesh-sharded paged pool.

    Each shard appends its slots' new K/V (and side-car group) to its own
    pool part, in place, and runs the plan's backend over its local heads
    and slots — the ordinary single-device ``decode_attention`` on the
    local views, with the plan re-built shard-free.  The shards' outputs
    come back to the engine's device and concatenate along the head axis
    (TP) and the slot axis (DP) in shard order; the caller's output
    projection then runs on the whole [B, Hq·D] row, as on one device (a
    per-shard partial product summed across shards would change the
    reduction order).  Returns out [B, Hq, D].

    The kernels size their split over the card from the number of (batch,
    kv-head) rows (``attend_plan`` / ``retrieval_plan``), and a shard has
    fewer rows than the unsharded call; a different split sums K4's partial
    softmax in another order.  So the shard-free plan carries
    ``plan_rows`` = the unsharded call's B·Hkv, and every shard launches
    with the split the single-device step takes: the sharded step equals it
    bit for bit."""
    B, Hq, D = q.shape
    n_dp, n_tp = spec.n_dp, spec.n_tp
    Hkv = k_pool.shape[2]
    if B % n_dp:
        raise ValueError(f"{B} slots not divisible by {n_dp} DP shards")
    if Hkv % n_tp:
        raise ValueError(f"n_kv_heads {Hkv} not divisible by TP degree {n_tp}")
    plan_inner = dataclasses.replace(plan, shard=None, plan_rows=B * Hkv)
    if k_new.dim() == 4:
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    b_loc, h_loc, hq_loc = B // n_dp, Hkv // n_tp, Hq // n_tp
    rows_out = []
    for d in range(n_dp):
        rows = slice(d * b_loc, (d + 1) * b_loc)
        heads_out = []
        for t in range(n_tp):
            dev = spec.device(d, t)
            kv_h, q_h = slice(t * h_loc, (t + 1) * h_loc), slice(t * hq_loc, (t + 1) * hq_loc)
            len_l = length[rows].to(dev)
            bt_l = localize_block_table(block_table[rows].to(dev), d, k_pool.n_local, n_dp)
            k_l, v_l = k_pool.parts[d][t], v_pool.parts[d][t]
            paged_append_kv(k_l, v_l, k_new[rows, kv_h].to(dev), v_new[rows, kv_h].to(dev),
                            bt_l, len_l)
            meta_l = None
            if meta is not None:
                meta_l = dataclasses.replace(
                    meta, **{f: getattr(meta, f).parts[d][t] for f in meta.FIELDS})
                paged_append_token_metadata(meta_l, k_l, bt_l, len_l, pol)
            view = core_policy.CacheView.paged(k_l, v_l, meta_l, bt_l, len_l + 1)
            out = core_policy.decode_attention(q[rows, q_h].to(dev), view, plan_inner)
            heads_out.append(out.to(q.device))
        rows_out.append(torch.cat(heads_out, dim=1))
    return torch.cat(rows_out, dim=0)


# ---------------------------------------------------------- host allocator

class _GlobalRefView:
    """Read-only ``allocator.ref[gid]`` over the per-shard ref lists."""

    def __init__(self, alloc: "ShardedBlockAllocator"):
        self._a = alloc

    def __getitem__(self, gid: int) -> int:
        shard, lid = self._a._split(gid)
        return self._a.shards[shard].ref[lid]


class ShardedBlockAllocator:
    """One :class:`BlockAllocator` per DP shard behind the global-id surface
    the engine and scheduler already speak (a copy of the reference's: pure
    Python).

    Global id ``gid = shard · n_local + local_id``; each inner allocator
    reserves its local block 0 as the shard's null block, so the global ids
    ``shard · n_local`` are never allocated and :func:`localize_block_table`
    can collapse foreign ids onto a row no slot owns.  Admission accounting
    is conservative: a request's blocks all come from one home shard, so
    :attr:`usable` and :attr:`n_free` report per-shard capacity
    (``n_local - 1`` and the minimum free count) rather than pool-wide sums
    — a request the scheduler admits fits whichever shard its slot lands on.
    Prefix lookups are shard-local; callers that don't know the home shard
    yet (pre-admission sizing) get the conservative no-hit answer."""

    def __init__(self, n_blocks: int, block_size: int, n_shards: int,
                 park_ttl: float | None = None):
        if n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {n_shards}")
        if n_blocks % n_shards:
            raise ValueError(
                f"pool blocks {n_blocks} not divisible by {n_shards} DP shards"
            )
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.n_shards = n_shards
        self.n_local = n_blocks // n_shards
        self.park_ttl = park_ttl
        self.shards = [
            BlockAllocator(self.n_local, block_size, park_ttl=park_ttl)
            for _ in range(n_shards)
        ]
        self.ref = _GlobalRefView(self)
        # wrapper-level: the engine bumps cow_copies directly, and the chaos
        # injector arms fail_next before knowing which shard allocates next
        self.cow_copies = 0
        self._fail_next = 0
        self.injected_alloc_failures = 0

    # ------------------------------------------------------------- id mapping
    def _split(self, gid: int) -> tuple[int, int]:
        return divmod(gid, self.n_local)

    def _glob(self, shard: int, lid: int) -> int:
        return shard * self.n_local + lid

    def home(self, gid: int) -> int:
        return gid // self.n_local

    # ------------------------------------------------------------- accounting
    def set_clock(self, clock) -> None:
        for inner in self.shards:
            inner.set_clock(clock)

    def key_of(self, gid: int) -> int | None:
        shard, lid = self._split(gid)
        return self.shards[shard].key_of(lid)

    def key_resident(self, key: int) -> bool:
        return any(inner.key_resident(key) for inner in self.shards)

    @property
    def usable(self) -> int:
        # per shard: one request's blocks all come from its home shard
        return self.n_local - 1

    @property
    def n_in_use(self) -> int:
        return sum(inner.n_in_use for inner in self.shards)

    @property
    def n_parked(self) -> int:
        return sum(inner.n_parked for inner in self.shards)

    @property
    def n_free(self) -> int:
        # the per-shard minimum: what any admitted request is guaranteed to
        # find on its home shard
        return min(inner.n_free for inner in self.shards)

    @property
    def _free(self) -> list[int]:
        out: list[int] = []
        for s, inner in enumerate(self.shards):
            out.extend(self._glob(s, lid) for lid in inner._free)
        return out

    @property
    def peak_in_use(self) -> int:
        return sum(inner.peak_in_use for inner in self.shards)

    @property
    def prefix_block_hits(self) -> int:
        return sum(inner.prefix_block_hits for inner in self.shards)

    @property
    def ttl_evictions(self) -> int:
        return sum(inner.ttl_evictions for inner in self.shards)

    @property
    def record_evictions(self) -> bool:
        return self.shards[0].record_evictions

    @record_evictions.setter
    def record_evictions(self, value: bool) -> None:
        for inner in self.shards:
            inner.record_evictions = value

    def utilization(self) -> float:
        return self.n_in_use / (self.n_blocks - self.n_shards)

    def stats(self) -> dict[str, float]:
        per = [inner.stats() for inner in self.shards]
        out = {k: sum(p[k] for p in per) for k in per[0]}
        ages = sorted(
            age for inner in self.shards for age in inner.tree.parked_ages()
        )
        out.update(
            pool_shards=self.n_shards,
            pool_blocks_total=self.n_blocks,
            pool_blocks_usable=self.n_blocks - self.n_shards,
            pool_utilization=self.utilization(),
            pool_cow_copies=self.cow_copies
            + sum(p["pool_cow_copies"] for p in per),
            pool_injected_alloc_failures=self.injected_alloc_failures
            + sum(p["pool_injected_alloc_failures"] for p in per),
            pool_parked_age_p50=BlockAllocator._percentile(ages, 0.50),
            pool_parked_age_p90=BlockAllocator._percentile(ages, 0.90),
            pool_parked_age_max=ages[-1] if ages else 0.0,
        )
        return out

    def shard_stats(self) -> list[dict[str, float]]:
        """Per-shard ``pool_*`` snapshots (for ``shard``-labelled gauges)."""
        return [inner.stats() for inner in self.shards]

    # -------------------------------------------------------------- alloc/free
    def fail_next(self, n: int = 1) -> None:
        self._fail_next += int(n)

    def alloc(self, shard: int = 0) -> int | None:
        if self._fail_next > 0:
            self._fail_next -= 1
            self.injected_alloc_failures += 1
            return None
        lid = self.shards[shard].alloc()
        return None if lid is None else self._glob(shard, lid)

    def free(self, gid: int) -> None:
        shard, lid = self._split(gid)
        self.shards[shard].free(lid)

    # ------------------------------------------------------------ prefix cache
    def register(self, gid: int, key: int, parent_key: int | None = None) -> None:
        shard, lid = self._split(gid)
        self.shards[shard].register(lid, key, parent_key)

    def lookup(self, key: int, shard: int) -> int | None:
        lid = self.shards[shard].lookup(key)
        return None if lid is None else self._glob(shard, lid)

    def peek(self, keys: list[int], shard: int | None = None) -> tuple[int, int]:
        if shard is None:
            return 0, 0
        return self.shards[shard].peek(keys)

    def peek_prefix(self, keys: list[int], shard: int | None = None) -> list[bool]:
        if shard is None:
            return []
        return self.shards[shard].peek_prefix(keys)

    def blocks_needed(self, n_tokens: int, keys: list[int] | None = None,
                      shard: int | None = None) -> int:
        if keys is None or shard is None:
            return -(-n_tokens // self.block_size)
        return self.shards[shard].blocks_needed(n_tokens, keys)

    # ---------------------------------------------------- eviction / offload
    def expire_parked(self) -> int:
        return sum(inner.expire_parked() for inner in self.shards)

    def take_evicted(self) -> list[EvictedBlock]:
        out: list[EvictedBlock] = []
        for s, inner in enumerate(self.shards):
            out.extend(
                EvictedBlock(self._glob(s, ev.bid), ev.key, ev.parent_key, ev.reason)
                for ev in inner.take_evicted()
            )
        return out

    def drop_key(self, key: int) -> int | None:
        hit = None
        for s, inner in enumerate(self.shards):
            lid = inner.drop_key(key)
            if lid is not None and hit is None:
                hit = self._glob(s, lid)
        return hit

    # ------------------------------------------------------------------- audit
    def audit(
        self,
        owners: dict[int, int] | None = None,
        host_keys: "set[int] | None" = None,
    ) -> None:
        per_owner: list[dict[int, int] | None]
        if owners is None:
            per_owner = [None] * self.n_shards
        else:
            per_owner = [{} for _ in self.shards]
            for gid, refs in owners.items():
                shard, lid = self._split(gid)
                per_owner[shard][lid] = refs
        for inner, own in zip(self.shards, per_owner):
            # host_keys goes to every shard unchanged: the engine's eviction
            # drain offloads only keys resident on *no* shard (key_resident),
            # so cross-tier disjointness holds per shard
            inner.audit(own, host_keys)
