"""Decode-attention backend registry: ``CacheView`` + ``DecodePlan``.

Port of ``repro.core.policy`` for the slab and paged layouts.  The registry
holds the ``full``, ``fier``, ``quest`` and ``slm`` backends; ``quest``
(page-level retrieval) and ``slm`` (StreamingLLM's sink ∪ recent window)
are the paper's baselines, plain PyTorch on the slab layout only, as in
the reference.  ``fier`` runs the ``one_pass``
pipeline (the CUDA retrieval kernel chained into the CUDA select-and-attend
kernel; on a paged cache their block-table variants), the slab-only
``two_pass`` pipeline (the CUDA score scan and threshold search, then the
select-and-attend kernel) or the ``reference`` pipeline (plain PyTorch
oracles over the logical, table-gathered cache; ``use_kernels`` scores with
the CUDA score scan)::

    plan = DecodePlan.build(cfg, capacity=capacity)
    meta = build_metadata(K, cfg)                 # after prefill
    meta = update_metadata(meta, K, pos, cfg)     # after an appended token
    out  = decode_attention(q, view, plan)

A plan may carry a mesh sharding spec (``kvcache.sharded.ShardSpec``):
``DecodePlan.build(..., shard=spec)`` checks it against the backend's
``supports_sharding`` modes, and the model's paged decode step runs the
plan shard by shard (``kvcache.sharded.sharded_paged_decode_step``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from . import quantize, quest, retrieval

PIPELINES = ("reference", "two_pass", "one_pass")
LAYOUTS = ("slab", "paged")


# --------------------------------------------------------------- PolicyConfig

@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    kind: str = "full"
    budget: int = 1024
    group: int = 32            # FIER group size g
    page: int = 16             # Quest page size L
    group_reduce: str = "max"  # GQA query-group score reduction
    sink: int = 0              # forced sink tokens (0 = paper-faithful)
    recent: int = 0            # forced recent window (0 = paper-faithful)
    skip_layers: int = 2       # full attention on the first N layers
    use_kernels: bool = False  # reference pipeline only: score with the CUDA
                               # score scan (K6) instead of the plain oracle
    pipeline: str = "reference"  # reference | two_pass | one_pass
    layout: str = "slab"       # slab | paged
    block_size: int = 32       # tokens per cache block (paged layout); a
                               # multiple of 8 and of `group`
    pool_blocks: int = 0       # physical blocks in the pool (paged layout);
                               # 0 → worst-case default n_slots·capacity/bs+1

    def __post_init__(self):
        if self.kind not in _REGISTRY:
            raise ValueError(
                f"unknown policy {self.kind!r}; registered: {tuple(_REGISTRY)}"
            )
        if self.pipeline not in PIPELINES:
            raise ValueError(
                f"unknown pipeline {self.pipeline!r}; choose from {PIPELINES}"
            )
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; choose from {LAYOUTS}")


# ------------------------------------------------------------------ CacheView

class CacheView:
    """Everything one decode-attention call reads.

    ``layout='slab'``: ``k``/``v`` are per-slot capacity slabs
    [B, S, Hkv, D] and ``block_table`` is None.  ``layout='paged'``:
    ``k``/``v`` are the shared block pool [N, bs, Hkv, D] and
    ``block_table`` [B, n_btab] maps logical blocks to pool rows.
    ``meta`` is the policy side-car (``QuantizedKeys`` for fier,
    ``PageMeta`` for quest, None for full and slm) in the matching layout;
    ``length`` [B] int32 masks unwritten positions (None = all valid)."""

    __slots__ = ("k", "v", "meta", "block_table", "length", "layout")

    def __init__(self, k, v, meta=None, block_table=None, length=None,
                 *, layout: str = "slab"):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; choose from {LAYOUTS}")
        if layout == "paged" and block_table is None:
            raise ValueError("paged CacheView requires a block_table")
        self.k = k
        self.v = v
        self.meta = meta
        self.block_table = block_table
        self.length = length
        self.layout = layout

    @classmethod
    def slab(cls, k, v, meta=None, length=None) -> "CacheView":
        return cls(k, v, meta, None, length, layout="slab")

    @classmethod
    def paged(cls, k, v, meta, block_table, length=None) -> "CacheView":
        return cls(k, v, meta, block_table, length, layout="paged")

    def logical(self):
        """(K, V, meta) as logical per-request slabs — gathered through the
        block table for the paged layout (the plain path; the paged kernels
        walk the table in-kernel instead).  Absent leaves pass through as
        None."""
        if self.layout == "slab":
            return self.k, self.v, self.meta
        from repro_torch.kvcache.paged import gather_block_rows

        def g(a):
            return None if a is None else gather_block_rows(a, self.block_table)

        meta = None if self.meta is None else map_meta(self.meta, g)
        return g(self.k), g(self.v), meta

    def __repr__(self):
        sh = lambda a: None if a is None else tuple(a.shape)
        return (
            f"CacheView(layout={self.layout!r}, k={sh(self.k)}, "
            f"meta={type(self.meta).__name__ if self.meta is not None else None}, "
            f"block_table={sh(self.block_table)})"
        )


def map_meta(meta: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """A side-car (``QuantizedKeys`` or ``PageMeta``) with ``fn`` applied to
    each of its tensors."""
    return dataclasses.replace(meta, **{f: fn(getattr(meta, f)) for f in meta.FIELDS})


# ----------------------------------------------------------- backend registry

class UnsupportedPlanError(ValueError):
    """(policy, layout, pipeline) combination outside the backend's
    declared capability matrix."""


@dataclasses.dataclass(frozen=True)
class AttentionBackend:
    """One registered decode-attention policy: its (layout, pipeline)
    capability matrix, the side-car builder ``(K, cfg) -> meta``, its
    in-place refresh ``(meta, K, pos, cfg) -> meta`` and the decode
    ``(q, view, plan) -> out [B, Hq, D]``.  ``needs_metadata``: a view
    without a side-car falls back to dense attention on the CPU and raises
    on the card; ``skip_layers_fallback``:
    ``decode_attention(..., layer=l)`` with ``l < skip_layers`` attends
    densely (False for backends that are their own full-attention
    substitute: full, slm).  ``supports_sharding``: the selection modes
    the backend takes when the plan carries a mesh sharding spec; empty =
    single-device only ("exact" promises the single-device result on the
    TP×DP paged layout, "local" admits per-shard approximate selection, as
    on the sequence-sharded slab path)."""

    name: str
    supports: frozenset
    build_metadata: Callable[[torch.Tensor, PolicyConfig], Any]
    update_metadata: Callable[[Any, torch.Tensor, Any, PolicyConfig], Any]
    decode: Callable[[torch.Tensor, CacheView, "DecodePlan"], torch.Tensor]
    supports_sharding: frozenset = frozenset()
    needs_metadata: bool = True
    skip_layers_fallback: bool = True

    def supports_str(self) -> str:
        return ", ".join(f"{lo}×{pi}" for lo, pi in sorted(self.supports))

    def sharding_str(self) -> str:
        """The ``supports_sharding`` entry, rendered like the capability
        matrix ('-' when the backend is single-device only)."""
        return ", ".join(sorted(self.supports_sharding)) or "-"


_REGISTRY: dict[str, AttentionBackend] = {}


def register_backend(backend: AttentionBackend) -> None:
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    bad = {c for c in backend.supports if c[0] not in LAYOUTS or c[1] not in PIPELINES}
    if bad:
        raise ValueError(f"backend {backend.name!r}: invalid capabilities {bad}")
    bad_modes = set(backend.supports_sharding) - {"local", "exact"}
    if bad_modes:
        raise ValueError(
            f"backend {backend.name!r}: invalid sharding modes {sorted(bad_modes)}"
        )
    _REGISTRY[backend.name] = backend


def registered_backends() -> tuple[str, ...]:
    """The registered policy names, in registration order."""
    return tuple(_REGISTRY)


def get_backend(name: str) -> AttentionBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; registered: {tuple(_REGISTRY)}"
        ) from None


# ----------------------------------------------------------------- DecodePlan

@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """A validated ``policy × layout × pipeline`` execution plan.  Build
    via :meth:`build`; the constructor validates nothing.

    ``shard`` is the mesh sharding spec (``kvcache.sharded.ShardSpec``;
    None = one device), carried on the plan so ``decode_attention``
    composes TP×DP with every backend.  ``plan_rows`` is set only on a
    shard's own plan, by the sharded step: the (batch, kv-head) rows of the
    unsharded call, which the CUDA kernels size their split for (None =
    the call's own rows)."""

    policy: PolicyConfig
    layout: str = "slab"
    pipeline: str = "reference"
    shard: Any = None
    plan_rows: int | None = None

    @property
    def backend(self) -> AttentionBackend:
        return get_backend(self.policy.kind)

    @classmethod
    def build(
        cls,
        policy: PolicyConfig,
        *,
        layout: str | None = None,
        pipeline: str | None = None,
        capacity: int | None = None,
        shard: Any = None,
    ) -> "DecodePlan":
        layout = layout if layout is not None else policy.layout
        pipeline = pipeline if pipeline is not None else policy.pipeline
        backend = get_backend(policy.kind)
        if (layout, pipeline) not in backend.supports:
            raise UnsupportedPlanError(
                f"policy {policy.kind!r} does not support layout={layout!r} "
                f"with pipeline={pipeline!r}; supported: {backend.supports_str()}"
            )
        if policy.budget <= 0:
            raise ValueError(f"budget must be positive, got {policy.budget}")
        if policy.sink < 0 or policy.recent < 0:
            raise ValueError(
                f"sink/recent must be >= 0, got ({policy.sink}, {policy.recent})"
            )
        if layout == "paged":
            from repro_torch.kvcache.paged import check_block_size

            check_block_size(
                policy.block_size, policy.group if policy.kind == "fier" else 0
            )
        if shard is not None:
            # duck-typed (tp_axes/dp_axes/mode) so policy.py never imports
            # kvcache.sharded — the kvcache modules import this one
            axes = tuple(shard.tp_axes) + tuple(shard.dp_axes)
            if layout != "paged":
                raise UnsupportedPlanError(
                    f"policy {policy.kind!r}: mesh-sharded decode over axes "
                    f"{axes!r} requires layout='paged', got layout={layout!r}"
                )
            if shard.mode not in backend.supports_sharding:
                raise UnsupportedPlanError(
                    f"policy {policy.kind!r} does not support sharded decode "
                    f"in mode={shard.mode!r} over mesh axes {axes!r}; backend "
                    f"sharding modes: {backend.sharding_str()}; supported "
                    f"layouts: {backend.supports_str()}"
                )
        plan = cls(policy, layout, pipeline, shard)
        if capacity is not None:
            plan.validate_capacity(capacity)
        return plan

    def validate_capacity(self, capacity: int) -> "DecodePlan":
        """Check the plan against a concrete cache capacity."""
        pol = self.policy
        if pol.kind != "full" and pol.budget > capacity:
            raise ValueError(
                f"policy budget {pol.budget} exceeds cache capacity "
                f"{capacity}: the selection kernels require budget <= S "
                f"(clamp the budget or grow the cache)"
            )
        if self.layout == "paged" and capacity % pol.block_size:
            raise ValueError(
                f"capacity {capacity} not divisible by block_size "
                f"{pol.block_size}"
            )
        return self

    def with_pipeline(self, pipeline: str) -> "DecodePlan":
        """Re-resolve (and re-validate) this plan with another pipeline; a
        shard's ``plan_rows`` stays."""
        plan = DecodePlan.build(
            self.policy, layout=self.layout, pipeline=pipeline, shard=self.shard
        )
        return dataclasses.replace(plan, plan_rows=self.plan_rows)


# --------------------------------------------------------- metadata dispatch

def build_metadata(K: torch.Tensor, cfg: PolicyConfig) -> Any:
    """Selection metadata over a (capacity-sized) key slab [B,S,Hkv,D]."""
    return get_backend(cfg.kind).build_metadata(K, cfg)


def update_metadata(meta: Any, K: torch.Tensor, pos, cfg: PolicyConfig) -> Any:
    """Refresh, in place, the metadata block (FIER group / Quest page) that
    holds position ``pos`` (scalar or [B]) from the slab ``K``, which
    already holds the appended token.  Returns ``meta``."""
    if meta is None:
        return None
    return get_backend(cfg.kind).update_metadata(meta, K, pos, cfg)


# ------------------------------------------------------------------ dispatch

def _dense_decode(q: torch.Tensor, view: CacheView) -> torch.Tensor:
    K, V, _ = view.logical()
    return retrieval.full_attention_decode(q, K, V, view.length)


def decode_attention(
    q: torch.Tensor, view: CacheView, plan: DecodePlan, layer: int | None = None
) -> torch.Tensor:
    """The single decode-attention entry point.  The model's decode step
    gives the skip layers a ``full`` plan (``models/transformer.py``) and
    passes no ``layer``; a caller that passes ``layer < skip_layers`` gets
    dense attention from backends with ``skip_layers_fallback``, as the
    reference's ``layer`` argument does.  On the CPU a view without the
    side-car its backend needs attends densely; on the card it raises, so
    that a missing side-car never runs in place of the kernels."""
    if plan.layout != view.layout:
        raise UnsupportedPlanError(
            f"plan layout {plan.layout!r} does not match view layout "
            f"{view.layout!r}"
        )
    backend = plan.backend
    if backend.needs_metadata and view.meta is None:
        if q.is_cuda:
            raise UnsupportedPlanError(
                f"the {backend.name!r} backend needs its side-car metadata on the "
                f"card; the view has none"
            )
        return _dense_decode(q, view)
    if (layer is not None and backend.skip_layers_fallback
            and layer < plan.policy.skip_layers):
        return _dense_decode(q, view)
    return backend.decode(q, view, plan)


# ---------------------------------------------------------- builtin backends

def _fier_build_metadata(K, cfg):
    return quantize.quantize(K, cfg.group)


def _append_metadata(meta, K, pos, cfg):
    # one refresh for both kinds: the cache's per-row append
    from repro_torch.kvcache.cache import append_token_metadata  # cache imports this module

    pos = torch.broadcast_to(torch.as_tensor(pos, device=K.device), (K.shape[0],))
    return append_token_metadata(meta, K, pos, cfg)


def _fier_decode(q, view, plan):
    cfg = plan.policy
    sel = dict(group_reduce=cfg.group_reduce, sink=cfg.sink, recent=cfg.recent)
    if plan.pipeline in ("one_pass", "two_pass"):
        from repro_torch.kernels import ops as kops

        if plan.pipeline == "one_pass":
            return kops.fier_decode_one_pass(q, view, cfg.budget, plan_rows=plan.plan_rows,
                                             **sel)
        return kops.fier_decode_two_pass(q, view, cfg.budget, **sel)
    K, V, meta = view.logical()
    return retrieval.fier_decode_reference(
        q, K, V, meta, cfg.budget, view.length, use_kernels=cfg.use_kernels, **sel
    )


def _quest_build_metadata(K, cfg):
    return quest.build_page_meta(K, cfg.page)


def _quest_decode(q, view, plan):
    cfg = plan.policy
    K, V, meta = view.logical()
    return quest.quest_attention_decode(
        q, K, V, meta, cfg.budget, view.length, group_reduce=cfg.group_reduce
    )


def _slm_decode(q, view, plan):
    """StreamingLLM as a policy: the sink ∪ recent window, selected by
    ``select_topk`` over an all-zero score row (its guard-rails pick the
    window; ties go to the lower position)."""
    cfg = plan.policy
    K, V, _ = view.logical()
    B, Hkv, S = q.shape[0], K.shape[2], K.shape[1]
    sink = max(cfg.sink, 4)
    zeros = torch.zeros((B, Hkv, S), dtype=torch.float32, device=q.device)
    idx = retrieval.select_topk(
        zeros, cfg.budget, view.length, sink=sink, recent=cfg.budget - sink
    )
    Ksel, Vsel = retrieval.gather_kv(K, V, idx)
    return retrieval.sparse_attention(q, Ksel, Vsel, idx, view.length)


def _no_metadata(K, cfg):
    return None


def _keep_metadata(meta, K, pos, cfg):
    return meta


register_backend(AttentionBackend(
    name="full",
    supports=frozenset({("slab", "reference"), ("paged", "reference")}),
    build_metadata=_no_metadata,
    update_metadata=_keep_metadata,
    decode=lambda q, view, plan: _dense_decode(q, view),
    needs_metadata=False,
    skip_layers_fallback=False,  # decode *is* dense attention
    supports_sharding=frozenset({"local", "exact"}),
))

register_backend(AttentionBackend(
    name="fier",
    supports=frozenset({
        ("slab", "reference"), ("slab", "two_pass"), ("slab", "one_pass"),
        ("paged", "reference"), ("paged", "one_pass"),
    }),
    build_metadata=_fier_build_metadata,
    update_metadata=_append_metadata,
    decode=_fier_decode,
    supports_sharding=frozenset({"local", "exact"}),
))

register_backend(AttentionBackend(
    name="quest",
    supports=frozenset({("slab", "reference")}),
    build_metadata=_quest_build_metadata,
    update_metadata=_append_metadata,
    decode=_quest_decode,
))

# slm: StreamingLLM as a *policy* (sink ∪ recent window — the strongest
# eviction baseline that needs no per-step state)
register_backend(AttentionBackend(
    name="slm",
    supports=frozenset({("slab", "reference")}),
    build_metadata=_no_metadata,
    update_metadata=_keep_metadata,
    decode=_slm_decode,
    needs_metadata=False,
    skip_layers_fallback=False,  # its own full-attention substitute
))


# ---------------------------------------------------------------- deprecation

_warned: set[str] = set()


def _warn_deprecated(old: str, new: str) -> None:
    """One DeprecationWarning per deprecated entry point per process."""
    if old in _warned:
        return
    _warned.add(old)
    warnings.warn(
        f"{old} is deprecated; use {new} (DESIGN.md §Backend registry & DecodePlan)",
        DeprecationWarning,
        stacklevel=3,
    )


def decode_attention_paged(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    meta: Any,
    block_table: torch.Tensor,
    cfg: PolicyConfig,
    length: torch.Tensor,
    layer: int = 0,
) -> torch.Tensor:
    """Deprecated: build a paged ``CacheView`` + ``DecodePlan`` and call
    :func:`decode_attention` (``layer < cfg.skip_layers`` attends densely,
    as the reference's does)."""
    _warn_deprecated(
        "decode_attention_paged(q, k_pool, v_pool, meta, block_table, cfg, length)",
        "decode_attention(q, CacheView.paged(...), DecodePlan.build(cfg, layout='paged'))",
    )
    view = CacheView.paged(k_pool, v_pool, meta, block_table, length)
    return decode_attention(q, view, DecodePlan.build(cfg, layout="paged"), layer)
