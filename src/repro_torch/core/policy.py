"""Decode-attention backend registry: ``CacheView`` + ``DecodePlan``.

Port of ``repro.core.policy`` for the slab and paged layouts.  The registry
holds the ``full`` and ``fier`` backends; ``fier`` runs the ``one_pass``
pipeline (the CUDA retrieval kernel chained into the CUDA select-and-attend
kernel; on a paged cache their block-table variants), the slab-only
``two_pass`` pipeline (the CUDA score scan and threshold search, then the
select-and-attend kernel) or the ``reference`` pipeline (plain PyTorch
oracles over the logical, table-gathered cache; ``use_kernels`` scores with
the CUDA score scan)::

    plan = DecodePlan.build(cfg, capacity=capacity)
    meta = build_metadata(K, cfg)                 # after prefill
    out  = decode_attention(q, view, plan)

Modes this slice does not carry raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import quantize, retrieval

PIPELINES = ("reference", "two_pass", "one_pass")
LAYOUTS = ("slab", "paged")

# kinds the JAX package registers that this slice does not port yet
_NOT_PORTED_KINDS = {"quest": "ROADMAP Queue 1 item 7b", "slm": "ROADMAP Queue 1 item 7b"}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


# --------------------------------------------------------------- PolicyConfig

@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    kind: str = "full"
    budget: int = 1024
    group: int = 32            # FIER group size g
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
        if self.kind in _NOT_PORTED_KINDS:
            raise _not_ported(f"policy {self.kind!r}", _NOT_PORTED_KINDS[self.kind])
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
    ``meta`` is the policy side-car (``QuantizedKeys`` for fier, None for
    full) in the matching layout; ``length`` [B] int32 masks unwritten
    positions (None = all valid)."""

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

        meta = None
        if self.meta is not None:
            m = self.meta
            meta = quantize.QuantizedKeys(g(m.codes), g(m.scale), g(m.zero), m.group)
        return g(self.k), g(self.v), meta

    def __repr__(self):
        sh = lambda a: None if a is None else tuple(a.shape)
        return (
            f"CacheView(layout={self.layout!r}, k={sh(self.k)}, "
            f"meta={type(self.meta).__name__ if self.meta is not None else None}, "
            f"block_table={sh(self.block_table)})"
        )


# ----------------------------------------------------------- backend registry

class UnsupportedPlanError(ValueError):
    """(policy, layout, pipeline) combination outside the backend's
    declared capability matrix."""


@dataclasses.dataclass(frozen=True)
class AttentionBackend:
    """One registered decode-attention policy: its (layout, pipeline)
    capability matrix, the side-car builder ``(K, cfg) -> meta`` and the
    decode ``(q, view, plan) -> out [B, Hq, D]``."""

    name: str
    supports: frozenset
    build_metadata: Callable[[torch.Tensor, PolicyConfig], Any]
    decode: Callable[[torch.Tensor, CacheView, "DecodePlan"], torch.Tensor]

    def supports_str(self) -> str:
        return ", ".join(f"{lo}×{pi}" for lo, pi in sorted(self.supports))


_REGISTRY: dict[str, AttentionBackend] = {}


def register_backend(backend: AttentionBackend) -> None:
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    bad = {c for c in backend.supports if c[0] not in LAYOUTS or c[1] not in PIPELINES}
    if bad:
        raise ValueError(f"backend {backend.name!r}: invalid capabilities {bad}")
    _REGISTRY[backend.name] = backend


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
    via :meth:`build`; the constructor validates nothing."""

    policy: PolicyConfig
    layout: str = "slab"
    pipeline: str = "reference"

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
        if shard is not None:
            raise _not_ported("mesh-sharded decode", "ROADMAP Queue 1 item 10")
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
        plan = cls(policy, layout, pipeline)
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


# --------------------------------------------------------- metadata dispatch

def build_metadata(K: torch.Tensor, cfg: PolicyConfig) -> Any:
    """Selection metadata over a (capacity-sized) key slab [B,S,Hkv,D]."""
    return get_backend(cfg.kind).build_metadata(K, cfg)


# ------------------------------------------------------------------ dispatch

def _dense_decode(q: torch.Tensor, view: CacheView) -> torch.Tensor:
    K, V, _ = view.logical()
    return retrieval.full_attention_decode(q, K, V, view.length)


def decode_attention(q: torch.Tensor, view: CacheView, plan: DecodePlan) -> torch.Tensor:
    """The single decode-attention entry point.  The skip layers do not
    come here with a ``fier`` plan: the model's decode step gives them a
    ``full`` plan (``models/transformer.py``)."""
    if plan.layout != view.layout:
        raise UnsupportedPlanError(
            f"plan layout {plan.layout!r} does not match view layout "
            f"{view.layout!r}"
        )
    return plan.backend.decode(q, view, plan)


# ---------------------------------------------------------- builtin backends

def _fier_build_metadata(K, cfg):
    return quantize.quantize(K, cfg.group)


def _fier_decode(q, view, plan):
    cfg = plan.policy
    sel = dict(group_reduce=cfg.group_reduce, sink=cfg.sink, recent=cfg.recent)
    if plan.pipeline in ("one_pass", "two_pass"):
        from repro_torch.kernels import ops as kops

        if plan.pipeline == "one_pass":
            return kops.fier_decode_one_pass(q, view, cfg.budget, **sel)
        return kops.fier_decode_two_pass(q, view, cfg.budget, **sel)
    K, V, meta = view.logical()
    return retrieval.fier_decode_reference(
        q, K, V, meta, cfg.budget, view.length, use_kernels=cfg.use_kernels, **sel
    )


register_backend(AttentionBackend(
    name="full",
    supports=frozenset({("slab", "reference"), ("paged", "reference")}),
    build_metadata=lambda K, cfg: None,
    decode=lambda q, view, plan: _dense_decode(q, view),
))

register_backend(AttentionBackend(
    name="fier",
    supports=frozenset({
        ("slab", "reference"), ("slab", "two_pass"), ("slab", "one_pass"),
        ("paged", "reference"), ("paged", "one_pass"),
    }),
    build_metadata=_fier_build_metadata,
    decode=_fier_decode,
))
