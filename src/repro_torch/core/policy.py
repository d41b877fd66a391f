"""Decode-attention backend registry: ``CacheView`` + ``DecodePlan``.

Port of ``repro.core.policy`` for the slab layout.  The registry holds the
``full`` and ``fier`` backends; ``fier`` runs the ``one_pass`` pipeline
(the CUDA retrieval kernel chained into the CUDA select-and-attend kernel)
or the ``reference`` pipeline (plain PyTorch oracles)::

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
_NOT_PORTED_KINDS = {"quest": "ROADMAP Queue 1 item 7", "slm": "ROADMAP Queue 1 item 7"}


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
    pipeline: str = "reference"  # reference | two_pass | one_pass
    layout: str = "slab"       # slab | paged

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
    [B, S, Hkv, D]; ``meta`` is the policy side-car (``QuantizedKeys`` for
    fier, None for full); ``length`` [B] int32 masks unwritten positions
    (None = all valid)."""

    __slots__ = ("k", "v", "meta", "block_table", "length", "layout")

    def __init__(self, k, v, meta=None, block_table=None, length=None,
                 *, layout: str = "slab"):
        if layout == "paged":
            raise _not_ported("the paged CacheView", "ROADMAP Queue 1 item 6")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; choose from {LAYOUTS}")
        self.k = k
        self.v = v
        self.meta = meta
        self.block_table = block_table
        self.length = length
        self.layout = layout

    @classmethod
    def slab(cls, k, v, meta=None, length=None) -> "CacheView":
        return cls(k, v, meta, None, length, layout="slab")

    def logical(self):
        """(K, V, meta) as logical per-request slabs."""
        return self.k, self.v, self.meta

    def __repr__(self):
        sh = lambda a: None if a is None else tuple(a.shape)
        return (
            f"CacheView(layout={self.layout!r}, k={sh(self.k)}, "
            f"meta={type(self.meta).__name__ if self.meta is not None else None})"
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
        if layout == "paged":
            raise _not_ported("layout='paged'", "ROADMAP Queue 1 item 6")
        if pipeline == "two_pass":
            raise _not_ported(
                "pipeline='two_pass' (kernels K6/K7)", "ROADMAP Queue 1 item 7"
            )
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
    if plan.pipeline == "one_pass":
        from repro_torch.kernels import ops as kops

        return kops.fier_decode_one_pass(q, view, cfg.budget, **sel)
    K, V, meta = view.logical()
    return retrieval.fier_decode_reference(q, K, V, meta, cfg.budget, view.length, **sel)


register_backend(AttentionBackend(
    name="full",
    supports=frozenset({("slab", "reference")}),
    build_metadata=lambda K, cfg: None,
    decode=lambda q, view, plan: _dense_decode(q, view),
))

register_backend(AttentionBackend(
    name="fier",
    supports=frozenset({("slab", "reference"), ("slab", "one_pass")}),
    build_metadata=_fier_build_metadata,
    decode=_fier_decode,
))
