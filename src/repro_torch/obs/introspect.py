"""Retrieval-quality introspection: how good is FIER's approximate top-k?

Port of ``repro.obs.introspect``.  Opt-in debug mode
(``Observability(introspect=True)``): each scheduler decode step
(subsampled by ``every``) re-runs the retrieval stage for the probed layer
*outside* the decode step — eagerly, through the plain PyTorch functions
of ``core.retrieval`` on the engine's device — and compares the 1-bit
approximate selection against the exact dot-product oracle on the same
cache contents.  Per running slot it records:

* **budget utilization** — ``min(length, budget) / budget``: how much of
  the configured (possibly degraded) retrieval budget addresses real
  tokens.  Below 1.0 the top-k is vacuous (everything fits).
* **τ threshold** — the ``budget``-th largest approximate score (the
  admission threshold the one-pass kernel radix-searches for), mean over
  KV heads, on length-masked scores (guard-rail ±inf overrides excluded
  so τ stays finite).
* **oracle overlap** — ``|topk(approx) ∩ topk(exact)| / k_eff`` under the
  *same* sink/recent guard-rails: the paper's selection-quality metric.
* **recaptured attention mass** — sum of the exact softmax attention
  weights (1/√D-scaled, length-masked) that the approximate selection
  retains — FIER's "recall" framing: quality loss is the mass you drop.

Everything lands in the shared metrics registry (histograms + gauges)
and as per-step ``C`` counter rows on the tracer, so ``obs_report``
renders it next to the serving numbers.  Cost caveat: one probe is
O(S·Hkv·D) eager work per running slot plus a copy of its scores to the
host — strictly a debugging mode, never on in timed sections.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .metrics import MetricsRegistry
from .tracing import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class ProbeRecord:
    """One (step, slot) introspection sample."""

    step: int
    slot: int
    length: int
    budget: int
    budget_utilization: float
    tau: float
    oracle_overlap: float
    recaptured_mass: float


# buckets for ratio-valued series in [0, 1]
_RATIO_BUCKETS = tuple(i / 10 for i in range(1, 11))


class RetrievalIntrospector:
    """Probes the FIER retrieval stage of a live engine cache.

    ``probe_layer`` indexes the *rest* (retrieval-policy) layer stack;
    ``every`` subsamples decode steps.  Slab and paged layouts are both
    supported — paged probes materialise the logical view through the
    block table (``kvcache.paged.gather_block_rows``)."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer=NULL_TRACER, *, probe_layer: int = 0,
                 every: int = 1):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.probe_layer = probe_layer
        self.every = max(1, every)
        self.records: list[ProbeRecord] = []
        r = self.registry
        self._h_overlap = r.histogram(
            "fier_oracle_overlap",
            "fraction of exact top-k recovered by the 1-bit selection",
            unit="ratio", better="higher", buckets=_RATIO_BUCKETS)
        self._h_mass = r.histogram(
            "fier_recaptured_mass",
            "exact attention mass retained by the approximate selection",
            unit="ratio", better="higher", buckets=_RATIO_BUCKETS)
        self._h_util = r.histogram(
            "fier_budget_utilization",
            "min(length, budget) / budget per probed slot-step",
            unit="ratio", buckets=_RATIO_BUCKETS)
        self._g_tau = r.gauge(
            "fier_tau", "latest top-k admission threshold (approx score)")
        self._c_probes = r.counter(
            "fier_probes_total", "introspection probes taken")

    # ------------------------------------------------------------------ cache
    def _layer_view(self, engine, cache):
        """(K [B,S,Hkv,D], QuantizedKeys) logical view of the probed rest
        layer, or None when the cache has no FIER side-car."""
        from repro_torch.core.quantize import QuantizedKeys

        rest = cache["rest"]
        if not isinstance(rest, dict) or not isinstance(rest.get("meta"), QuantizedKeys):
            return None
        lyr = self.probe_layer
        if not (0 <= lyr < rest["k"].shape[0]):
            # probe layer outside the rest (retrieval-policy) stack — e.g. a
            # reduced config whose layers are all skip layers
            return None
        K, qk = rest["k"][lyr], rest["meta"].layer(lyr)
        if engine.paged:
            from repro_torch.core.policy import map_meta
            from repro_torch.kvcache.paged import gather_block_rows

            tbl = cache["block_table"]
            K = gather_block_rows(K, tbl)
            qk = map_meta(qk, lambda a: gather_block_rows(a, tbl))
        return K, qk

    # ------------------------------------------------------------------ probe
    def probe(self, engine, cache, running_slots, step: int) -> list[ProbeRecord]:
        """Sample every running slot at this decode step (subject to
        ``every``).  Returns the new records (also appended to
        ``self.records`` / the registry / the tracer)."""
        if step % self.every:
            return []
        pol = engine.bundle.policy
        if pol is None or pol.kind != "fier":
            return []
        view = self._layer_view(engine, cache)
        if view is None:
            return []
        import torch

        from repro_torch.core import retrieval as R
        from repro_torch.core.policy import map_meta

        K, qk = view
        lengths = cache["length"].cpu().numpy()
        budget = int(engine.current_budget)
        out: list[ProbeRecord] = []
        for slot in running_slots:
            L = int(lengths[slot])
            if L < 2 or budget < 1:
                continue
            Kb = K[slot:slot + 1]                       # [1, S, Hkv, D]
            qkb = map_meta(qk, lambda a: a[slot:slot + 1])
            # probe query: the newest resident key (Hq = Hkv, rep = 1) — a
            # zero-setup stand-in with the true q's scale and layout
            q = Kb[:, L - 1].to(torch.float32)          # [1, Hkv, D]
            length = torch.tensor([L], dtype=torch.int32, device=K.device)
            Hkv = Kb.shape[2]
            approx = R.reduce_over_query_group(
                R.approx_scores(q, qkb), Hkv, pol.group_reduce)
            exact = R.reduce_over_query_group(
                R.exact_scores(q, Kb), Hkv, pol.group_reduce)
            k_eff = min(budget, L)
            # τ on length-masked-only scores (no ±inf guard-rail overrides)
            am = R.masked_scores(approx, length).cpu().numpy()   # [1, Hkv, S]
            tau = float(np.mean(np.sort(am[0], axis=-1)[:, -k_eff]))
            idx_a = R.select_topk(
                approx, k_eff, length, sink=pol.sink, recent=pol.recent).cpu().numpy()
            idx_e = R.select_topk(
                exact, k_eff, length, sink=pol.sink, recent=pol.recent).cpu().numpy()
            overlaps, masses = [], []
            em = R.masked_scores(exact, length).cpu().numpy()[0]  # [Hkv, S]
            scale = 1.0 / np.sqrt(float(Kb.shape[-1]))
            for h in range(Hkv):
                sel_a, sel_e = set(idx_a[0, h]), set(idx_e[0, h])
                overlaps.append(len(sel_a & sel_e) / k_eff)
                # exact softmax over the valid prefix; mass at approx picks
                s = em[h, :L] * scale
                p = np.exp(s - s.max())
                p /= p.sum()
                masses.append(float(sum(
                    p[i] for i in sel_a if 0 <= i < L)))
            rec = ProbeRecord(
                step=step, slot=int(slot), length=L, budget=budget,
                budget_utilization=k_eff / budget, tau=tau,
                oracle_overlap=float(np.mean(overlaps)),
                recaptured_mass=float(np.mean(masses)),
            )
            out.append(rec)
            self.records.append(rec)
            labels = {"slot": str(slot)}
            self._h_overlap.observe(rec.oracle_overlap, **labels)
            self._h_mass.observe(rec.recaptured_mass, **labels)
            self._h_util.observe(rec.budget_utilization, **labels)
            self._g_tau.set(rec.tau, **labels)
            self._c_probes.inc()
            self.tracer.counter(
                f"introspect/slot{slot}",
                {"oracle_overlap": rec.oracle_overlap,
                 "recaptured_mass": rec.recaptured_mass,
                 "budget_utilization": rec.budget_utilization,
                 "tau": rec.tau},
                cat="introspect",
            )
        return out
