"""Serving health primitives: the per-request outcome state machine, the
decode-step NaN/Inf watchdog, and the health counter/audit-cadence
bookkeeping the scheduler threads its fault-tolerance decisions through
(a copy of ``repro.serving.health``).

Every request leaves the scheduler through exactly one of the terminal
states in :data:`STATUSES` (DESIGN.md §Serving fault tolerance):

    finished          ran to max_new / eos / capacity
    rejected          could never be served (prompt > capacity, prompt
                      outgrows the whole block pool, repeated
                      self-preemption without progress)
    cancelled         caller withdrew it (``ContinuousScheduler.cancel``)
    deadline_exceeded its virtual-token-clock deadline passed while it
                      was queued / prefilling / decoding
    quarantined       the decode watchdog saw non-finite logits in its
                      slot and isolated it from the batch

The scheduler records a :class:`RequestOutcome` for every request (also
attached as ``Request.outcome``), so callers distinguish the states
structurally instead of parsing warnings.
"""
from __future__ import annotations

import dataclasses

import numpy as np

STATUSES = (
    "finished",
    "rejected",
    "cancelled",
    "deadline_exceeded",
    "quarantined",
)


@dataclasses.dataclass(frozen=True)
class RequestOutcome:
    """Terminal record for one request: how it left the scheduler."""

    rid: int
    status: str                  # one of STATUSES
    reason: str = ""             # human-readable detail
    tokens: int = 0              # generated tokens at retirement
    vtime: float = 0.0           # scheduler virtual-token clock at retirement
    slot: int | None = None      # decode slot held at retirement (None when
                                 # queued / mid-prefill) — quarantines and
                                 # preempt-retires are diagnosable from the
                                 # outcome record alone

    def __post_init__(self):
        if self.status not in STATUSES:
            raise ValueError(
                f"unknown outcome status {self.status!r}; one of {STATUSES}"
            )


class StepReport:
    """Return value of ``ContinuousScheduler.step``: truthy iff the step
    made progress (back-compat with the old bool), plus the outcomes of
    every request retired during the step."""

    __slots__ = ("progressed", "retired")

    def __init__(self, progressed: bool, retired: list[RequestOutcome]):
        self.progressed = bool(progressed)
        self.retired = retired

    def __bool__(self) -> bool:
        return self.progressed

    def __repr__(self) -> str:
        return f"StepReport(progressed={self.progressed}, retired={self.retired})"


class ServeResult(dict):
    """``run()``'s return value: a plain ``rid → generated tokens`` dict
    (back-compat — equality/iteration behave exactly like before) that
    additionally carries the structured per-request outcomes."""

    def __init__(self, outputs: dict, outcomes: dict[int, RequestOutcome]):
        super().__init__(outputs)
        self.outcomes = outcomes


def nonfinite_slots(logits: np.ndarray, slots) -> list[int]:
    """The decode watchdog check: which of ``slots`` have any NaN/Inf in
    their logits row.  ``logits`` [n_slots, V] (host array)."""
    bad = ~np.isfinite(logits).all(axis=-1)
    return [s for s in slots if bad[s]]


class HealthMonitor:
    """Counters + audit cadence for one serving session.

    ``counts`` mirrors the outcome state machine (one counter per status);
    the extra counters track the fault-tolerance machinery itself:
    quarantine events, deadline expiries by phase, allocator audits run.
    """

    def __init__(self, audit_every: int | None = None):
        self.audit_every = audit_every
        self.counts: dict[str, int] = {s: 0 for s in STATUSES}
        self.audits_run = 0
        self.self_preempt_retires = 0
        # structured event log: quarantines, preemptions, prefill aborts —
        # each a dict with at least {kind, slot, rid, reason}, so chaos
        # runs are diagnosable without parsing warning text
        self.events: list[dict] = []

    def record(self, outcome: RequestOutcome) -> None:
        self.counts[outcome.status] += 1

    def record_event(self, kind: str, *, slot: int | None = None,
                     rid: int | None = None, reason: str = "",
                     **detail) -> dict:
        """Log one structured health event (quarantine / preempt /
        prefill_abort / …) with its slot id, request id, and reason."""
        ev = dict(kind=kind, slot=slot, rid=rid, reason=reason, **detail)
        self.events.append(ev)
        return ev

    def event_counts(self) -> dict[str, int]:
        """Events-by-kind histogram of the structured log — the quick
        answer to "did the offload_drop / quarantine / prefill_abort
        machinery actually fire in this run?"."""
        out: dict[str, int] = {}
        for ev in self.events:
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def maybe_audit(self, engine, step: int) -> bool:
        """Run the engine's allocator audit every ``audit_every`` decode
        steps (no-op when disabled or the engine is not paged; for a
        two-tier engine the audit covers the device pool AND the host
        offload tier, including cross-tier key disjointness).  Raises
        ``AllocatorAuditError`` on an invariant violation."""
        if not self.audit_every or step == 0 or step % self.audit_every:
            return False
        engine.audit()
        self.audits_run += 1
        return True

    def summary(self) -> dict:
        return dict(self.counts, audits_run=self.audits_run,
                    self_preempt_retires=self.self_preempt_retires,
                    events=len(self.events))
