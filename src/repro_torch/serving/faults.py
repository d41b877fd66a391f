"""Deterministic serving chaos harness: seeded fault injection against a
live ``ContinuousScheduler``.

The training loop already has exception-at-step injection
(the JAX package's ``runtime.fault.FaultInjector``); serving faults are different in kind —
they corrupt *state* (logits, cache metadata, allocator responses) or the
*request stream* (cancels) rather than raising, and the contract under
test is containment: the scheduler must survive every fault class, the
allocator must audit clean at drain, and requests not targeted by a fault
must produce bit-identical outputs to a fault-free run.

Fault classes (:data:`FAULT_KINDS`):

``alloc_fail``
    The next ``count`` block allocations return None (a transient
    pool-exhaustion burst), exercising the degradation/preemption ladder.
``poison_logits``
    The target request's logits row turns NaN at the given decode step —
    the watchdog must quarantine only that slot.
``corrupt_metadata``
    A block (paged) / slot row (slab) of the target request's FIER
    side-car is scrambled on device — retrieval quality degrades for that
    request only; everything stays finite and the batch keeps decoding.
``cancel``
    The request is cancelled mid-flight (queued, mid-chunked-prefill, or
    decoding) through the ``cancel()`` API.
``offload_drop``
    ``count`` LRU entries of the engine's host-DRAM offload tier are lost
    (models host memory reclaim / a failed D2H transfer).  Recalls that
    would have hit now miss and fall back to recomputing the prefix —
    outputs must stay bit-identical; a no-op on engines without an
    offload tier.

Injection points are either given explicitly as :class:`FaultSpec`s or
drawn from a seeded rng (:meth:`ServingFaultInjector.random`), so every
chaos run is exactly reproducible from (trace seed, injector seed).

A copy of ``repro.serving.faults`` (host logic only: numpy and the
scheduler's API).
"""
from __future__ import annotations

import dataclasses

import numpy as np

FAULT_KINDS = (
    "alloc_fail", "poison_logits", "corrupt_metadata", "cancel",
    "offload_drop",
)


@dataclasses.dataclass
class FaultSpec:
    """One fault to inject.

    ``step`` is the scheduler decode-step counter (``sched.steps``) at
    which the fault arms.  Slot-targeted faults (poison / corrupt) fire at
    the first armed step where the target request is actually resident in
    a decode slot; ``cancel`` / ``alloc_fail`` fire exactly once when
    armed.  ``rid`` is the target request where applicable; ``count`` is
    the number of consecutive allocation failures for ``alloc_fail``.
    """

    kind: str
    step: int
    rid: int | None = None
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")


class ServingFaultInjector:
    """Deterministic fault schedule, wired into the scheduler step loop.

    The scheduler calls :meth:`on_step_begin` before each step's admission
    work and :meth:`poison_logits` on the decode logits (host copy) before
    the NaN watchdog runs; no other integration points exist, so a
    scheduler without an injector runs byte-identical code.
    """

    def __init__(self, specs: list[FaultSpec] | tuple = ()):
        self.specs = list(specs)
        self._fired: set[int] = set()        # indices into self.specs
        self.fired_log: list[tuple[int, str, int | None]] = []  # (step, kind, rid)

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        rids,
        kinds=FAULT_KINDS,
        n_faults: int = 3,
        step_lo: int = 1,
        step_hi: int = 12,
    ) -> "ServingFaultInjector":
        """A seeded fault schedule: ``n_faults`` draws of (kind, step,
        target rid) — identical schedule for identical arguments."""
        rng = np.random.default_rng(seed)
        rids = list(rids)
        specs = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            step = int(rng.integers(step_lo, step_hi + 1))
            rid = rids[int(rng.integers(0, len(rids)))] if rids else None
            specs.append(FaultSpec(kind=kind, step=step, rid=rid,
                                   count=int(rng.integers(1, 4))))
        return cls(specs)

    # ------------------------------------------------------------------ hooks
    def _mark(self, i: int, spec: FaultSpec, sched) -> None:
        self._fired.add(i)
        self.fired_log.append((sched.steps, spec.kind, spec.rid))
        # fired faults are trace events: a chaos run's injections land on
        # the same virtual-clock timeline as the preemptions/quarantines
        # they provoke (obs disabled → the null tracer swallows this)
        obs = getattr(sched, "obs", None)
        if obs is not None and obs.enabled:
            obs.tracer.instant(
                "fault", cat="fault", kind=spec.kind, rid=spec.rid,
                step=sched.steps, count=spec.count)
            obs.metrics.counter(
                "faults_injected_total", "chaos-harness faults fired",
            ).inc(kind=spec.kind)

    def on_step_begin(self, sched) -> None:
        """Fire step-armed faults: cancels, allocation-failure bursts, and
        device metadata corruption (the latter waits for its target to be
        resident in a slot)."""
        eng = sched.engine
        for i, spec in enumerate(self.specs):
            if i in self._fired or sched.steps < spec.step:
                continue
            if spec.kind == "cancel":
                # not submitted yet → cancel() refuses; retry next step
                if sched.cancel(spec.rid, reason="fault-injected cancel"):
                    self._mark(i, spec, sched)
            elif spec.kind == "alloc_fail":
                if eng.paged:
                    eng.allocator.fail_next(spec.count)
                self._mark(i, spec, sched)
            elif spec.kind == "offload_drop":
                off = getattr(eng, "offload", None)
                if off is not None:
                    n = off.drop_lru(spec.count)
                    sched.health.record_event(
                        "offload_drop", reason="fault-injected host loss",
                        dropped=n,
                    )
                self._mark(i, spec, sched)  # no-op without a host tier
            elif spec.kind == "corrupt_metadata":
                slot = sched.slot_of(spec.rid)
                if slot is None:
                    continue  # not resident yet; retry next step
                ok, sched._cache = eng.corrupt_slot_metadata(sched._cache, slot)
                if ok:  # no privately-held block yet: retry next step
                    self._mark(i, spec, sched)

    def poison_logits(self, sched, logits: np.ndarray) -> np.ndarray:
        """Overwrite armed targets' logits rows with NaN (models a
        numerically-poisoned decode step for that slot)."""
        for i, spec in enumerate(self.specs):
            if (
                i in self._fired
                or spec.kind != "poison_logits"
                or sched.steps < spec.step
            ):
                continue
            slot = sched.slot_of(spec.rid)
            if slot is None:
                continue  # not resident yet; retry next step
            logits = np.array(logits)  # never scribble on a shared buffer
            logits[slot] = np.nan
            self._mark(i, spec, sched)
        return logits

    @property
    def all_fired(self) -> bool:
        return len(self._fired) == len(self.specs)
