"""Fault tolerance: failure injection, recovery loop, straggler monitor
(a copy of ``repro.runtime.fault``: pure Python).

At pod scale, failures are host/chip losses; here they are simulated as
exceptions at configurable steps.  The recovery contract the loop
enforces (and tests verify bit-exactly):

  * state (params, optimizer, step) restores from the latest checkpoint;
  * the data pipeline is (seed, step)-deterministic, so replayed steps see
    identical batches;
  * ⇒ resumed training is bit-identical to an uninterrupted run.

On a mesh the loop restores the logical arrays and ``on_restore``
re-places them on the mesh (``runtime/elastic.reshard_tree``; the train
CLI with ``--model-axis``), or a smaller mesh after a lost device.
"""
from __future__ import annotations

import time
from typing import Any, Callable


class FaultInjector:
    """Raises RuntimeError at the given (1-based) global steps — once each."""

    def __init__(self, fail_at: set[int] | list[int] = ()):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than ``threshold×`` EWMA.

    On real pods a flagged step triggers the drain→checkpoint→re-mesh path
    (the collective barrier makes one slow host everyone's problem); here
    it records events for tests/metrics.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: float | None = None
        self.events: list[tuple[int, float, float]] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        if self.ewma is None:
            self.ewma = dt
        elif dt > self.threshold * self.ewma:
            self.events.append((step, dt, self.ewma))
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return dt


def run_with_recovery(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    n_steps: int,
    ckpt,
    *,
    ckpt_every: int = 10,
    max_restarts: int = 5,
    state_like: Any = None,
    on_restore: Callable[[Any], Any] | None = None,
) -> tuple[Any, dict]:
    """Run ``state = step_fn(state, step)`` for steps [resume..n_steps) with
    checkpoint/restart.  Returns (final_state, stats)."""
    restarts = 0
    stats = {"restarts": 0, "resumed_from": []}
    state = init_state
    step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(latest, state_like if state_like is not None else state)
        if on_restore:
            state = on_restore(state)
        step = latest
        stats["resumed_from"].append(latest)
    while step < n_steps:
        try:
            state = step_fn(state, step)
            step += 1
            if step % ckpt_every == 0 or step == n_steps:
                ckpt.wait()
                ckpt.save_async(step, state)
        except RuntimeError as e:
            restarts += 1
            stats["restarts"] = restarts
            if restarts > max_restarts:
                raise RuntimeError(f"too many restarts ({restarts})") from e
            ckpt.wait()
            latest = ckpt.latest_step()
            if latest is None:
                state, step = init_state, 0
            else:
                state = ckpt.restore(
                    latest, state_like if state_like is not None else state
                )
                if on_restore:
                    state = on_restore(state)
                step = latest
            stats["resumed_from"].append(step)
    ckpt.wait()
    return state, stats
