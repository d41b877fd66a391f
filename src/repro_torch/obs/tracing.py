"""Structured span/event tracing on the scheduler's virtual token clock
(a copy of ``repro.obs.tracing``).

The :class:`Tracer` records a flat, append-only list of events.  Each
event carries **two** timestamps: ``ts`` — the scheduler's virtual token
clock (``ContinuousScheduler.vtime``: 1 unit per prefill token, 1 per
active slot per decode step), which is deterministic across seeded runs —
and ``wall_ts`` (``time.monotonic()``), which is informational.  All
derived serving numbers (:func:`derive_serving_metrics`) use ``ts`` only,
so two identical seeded runs produce identical traces modulo ``wall_ts``
(gated in tests/test_obs.py).

Event vocabulary (Chrome trace-event ``ph`` phases):

* ``X`` complete spans — request lifecycle: ``queued``, ``prefill``,
  ``prefill_chunk[i]``, ``prefix_replay``, ``request`` (whole lifetime);
* ``i`` instants — ``submitted``, ``token``, ``retired``, ``preempt``,
  ``prefill_abort``, ``budget_downshift`` / ``budget_restore``,
  ``blocks_shed``, ``quarantine``, ``fault``;
* ``C`` counters — ``pool`` (block-pool occupancy), ``occupancy``
  (running slots), introspection series.

Track layout: requests live on ``pid=1`` with ``tid = rid`` (one lane per
request in Perfetto); scheduler-global events on ``pid=0, tid=0``;
counter tracks on ``pid=0``.  Export: :meth:`Tracer.to_chrome_trace`
(the ``{"traceEvents": [...]}`` JSON Perfetto loads — virtual ts maps to
µs) and :meth:`Tracer.to_jsonl` (one event per line for grep/pandas).
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Callable

# Perfetto process/track ids
PID_SCHED = 0
PID_REQUEST = 1

_CHROME_PHASES = ("X", "B", "E", "i", "C", "M")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    ph: str                  # chrome trace-event phase
    ts: float                # virtual token clock
    wall_ts: float           # time.monotonic(), informational
    cat: str = "serving"
    pid: int = PID_SCHED
    tid: int = 0
    dur: float | None = None       # X spans only (virtual units)
    args: tuple[tuple[str, Any], ...] = ()

    def arg(self, key: str, default: Any = None) -> Any:
        for k, v in self.args:
            if k == key:
                return v
        return default


class _NullTracer:
    """Disabled tracer: every emit is a no-op (shared instance)."""

    enabled = False
    events: tuple = ()

    def set_clock(self, clock: Callable[[], float]) -> None: ...
    def reset(self) -> None: ...
    def now(self) -> float: return 0.0
    def instant(self, name, **kw) -> None: ...
    def complete(self, name, ts, dur, **kw) -> None: ...
    def counter(self, name, values, **kw) -> None: ...


NULL_TRACER = _NullTracer()


class Tracer:
    """Append-only trace buffer bound to a virtual clock.

    ``set_clock`` is called by the scheduler (``lambda: sched.vtime``);
    until then ``now()`` reads the last explicit timestamp (0.0 at
    start), so engine-level events emitted outside a scheduler still
    land on a monotone axis.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] | None = None):
        self.events: list[Event] = []
        self._clock = clock
        self._last_ts = 0.0

    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def reset(self) -> None:
        """Drop all buffered events (a new serving session restarts the
        virtual clock at 0, so a carried-over buffer would be
        non-monotone)."""
        self.events.clear()
        self._last_ts = 0.0

    def now(self) -> float:
        if self._clock is not None:
            self._last_ts = float(self._clock())
        return self._last_ts

    def _emit(self, name: str, ph: str, ts: float | None, *, cat: str,
              pid: int, tid: int, dur: float | None = None,
              **args: Any) -> None:
        self.events.append(Event(
            name=name, ph=ph,
            ts=self.now() if ts is None else float(ts),
            wall_ts=time.monotonic(), cat=cat, pid=pid, tid=tid, dur=dur,
            args=tuple(sorted(args.items())),
        ))

    # ------------------------------------------------------------- emitters
    def instant(self, name: str, *, ts: float | None = None,
                cat: str = "serving", pid: int = PID_SCHED, tid: int = 0,
                **args: Any) -> None:
        self._emit(name, "i", ts, cat=cat, pid=pid, tid=tid, **args)

    def complete(self, name: str, ts: float, dur: float, *,
                 cat: str = "serving", pid: int = PID_SCHED, tid: int = 0,
                 **args: Any) -> None:
        self._emit(name, "X", ts, cat=cat, pid=pid, tid=tid,
                   dur=float(dur), **args)

    def counter(self, name: str, values: dict[str, float], *,
                ts: float | None = None, cat: str = "serving",
                pid: int = PID_SCHED, tid: int = 0) -> None:
        self._emit(name, "C", ts, cat=cat, pid=pid, tid=tid,
                   **{k: float(v) for k, v in values.items()})

    # -------------------------------------------------------------- exports
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable).  Virtual token
        units map 1:1 onto trace µs; ``wall_ts`` rides along in args."""
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": PID_SCHED, "tid": 0,
             "args": {"name": "scheduler"}},
            {"name": "process_name", "ph": "M", "pid": PID_REQUEST, "tid": 0,
             "args": {"name": "requests"}},
        ]
        named_tids: set[tuple[int, int]] = set()
        for e in self.events:
            if e.pid == PID_REQUEST and (e.pid, e.tid) not in named_tids:
                named_tids.add((e.pid, e.tid))
                events.append({
                    "name": "thread_name", "ph": "M", "pid": e.pid,
                    "tid": e.tid, "args": {"name": f"rid={e.tid}"}})
            row: dict[str, Any] = {
                "name": e.name, "ph": e.ph, "cat": e.cat,
                "ts": e.ts, "pid": e.pid, "tid": e.tid,
                "args": dict(e.args, wall_ts=e.wall_ts),
            }
            if e.ph == "X":
                row["dur"] = e.dur
            if e.ph == "i":
                row["s"] = "t"   # thread-scoped instant
            events.append(row)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> dict:
        doc = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        return doc

    def to_jsonl(self) -> str:
        lines = []
        for e in self.events:
            row = dataclasses.asdict(e)
            row["args"] = dict(e.args)
            lines.append(json.dumps(row, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    # ------------------------------------------------------------- analysis
    def request_events(self, rid: int) -> list[Event]:
        return [e for e in self.events
                if e.pid == PID_REQUEST and e.tid == rid]

    def canonical(self) -> list[tuple]:
        """Deterministic projection (drops ``wall_ts``) — two identical
        seeded runs must compare equal on this."""
        return [(e.name, e.ph, e.ts, e.cat, e.pid, e.tid, e.dur, e.args)
                for e in self.events]


def validate_chrome_trace(doc: Any) -> list[str]:
    """Stdlib-only structural check that ``doc`` is a Perfetto-loadable
    Chrome trace-event document.  Returns a list of problems (empty =
    valid).  Used by ``tools/obs_report.py --validate`` and the exporter
    round-trip tests."""
    errs: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with a 'traceEvents' array"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be an array"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        for field in ("name", "ph", "pid", "tid"):
            if field not in e:
                errs.append(f"{where}: missing {field!r}")
        ph = e.get("ph")
        if ph not in _CHROME_PHASES:
            errs.append(f"{where}: unknown phase {ph!r}")
            continue
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)):
                errs.append(f"{where}: ts must be a number, got {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: X span needs numeric dur >= 0")
        if ph == "C":
            args = e.get("args", {})
            if not isinstance(args, dict) or not args:
                errs.append(f"{where}: C event needs non-empty args")
            elif not all(isinstance(v, (int, float))
                         for k, v in args.items() if k != "wall_ts"):
                errs.append(f"{where}: C args must be numeric")
        if "args" in e and not isinstance(e["args"], dict):
            errs.append(f"{where}: args must be an object")
    return errs


def load_trace_events(doc: dict) -> list[Event]:
    """Parse a Chrome trace document back into :class:`Event` rows
    (metadata events dropped) — the Perfetto-JSON half of the exporter
    round-trip test."""
    out: list[Event] = []
    for row in doc["traceEvents"]:
        if row.get("ph") == "M":
            continue
        args = dict(row.get("args", {}))
        wall = args.pop("wall_ts", 0.0)
        out.append(Event(
            name=row["name"], ph=row["ph"], ts=float(row["ts"]),
            wall_ts=float(wall), cat=row.get("cat", "serving"),
            pid=int(row["pid"]), tid=int(row["tid"]),
            dur=(float(row["dur"]) if "dur" in row else None),
            args=tuple(sorted(args.items())),
        ))
    return out


def _percentile(sorted_vals: list[float], q: float) -> float:
    # linear interpolation between closest ranks on a pre-sorted list —
    # bit-identical to np.percentile's default method including its lerp
    # branch (t >= 0.5 computes from the upper rank), so span-derived
    # numbers match historical BENCH_serve_trace baselines exactly
    if not sorted_vals:
        return 0.0
    rank = q * (len(sorted_vals) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    a, b = float(sorted_vals[lo]), float(sorted_vals[hi])
    t = rank - lo
    if t >= 0.5:
        return b - (b - a) * (1.0 - t)
    return a + (b - a) * t


def derive_serving_metrics(events: list[Event] | Tracer) -> dict:
    """Compute TTFT / ITL / throughput from a request-span trace — the
    single source of truth shared by ``bench_serve_trace`` and the
    metrics snapshot, so the benchmark and the engine can never disagree.

    Per rid: TTFT = first ``token`` ts − ``submitted`` ts; ITL = gaps
    between consecutive ``token`` ts.  Throughput = total tokens /
    makespan (first ``submitted`` → last ``token``), in tokens per 1000
    virtual units.  All on the virtual clock.
    """
    if isinstance(events, Tracer):
        events = events.events
    submitted: dict[int, float] = {}
    tokens: dict[int, list[float]] = {}
    for e in events:
        if e.pid != PID_REQUEST:
            continue
        if e.name == "submitted":
            submitted.setdefault(e.tid, e.ts)
        elif e.name == "token":
            tokens.setdefault(e.tid, []).append(e.ts)
    ttfts = sorted(tokens[rid][0] - t0 for rid, t0 in submitted.items()
                   if tokens.get(rid))
    itls = sorted(b - a
                  for stamps in tokens.values()
                  for a, b in zip(stamps, stamps[1:]))
    total_tokens = sum(len(v) for v in tokens.values())
    t_start = min(submitted.values(), default=0.0)
    t_end = max((v[-1] for v in tokens.values() if v), default=t_start)
    makespan = max(t_end - t_start, 1e-9)
    return {
        "ttft_p50": _percentile(ttfts, 0.50),
        "ttft_p99": _percentile(ttfts, 0.99),
        "itl_p50": _percentile(itls, 0.50),
        "itl_p99": _percentile(itls, 0.99),
        "total_tokens": total_tokens,
        "makespan": makespan,
        "tokens_per_kunit": 1000.0 * total_tokens / makespan,
        "n_requests": len(submitted),
        "n_finished_first_token": len(ttfts),
    }
