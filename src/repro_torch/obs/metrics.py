"""Zero-dependency in-process metrics registry (a copy of
``repro.obs.metrics``).

One :class:`MetricsRegistry` per serving session (the engine and the
scheduler share it through :class:`repro_torch.obs.Observability`).  Three
instrument kinds — :class:`Counter` (monotone), :class:`Gauge` (level),
:class:`Histogram` (bucketed distribution + exact sum/count) — each
holding *labeled series*: ``counter.inc(1, status="finished")`` keeps one
float per distinct label set, so the registry is the single namespace for
every quantity the serving stack reports (DESIGN.md §Observability).

Design constraints, in order:

* **Host-side only.**  Instruments never appear inside jitted code; a
  metric update is a Python dict write.  The disabled registry
  (``MetricsRegistry(enabled=False)``) hands out one shared no-op
  instrument, so the cold path costs an attribute load — no measurable
  per-step cost.
* **Snapshot/diff semantics.**  :meth:`MetricsRegistry.snapshot` freezes
  every series into a :class:`Snapshot`; ``snap_b.diff(snap_a)`` returns
  the counter/histogram deltas (gauges keep their newer level), so a
  benchmark can meter exactly one replay on a shared registry.
* **Self-describing exposition.**  Each instrument carries ``unit`` /
  ``better`` / ``gate`` metadata (the benchmarks/persist.py contract), so
  a snapshot serialises to JSON that
  ``tools/check_bench_regression.py`` can gate directly, and to
  Prometheus text exposition — both round-trip (``Snapshot.from_json``,
  :func:`parse_prometheus_text`).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Iterable

OBS_SCHEMA_VERSION = 1

# matches benchmarks/persist.py: gated series must declare a direction
BETTER = ("lower", "higher", "info")

# generic latency-ish buckets in virtual token units (powers of 2 cover
# the trace benchmark's 1..10^4 range); histograms accept overrides
DEFAULT_BUCKETS = tuple(float(2**i) for i in range(0, 15))


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Instrument:
    """Shared series bookkeeping for one named metric."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", *, unit: str = "",
                 better: str = "info", gate: bool = False):
        if better not in BETTER:
            raise ValueError(f"better must be one of {BETTER}, got {better!r}")
        if gate and better == "info":
            raise ValueError(f"metric {name!r}: gated metrics need a direction")
        self.name = name
        self.help = help
        self.unit = unit
        self.better = better
        self.gate = gate
        self._series: dict[tuple[tuple[str, str], ...], float] = {}

    def _meta(self) -> dict:
        return dict(unit=self.unit, better=self.better, gate=self.gate,
                    help=self.help)


class Counter(_Instrument):
    """Monotone accumulator.  ``inc(amount, **labels)``."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels: str) -> float:
        return self._series.get(_label_key(labels), 0.0)


class Gauge(_Instrument):
    """Point-in-time level.  ``set(value, **labels)`` / ``add(delta)``."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        self._series[_label_key(labels)] = float(value)

    def add(self, delta: float, **labels: str) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + float(delta)

    def value(self, **labels: str) -> float:
        return self._series.get(_label_key(labels), 0.0)


class Histogram(_Instrument):
    """Cumulative-bucket histogram with exact ``sum``/``count``.

    Buckets are upper bounds (``le``); an implicit ``+inf`` bucket always
    exists.  Series value is ``(bucket_counts, sum, count)``.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", *, unit: str = "",
                 better: str = "info", gate: bool = False,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, unit=unit, better=better, gate=gate)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name!r}: need at least one bucket")
        self.buckets = bs

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        state = self._series.get(key)
        if state is None:
            state = self._series[key] = [
                [0] * (len(self.buckets) + 1), 0.0, 0]
        counts, _, _ = state
        v = float(value)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        state[1] += v
        state[2] += 1

    def count(self, **labels: str) -> int:
        state = self._series.get(_label_key(labels))
        return 0 if state is None else state[2]

    def sum(self, **labels: str) -> float:
        state = self._series.get(_label_key(labels))
        return 0.0 if state is None else state[1]

    def mean(self, **labels: str) -> float:
        state = self._series.get(_label_key(labels))
        if state is None or state[2] == 0:
            return 0.0
        return state[1] / state[2]

    def percentile(self, q: float, **labels: str) -> float:
        """Bucket-resolution quantile estimate (``0 <= q <= 1``): the
        upper bound of the first bucket whose cumulative count reaches
        ``q · count``.  Observations past the last bound clamp to it, so
        the estimate never exceeds the configured bucket range — use
        ``sum()/count()`` when exact tails matter."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        state = self._series.get(_label_key(labels))
        if state is None or state[2] == 0:
            return 0.0
        counts, _, total = state
        rank = q * total
        cum = 0
        for i, ub in enumerate(self.buckets):
            cum += counts[i]
            if cum >= rank:
                return ub
        return self.buckets[-1]


class _NullInstrument:
    """The disabled registry's single shared instrument: every mutator is
    a no-op, every reader returns zero."""

    def inc(self, amount: float = 1.0, **labels: str) -> None: ...
    def set(self, value: float, **labels: str) -> None: ...
    def add(self, delta: float, **labels: str) -> None: ...
    def observe(self, value: float, **labels: str) -> None: ...
    def value(self, **labels: str) -> float: return 0.0
    def count(self, **labels: str) -> int: return 0
    def sum(self, **labels: str) -> float: return 0.0
    def mean(self, **labels: str) -> float: return 0.0
    def percentile(self, q: float, **labels: str) -> float: return 0.0


_NULL = _NullInstrument()


@dataclasses.dataclass(frozen=True)
class Series:
    """One flattened (metric, labels) series inside a :class:`Snapshot`."""

    name: str
    kind: str                       # counter | gauge | histogram
    labels: tuple[tuple[str, str], ...]
    value: float                    # counter/gauge value; histogram sum
    unit: str = ""
    better: str = "info"
    gate: bool = False
    # histogram extras (None for scalar kinds)
    buckets: tuple[float, ...] | None = None
    bucket_counts: tuple[int, ...] | None = None
    count: int | None = None

    @property
    def full_name(self) -> str:
        return self.name + _format_labels(self.labels)


class Snapshot:
    """A frozen view of every series in a registry at one instant."""

    def __init__(self, series: list[Series]):
        self.series = list(series)
        self._by_key = {(s.name, s.labels): s for s in self.series}

    def get(self, name: str, **labels: str) -> Series | None:
        return self._by_key.get((name, _label_key(labels)))

    def value(self, name: str, **labels: str) -> float:
        s = self.get(name, **labels)
        return 0.0 if s is None else s.value

    def as_dict(self) -> dict[str, float]:
        """Flat ``name{labels} -> value`` mapping (histogram → sum)."""
        return {s.full_name: s.value for s in self.series}

    def diff(self, older: "Snapshot") -> "Snapshot":
        """Delta snapshot: counters/histograms subtract the older series
        (absent in older → unchanged); gauges keep their newer level."""
        out: list[Series] = []
        for s in self.series:
            if s.kind == "gauge":
                out.append(s)
                continue
            o = older._by_key.get((s.name, s.labels))
            if o is None:
                out.append(s)
            elif s.kind == "counter":
                out.append(dataclasses.replace(s, value=s.value - o.value))
            else:
                bc = tuple(a - b for a, b in
                           zip(s.bucket_counts, o.bucket_counts))
                out.append(dataclasses.replace(
                    s, value=s.value - o.value, bucket_counts=bc,
                    count=s.count - o.count))
        return Snapshot(out)

    # ------------------------------------------------------------- exposition
    def to_json(self) -> dict:
        """The registry-snapshot document format — understood by
        ``tools/check_bench_regression.py`` and ``tools/obs_report.py``."""
        rows = []
        for s in self.series:
            row = {
                "name": s.name,
                "kind": s.kind,
                "labels": {k: v for k, v in s.labels},
                "value": s.value,
                "unit": s.unit,
                "better": s.better,
                "gate": s.gate,
            }
            if s.kind == "histogram":
                row["buckets"] = list(s.buckets)
                row["bucket_counts"] = list(s.bucket_counts)
                row["count"] = s.count
            rows.append(row)
        return {
            "obs_schema": OBS_SCHEMA_VERSION,
            "kind": "metrics_snapshot",
            "series": rows,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "Snapshot":
        if doc.get("obs_schema") != OBS_SCHEMA_VERSION:
            raise ValueError(
                f"obs_schema {doc.get('obs_schema')} != {OBS_SCHEMA_VERSION}"
            )
        out = []
        for row in doc["series"]:
            out.append(Series(
                name=row["name"], kind=row["kind"],
                labels=_label_key(row.get("labels", {})),
                value=float(row["value"]), unit=row.get("unit", ""),
                better=row.get("better", "info"),
                gate=bool(row.get("gate", False)),
                buckets=(tuple(row["buckets"])
                         if "buckets" in row else None),
                bucket_counts=(tuple(row["bucket_counts"])
                               if "bucket_counts" in row else None),
                count=row.get("count"),
            ))
        return cls(out)

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (round-trips through
        :func:`parse_prometheus_text` for every kind)."""
        lines: list[str] = []
        seen: set[str] = set()
        for s in self.series:
            if s.name not in seen:
                seen.add(s.name)
                lines.append(f"# TYPE {s.name} {s.kind}")
            lab = _format_labels(s.labels)
            if s.kind != "histogram":
                lines.append(f"{s.name}{lab} {s.value!r}")
                continue
            cum = 0
            for ub, c in zip(s.buckets, s.bucket_counts):
                cum += c
                key = _label_key(dict(s.labels, le=_le_str(ub)))
                lines.append(f"{s.name}_bucket{_format_labels(key)} {cum}")
            cum += s.bucket_counts[-1]
            key = _label_key(dict(s.labels, le="+Inf"))
            lines.append(f"{s.name}_bucket{_format_labels(key)} {cum}")
            lines.append(f"{s.name}_sum{lab} {s.value!r}")
            lines.append(f"{s.name}_count{lab} {s.count}")
        return "\n".join(lines) + "\n"


def _le_str(ub: float) -> str:
    return repr(ub) if not math.isinf(ub) else "+Inf"


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Parse exposition text back to a flat ``name{labels} -> value``
    mapping (stdlib-only; the exporter round-trip test's other half).
    Histogram ``_bucket``/``_sum``/``_count`` samples appear under their
    exposed names."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        sample, value = line.rsplit(" ", 1)
        if "{" in sample:
            name, rest = sample.split("{", 1)
            labels = {}
            for part in rest.rstrip("}").split(","):
                if not part:
                    continue
                k, v = part.split("=", 1)
                labels[k] = v.strip('"')
            key = name + _format_labels(_label_key(labels))
        else:
            key = sample
        out[key] = float(value)
    return out


class MetricsRegistry:
    """The serving stack's metric namespace.

    ``counter`` / ``gauge`` / ``histogram`` create-or-return instruments
    by name (re-registration with the same kind returns the existing one,
    so instrumented sites can look up lazily).  ``enabled=False`` hands
    out the shared no-op instrument and snapshots empty.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._instruments: dict[str, _Instrument] = {}

    def _get(self, cls, name, help, **kw):
        if not self.enabled:
            return _NULL
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}"
                )
            return inst
        inst = self._instruments[name] = cls(name, help, **kw)
        return inst

    def counter(self, name: str, help: str = "", *, unit: str = "",
                better: str = "info", gate: bool = False) -> Counter:
        return self._get(Counter, name, help, unit=unit, better=better,
                         gate=gate)

    def gauge(self, name: str, help: str = "", *, unit: str = "",
              better: str = "info", gate: bool = False) -> Gauge:
        return self._get(Gauge, name, help, unit=unit, better=better,
                         gate=gate)

    def histogram(self, name: str, help: str = "", *, unit: str = "",
                  better: str = "info", gate: bool = False,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, unit=unit, better=better,
                         gate=gate, buckets=buckets)

    def set_gauges(self, values: dict[str, float], *, prefix: str = "",
                   unit: str = "", **labels: str) -> None:
        """Bulk gauge update — the allocator/pool sampling helper."""
        for k, v in values.items():
            self.gauge(prefix + k, unit=unit).set(float(v), **labels)

    def snapshot(self) -> Snapshot:
        series: list[Series] = []
        for inst in self._instruments.values():
            for key, val in sorted(inst._series.items()):
                if inst.kind == "histogram":
                    counts, total, n = val
                    series.append(Series(
                        name=inst.name, kind=inst.kind, labels=key,
                        value=total, unit=inst.unit, better=inst.better,
                        gate=inst.gate, buckets=inst.buckets,
                        bucket_counts=tuple(counts), count=n,
                    ))
                else:
                    series.append(Series(
                        name=inst.name, kind=inst.kind, labels=key,
                        value=val, unit=inst.unit, better=inst.better,
                        gate=inst.gate,
                    ))
        return Snapshot(series)

    def write_snapshot_json(self, path: str) -> dict:
        doc = self.snapshot().to_json()
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        return doc
