"""MetricsHub: typed metric emission behind pluggable sinks (port of
``repro.obs.metrics``).

One hub carries the engine's and the trainers' per-epoch records, the
``SigmaTracker`` products and the ``BytesTracker`` per-link wire ledger as
a stream of typed ``MetricEvent``s fanned out to every attached sink:

- ``MemorySink``     — accumulates the ``history`` dict (a list per scalar
                       metric, in epoch order).
- ``JSONLSink``      — newline-delimited JSON with a versioned schema
                       (``SCHEMA_VERSION``); the first line is a ``meta``
                       record, every later line one event.
- ``ConsoleSink``    — the one place the port prints progress (the
                       trainers' epoch lines).

Event kinds: ``counter`` (monotonic totals, e.g. wire bytes), ``gauge``
(point-in-time scalars, e.g. the sigma product, the disagreement),
``histogram`` (small per-epoch vectors with per-server / per-link labels,
e.g. screen-rejection counts), ``epoch`` (the engine's whole record in one
event), ``warning`` (watchdog emissions).  The event kinds, names, labels
and the meta line are the reference's, so each package's validator
accepts the other's files.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, IO, Iterable, List, Optional, Sequence, Union

SCHEMA_VERSION = 1

_KINDS = ("epoch", "counter", "gauge", "histogram", "warning")

__all__ = [
    "SCHEMA_VERSION", "MetricEvent", "Sink", "MemorySink", "JSONLSink",
    "ConsoleSink", "MetricsHub", "load_jsonl", "validate_jsonl",
]


@dataclasses.dataclass
class MetricEvent:
    """One typed telemetry record.  ``value`` is a float for
    counter/gauge, a list of floats for histogram, a flat str->scalar
    dict for epoch, and a message dict for warning.  ``labels`` carry
    the per-server (``server=i``) / per-link (``src=j,dst=i``) axes."""

    kind: str
    name: str
    value: Union[float, List[float], Dict[str, Any]]
    epoch: Optional[int] = None
    labels: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "name": self.name,
                               "value": self.value}
        if self.epoch is not None:
            out["epoch"] = self.epoch
        if self.labels:
            out["labels"] = self.labels
        return out


class Sink:
    """Sink interface: ``emit`` receives every event; ``close`` flushes."""

    def emit(self, ev: MetricEvent) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Accumulates the ``history`` dict: one list per scalar key of each
    ``epoch`` event, in arrival order (the shape
    ``DynamicFederationEngine.run`` and ``launch.train`` return)."""

    def __init__(self):
        self._history: Dict[str, List[float]] = {}
        self._totals: Dict[str, float] = {}
        self._warnings: List[MetricEvent] = []

    def emit(self, ev: MetricEvent) -> None:
        if ev.kind == "epoch":
            for k, v in ev.value.items():
                self._history.setdefault(k, []).append(v)
        elif ev.kind == "counter":
            self._totals[ev.name] = self._totals.get(ev.name, 0.0) + ev.value
        elif ev.kind == "warning":
            self._warnings.append(ev)

    def history(self) -> Dict[str, List[float]]:
        return self._history

    def totals(self) -> Dict[str, float]:
        return self._totals

    def warnings(self) -> List[MetricEvent]:
        return self._warnings


class JSONLSink(Sink):
    """Newline-delimited JSON stream.  Line 1 is the meta record
    ``{"kind": "meta", "schema": SCHEMA_VERSION, ...}``; every later line
    is one ``MetricEvent``.  ``validate_jsonl`` round-trips it."""

    def __init__(self, path_or_file: Union[str, IO[str]],
                 run_info: Optional[Dict[str, Any]] = None):
        if isinstance(path_or_file, str):
            self._f: IO[str] = open(path_or_file, "w", encoding="utf-8")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
        meta = {"kind": "meta", "schema": SCHEMA_VERSION,
                "unix_time": time.time()}
        if run_info:
            meta["run"] = run_info
        self._f.write(json.dumps(meta) + "\n")

    def emit(self, ev: MetricEvent) -> None:
        self._f.write(json.dumps(ev.to_json()) + "\n")

    def close(self) -> None:
        self._f.flush()
        if self._owns:
            self._f.close()


class ConsoleSink(Sink):
    """Human progress lines, the port's one print site: every
    ``log_every``-th epoch event (and epoch 0's) plus every warning.  An
    epoch line shows the keys of ``_ORDER`` that the record carries (the
    reference's six and the port's trainer columns) and the seconds since
    the sink was made."""

    _ORDER = ("loss", "disagreement", "drift", "sigma_prod", "num_servers",
              "participation", "psum_min_weight", "wire_mb", "wire_ratio",
              "byzantine", "screen_rejected", "epoch_s")
    _FMT = {"loss": ".4f", "disagreement": ".3e", "drift": ".3e",
            "sigma_prod": ".3f", "num_servers": ".0f",
            "participation": ".2f", "psum_min_weight": ".3f",
            "wire_mb": ".1f", "wire_ratio": ".2f", "byzantine": ".3f",
            "screen_rejected": ".4g", "epoch_s": ".2f"}

    def __init__(self, log_every: int = 1, prefix: str = "epoch"):
        self.log_every = max(1, int(log_every))
        self.prefix = prefix
        self._t0 = time.perf_counter()

    def emit(self, ev: MetricEvent) -> None:
        if ev.kind == "warning":
            print(f"[obs:warn] {ev.name}: "
                  f"{ev.value.get('message', ev.value)}")
            return
        if ev.kind != "epoch" or ev.epoch is None:
            return
        if ev.epoch % self.log_every and ev.epoch != 0:
            return
        parts = [f"{self.prefix} {ev.epoch:4d}"]
        for k in self._ORDER:
            if k in ev.value:
                parts.append(f"{k}={ev.value[k]:{self._FMT[k]}}")
        parts.append(f"({time.perf_counter() - self._t0:.1f}s)")
        print("  ".join(parts))


class MetricsHub:
    """Fan-out of typed metric events to every attached sink."""

    def __init__(self, sinks: Sequence[Sink] = ()):
        self.sinks: List[Sink] = list(sinks)

    def add_sink(self, sink: Sink) -> Sink:
        self.sinks.append(sink)
        return sink

    def _emit(self, ev: MetricEvent) -> None:
        for s in self.sinks:
            s.emit(ev)

    def counter(self, name: str, value: float, *, epoch: Optional[int] = None,
                **labels: Any) -> None:
        self._emit(MetricEvent("counter", name, float(value), epoch, labels))

    def gauge(self, name: str, value: float, *, epoch: Optional[int] = None,
              **labels: Any) -> None:
        self._emit(MetricEvent("gauge", name, float(value), epoch, labels))

    def histogram(self, name: str, values: Iterable[float], *,
                  epoch: Optional[int] = None, **labels: Any) -> None:
        self._emit(MetricEvent("histogram", name,
                               [float(v) for v in values], epoch, labels))

    def warning(self, name: str, message: str, *,
                epoch: Optional[int] = None, **fields: Any) -> None:
        payload = {"message": message, **fields}
        self._emit(MetricEvent("warning", name, payload, epoch))

    def observe_epoch(self, epoch: int, record: Dict[str, float],
                      **labels: Any) -> None:
        """The engine's whole per-epoch record in one event (MemorySink
        turns it back into the ``history`` dict)."""
        self._emit(MetricEvent("epoch", "epoch",
                               {k: float(v) for k, v in record.items()},
                               epoch, labels))

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    with open(path, "r", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def validate_jsonl(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Validate a decoded JSONL telemetry stream against the versioned
    schema; returns the event records (meta stripped).  Raises
    ``ValueError`` with the offending record on any violation."""
    if not records:
        raise ValueError("empty telemetry stream: missing meta record")
    meta = records[0]
    if meta.get("kind") != "meta":
        raise ValueError(f"first record must be meta, got {meta!r}")
    if meta.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"schema version {meta.get('schema')!r} != "
                         f"{SCHEMA_VERSION}")
    events = records[1:]
    for rec in events:
        kind = rec.get("kind")
        if kind not in _KINDS:
            raise ValueError(f"unknown event kind {kind!r}: {rec!r}")
        if not isinstance(rec.get("name"), str):
            raise ValueError(f"event without name: {rec!r}")
        val = rec.get("value")
        if kind in ("counter", "gauge"):
            ok = isinstance(val, (int, float)) and not isinstance(val, bool)
        elif kind == "histogram":
            ok = (isinstance(val, list)
                  and all(isinstance(v, (int, float)) for v in val))
        else:  # epoch / warning
            ok = isinstance(val, dict)
        if not ok:
            raise ValueError(f"bad value for {kind} event: {rec!r}")
        if "epoch" in rec and not isinstance(rec["epoch"], int):
            raise ValueError(f"non-integer epoch: {rec!r}")
        if "labels" in rec and not isinstance(rec["labels"], dict):
            raise ValueError(f"non-object labels: {rec!r}")
    return events
