"""Host-side span tracing for the DFL engine (port of ``repro.obs.trace``).

``Tracer`` is a monotonic-clock (``time.perf_counter_ns``) span recorder
for the HOST loop: an epoch step is timed as one opaque span, bounded by an
explicit device synchronize that the caller places after the step (the
engine syncs only when a tracer is attached, so tracing never changes how
an untraced run dispatches, and never changes the numerics of any run).
Spans nest through the ``span()`` context manager; phases measured
indirectly (the engine's consensus-replay attribution of local against
gossip time inside one epoch step) are inserted with explicit timestamps
through ``add_span``.

Besides spans the tracer records INSTANT events, most importantly
``compile`` events, which the engine emits whenever it builds the step of a
new federation size, tagged with the cause (``first_trace``,
``federation_size_change``; ``retrace`` stays in the vocabulary, though the
port's per-M step cache cannot produce it).

``to_chrome()`` exports everything in the Chrome trace-event JSON format
(``{"traceEvents": [...]}``, complete ``"ph": "X"`` events with microsecond
``ts``/``dur``), loadable in Perfetto or chrome://tracing;
``save_chrome(path)`` writes it to disk.  The format and the span taxonomy
are the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "validate_chrome_trace"]


@dataclasses.dataclass
class Span:
    """One closed wall-clock interval.  ``depth``/``parent`` encode the
    nesting at record time; Chrome viewers re-derive nesting from time
    containment on the single host track."""

    name: str
    t0_ns: int
    t1_ns: Optional[int] = None
    depth: int = 0
    parent: Optional["Span"] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_ns(self) -> int:
        if self.t1_ns is None:
            raise ValueError(f"span {self.name!r} is still open")
        return self.t1_ns - self.t0_ns

    def encloses(self, other: "Span") -> bool:
        """Whether ``other`` lies fully inside this span's interval."""
        return (self.t0_ns <= other.t0_ns
                and other.t1_ns is not None and self.t1_ns is not None
                and other.t1_ns <= self.t1_ns)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


class Tracer:
    """Span + instant-event recorder over one monotonic clock.

    The engine holds NO tracer by default, so the untraced path never
    reaches this module.  ``clock`` is injectable for deterministic tests
    (it must return integer nanoseconds and be monotonic)."""

    def __init__(self, clock: Callable[[], int] = time.perf_counter_ns):
        self._clock = clock
        self.spans: List[Span] = []       # appended at span EXIT
        self.instants: List[Dict[str, Any]] = []
        self._stack: List[Span] = []

    def now(self) -> int:
        """The tracer's clock, for callers timing external work (e.g. the
        engine's consensus-replay probe) that lands via ``add_span``."""
        return self._clock()

    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        sp = Span(name=name, t0_ns=self._clock(), depth=len(self._stack),
                  parent=self._stack[-1] if self._stack else None, args=args)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.t1_ns = self._clock()
            self.spans.append(sp)

    def add_span(self, name: str, t0_ns: int, t1_ns: int,
                 parent: Optional[Span] = None, **args: Any) -> Span:
        """Record a span with EXPLICIT timestamps, for phases whose wall
        time was measured out of band (the engine's local/gossip split of
        one epoch step) and that must sit inside an already-closed parent's
        interval."""
        if t1_ns < t0_ns:
            raise ValueError(f"span {name!r} ends before it starts")
        depth = parent.depth + 1 if parent is not None else len(self._stack)
        sp = Span(name=name, t0_ns=t0_ns, t1_ns=t1_ns, depth=depth,
                  parent=parent, args=args)
        self.spans.append(sp)
        return sp

    def instant(self, name: str, **args: Any) -> None:
        self.instants.append({"name": name, "ts_ns": self._clock(),
                              "args": args})

    def compile_event(self, cause: str, **args: Any) -> None:
        """The caller built a new step: ``cause`` is ``first_trace`` (the
        first step of the run), ``federation_size_change`` (fault surgery
        needs the step of a new M) or ``retrace`` (a step rebuilt for a
        size already seen, which breaks the build-once contract of
        ``engine.DynamicFederationEngine.compile_counts``)."""
        self.instant("compile", cause=cause, **args)

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: complete ``X`` events (ts/dur in
        microseconds) on one pid/tid track plus instant ``i`` events; load
        the saved file into Perfetto (ui.perfetto.dev)."""
        events: List[Dict[str, Any]] = []
        for sp in sorted(self.spans, key=lambda s: (s.t0_ns, s.depth)):
            if sp.t1_ns is None:
                continue
            events.append({
                "name": sp.name, "ph": "X", "cat": "repro", "pid": 1,
                "tid": 1, "ts": sp.t0_ns / 1e3,
                "dur": (sp.t1_ns - sp.t0_ns) / 1e3,
                "args": {k: _jsonable(v) for k, v in sp.args.items()},
            })
        for ev in self.instants:
            events.append({
                "name": ev["name"], "ph": "i", "s": "t", "cat": "repro",
                "pid": 1, "tid": 1, "ts": ev["ts_ns"] / 1e3,
                "args": {k: _jsonable(v) for k, v in ev["args"].items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome(), f)


def validate_chrome_trace(doc: Any) -> List[Dict[str, Any]]:
    """Validate a Chrome trace-event document (the JSON-object form this
    module emits) and return its event list.  Raises ``ValueError`` on any
    event a trace viewer would reject."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("not a Chrome trace: expected "
                         "{'traceEvents': [...]}")
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict):
            raise ValueError(f"trace event is not an object: {ev!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"trace event without a name: {ev!r}")
        if ev.get("ph") not in ("X", "i", "B", "E", "M"):
            raise ValueError(f"unsupported phase {ev.get('ph')!r}")
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"trace event without numeric ts: {ev!r}")
        if ev["ph"] == "X" and not (isinstance(ev.get("dur"), (int, float))
                                    and ev["dur"] >= 0):
            raise ValueError(f"complete event needs dur >= 0: {ev!r}")
    return doc["traceEvents"]
