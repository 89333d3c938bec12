"""repro_torch.obs — structured telemetry for the DFL engine (port of
``repro.obs``; plain Python, no torch).

Three layers, combined in one ``Observability`` bundle handed to
``core.engine.DynamicFederationEngine`` and the trainers:

- ``trace.Tracer``               — host-side span tracing -> Chrome trace
                                   JSON (Perfetto-loadable).
- ``metrics.MetricsHub``         — typed counter/gauge/histogram events
                                   fanned out to Memory/JSONL/Console sinks.
- ``monitor.ConvergenceMonitor`` — Theorem-1 / fig-3 derived gauges and
                                   watchdog warnings.

The bundle is BITWISE INERT on training numerics: it only reads floats the
engine already computed, and the consensus-replay probe that splits an
epoch's time runs on its own copy of the server tree with its own key and
residual (``tests/test_torch_obs.py`` holds histories with the full bundle
to ``OBS_OFF``'s, bit for bit).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence

from .metrics import (SCHEMA_VERSION, ConsoleSink, JSONLSink, MemorySink,
                      MetricEvent, MetricsHub, Sink, load_jsonl,
                      validate_jsonl)
from .monitor import FIG3_TOLERANCE, ConvergenceMonitor, WatchdogEvent
from .trace import Span, Tracer, validate_chrome_trace

__all__ = [
    "SCHEMA_VERSION", "FIG3_TOLERANCE", "MetricEvent", "MetricsHub",
    "Sink", "MemorySink", "JSONLSink", "ConsoleSink", "ConvergenceMonitor",
    "WatchdogEvent", "Span", "Tracer", "Observability", "OBS_OFF",
    "load_jsonl", "validate_jsonl", "validate_chrome_trace",
]


class _NullSpan:
    """Context manager that does nothing — what ``OBS_OFF.span`` returns,
    so instrumented code has ONE code path whether obs is on or off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Observability:
    """One handle bundling hub + tracer + monitor.

    Everything is optional: ``Observability()`` gives a bare hub with no
    sinks; pass ``tracer=Tracer()`` to record spans, ``monitor=True`` to
    attach a ``ConvergenceMonitor`` over the hub.  The engine and trainers
    call only ``span`` / ``compile_event`` / ``observe`` / ``close``."""

    enabled = True

    def __init__(self, hub: Optional[MetricsHub] = None,
                 tracer: Optional[Tracer] = None,
                 monitor: Any = None):
        self.hub = hub if hub is not None else MetricsHub()
        self.tracer = tracer
        if monitor is True:
            monitor = ConvergenceMonitor(self.hub)
        self.monitor: Optional[ConvergenceMonitor] = monitor

    def span(self, name: str, **args: Any):
        if self.tracer is None:
            return _NULL_SPAN
        return self.tracer.span(name, **args)

    def compile_event(self, cause: str, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.compile_event(cause, **args)

    def observe(self, epoch: int, record: Dict[str, float], *,
                servers: Optional[Sequence[int]] = None,
                per_link: Any = None,
                screen_rejected: Optional[Iterable[float]] = None) -> None:
        """Fan one epoch's telemetry out: the whole record as an ``epoch``
        event, the ``BytesTracker`` per-link byte matrix as labelled
        counters (``dst``/``src`` are ORIGINAL server ids through
        ``servers``), the robust screens' per-server rejection counts as a
        labelled histogram, then the convergence monitor's checks."""
        self.hub.observe_epoch(epoch, record)
        if per_link is not None:
            ids = list(servers) if servers is not None else None
            m = len(per_link)
            for i in range(m):
                for j in range(m):
                    b = float(per_link[i][j])
                    if b > 0:
                        self.hub.counter(
                            "wire_bytes", b, epoch=epoch,
                            dst=ids[i] if ids else i,
                            src=ids[j] if ids else j)
        if screen_rejected is not None:
            vals = [float(v) for v in screen_rejected]
            self.hub.histogram(
                "screen_rejected", vals, epoch=epoch,
                servers=list(servers) if servers is not None
                else list(range(len(vals))))
        if self.monitor is not None:
            self.monitor.observe(epoch, record)

    def close(self) -> None:
        self.hub.close()


class _ObsOff:
    """The null bundle: every hook is a no-op.  The engine's default, so an
    uninstrumented run pays one attribute read and one call per hook."""

    enabled = False
    hub = None
    tracer = None
    monitor = None

    __slots__ = ()

    def span(self, name: str, **args: Any):
        return _NULL_SPAN

    def compile_event(self, cause: str, **args: Any) -> None:
        pass

    def observe(self, epoch: int, record: Dict[str, float],
                **kw: Any) -> None:
        pass

    def close(self) -> None:
        pass


OBS_OFF = _ObsOff()
