"""The serving engine's tracer: spans and counters of ``NanoCPEngine``.

One tracer per engine (``eng.tracer``).  Off (the default) it keeps only
the current step's phase durations, which ``eng.timings`` shows under the
keys it has always had (``step_us``, ``prefill_us``, ``lower_us``, ...),
and takes one clock reading per phase boundary.  ``start()`` switches it
on: every span and counter is then also appended to an in-memory buffer
(``spans``, ``counters``) until ``stop()``.

A step is one root span, ``engine.step``, whose children tile it phase
after phase (each phase ends where the next begins, so one clock reading
closes one phase and opens the next):

    engine.handoff, scheduler.schedule, engine.reshard, engine.prefill,
    routing.lower, aot.lookup, engine.harvest, routing.tables,
    dcp.dispatch, engine.bookkeeping

A phase with nothing to do (no prefill cells, no re-shard, no admission,
nothing in flight to harvest) is left out.  Spans opened with ``span()``
nest inside whatever is open (a spill's ``engine.reshard`` inside
``routing.lower``, an online ``aot.capture``); outside a step they are
roots of their own (``engine.drain``, ``engine.compact``).  Request spans
(``request.queued``, ``request.prefill``, ``request.decode``) carry the
request's id (``attrs["rid"]``) and point at the span that caused them.

Stamps are ``time.perf_counter_ns``.  ``start()`` and ``stop()`` each read
it together with ``time.time_ns``, the clock ``torch.profiler`` (kineto)
stamps its host and device events with; ``to_profiler_ns`` maps a stamp
onto the profiler's timeline through those two anchors, so drift between
the clocks over the recording is corrected (``drift_ns`` reports it).
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

_clock = time.perf_counter_ns

# the phases that ``eng.timings`` shows, under the keys it has always had
TIMING_KEYS = {
    "engine.handoff": "handoff_us", "engine.reshard": "reshard_us",
    "engine.prefill": "prefill_us", "routing.lower": "lower_us",
    "aot.lookup": "lookup_us", "engine.harvest": "harvest_us",
    "routing.tables": "tables_us", "dcp.dispatch": "dispatch_us",
}


class Span(NamedTuple):
    id: int
    parent: int          # the span that caused or contains it; 0 for none
    name: str
    start: int           # time.perf_counter_ns
    end: int
    attrs: dict | None


class Count(NamedTuple):
    name: str
    t: int               # time.perf_counter_ns
    step: int            # the engine.step span's ``attrs["step"]``
    values: dict


class Tracer:
    """Spans and counters of one engine; see the module's docstring."""

    def __init__(self):
        self.on = False
        self.timings: dict = {}          # the current step's phases, in us
        self.spans: list = []
        self.counters: list = []
        self.anchors: list = []          # (perf_counter_ns, time_ns) pairs
        self.steps = 0                   # steps begun since construction
        self.recordings = 0              # ``start()`` calls
        self._ids = 0
        self._root = 0                   # the open step's id, 0 when none
        self.root_start = 0
        self._mark = 0                   # where the next phase starts
        self._phase = 0                  # the id the next phase takes
        self.last = 0                    # the id of the phase closed last
        self._decoded = False
        self._stack: list = []           # open ``span()`` ids

    # ------------------------------------------------------------------ #
    def start(self) -> None:
        """Switch recording on, with an empty buffer."""
        self.spans, self.counters = [], []
        self.anchors = [self._anchor()]
        self.recordings += 1
        self.on = True

    def stop(self) -> None:
        """Switch recording off; the buffer stays for reading."""
        if self.on:
            self.anchors.append(self._anchor())
        self.on = False

    @staticmethod
    def _anchor() -> tuple:
        a = _clock()
        u = time.time_ns()
        b = _clock()
        return ((a + b) // 2, u)

    def to_profiler_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` stamp on the ``torch.profiler`` timeline,
        interpolated between the recording's first and last anchor."""
        (p0, u0), (p1, u1) = self.anchors[0], self.anchors[-1]
        if p1 == p0:
            return t + u0 - p0
        return u0 + round((t - p0) * (u1 - u0) / (p1 - p0))

    @property
    def drift_ns(self) -> int:
        """How far the profiler's clock ran ahead of ``perf_counter`` from
        the first anchor to the last."""
        (p0, u0), (p1, u1) = self.anchors[0], self.anchors[-1]
        return (u1 - u0) - (p1 - p0)

    def _new_id(self) -> int:
        self._ids += 1
        return self._ids

    # ------------------------------------------------------------------ #
    def begin_step(self) -> None:
        """Open a step's root span; its first phase starts now."""
        self.timings = {}
        self._root = self._new_id()
        self._phase = self._new_id()
        self.root_start = self._mark = _clock()
        self._decoded = False
        self.steps += 1

    def lap(self, name: str, attrs: dict | None = None) -> int:
        """Close the open step's current phase as ``name`` (from the last
        boundary to now) and start the next; returns the boundary."""
        if not self._root:
            return 0
        t = _clock()
        key = TIMING_KEYS.get(name)
        if key is not None:
            self.timings[key] = (self.timings.get(key, 0.0)
                                 + (t - self._mark) / 1e3)
        if name == "dcp.dispatch":
            self._decoded = True
        if self.on:
            self.spans.append(Span(self._phase, self._root, name, self._mark,
                                   t, attrs))
        self.last = self._phase
        self._phase = self._new_id()
        self._mark = t
        return t

    def note(self, **attrs) -> None:
        """Add attributes to the span recorded last (tracing on only)."""
        s = self.spans[-1]
        if s.attrs is None:
            self.spans[-1] = s._replace(attrs=attrs)
        else:
            s.attrs.update(attrs)

    def end_step(self) -> int:
        """Close the open step's root span; returns its end."""
        t = _clock()
        self.timings["step_us"] = (t - self.root_start) / 1e3
        if self.on:
            self.spans.append(Span(self._root, 0, "engine.step",
                                   self.root_start, t,
                                   {"step": self.steps,
                                    "decoded": self._decoded}))
        self._root = 0
        return t

    def span(self, name: str, **attrs):
        """A span around a block, nested in whatever is open (the current
        phase of an open step, or an enclosing ``span``).  Yields its
        ``attrs`` for the block to fill.  Off, it reads no clock."""
        if not self.on:
            return contextlib.nullcontext(attrs)
        return self._span(name, attrs)

    @contextlib.contextmanager
    def _span(self, name: str, attrs: dict):
        parent = (self._stack[-1] if self._stack
                  else self._phase if self._root else 0)
        sid = self._new_id()
        self._stack.append(sid)
        t0 = _clock()
        try:
            yield attrs
        finally:
            self._stack.pop()
            self.spans.append(Span(sid, parent, name, t0, _clock(), attrs))

    def record(self, name: str, start: int, end: int, parent: int,
               attrs: dict) -> int:
        """Append a span whose bounds are already known (tracing on)."""
        sid = self._new_id()
        self.spans.append(Span(sid, parent, name, start, end, attrs))
        return sid

    def count(self, name: str, t: int, step: int | None = None,
              **values) -> None:
        """Append a counter reading at ``t`` (tracing on), of the current
        step unless ``step`` names an earlier one."""
        self.counters.append(Count(name, t, self.steps if step is None
                                   else step, values))

    # ------------------------------------------------------------------ #
    def request(self, rid: int) -> list:
        """Every recorded span of request ``rid``, in time order."""
        return sorted((s for s in self.spans
                       if s.attrs and s.attrs.get("rid") == rid),
                      key=lambda s: (s.start, s.end))

    def children(self, sid: int) -> list:
        """The recorded spans whose parent is ``sid``, in time order."""
        return sorted((s for s in self.spans if s.parent == sid),
                      key=lambda s: (s.start, s.end))
