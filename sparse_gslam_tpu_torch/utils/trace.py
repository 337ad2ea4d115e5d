"""The port's recorder of spans and counters.

One `Recorder` belongs to one SlamSystem: its Frontend and its
SubmapLoopCloser hold the same one, and the solvers take it as an
argument. It keeps

- counters (`count`, and `tally` for a set of keys seen with their
  counts), always on: integer adds, kept per thread and summed when
  read, so that two threads never update one number;
- spans (`span`), recorded only while `enabled` is set: name, start and
  end on time.perf_counter_ns, the parent span (the innermost one open
  in the same thread), the thread, and the frame index that was current
  when the span opened (`frame`, set by SlamSystem.process_frame: the
  request id). While `enabled` is set and a torch profiler is
  recording, each span also opens a torch.profiler.record_function
  range of its name, so that it lies in the profiler's trace on the
  device trace's clock. With `enabled` off, `span` costs one branch and
  enters no record_function;
- timed spans (`timed`), which always time their block and hand back
  its seconds (SlamSystem.frontend_times and backend_times,
  SubmapLoopCloser.prof), and are recorded as spans while `enabled` is
  set.

Spans stay in memory (`spans`, in the order they opened). The recorder
never synchronises the device: a span that ends in a host read times
the device work it waited for, any other times only the enqueue.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

_OFF = contextlib.nullcontext()


def _profiling() -> bool:
    """Whether a torch profiler is recording in this process."""
    return torch._C._autograd._profiler_enabled()


class Span:
    """One span: a context manager while open, a record once closed
    (`end_ns` 0 while it is open). `parent` is the enclosing Span of the
    same thread or None; `thread` is None where the span was not
    recorded (a timed span with `enabled` off)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "frame",
                 "_rec", "_range")

    def __init__(self, rec: "Recorder", name: str):
        self.name = name
        self.start_ns = self.end_ns = 0
        self.parent = self.thread = self._range = None
        self.frame = -1
        self._rec = rec

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        rec = self._rec
        if rec.enabled:
            state = rec._state()
            stack = state.stack
            self.parent = stack[-1] if stack else None
            self.thread = state.ident
            self.frame = rec.frame
            stack.append(self)
            rec.spans.append(self)
            if _profiling():
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.thread is not None:
            if self._range is not None:
                self._range.__exit__(*exc)
                self._range = None
            self._rec._state().stack.pop()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, frame={self.frame}, "
                f"{self.seconds * 1e3:.3f} ms)")


class _ThreadState:
    __slots__ = ("ident", "stack", "counts", "tallies")

    def __init__(self, ident: int):
        self.ident = ident
        self.stack: list[Span] = []
        self.counts = collections.Counter()
        self.tallies = collections.defaultdict(collections.Counter)


class Recorder:
    """Spans and counters of one SlamSystem (module docstring)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.frame = -1
        self.spans: list[Span] = []
        self._threads: dict[int, _ThreadState] = {}

    def _state(self) -> _ThreadState:
        ident = threading.get_ident()
        state = self._threads.get(ident)
        if state is None:
            state = self._threads.setdefault(ident, _ThreadState(ident))
        return state

    # -- recording --------------------------------------------------------
    def span(self, name: str):
        """A span of the block, recorded while `enabled` is set."""
        return Span(self, name) if self.enabled else _OFF

    def timed(self, name: str) -> Span:
        """A span that times its block whatever `enabled` says; read
        its `seconds` after the block."""
        return Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self._state().counts[name] += n

    def tally(self, name: str, key) -> None:
        """One more occurrence of `key` under `name` (a set of keys with
        their counts, e.g. the padded shapes a solver met)."""
        self._state().tallies[name][key] += 1

    # -- reading ----------------------------------------------------------
    @property
    def counts(self) -> collections.Counter:
        out = collections.Counter()
        for state in list(self._threads.values()):
            out.update(state.counts)
        return out

    def tallies(self, name: str) -> collections.Counter:
        out = collections.Counter()
        for state in list(self._threads.values()):
            out.update(state.tallies.get(name, {}))
        return out

    def closed(self, name: str | None = None) -> list[Span]:
        """The recorded spans that have closed, of `name` or of all."""
        return [s for s in self.spans
                if s.end_ns and (name is None or s.name == name)]

    def durations(self, name: str) -> list[float]:
        """Seconds of each closed recorded span named `name`."""
        return [s.seconds for s in self.closed(name)]
