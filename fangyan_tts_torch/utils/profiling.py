"""The port's tracer: spans and counters inside the program, and `trace()`,
a Chrome trace for Perfetto.

- `span(name, **attrs)`: a context manager around host work. While
  recording it keeps one record: the name, `t0_ns` and `t1_ns` from
  `time.perf_counter_ns()`, the index of the enclosing span on this thread
  (`parent`, None for an outermost span), the thread id, a request id (a
  new one for each outermost span, inherited by its children) and the
  attrs; and, under a profiler, it opens a `record_function` range of the
  same name, so that the profiler's trace shows the same names. Not
  recording, it returns one shared no-op object: it records, allocates and
  synchronizes nothing.
- `count(name, n=1)`: adds `n` to a counter while recording.
- `active()`: whether the tracer records now (for a caller that would
  read the device only to count).
- `spans()`, `counters()`, `dropped()`, `reset()`: the records (a span's
  `parent` indexes this list), the counters, the spans left out past the
  cap, and a fresh start. Records are kept in memory, at most `CAP` of
  them, and written out only when read.
- Recording is on while a torch profiler is active in the process (on
  any thread), or inside `recording()`. There is no other switch.
- `trace(dir)`: profiles a block and writes `<dir>/trace.json` (the Chrome
  trace) and `<dir>/program.json` (the block's spans and counters).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path

import torch

CAP = 1_000_000
# a profiler is on: torch.profiler's flag for the whole process (where this
# torch has one), else the autograd profiler's state on the calling thread
_autograd_profiler = torch.autograd.profiler
_PROCESS_FLAG = hasattr(_autograd_profiler, "_is_profiler_enabled")
_profiler_enabled = torch.autograd._profiler_enabled


def _profiler_on() -> bool:
    return (_PROCESS_FLAG and _autograd_profiler._is_profiler_enabled) or _profiler_enabled()


# a profiler range, as torch.profiler.record_function opens one, at a tenth of its host cost
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    """One recorded span. Its clock starts when it is made and stops when it
    is left, so the span's own cost falls inside it, not in its parent."""

    __slots__ = ("tracer", "rec", "rf")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.rec = {"name": name, "t0_ns": time.perf_counter_ns(), "t1_ns": None, "parent": None,
                    "thread": threading.get_ident(), "request": None, "attrs": attrs}
        self.rf = None

    def __enter__(self):
        tr, rec = self.tracer, self.rec
        stack = tr._stack()
        if stack:
            rec["parent"], rec["request"] = stack[-1]
        else:
            rec["request"] = next(tr._requests)
        with tr._lock:
            if len(tr._records) < tr.cap:
                idx = len(tr._records)
                tr._records.append(rec)
            else:
                idx = None
                tr._dropped += 1
        stack.append((idx, rec["request"]))
        if _profiler_on():
            self.rf = _record_function(rec["name"])
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.tracer._stack().pop()
        self.rec["t1_ns"] = time.perf_counter_ns()
        return False


class Tracer:
    """Spans and counters of one process; the module's functions use one
    shared instance."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._local = threading.local()
        self._forced = 0
        self._requests = itertools.count()
        self._records: list[dict] = []
        self._counters: dict[str, int] = {}
        self._dropped = 0

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def span(self, name: str, **attrs):
        if not (self._forced or _profiler_on()):
            return NO_SPAN
        return _Span(self, name, attrs)

    def active(self) -> bool:
        return bool(self._forced or _profiler_on())

    def count(self, name: str, n: int = 1) -> None:
        if not (self._forced or _profiler_on()):
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def dropped(self) -> int:
        return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._records, self._counters, self._dropped = [], {}, 0

    @contextlib.contextmanager
    def recording(self):
        """Record inside the block, with no profiler."""
        with self._lock:
            self._forced += 1
        try:
            yield self
        finally:
            with self._lock:
                self._forced -= 1


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
active = TRACER.active
spans = TRACER.spans
counters = TRACER.counters
dropped = TRACER.dropped
reset = TRACER.reset
recording = TRACER.recording


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile the block (the CPU and, where present, the card) and the
    tracer afresh; on exit write `<log_dir>/trace.json` and
    `<log_dir>/program.json`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    reset()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    program = {"spans": spans(), "counters": counters(), "dropped": dropped()}
    (out / "program.json").write_text(json.dumps(program, default=str))
