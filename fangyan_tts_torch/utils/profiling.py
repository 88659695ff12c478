"""Tracing and profiling helpers (the port's copy of
fangyan_tts_tpu/utils/profiling.py).

- `trace(dir)`: a torch.profiler trace of the CPU and, where present, the
  card, written as a Chrome trace under `dir` (view in Perfetto);
- `annotate(name)`: a `record_function` span inside such a trace;
- `StageTimer`: per-stage wall time and RTF accounting with a JSONL sink,
  used by the serving layer and benchmarks.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile the block; on exit write `<log_dir>/trace.json`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulates wall time per named stage + audio-seconds for RTF."""

    def __init__(self, sink: str | Path | None = None):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.audio_seconds = 0.0
        self._sink = open(sink, "a", encoding="utf-8") if sink else None

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if self._sink:
                self._sink.write(json.dumps({"stage": name, "seconds": dt, "time": time.time()}) + "\n")
                self._sink.flush()

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    @property
    def rtf(self) -> float:
        total = sum(self.totals.values())
        return total / max(self.audio_seconds, 1e-9)

    def summary(self) -> dict:
        return {
            "stages": {k: {"seconds": v, "count": self.counts[k]} for k, v in self.totals.items()},
            "audio_seconds": self.audio_seconds,
            "rtf": self.rtf,
        }
