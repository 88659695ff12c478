"""The benchmark's general machinery: finding a cell's files by name, spans
around calls into the system's layers, percentiles, and the device trace and
its reduction.

A cell (`workloads/<cell>.json`) names a configuration (`configs/<name>.json`,
whose `family` picks `systems/<family>.py`), a traffic kind
(`traffic/<kind>.py`) with its parameters, and its correctness limits. A
per-layer metric is `metrics/<metric>.py`, whose `read(ctx)` returns a
number, or None where the run gave it nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fangyan_tts_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: Path, name: str):
    """Import one file of the benchmark by its path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's files, found by name under `root` (the benchmark folder)."""

    def __init__(self, name: str, root: Path = HERE, bench: dict | None = None):
        self.root = root
        self.name = name
        self.spec = read_json(root / "workloads" / f"{name}.json")
        self.config = read_json(root / "configs" / f"{self.spec['config']}.json")
        self.bench = bench if bench is not None else read_json(root.parent / "BENCHMARK.json")
        self.traffic = load_file_module(root / "traffic" / f"{self.spec['traffic']}.py", f"bench_traffic_{self.spec['traffic']}")
        self.system = load_file_module(root / "systems" / f"{self.config['family']}.py", f"bench_system_{self.config['family']}")

    def _mine(self, entry: dict) -> bool:
        return "workloads" not in entry or self.name in entry["workloads"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self._mine(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self._mine(m)]

    def reader(self, metric: str):
        return load_file_module(self.root / "metrics" / f"{metric}.py", f"bench_metric_{metric.replace('.', '_')}").read


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark must never load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---- spans -------------------------------------------------------------------

class Spans:
    """Spans around calls into the system's layers: host clock always, and on
    the card a CUDA event at each edge, so that a span's device time is read
    after the window without a synchronize inside it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.items: list[dict] = []

    def wrap(self, obj, attr: str, name: str, keep=None) -> None:
        """Replace obj.attr (a method) by a wrapper that records span `name`;
        keep(args, kwargs, out) -> dict is stored with the span."""
        fn = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            rec = {"name": name, "t0": time.perf_counter()}
            if self.cuda:
                import torch

                rec["e0"] = torch.cuda.Event(enable_timing=True)
                rec["e0"].record()
            out = fn(*args, **kwargs)
            if self.cuda:
                rec["e1"] = torch.cuda.Event(enable_timing=True)
                rec["e1"].record()
            rec["t1"] = time.perf_counter()
            if keep is not None:
                rec.update(keep(args, kwargs, out))
            self.items.append(rec)
            return out

        setattr(obj, attr, wrapped)

    def named(self, name: str) -> list[dict]:
        return [s for s in self.items if s["name"] == name]

    def device_ms(self, s: dict) -> float | None:
        """A span's device time by its events (after a synchronize), or None off the card."""
        if "e0" not in s:
            return None
        return s["e0"].elapsed_time(s["e1"])


# ---- statistics ----------------------------------------------------------------

def percentile(values: list[float], p: float) -> float:
    """The p-th percentile of all samples, linear between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    k = (len(xs) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


# ---- device trace ---------------------------------------------------------------

def interval_union(intervals: list[tuple[int, int]]) -> int:
    """Total length covered by (start, end) intervals; overlaps count once."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """(start, end) of the gaps between the union's covered stretches."""
    gaps, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


class Trace:
    """torch.profiler over the window with device activity only, reduced to
    device operations (name, start_ns, end_ns). A marker kernel launched at
    the start, right after a synchronize, maps the trace's clock onto the
    host's, so that idle gaps can be labelled with the span open on the host."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops: list[tuple[str, int, int]] = []
        self.offset_ns: int | None = None
        self.window_s = 0.0

    def start(self) -> None:
        import torch

        self.prof.__enter__()
        torch.cuda.synchronize()
        self._host_ns = time.time_ns()
        self._host_perf = time.perf_counter()
        torch.cuda._sleep(1000)  # the marker kernel
        torch.cuda.synchronize()

    def stop(self) -> None:
        """Close the traced window; threads may still be running work."""
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._host_perf
        self.prof.__exit__(None, None, None)
        try:
            events = self.prof.profiler.kineto_results.events()
            raw = [(e.name(), e.start_ns(), e.end_ns(), str(e.device_type())) for e in events]
        except AttributeError:  # an older profiler: its parsed events
            raw = [(e.name, int(e.time_range.start * 1000), int(e.time_range.end * 1000), str(e.device_type))
                   for e in self.prof.events()]
        ops = [(n, s, e) for n, s, e, d in raw if d.endswith("CUDA") and e > s]
        marks = [o for o in ops if "sleep" in o[0].lower() or "spin" in o[0].lower()]
        if marks:
            first = min(marks, key=lambda o: o[1])
            self.offset_ns = first[1] - self._host_ns
            ops.remove(first)
        self.ops = ops

    def busy_s(self) -> float:
        return interval_union([(s, e) for _, s, e in self.ops]) / 1e9

    def kernel_times_s(self, pattern: str) -> list[float]:
        return [(e - s) / 1e9 for n, s, e in sorted(self.ops, key=lambda o: o[1]) if pattern in n]

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, spans: Spans, n: int = 10) -> list[list]:
        """The longest idle gaps, each labelled by the span open on the host
        when the gap began (host clock through the marker), or by the
        operations on either side."""
        ops = sorted(self.ops, key=lambda o: o[1])
        gaps = sorted(idle_gaps([(s, e) for _, s, e in ops]), key=lambda g: g[0] - g[1])[:n]
        out = []
        for g0, g1 in gaps:
            label = None
            if self.offset_ns is not None:
                t = self._host_perf + (g0 - self.offset_ns - self._host_ns) / 1e9
                open_now = [s["name"] for s in spans.items if s["t0"] <= t <= s["t1"]]
                label = "in " + open_now[-1] if open_now else "outside the spans"
            if label is None:
                before = max((o for o in ops if o[2] <= g0), key=lambda o: o[2], default=("start", 0, 0))
                label = "after " + before[0][:60]
            out.append([label, (g1 - g0) / 1e9])
        return out


# ---- output ------------------------------------------------------------------------

def note(msg: str) -> None:
    """An earlier line of the run, on standard error."""
    print(msg, file=sys.stderr, flush=True)
