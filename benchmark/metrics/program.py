"""The program's own spans and counters (fangyan_tts_torch/utils/profiling.py)
on the device trace's clock.

The program's tracer records while a torch profiler runs, which is the
traced window. `view(ctx)` takes the records whose start falls in the
window (`trace._host_perf` for `trace.window_s`), maps the device
operations onto the host's `perf_counter` with the marker arithmetic of
`harness.Trace.top_gaps`, and adds two lines to `ctx["notes"]`: idle device
seconds by innermost program span, and the clock's skew at the LLM's stop
checks. It is made once a run and kept in `ctx`. Where the program recorded
nothing (a program without the tracer, or no trace) it is None, and so is
every reader built on it.

`ctx["program_records"]`, where present, stands for the tracer's
`(spans(), counters())`.
"""

from __future__ import annotations

import numpy as np

KEY = "program_view"


def tracer_records() -> tuple[list[dict], dict] | None:
    """The program tracer's (records, counters), or None where the program has no tracer."""
    try:
        from fangyan_tts_torch.utils import profiling

        return profiling.spans(), profiling.counters()
    except (ImportError, AttributeError):
        return None


class Idle:
    """The device's idle stretches inside the window [w0, w1], in host
    seconds, with a running sum for the idle time inside any interval."""

    def __init__(self, trace, w0: float, w1: float):
        ops = trace.ops
        to_host = trace.offset_ns + trace._host_ns
        s = np.fromiter((o[1] for o in ops), np.int64, len(ops))
        e = np.fromiter((o[2] for o in ops), np.int64, len(ops))
        order = np.argsort(s, kind="stable")
        self.starts = (s[order] - to_host) / 1e9 + trace._host_perf
        self.reach = np.maximum.accumulate((e[order] - to_host) / 1e9 + trace._host_perf) if len(ops) else e[:0]
        if len(ops):
            inner = self.starts[1:] > self.reach[:-1]
            g0 = np.concatenate([[w0], self.reach[:-1][inner], [self.reach[-1]]])
            g1 = np.concatenate([[self.starts[0]], self.starts[1:][inner], [w1]])
        else:
            g0, g1 = np.array([w0]), np.array([w1])
        g0, g1 = np.maximum(g0, w0), np.minimum(g1, w1)
        keep = g1 > g0
        self.g0, self.g1 = g0[keep], g1[keep]
        self.cum = np.concatenate([[0.0], np.cumsum(self.g1 - self.g0)])
        self.total = float(self.cum[-1])

    def before(self, t) -> np.ndarray:
        """Idle seconds from the window's start to each time in t."""
        t = np.asarray(t, np.float64)
        n = len(self.g0)
        if n == 0:
            return np.zeros_like(t)
        k = np.searchsorted(self.g1, t, side="right")
        part = np.clip(t - self.g0[np.minimum(k, n - 1)], 0.0, None)
        return self.cum[k] + np.where(k < n, part, 0.0)

    def within(self, a, b) -> np.ndarray:
        return self.before(b) - self.before(a)

    def device_end_before(self, t) -> np.ndarray:
        """For each time in t, the end of the device work that started before
        it (NaN where none had)."""
        t = np.asarray(t, np.float64)
        k = np.searchsorted(self.starts, t, side="right") - 1
        return np.where(k >= 0, self.reach[np.maximum(k, 0)] if len(self.reach) else np.nan, np.nan)


class View:
    """The window's records (`recs`; `parent` indexes the tracer's list,
    which `index` keeps), the counters, and the idle stretches (None where
    the trace has no marker)."""

    def __init__(self, records: list[dict], counters: dict, trace):
        w0 = trace._host_perf
        w1 = w0 + trace.window_s
        self.recs = [dict(r, index=i) for i, r in enumerate(records)
                     if r.get("t1_ns") is not None and w0 <= r["t0_ns"] / 1e9 <= w1]
        self.counters = dict(counters)
        self.idle = Idle(trace, w0, w1) if trace.offset_ns is not None else None

    def named(self, name: str) -> list[dict]:
        return [r for r in self.recs if r["name"] == name]

    def idle_s(self, recs: list[dict]) -> np.ndarray:
        """Idle device seconds inside each record's extent."""
        return self.idle.within([r["t0_ns"] / 1e9 for r in recs], [r["t1_ns"] / 1e9 for r in recs])

    def idle_by_span(self) -> tuple[dict, float, float]:
        """({innermost span name, or None outside every span: idle s}, the
        leaf spans' share of the window's idle time in %, the window's idle
        s). The records of one thread nest; records of two threads that
        overlap would count twice."""
        own = dict(zip((r["index"] for r in self.recs), self.idle_s(self.recs)))
        inner = dict(own)
        parents = set()
        for r in self.recs:
            p = r["parent"]
            if p is not None and p in own:
                inner[p] -= own[r["index"]]
                parents.add(p)
        by: dict = {}
        for r in self.recs:
            by[r["name"]] = by.get(r["name"], 0.0) + float(inner[r["index"]])
        rooted = sum(float(own[r["index"]]) for r in self.recs if r["parent"] not in own)
        by[None] = self.idle.total - rooted
        leaves = sum(float(own[r["index"]]) for r in self.recs if r["index"] not in parents)
        return by, (100.0 * leaves / self.idle.total if self.idle.total > 0 else 100.0), self.idle.total

    def stop_check_skew_ms(self) -> list[float]:
        """For each `llm.stop_check`: the end of the device work that started
        before it returned, minus its return, in ms."""
        checks = self.named("llm.stop_check")
        ret = np.array([r["t1_ns"] / 1e9 for r in checks])
        skew = (self.idle.device_end_before(ret) - ret) * 1e3
        return [float(x) for x in skew if np.isfinite(x)]

    def notes(self) -> list[str]:
        out = [f"program spans: {len(self.recs)} in the window, counters {self.counters}"]
        if self.idle is None:
            return out + ["program spans: the trace has no marker; idle time not mapped onto them"]
        by, leaf_pct, total = self.idle_by_span()
        parts = sorted(by.items(), key=lambda kv: -kv[1])
        out.append("idle device s by innermost program span: "
                   + ", ".join(f"{k or '(outside every span)'} {v:.4f}" for k, v in parts)
                   + f"; leaf spans hold {leaf_pct:.2f}% of {total:.4f} s idle")
        skew = self.stop_check_skew_ms()
        if skew:
            out.append(f"clock skew at llm.stop_check (device end minus return): median "
                       f"{float(np.median(skew)):.4f} ms, max {max(skew):.4f} ms, min {min(skew):.4f} ms "
                       f"over {len(skew)} checks")
        return out


def view(ctx: dict) -> View | None:
    """The run's View, made on first use (with its notes), or None."""
    if KEY not in ctx:
        trace = ctx.get("trace")
        got = ctx["program_records"] if "program_records" in ctx else tracer_records()
        v = View(*got, trace) if trace is not None and got is not None else None
        ctx[KEY] = v if v is not None and v.recs else None
        if ctx[KEY] is not None:
            ctx.setdefault("notes", []).extend(ctx[KEY].notes())
    return ctx[KEY]


def mean_span_ms(ctx: dict, name: str) -> float | None:
    """Mean host ms of the window's spans called `name`."""
    v = view(ctx)
    recs = v.named(name) if v is not None else []
    return sum(r["t1_ns"] - r["t0_ns"] for r in recs) / len(recs) / 1e6 if recs else None
