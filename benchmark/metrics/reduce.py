"""Reductions that per-layer metrics share: span device times and kernel
rooflines. Each returns None where the run gave it nothing to read."""

from __future__ import annotations

from benchmark.metrics import counters


def span_ms(ctx: dict, name: str) -> list[float]:
    """Device ms of the window's spans called `name`."""
    return [s["device_ms"] for s in ctx["spans"] if s["name"] == name and s.get("device_ms") is not None]


def mean_span_ms(ctx: dict, name: str) -> float | None:
    ms = span_ms(ctx, name)
    return sum(ms) / len(ms) if ms else None


def roofline_pct(ctx: dict, launches: str, pattern: str) -> float | None:
    """100 x the least time the window's launches of a kernel need (the
    frozen byte and operation counts at the published peaks) over the
    device time the trace gives those launches. None without a trace, or
    where the trace holds another number of launches than the traffic and
    the wrapper's record predict."""
    trace, work = ctx.get("trace"), ctx.get("work") or {}
    shapes = work.get("launches", {}).get(launches)
    if trace is None or not shapes:
        return None
    times = trace.kernel_times_s(pattern)
    ctx.setdefault("notes", []).append(f"{launches}: {len(times)} launches traced, {len(shapes)} predicted")
    if len(times) != len(shapes) or sum(times) <= 0:
        return None
    least_ms = sum(counters.bound(nb, fl)[0] for nb, fl in shapes)
    return 100.0 * least_ms / 1e3 / sum(times)
