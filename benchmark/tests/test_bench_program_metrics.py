"""The readers of the program's spans (`metrics/program.py` and the five
metrics on it) on a hand-made record list and a stub trace with a known
marker offset, against hand arithmetic."""

import pytest

from benchmark.harness import Cell
from benchmark.metrics import program

HOST_NS, OFFSET_NS, PERF0 = 1_700_000_000_000_000_000, 5_000, 100.0
NAMES = ("decode_enqueue_ms_per_step.datagen", "decode_stop_wait_ms_per_step.datagen",
         "decode_idle_ms_per_step.datagen", "decode_row_use_pct.datagen", "flow_idle_ms_per_batch.datagen")


class StubTrace:
    """Device operations at given host times (s), stored on the device's
    clock as `harness.Trace` stores them: the marker started OFFSET_NS after
    the host's time_ns HOST_NS, read when perf_counter was PERF0."""

    def __init__(self, busy, window_s=1.0, marker=True):
        dev = lambda h: HOST_NS + OFFSET_NS + round((h - PERF0) * 1e9)
        self.ops = [("kernel", dev(a), dev(b)) for a, b in busy]
        self._host_ns, self._host_perf, self.window_s = HOST_NS, PERF0, window_s
        self.offset_ns = OFFSET_NS if marker else None


def rec(name, t0, t1, parent):
    return {"name": name, "t0_ns": round(t0 * 1e9), "t1_ns": round(t1 * 1e9), "parent": parent, "thread": 1,
            "request": 0, "attrs": {}}


RECORDS = [
    rec("tts.batch", 100.000, 100.900, None),  # 0
    rec("llm", 100.000, 100.500, 0),  # 1
    rec("llm.prefill", 100.000, 100.100, 1),
    rec("llm.stop_check", 100.100, 100.110, 1),
    rec("llm.step", 100.110, 100.200, 1),
    rec("llm.stop_check", 100.200, 100.300, 1),
    rec("llm.step", 100.300, 100.400, 1),
    rec("llm.stop_check", 100.400, 100.450, 1),
    rec("llm.fetch", 100.450, 100.500, 1),
    rec("flow", 100.500, 100.800, 0),  # 9
    rec("flow.euler", 100.500, 100.800, 9),
    rec("vocoder", 100.800, 100.900, 0),
    rec("before", 99.0, 99.5, None),  # outside the window
]
COUNTERS = {"llm.decode_steps": 2, "llm.row_steps": 32, "llm.tokens": 24}
# busy on the host's clock; idle in the window [100, 101]: 50 + 75 + 78 + 155 + 120 + 120 = 598 ms
BUSY = [(100.050, 100.105), (100.180, 100.302), (100.380, 100.445), (100.600, 100.700), (100.820, 100.880)]


def ctx_of(records=RECORDS, counters=COUNTERS, trace=None):
    return {"trace": trace or StubTrace(BUSY), "program_records": (records, counters), "spans": [], "window_s": 1.0}


def read(name, ctx):
    return Cell("cv3.datagen_b16").reader(name)(ctx)


def test_readers_against_hand_arithmetic():
    ctx = ctx_of()
    assert read("decode_enqueue_ms_per_step.datagen", ctx) == pytest.approx((90 + 100) / 2)
    assert read("decode_stop_wait_ms_per_step.datagen", ctx) == pytest.approx((10 + 100 + 50) / 3)
    # from the first step (100.110) to the last check's return (100.450): 70 + 78 + 5 ms over 2 steps
    assert read("decode_idle_ms_per_step.datagen", ctx) == pytest.approx((70 + 78 + 5) / 2)
    assert read("decode_row_use_pct.datagen", ctx) == pytest.approx(75.0)
    # the flow [100.5, 100.8]: 100 ms of the gap from 100.445 and 100 of the gap to 100.82
    assert read("flow_idle_ms_per_batch.datagen", ctx) == pytest.approx(200.0)


def test_idle_by_span_and_skew():
    ctx = ctx_of()
    v = program.view(ctx)
    assert [r["name"] for r in v.recs][-1] == "vocoder"  # the record before the window left out
    by, leaf_pct, total = v.idle_by_span()
    want = {"llm.prefill": 50, "llm.stop_check": 5 + 0 + 5, "llm.step": 70 + 78, "llm.fetch": 50, "flow.euler": 200,
            "vocoder": 20 + 20, None: 100, "tts.batch": 0, "llm": 0, "flow": 0}
    assert total == pytest.approx(0.598)
    assert set(by) == set(want)
    for k, ms in want.items():
        assert by[k] == pytest.approx(ms / 1e3, abs=1e-9), k
    assert leaf_pct == pytest.approx(100 * 498 / 598)
    # the checks return at 100.110, 100.300, 100.450; the work before them ends at 100.105, 100.302, 100.445
    assert v.stop_check_skew_ms() == pytest.approx([-5.0, 2.0, -5.0])
    notes = ctx["notes"]
    assert len(notes) == 3 and notes[0].startswith("program spans: 12 in the window")
    assert "flow.euler 0.2000" in notes[1] and "(outside every span) 0.1000" in notes[1]
    assert "leaf spans hold 83.28% of 0.5980 s idle" in notes[1]
    assert "median -5.0000 ms, max 2.0000 ms, min -5.0000 ms over 3 checks" in notes[2]
    program.view(ctx)
    assert len(ctx["notes"]) == 3  # made once a run


def test_none_where_nothing_was_recorded():
    for ctx in (ctx_of(records=[], counters={}), ctx_of(records=RECORDS[-1:]),
                {"trace": None, "program_records": (RECORDS, COUNTERS), "spans": [], "window_s": 1.0}):
        assert all(read(n, ctx) is None for n in NAMES)
        assert "notes" not in ctx
    # no marker: the host-time readers read, the idle readers do not
    ctx = ctx_of(trace=StubTrace(BUSY, marker=False))
    assert read("decode_enqueue_ms_per_step.datagen", ctx) == pytest.approx(95.0)
    assert read("decode_row_use_pct.datagen", ctx) == pytest.approx(75.0)
    assert read("decode_idle_ms_per_step.datagen", ctx) is None
    assert read("flow_idle_ms_per_batch.datagen", ctx) is None
    assert "no marker" in ctx["notes"][-1]


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    """The parent's program has no spans(): the readers return None and raise nothing."""
    from fangyan_tts_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    ctx = {"trace": StubTrace(BUSY), "spans": [], "window_s": 1.0}
    assert program.tracer_records() is None
    assert all(read(n, ctx) is None for n in NAMES)


def test_the_tracer_feeds_the_view():
    """Records the program's tracer makes under recording() reach the view."""
    import time

    from fangyan_tts_torch.utils import profiling

    profiling.reset()
    try:
        perf = time.perf_counter()
        with profiling.recording():
            with profiling.span("llm"):
                with profiling.span("llm.step"):
                    time.sleep(0.002)
            profiling.count("llm.decode_steps")
        trace = StubTrace([])
        trace._host_perf = perf
        ctx = {"trace": trace, "spans": [], "window_s": 1.0}
        assert read("decode_enqueue_ms_per_step.datagen", ctx) >= 2.0
        assert program.view(ctx).counters == {"llm.decode_steps": 1}
    finally:
        profiling.reset()
