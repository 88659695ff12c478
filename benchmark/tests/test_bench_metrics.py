"""The metric arithmetic on synthetic spans and traces."""

import pytest

from benchmark.harness import Cell, Spans, Trace, idle_gaps, interval_union, percentile
from benchmark.metrics import counters


def test_interval_union_counts_overlaps_once():
    assert interval_union([]) == 0
    assert interval_union([(0, 10)]) == 10
    assert interval_union([(0, 10), (5, 15)]) == 15  # a sum would say 20
    assert interval_union([(0, 10), (2, 3), (20, 25)]) == 15
    assert interval_union([(20, 25), (0, 10), (10, 12)]) == 17
    assert idle_gaps([(0, 10), (2, 3), (20, 25), (24, 30)]) == [(10, 20)]


def test_percentiles_over_all_samples():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == pytest.approx(50.5)
    assert percentile(xs, 90) == pytest.approx(90.1)
    assert percentile([3.0], 90) == 3.0
    with pytest.raises(ValueError):
        percentile([], 50)


class FakeTrace(Trace):
    """A Trace with given device operations (ns) and window."""

    def __init__(self, ops, window_s):
        self.ops, self.window_s, self.offset_ns = ops, window_s, None


def _ctx(ops, launches, window_s=1.0, spans=(), work=None):
    w = {"launches": launches, "decode_steps": 10, "model_flops": 9.89e12}
    return {"trace": FakeTrace(ops, window_s), "work": work or w, "window_s": window_s, "spans": list(spans)}


def read(name):
    return Cell("cv3.datagen_b16").reader(name)


def test_roofline_sums_least_time_over_traced_time():
    shapes = [counters.decode_attention_work(16, 512, 14, 2, 64, 16 * 200)] * 3
    least_s = sum(counters.bound(*s)[0] for s in shapes) / 1e3
    ops = [("decode_attention_kernel<...>", i * 10_000, i * 10_000 + 4_000) for i in range(3)]
    ops.append(("other_kernel", 50_000, 60_000))
    v = read("decode_attention_roofline_pct")(_ctx(ops, {"decode_attention": shapes}))
    assert v == pytest.approx(100 * least_s / 12e-6)
    # another number of launches than predicted: nothing to read
    assert read("decode_attention_roofline_pct")(_ctx(ops[:2], {"decode_attention": shapes})) is None
    assert read("flash_attention_roofline_pct")(_ctx(ops, {"decode_attention": shapes})) is None
    assert read("decode_attention_roofline_pct")({"trace": None, "work": {}, "window_s": 1.0, "spans": []}) is None


def test_idle_and_mfu():
    ops = [("a", 0, 200_000_000), ("b", 100_000_000, 300_000_000), ("c", 600_000_000, 700_000_000)]
    ctx = _ctx(ops, {}, window_s=1.0)
    assert read("device_idle_pct")(ctx) == pytest.approx(60.0)
    assert read("mfu_pct")(ctx) == pytest.approx(1.0)
    assert read("mfu_pct")(_ctx(ops, {}, window_s=2.0)) == pytest.approx(0.5)


def test_span_metrics():
    spans = [{"name": "llm", "device_ms": 100.0}, {"name": "llm", "device_ms": 50.0},
             {"name": "flow", "device_ms": 30.0}, {"name": "flow", "device_ms": 10.0},
             {"name": "vocoder", "device_ms": None}]
    ctx = _ctx([], {}, spans=spans)
    assert read("decode_ms_per_step.datagen")(ctx) == pytest.approx(15.0)
    assert read("flow_ms_per_batch.datagen")(ctx) == pytest.approx(20.0)
    assert read("vocoder_ms_per_batch.datagen")(ctx) is None


def test_spans_record_calls_and_keep_outputs():
    class Obj:
        def f(self, x):
            return x * 2

    o = Obj()
    s = Spans(cuda=False)
    s.wrap(o, "f", "double", keep=lambda a, k, out: {"out": out})
    assert o.f(3) == 6
    assert s.items[0]["name"] == "double" and s.items[0]["out"] == 6 and s.items[0]["t1"] >= s.items[0]["t0"]
    assert s.device_ms(s.items[0]) is None
    assert s.named("double") == s.items


def test_gap_labels_follow_the_host_spans():
    tr = FakeTrace([("k1", 1_000_000_000, 1_000_100_000), ("k2", 1_000_600_000, 1_000_700_000)], 1.0)
    tr.offset_ns, tr._host_ns, tr._host_perf = 0, 1_000_000_000, 50.0
    spans = Spans(cuda=False)
    spans.items.append({"name": "flow", "t0": 50.00005, "t1": 50.0002})
    gaps = tr.top_gaps(spans)
    assert gaps == [["in flow", pytest.approx(0.0005)]]
    assert tr.top_ops() == [["k1", pytest.approx(1e-4)], ["k2", pytest.approx(1e-4)]]
