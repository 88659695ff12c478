"""The reader of `decode_graph_step_pct.datagen` (the program's
`llm.graph_steps` over `llm.decode_steps`) on hand-made counters, and on a
program that counts no graph steps (the parent's)."""

import pytest

from benchmark.harness import Cell
from test_bench_program_metrics import RECORDS, StubTrace, BUSY

NAME = "decode_graph_step_pct.datagen"


def read(counters, records=RECORDS, trace=None):
    ctx = {"trace": trace or StubTrace(BUSY), "program_records": (records, counters), "spans": [], "window_s": 1.0}
    return Cell("cv3.datagen_b16").reader(NAME)(ctx)


def test_share_of_replayed_steps():
    assert read({"llm.decode_steps": 2400, "llm.graph_steps": 2396, "llm.graph_captures": 4}) == pytest.approx(
        100 * 2396 / 2400)
    assert read({"llm.decode_steps": 50, "llm.graph_steps": 50}) == pytest.approx(100.0)
    assert read({"llm.decode_steps": 50, "llm.graph_steps": 0}) == 0.0  # an eager program reads 0, not nothing


def test_none_where_nothing_was_counted():
    assert read({"llm.decode_steps": 50, "llm.row_steps": 800}) is None  # a program without graphs
    assert read({"llm.graph_steps": 0}) is None
    assert read({"llm.decode_steps": 0, "llm.graph_steps": 0}) is None
    assert read({"llm.decode_steps": 50, "llm.graph_steps": 50}, records=[]) is None  # nothing in the window
    ctx = {"trace": None, "program_records": (RECORDS, {"llm.decode_steps": 5, "llm.graph_steps": 5}), "spans": [],
           "window_s": 1.0}
    assert Cell("cv3.datagen_b16").reader(NAME)(ctx) is None


def test_listed_in_the_benchmark():
    cell = Cell("cv3.datagen_b16")
    entry = next(m for m in cell.per_layer() if m["name"] == NAME)
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_span",
                     "layer": "LLM (models/llm.py, models/qwen2.py)", "moves": "audio_s_per_s",
                     "workloads": ["cv3.datagen_b16"]}
