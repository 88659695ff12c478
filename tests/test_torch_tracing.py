"""The port's tracer (fangyan_tts_torch/utils/profiling.py) on the CPU:
recording only under a profiler or inside `recording()`, the records'
parents, threads and requests, the cap, and the spans and counters of
`batch_synthesize` on a small random-init CosyVoice3, whose wavs are the
same bits with recording on and off."""

import threading

import numpy as np
import pytest
import torch

from fangyan_tts_torch.infer.tts import CosyVoice3TTS
from fangyan_tts_torch.utils import profiling
from fangyan_tts_torch.utils.profiling import Tracer
from torch_port_util import both

_, TC = both()
CPU_PROFILE = dict(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def test_off_outside_a_profiler():
    s = profiling.span("off", rows=3)
    assert s is profiling.NO_SPAN and profiling.span("other") is s
    with s as entered:
        profiling.count("things")
    assert entered is None
    assert profiling.spans() == [] and profiling.counters() == {} and profiling.dropped() == 0


def test_on_under_a_profiler_and_inside_recording():
    with torch.profiler.profile(**CPU_PROFILE):
        with profiling.span("profiled", rows=2):
            profiling.count("things", 2)
    with profiling.recording():
        with profiling.span("forced"):
            profiling.count("things")
    with profiling.span("after"):
        profiling.count("things")
    def in_thread():
        with profiling.span("thread"):
            pass

    with torch.profiler.profile(**CPU_PROFILE):  # a thread of the process, not the profiler's own
        t = threading.Thread(target=in_thread)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    got = profiling.spans()
    assert [s["name"] for s in got] == ["profiled", "forced", "thread"]
    assert got[0]["attrs"] == {"rows": 2} and got[1]["attrs"] == {}
    assert all(s["t0_ns"] <= s["t1_ns"] for s in got)
    assert profiling.counters() == {"things": 3}


def test_parents_threads_and_requests():
    both_in = threading.Barrier(2, timeout=30)  # the two threads overlap, so their ids differ

    def work(tag):
        with profiling.span(f"{tag}.outer"):
            if tag != "main":
                both_in.wait()
            with profiling.span(f"{tag}.mid"):
                with profiling.span(f"{tag}.leaf"):
                    pass
            with profiling.span(f"{tag}.second"):
                pass

    with profiling.recording():
        work("main")
        ts = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    got = profiling.spans()
    assert len(got) == 12
    requests = set()
    for tag in ("main", "t0", "t1"):
        idx = {s["name"].split(".")[1]: i for i, s in enumerate(got) if s["name"].startswith(tag + ".")}
        outer = got[idx["outer"]]
        assert outer["parent"] is None
        assert got[idx["mid"]]["parent"] == idx["outer"] and got[idx["second"]]["parent"] == idx["outer"]
        assert got[idx["leaf"]]["parent"] == idx["mid"]
        assert len({got[i]["thread"] for i in idx.values()}) == 1
        assert {got[i]["request"] for i in idx.values()} == {outer["request"]}
        requests.add(outer["request"])
        assert got[idx["outer"]]["t0_ns"] <= got[idx["mid"]]["t0_ns"] <= got[idx["leaf"]]["t1_ns"]
        assert got[idx["second"]]["t1_ns"] <= got[idx["outer"]]["t1_ns"]
    assert len(requests) == 3
    assert got[0]["thread"] == threading.get_ident()
    assert len({s["thread"] for s in got}) == 3


def test_cap_and_dropped():
    tr = Tracer(cap=3)
    with tr.recording():
        with tr.span("a"):
            with tr.span("b"):
                pass
        with tr.span("c"):
            with tr.span("d"):  # past the cap
                with tr.span("e"):  # its parent dropped: no parent, the request inherited
                    pass
    got = tr.spans()
    assert [s["name"] for s in got] == ["a", "b", "c"] and tr.dropped() == 2
    assert tr.span("off") is profiling.NO_SPAN
    tr.reset()
    assert tr.spans() == [] and tr.dropped() == 0
    with tr.recording():
        with tr.span("x"):
            with tr.span("y"):
                with tr.span("z"):
                    pass
    assert [s["parent"] for s in tr.spans()] == [None, 0, 1]


def _batch_request():
    rng = np.random.default_rng(4)
    return dict(
        texts=[rng.integers(0, 300, n).astype(np.int32) for n in (4, 7, 5)],
        prompt_text=rng.integers(0, 300, 3).astype(np.int32),
        flow_prompt_speech_token=rng.integers(0, 50, 5).astype(np.int32),
        prompt_speech_feat=(rng.standard_normal((10, 80)) * 0.5).astype(np.float32),
        flow_embedding=rng.standard_normal(192).astype(np.float32),
        min_token_text_ratio=3, max_token_text_ratio=3,
    )


def test_batch_synthesize_spans_and_counters():
    tts = CosyVoice3TTS.random_init(TC, dtype=torch.float32, device="cpu", seed=3)
    req = _batch_request()
    tts.generator.manual_seed(0)
    off = tts.batch_synthesize(**req)
    assert profiling.spans() == []
    tts.generator.manual_seed(0)
    with torch.profiler.profile(**CPU_PROFILE):
        on = tts.batch_synthesize(**req)
    assert len(on) == len(off) == 3
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)

    got = profiling.spans()
    roots = [i for i, s in enumerate(got) if s["parent"] is None]
    assert [got[i]["name"] for i in roots] == ["tts.batch"] and got[0]["attrs"] == {"rows": 3}
    assert {s["request"] for s in got} == {got[0]["request"]} and {s["thread"] for s in got} == {threading.get_ident()}
    children = {}
    for i, s in enumerate(got):
        if s["parent"] is not None:
            children.setdefault(s["parent"], []).append(i)
    names = lambda idx: [got[i]["name"] for i in idx]
    assert names(children[0]) == ["llm", "flow", "vocoder"]
    llm, flow, vocoder = children[0]
    max_lens = [len(t) * 3 for t in req["texts"]]
    steps = max(max_lens)
    assert names(children[llm]) == (["llm.plan", "llm.prefill"] + ["llm.stop_check", "llm.step"] * steps
                                    + ["llm.stop_check", "llm.fetch"])
    assert names(children[flow]) == ["flow.pack", "flow.prepare"] + ["flow.euler"] * TC.flow.n_timesteps
    assert names(children[vocoder]) == ["vocoder.run", "vocoder.fetch"]
    assert all(i not in children for i in children[llm] + children[flow] + children[vocoder])  # leaves
    for stage in (llm, flow, vocoder):
        total = got[stage]["t1_ns"] - got[stage]["t0_ns"]
        covered = sum(got[i]["t1_ns"] - got[i]["t0_ns"] for i in children[stage])
        assert total - covered <= 0.05 * total, got[stage]["name"]
    # the DiT's AdaLN norms (ops/adaln): two a block and the final one, each Euler step; the LM's RMSNorms
    # (ops/rms_norm: two a layer and the final one) and qkv epilogues (ops/qkv_rope), each forward (the prefill and
    # every step); none fused on the CPU
    layers, forwards = TC.llm.qwen.num_hidden_layers, 1 + steps
    assert profiling.counters() == {"llm.decode_steps": steps, "llm.row_steps": 3 * steps,
                                    "llm.tokens": sum(max_lens), "llm.graph_steps": 0, "llm.graph_captures": 0,
                                    "dit.norms": (2 * TC.flow.dit.depth + 1) * TC.flow.n_timesteps,
                                    "llm.norms": (2 * layers + 1) * forwards, "llm.qkv": layers * forwards}
