"""A run on the CPU at a tiny size, the look for a card skipped, with the
timed path broken underneath: `correct` comes out false for each fault the
dataset-generation cell can have, and true for the sound program."""

import pytest
import torch

from benchmark.run import run_cell

SEED = 2**31 + 77


def _run(cell, after_build=None):
    return run_cell(cell, SEED, 0.5, False, torch.device("cpu"), 0.0, after_build=after_build)


def test_sound_program_is_correct(tiny_cell):
    r = _run(tiny_cell())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 8
    assert list(r)[-1] == "check" and set(r["check"]) == {"lm_gap", "lm_gap_mean", "mel_rel", "wav_spec_rel", "length_errors"}


def test_token_altered_where_produced(tiny_cell, monkeypatch):
    import fangyan_tts_torch.infer.tts as tts_mod

    real = tts_mod.generate_speech_tokens

    def altered(*a, **k):
        res = real(*a, **k)
        res.tokens[:, 1] = (res.tokens[:, 1] + 3001) % 6561
        return res

    monkeypatch.setattr(tts_mod, "generate_speech_tokens", altered)
    r = _run(tiny_cell())
    assert not r["correct"] and r["check"]["lm_gap"]["value"] > r["check"]["lm_gap"]["limit"]


def test_step_returns_its_state_unchanged(tiny_cell):
    def freeze(system):  # every Euler step leaves x as it was: zero velocity
        est = system.tts.flow.estimator
        est.forward = lambda x, *a, **k: torch.zeros_like(x)

    r = _run(tiny_cell(), after_build=freeze)
    assert not r["correct"] and r["check"]["mel_rel"]["value"] > r["check"]["mel_rel"]["limit"]


def test_half_the_batch_left_out(tiny_cell):
    def halve(system):
        real = system.tts.batch_synthesize
        system.tts.batch_synthesize = lambda texts, **k: real(texts[: len(texts) // 2], **k)

    r = _run(tiny_cell(), after_build=halve)
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("n_rows", [1, 3])
def test_few_rows_still_checked(tiny_cell, n_rows):
    cell = tiny_cell()
    cell.spec["params"].update(batch=n_rows, check_sample=2)
    r = _run(cell)
    assert r["correct"] and r["attempted"] % n_rows == 0


STREAMS = ["cv2.stream_c8", "cv3.stream_c8"]


def _stream_run(cell, after_build=None):
    return run_cell(cell, SEED, 2.0, False, torch.device("cpu"), 0.0, after_build=after_build)


@pytest.mark.parametrize("name", STREAMS)
def test_stream_sound_program_is_correct(tiny_stream_cell, name):
    r = _stream_run(tiny_stream_cell(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 3
    assert {"audio_s_per_s", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("name", STREAMS)
def test_stream_token_altered_where_produced(tiny_stream_cell, monkeypatch, name):
    import fangyan_tts_torch.infer.llm_batch as lb

    real = lb.decode_chunk_cont

    def altered(*a, **k):
        state, toks = real(*a, **k)
        toks = torch.where(toks >= 0, (toks + 3001) % 6561, toks)
        return state, toks

    monkeypatch.setattr(lb, "decode_chunk_cont", altered)
    r = _stream_run(tiny_stream_cell(name))
    assert not r["correct"] and r["check"]["lm_gap"]["value"] > r["check"]["lm_gap"]["limit"]


@pytest.mark.parametrize("name", STREAMS)
def test_stream_step_returns_its_state_unchanged(tiny_stream_cell, name):
    def freeze(system):  # every Euler step of the flow leaves x as it was
        system.tts.flow.estimator.forward = lambda x, *a, **k: torch.zeros_like(x)

    r = _stream_run(tiny_stream_cell(name), after_build=freeze)
    assert not r["correct"] and r["check"]["wav_spec_rel"]["value"] > r["check"]["wav_spec_rel"]["limit"]


@pytest.mark.parametrize("name", STREAMS)
def test_stream_answer_altered_where_produced(tiny_stream_cell, name):
    def quiet_first_chunk(system):
        real = system.tts.tts

        def tts(*a, **k):
            for i, out in enumerate(real(*a, **k)):
                yield {"tts_speech": out["tts_speech"] * 0.5} if i == 0 else out

        system.tts.tts = tts

    r = _stream_run(tiny_stream_cell(name), after_build=quiet_first_chunk)
    assert not r["correct"] and r["check"]["wav_spec_rel"]["value"] > r["check"]["wav_spec_rel"]["limit"]
