"""Offline batches, as a dataset-generation job sends them: a corpus of
texts sorted by length and cut into batches, one voice prompt for the run,
whole batches back to back.

Parameters: `batch` rows a batch and `batches` batches in the corpus; text
lengths log-normal (`text_median`, `text_sigma`) clipped to
[`text_min`, `text_max`], ids below `text_vocab`; `tokens_per_text_token`
speech tokens an utterance (its minimum and maximum alike); the prompt's
`instruct_tokens` text ids, `prompt_tokens` flow prompt tokens below
`speech_vocab` with `prompt_tokens * mel_ratio` mel frames of `mel_bins`,
and an x-vector of `xvector_dim`.

The set of text lengths is the same for every seed (the log-normal's
quantiles); the seed draws the ids, the prompt and which batch comes first.
Batches go short, long, short, long from there, so that any stretch of the
window holds a like mix.
"""

from __future__ import annotations

import statistics
import time

import numpy as np


def text_lengths(p: dict) -> np.ndarray:
    n = p["batch"] * p["batches"]
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.round(p["text_median"] * np.exp(p["text_sigma"] * z)), p["text_min"], p["text_max"]).astype(int)


def generate(p: dict, seed: int) -> dict:
    rng = np.random.default_rng(int(seed))
    texts = [rng.integers(0, p["text_vocab"], size=int(n), dtype=np.int32) for n in rng.permutation(text_lengths(p))]
    texts.sort(key=len)
    b = p["batch"]
    batches = [texts[i: i + b] for i in range(0, len(texts), b)]
    k = len(batches)
    zigzag = [i // 2 if i % 2 == 0 else k - 1 - i // 2 for i in range(k)]
    start = int(rng.integers(k // 2)) * 2
    order = zigzag[start:] + zigzag[:start]
    prompt = {
        "instruct": rng.integers(0, p["text_vocab"], size=p["instruct_tokens"], dtype=np.int32),
        "flow_tokens": rng.integers(0, p["speech_vocab"], size=p["prompt_tokens"], dtype=np.int32),
        "feat": (rng.standard_normal((p["prompt_tokens"] * p["mel_ratio"], p["mel_bins"])) * 2.0 - 5.0).astype(np.float32),
        "xvec": rng.standard_normal(p["xvector_dim"]).astype(np.float32),
    }
    return {"batches": [batches[i] for i in order], "prompt": prompt, "ratio": float(p["tokens_per_text_token"]),
            "sample": p["check_sample"], "rng": rng}


def warm(system, inputs: dict) -> None:
    """The cell's largest and smallest shapes: its longest and shortest batch."""
    by_len = sorted(inputs["batches"], key=lambda b: max(len(t) for t in b))
    for b in (by_len[-1], by_len[0]):
        system.batch(b, inputs["prompt"], inputs["ratio"])


def drive(system, inputs: dict, seconds: float, sync, on_close=None) -> dict:
    """Whole batches back to back, cycling over the corpus, until `seconds`
    have passed; the window ends with the last batch's audio in hand, and
    then `on_close` runs."""
    done = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        texts = inputs["batches"][i % len(inputs["batches"])]
        t = time.perf_counter()
        out = system.batch(texts, inputs["prompt"], inputs["ratio"])
        out["texts"], out["wall_s"] = texts, time.perf_counter() - t
        done.append(out)
        i += 1
    sync()
    t1 = time.perf_counter()
    if on_close is not None:
        on_close()
    return {"t0": t0, "t1": t1, "batches": done}


def answers(system, inputs: dict, window: dict) -> tuple[int, int, list[dict]]:
    """(attempted, failed, utterances): every utterance of the window is
    attempted, and failed where its audio is missing, not finite, or not as
    long as its tokens; the others are returned for the check."""
    utts, failed = [], 0
    for b in window["batches"]:
        for r, text in enumerate(b["texts"]):
            wav = b["wavs"][r] if r < len(b["wavs"]) else None
            n_tok = int(b["counts"][r]) if r < len(b["counts"]) else 0
            kept = int(b["token_len"][r]) - len(inputs["prompt"]["flow_tokens"]) if r < len(b["token_len"]) else 0
            ok = wav is not None and len(wav) == system.expected_samples(kept) and bool(np.isfinite(wav).all())
            failed += not ok
            if ok:
                utts.append({"text": text, "wav": wav, "tokens": b["tokens"][r, :n_tok], "mel_dev": (b["mel"], r),
                             "expected_tokens": int(len(text) * inputs["ratio"])})
    return sum(len(b["texts"]) for b in window["batches"]), failed, utts


def work(system, inputs: dict, window: dict) -> dict:
    """The window's decode steps, kernel launches (bytes, operations) and
    model FLOPs, batch by batch."""
    out = {"decode_steps": 0, "launches": {}, "model_flops": 0.0}
    for b in window["batches"]:
        w = system.batch_work(b, inputs["prompt"], inputs["ratio"])
        out["decode_steps"] += w["decode_steps"]
        out["model_flops"] += w["model_flops"]
        for k, v in w["launches"].items():
            out["launches"].setdefault(k, []).extend(v)
    return out


def check(system, inputs: dict, window: dict) -> tuple[int, int, dict]:
    """(attempted, failed, numbers compared): a sample of the window's
    utterances held against the references, after the program is freed."""
    attempted, failed, utts = answers(system, inputs, window)
    chosen = sample(inputs, utts)
    for u in chosen:
        mel, r = u.pop("mel_dev")
        u["mel"] = mel[r].float().cpu()
    window["batches"] = []
    system.free()
    return attempted, failed, system.check_utterances(chosen, inputs["prompt"])


def end_to_end(window: dict, sample_rate: int) -> dict:
    samples = sum(len(w) for b in window["batches"] for w in b["wavs"])
    return {"audio_s_per_s": samples / sample_rate / (window["t1"] - window["t0"])}


def counts(window: dict) -> str:
    n = sum(len(b["texts"]) for b in window["batches"])
    walls = sorted(b["wall_s"] for b in window["batches"])
    return (f"{len(window['batches'])} batches, {n} utterances in the window; a batch took "
            f"{walls[0]:.3f}-{walls[-1]:.3f} s (median {walls[len(walls) // 2]:.3f})" if walls else "no batch")


def sample(inputs: dict, utts: list[dict]) -> list[dict]:
    """The utterances the reference checks: the longest, and the rest drawn from the seed."""
    if not utts:
        return []
    longest = max(range(len(utts)), key=lambda i: len(utts[i]["tokens"]))
    rest = [i for i in range(len(utts)) if i != longest]
    pick = inputs["rng"].choice(rest, size=min(len(rest), inputs["sample"] - 1), replace=False) if rest else []
    return [utts[i] for i in [longest, *sorted(int(x) for x in pick)]]
