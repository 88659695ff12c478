"""Served streams in a closed loop: `clients` threads, each sending its next
zero-shot request as soon as its last stream has ended (no think time), for
the length of the window; a client then finishes the stream it has open.

Parameters: `clients`; `requests_per_client` requests drawn for each (a
client cycles through them); text lengths log-normal (`text_median`,
`text_sigma`) clipped to [`text_min`, `text_max`], ids below `text_vocab`;
`tokens_per_text_token` speech tokens a request (its minimum and maximum
alike); `voices` cached speakers, each with `prompt_text_tokens` text ids,
`prompt_tokens` LLM and flow prompt tokens below `speech_vocab`, their mel
(`prompt_tokens * mel_ratio` frames of `mel_bins`) and an x-vector of
`xvector_dim`; client c speaks with voice c mod `voices`; `check_sample`
finished streams are held against the references.

Every seed gets the same text lengths (the log-normal's quantiles), dealt
to the clients in the seed's order, with the seed's ids and voices.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchmark.harness import note, percentile
from benchmark.traffic.batch_offline import text_lengths


def generate(p: dict, seed: int) -> dict:
    rng = np.random.default_rng(int(seed))
    voices = [{
        "prompt_text": rng.integers(0, p["text_vocab"], size=p["prompt_text_tokens"], dtype=np.int32),
        "llm_tokens": rng.integers(0, p["speech_vocab"], size=p["prompt_tokens"], dtype=np.int32),
        "flow_tokens": rng.integers(0, p["speech_vocab"], size=p["prompt_tokens"], dtype=np.int32),
        "feat": (rng.standard_normal((p["prompt_tokens"] * p["mel_ratio"], p["mel_bins"])) * 2.0 - 5.0)
        .astype(np.float32),
        "xvec": rng.standard_normal(p["xvector_dim"]).astype(np.float32),
    } for _ in range(p["voices"])]
    k, n = p["clients"], p["requests_per_client"]
    lengths = rng.permutation(text_lengths({**p, "batch": k, "batches": n}))
    clients = [[{"text": rng.integers(0, p["text_vocab"], size=int(lengths[c * n + i]), dtype=np.int32),
                 "voice": c % p["voices"]} for i in range(n)] for c in range(k)]
    return {"clients": clients, "voices": voices, "ratio": float(p["tokens_per_text_token"]),
            "sample": p["check_sample"], "rng": rng}


def _one(system, inputs: dict, req: dict, rec: dict, until: float = float("inf")) -> None:
    """One stream, to its end, or once it has a chunk past `until` abandoned
    there (its generator closed, which frees its slots)."""
    gen = system.stream(req["text"], inputs["voices"][req["voice"]], inputs["ratio"], rec)
    try:
        for chunk in gen:
            rec["chunks"].append((time.perf_counter(), len(chunk)))
            rec["audio"].append(chunk)
            if rec["chunks"][-1][0] > until:
                rec["abandoned"] = True
                return
        rec["done"] = True
    except Exception as e:  # noqa: BLE001 - a failed stream is counted, not fatal to the run
        rec["error"] = repr(e)
    finally:
        gen.close()


def _record(c: int, req: dict) -> dict:
    return {"client": c, "req": req, "t_req": time.perf_counter(), "chunks": [], "audio": [], "tokens": [],
            "done": False, "abandoned": False, "error": None}


def warm(system, inputs: dict) -> None:
    """One stream for each of the traffic's decode buckets (its shortest
    text there), all at once, each to its first chunk: a new scheduler group
    pays its own first calls here, before the window."""
    first: dict = {}
    for reqs in inputs["clients"]:
        for req in reqs:
            key = system.stream_key(req["text"], inputs["voices"][req["voice"]], inputs["ratio"])
            if key not in first or len(req["text"]) < len(first[key]["text"]):
                first[key] = req
    threads = [threading.Thread(target=_one, args=(system, inputs, req, _record(-1, req), 0.0))
               for req in first.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def drive(system, inputs: dict, seconds: float, sync, on_close=None) -> dict:
    """Every client in its own thread until the window closes; `on_close`
    runs at the close; each client then finishes the stream it has open, and
    the threads are joined."""
    streams: list[dict] = []
    lock = threading.Lock()
    t0 = time.perf_counter()
    end = t0 + seconds

    def client(c: int) -> None:
        reqs, i = inputs["clients"][c], 0
        while time.perf_counter() < end:
            rec = _record(c, reqs[i % len(reqs)])
            i += 1
            with lock:
                streams.append(rec)
            _one(system, inputs, rec["req"], rec)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(inputs["clients"]))]
    for t in threads:
        t.start()
    time.sleep(max(end - time.perf_counter(), 0.0))
    if on_close is not None:
        on_close()
    for t in threads:
        t.join()
    sync()
    return {"t0": t0, "t1": end, "t_drained": time.perf_counter(), "streams": streams}


def _in_window(window: dict):
    return [s for s in window["streams"] if s["t_req"] < window["t1"]]


def end_to_end(window: dict, sample_rate: int) -> dict:
    """Audio of every chunk that arrived in the window, over its seconds; the
    median first chunk of the streams opened in it (a stream that failed or
    gave no chunk counts as missing: infinitely late); the 90th percentile
    of the gaps between one stream's chunks, over all of them."""
    t0, t1 = window["t0"], window["t1"]
    samples = sum(n for s in window["streams"] for t, n in s["chunks"] if t <= t1)
    firsts, gaps = [], []
    for s in _in_window(window):
        ok = s["chunks"] and s["error"] is None
        firsts.append((s["chunks"][0][0] - s["t_req"]) * 1e3 if ok else float("inf"))
        gaps += [(b[0] - a[0]) * 1e3 for a, b in zip(s["chunks"], s["chunks"][1:])]
    out = {"audio_s_per_s": samples / sample_rate / (t1 - t0)}
    if firsts:
        out["first_chunk_ms_p50"] = percentile(firsts, 50)
    if gaps:
        out["chunk_gap_ms_p90"] = percentile(gaps, 90)
    window["samples"] = {"first_chunk": len(firsts), "gap": len(gaps)}
    return out


def counts(window: dict) -> str:
    s = _in_window(window)
    n = window.get("samples", {})
    return (f"{len(s)} streams opened in the window ({sum(x['done'] for x in s)} finished, "
            f"{sum(x['error'] is not None for x in s)} failed), {n.get('first_chunk', 0)} first chunks and "
            f"{n.get('gap', 0)} gaps behind the percentiles, drained {window['t_drained'] - window['t1']:.1f} s "
            f"after the close")


def work(system, inputs: dict, window: dict) -> dict:
    """Model FLOPs of the audio the window delivered: each stream's whole
    work, in the share of its audio that arrived in the window."""
    flops = 0.0
    for s in window["streams"]:
        total = sum(n for _, n in s["chunks"])
        if not total or not s["done"]:
            continue
        inside = sum(n for t, n in s["chunks"] if t <= window["t1"])
        flops += system.stream_flops(s, inputs) * inside / total
    return {"model_flops": flops}


def check(system, inputs: dict, window: dict) -> tuple[int, int, dict]:
    """(attempted, failed, numbers compared): every stream opened in the
    window is attempted and failed if it raised or gave no audio; a sample of
    the finished ones, with the longest, is held against the references
    after the program is freed."""
    opened = _in_window(window)
    failed = sum(1 for s in opened if s["error"] is not None or not s["chunks"] or not s["done"])
    done = [s for s in window["streams"] if s["done"] and s["error"] is None and s["chunks"]]
    chosen = []
    if done:
        longest = max(range(len(done)), key=lambda i: sum(len(t) for t in done[i]["tokens"]))
        rest = [i for i in range(len(done)) if i != longest]
        pick = inputs["rng"].choice(rest, size=min(len(rest), inputs["sample"] - 1), replace=False) if rest else []
        chosen = [done[i] for i in [longest, *sorted(int(x) for x in pick)]]
    note(f"checking {len(chosen)} of {len(done)} finished streams, "
         f"{sum(len(t) for s in chosen for t in s['tokens'])} served tokens")
    window["streams"] = []
    system.free()
    return len(opened), failed, system.check_streams(chosen, inputs)
