"""Batched feature extraction on the card: speaker embeddings (stage 1),
speech tokens (stage 2), and stages 1+2+3 in one pipelined pass (the port
of fangyan_tts_tpu/data/extract.py).

Utterances are bucketed by length (1-30 s), zero-padded, and each batch goes
to the device once as int16 (wavs are 16-bit on disk, so the round trip is
lossless and the copy half the bytes of float32); the features are made
there (`embed_features`: the kaldi fbank with the masked mean subtraction
for CAM++; `token_features`: the whisper log-mel for S3) and fed to the
models. The host copy of a batch is pinned and copied without waiting, and
up to MAX_INFLIGHT batches are enqueued before the oldest one's results are
read back, so the copy and the host's work on the next batch overlap the
device's work on this one.

Everything runs on `device`, CUDA unless the caller asks for the CPU. The
outputs keep the reference's artifact formats: utt2embedding.pt /
spk2embedding.pt / utt2speech_token.pt (torch.save dicts of CPU tensors),
and prepare_corpus's parquet shards, json sidecars and data.list files, so
downstream packing and training recipes are drop-in compatible.

`extract_all` and `prepare_corpus` raise, before they write or pack
anything, when `load_utts` could not read an utterance of wav.scp (naming
every such utterance), where the JAX package drops it and returns a partial
result (a shard holding it, and every later shard, would never be packed).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..ops.device import exact_fp32, resolve_device
from ..ops.mel import kaldi_fbank, whisper_logmel
from .audio import load_audio
from .kaldi_io import read_scp

_BUCKETS_SEC = (1, 2, 3, 4, 5, 6, 8, 10, 15, 20, 30)
SAMPLE_RATE = 16000
# Batches enqueued on the device before the oldest one is read back. The
# window bounds device memory to a few padded batches and their activations.
MAX_INFLIGHT = 4


def _bucket_len(n: int, sr: int) -> int:
    for b in _BUCKETS_SEC:
        if n <= b * sr:
            return b * sr
    return _BUCKETS_SEC[-1] * sr


def _batched_buckets(utts: list[tuple[str, np.ndarray]], sr: int, batch_size: int):
    """Group (utt, audio) by padded bucket length; yield (names, int16 (B,
    bucket) padded audio, int32 (B,) lengths) batches."""
    buckets: dict[int, list[tuple[str, np.ndarray]]] = defaultdict(list)
    for utt, audio in utts:
        audio = audio[: _BUCKETS_SEC[-1] * sr]  # 30 s guard (extract_speech_token.py:36)
        buckets[_bucket_len(len(audio), sr)].append((utt, audio))
    for blen, items in sorted(buckets.items()):
        for i in range(0, len(items), batch_size):
            chunk = items[i : i + batch_size]
            pad = np.zeros((len(chunk), blen), np.int16)
            lens = np.zeros((len(chunk),), np.int32)
            names = []
            for j, (utt, audio) in enumerate(chunk):
                pad[j, : len(audio)] = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
                lens[j] = len(audio)
                names.append(utt)
            yield names, pad, lens


def load_utts(wav_scp: dict[str, str], target_sr: int = SAMPLE_RATE, progress: bool = True) -> list[tuple[str, np.ndarray]]:
    """Corpus loader. WAV files go through the native multithreaded C++
    loader (data/native.py, 8 decode threads) in bounded-memory chunks;
    anything else (or a file the native parser rejects) falls back to the
    python/ffmpeg path. Prints which loader served the wavs."""
    from . import native

    items = list(wav_scp.items())
    out: list[tuple[str, np.ndarray]] = []
    t0 = time.time()

    def _fallback(utt: str, path: str) -> None:
        try:
            audio, _ = load_audio(path, target_sr=target_sr)
            out.append((utt, audio))
        except Exception as e:  # noqa: BLE001 - a file that cannot be read is skipped and reported
            print(f"  ⚠️ failed to load {utt}: {e}")

    wavs = [(u, p) for u, p in items if p.lower().endswith(".wav")]
    rest = [(u, p) for u, p in items if not p.lower().endswith(".wav")]

    def _tick() -> None:
        if progress and len(out) and len(out) % 500 == 0:
            print(f"  loaded {len(out)}/{len(items)} ({len(out) / (time.time() - t0):.1f}/s)")

    if wavs:
        print(f"  audio loader: {native.loader()}")
    if wavs and native.available():
        # the native parser caps at max_samples; extraction cuts at 30 s
        # anyway (_batched_buckets), but a capped file is reported
        max_samples = 31 * 48000  # 30 s guard + headroom at up to 48 kHz sources
        chunk_rows = 32  # bounds the staging buffer to about 190 MB
        for i in range(0, len(wavs), chunk_rows):
            chunk = wavs[i : i + chunk_rows]
            audio, lengths, rates = native.load_wav_batch([p for _, p in chunk], max_samples)
            for j, (utt, path) in enumerate(chunk):
                n, sr = int(lengths[j]), int(rates[j])
                if n <= 0:  # non-PCM/exotic wav: python/ffmpeg fallback
                    _fallback(utt, path)
                    continue
                if n == max_samples:
                    print(f"  ⚠️ {utt} capped at {max_samples / sr:.0f}s by the native loader")
                # copy: audio[j, :n] is a view that would keep the whole
                # staging buffer alive as long as the row is referenced
                a = audio[j, :n].copy()
                if sr != target_sr:
                    a = native.resample_native(a, sr, target_sr)
                out.append((utt, a))
                _tick()
    else:
        for utt, path in wavs:
            _fallback(utt, path)
            _tick()
    for utt, path in rest:
        _fallback(utt, path)
        _tick()
    return out


def load_all_utts(wav_scp: dict[str, str], target_sr: int = SAMPLE_RATE) -> list[tuple[str, np.ndarray]]:
    """load_utts, raising if any utterance of `wav_scp` could not be read."""
    utts = load_utts(wav_scp, target_sr)
    missing = sorted(set(wav_scp) - {u for u, _ in utts})
    if missing:
        raise RuntimeError(f"{len(missing)} of {len(wav_scp)} utterances could not be read, so the corpus would "
                           f"be partial: {', '.join(missing)}")
    return utts


def embed_features(pad: torch.Tensor, lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int16 (B, T) padded audio, (B,) lengths -> (the kaldi fbank (B, F, 80)
    with the mean over each row's valid frames subtracted and the pad frames
    zeroed (extract_embedding.py:33), the valid frame counts (B,))."""
    feats = kaldi_fbank(pad.float() / 32768.0)
    frame_len = torch.clamp((lens - 400) // 160 + 1, min=1)
    mask = (torch.arange(feats.shape[1], device=feats.device)[None, :] < frame_len[:, None])[..., None]
    mean = (feats * mask).sum(dim=1, keepdim=True) / frame_len[:, None, None]
    return (feats - mean) * mask, frame_len


def token_features(pad: torch.Tensor, lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int16 (B, T) padded audio, (B,) lengths -> (the whisper log-mel (B,
    128, T // 160), the valid mel frames (B,))."""
    return whisper_logmel(pad.float() / 32768.0), lens // 160


def fused(emb_apply: Callable, tok_apply: Callable) -> Callable:
    """One function per batch (the counterpart of the JAX package's fused
    program, bench.py:153-166): (pad, lens) on the device -> (x-vectors (B,
    192), codes (B, T'), code lengths (B,)), features, CAM++ and S3 from
    the one upload."""

    @torch.inference_mode()
    def fn(pad: torch.Tensor, lens: torch.Tensor):
        feats, frame_len = embed_features(pad, lens)
        mel, mel_len = token_features(pad, lens)
        return (emb_apply(feats, frame_len), *tok_apply(mel, mel_len))

    return fn


def _pipelined(utts: list, step: Callable, device: torch.device, batch_size: int, on_batch: Callable,
               between: Callable | None = None) -> None:
    """Run `step(pad, lens)` (device tensors -> a tuple of device tensors) on
    every padded batch of `utts` with up to MAX_INFLIGHT batches in flight;
    `on_batch(names, *numpy outputs)` takes each batch's results in order,
    and `between()` runs on the host after each drain inside the loop, while
    the batches still in flight keep the device busy."""
    inflight: deque = deque()

    def drain() -> None:
        names, _host, outs = inflight.popleft()  # _host: the pinned buffers, released only now
        on_batch(names, *(o.float().cpu().numpy() if o.is_floating_point() else o.cpu().numpy() for o in outs))

    for names, pad, lens in _batched_buckets(utts, SAMPLE_RATE, batch_size):
        host = torch.from_numpy(pad), torch.from_numpy(lens)
        if device.type == "cuda":
            host = tuple(t.pin_memory() for t in host)
        with torch.inference_mode():
            outs = step(*(t.to(device, non_blocking=True) for t in host))
        inflight.append((names, host, outs))
        if len(inflight) >= MAX_INFLIGHT:
            drain()
            if between is not None:
                between()
    while inflight:
        drain()


def _device(device: str | torch.device | None) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_fp32()  # the fbank's and mel's DFT products need float32, not TF32
    return dev


def _spk_means(utt2emb: dict, utt2spk: dict) -> dict[str, np.ndarray]:
    spk_lists: dict[str, list[np.ndarray]] = defaultdict(list)
    for utt, emb in utt2emb.items():
        spk_lists[utt2spk.get(utt, "unk")].append(emb)
    return {spk: np.mean(np.stack(v), axis=0) for spk, v in spk_lists.items()}


def _torch_save(obj: dict, path) -> None:
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in obj.items()}, str(path))


def extract_embeddings(
    data_dir: str | Path,
    apply_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    batch_size: int = 64,
    device: str | torch.device | None = None,
) -> dict[str, np.ndarray]:
    """Stage 1: wav.scp -> utt2embedding.pt + spk2embedding.pt.

    apply_fn(fbank (B, T, 80), frame_len (B,)) -> (B, 192) x-vectors (e.g.
    infer/frontend.make_campplus_fn's function, which ignores frame_len)."""
    dev = _device(device)
    data_dir = Path(data_dir)
    utt2spk = read_scp(data_dir / "utt2spk")
    utts = load_utts(read_scp(data_dir / "wav.scp"))

    utt2emb: dict[str, np.ndarray] = {}

    def step(pad, lens):
        return (apply_fn(*embed_features(pad, lens)),)

    def on_batch(names, embs):
        for utt, e in zip(names, embs):
            utt2emb[utt] = e.astype(np.float32)

    _pipelined(utts, step, dev, batch_size, on_batch)
    _torch_save(utt2emb, data_dir / "utt2embedding.pt")
    _torch_save(_spk_means(utt2emb, utt2spk), data_dir / "spk2embedding.pt")
    return utt2emb


def extract_speech_tokens(
    data_dir: str | Path,
    apply_fn: Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    batch_size: int = 32,
    device: str | torch.device | None = None,
) -> dict[str, np.ndarray]:
    """Stage 2: wav.scp -> utt2speech_token.pt.

    apply_fn(mel (B, 128, T), mel_len (B,)) -> (codes (B, T'), code_len (B,))
    (e.g. infer/frontend.make_s3_fn's function)."""
    dev = _device(device)
    data_dir = Path(data_dir)
    utts = load_utts(read_scp(data_dir / "wav.scp"))

    utt2tok: dict[str, np.ndarray] = {}

    def step(pad, lens):
        return apply_fn(*token_features(pad, lens))

    def on_batch(names, codes, code_len):
        for i, utt in enumerate(names):
            utt2tok[utt] = codes[i, : code_len[i]].astype(np.int32)

    _pipelined(utts, step, dev, batch_size, on_batch)
    _torch_save(utt2tok, data_dir / "utt2speech_token.pt")
    return utt2tok


def extract_all(
    data_dir: str | Path,
    emb_apply: Callable,
    tok_apply: Callable,
    batch_size: int = 64,
    device: str | torch.device | None = None,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Stages 1+2 in ONE pass: the corpus is loaded once and each padded
    batch is uploaded once, feeding both CAM++ and S3 (the separate CLIs
    each load and upload the corpus), through `fused(emb_apply, tok_apply)`.
    Writes the same utt2embedding.pt / spk2embedding.pt / utt2speech_token.pt
    artifacts as the two stages. Raises when a wav cannot be read
    (load_all_utts)."""
    dev = _device(device)
    data_dir = Path(data_dir)
    utt2spk = read_scp(data_dir / "utt2spk")
    utts = load_all_utts(read_scp(data_dir / "wav.scp"))

    utt2emb: dict[str, np.ndarray] = {}
    utt2tok: dict[str, np.ndarray] = {}

    def on_batch(names, embs, codes, code_len):
        for i, utt in enumerate(names):
            utt2emb[utt] = embs[i].astype(np.float32)
            utt2tok[utt] = codes[i, : code_len[i]].astype(np.int32)

    _pipelined(utts, fused(emb_apply, tok_apply), dev, batch_size, on_batch)
    _torch_save(utt2emb, data_dir / "utt2embedding.pt")
    _torch_save(_spk_means(utt2emb, utt2spk), data_dir / "spk2embedding.pt")
    _torch_save(utt2tok, data_dir / "utt2speech_token.pt")
    return utt2emb, utt2tok


def prepare_corpus(
    data_dir: str | Path,
    des_dir: str | Path,
    emb_apply: Callable,
    tok_apply: Callable,
    batch_size: int = 64,
    num_utts_per_parquet: int = 1000,
    instruct: bool = False,
    device: str | torch.device | None = None,
) -> list[str]:
    """Stages 1+2+3 as ONE pipelined pass.

    A parquet shard is packed as soon as every utterance it contains is
    extracted AND every speaker appearing in it has its mean embedding
    complete (kaldi convention orders utterances speaker-major, so early
    shards complete while later buckets are still on the device). Packing
    runs on the main thread between batch drains, while the batches still
    in flight keep the device busy. Artifacts are the same as running
    extract_all then parquet.make_parquet_list: the same .pt maps, shards,
    json sidecars and data.list files (reference pipeline:
    examples/dialect/cosyvoice3/run.sh:23-88). Returns the shard paths.
    Raises, before anything is packed, when a wav cannot be read
    (load_all_utts)."""
    from .parquet import make_lists, pack_shard

    dev = _device(device)
    data_dir, des = Path(data_dir), Path(des_dir)
    des.mkdir(parents=True, exist_ok=True)
    wav_scp = read_scp(data_dir / "wav.scp")
    utt2spk = read_scp(data_dir / "utt2spk")
    maps: dict = {
        "utt2wav": dict(wav_scp),
        "utt2text": read_scp(data_dir / "text"),
        "utt2spk": dict(utt2spk),
        "utt2embedding": {},
        "spk2embedding": {},
        "utt2speech_token": {},
    }
    if instruct:
        maps["utt2instruct"] = read_scp(data_dir / "instruct")

    utt_order = list(wav_scp.keys())
    shards = [utt_order[j : j + num_utts_per_parquet]
              for j in range(0, len(utt_order), num_utts_per_parquet)]
    spk_pending: dict[str, int] = defaultdict(int)
    spk_sum: dict[str, np.ndarray] = {}
    spk_n: dict[str, int] = defaultdict(int)
    for u in utt_order:
        spk_pending[utt2spk.get(u, "unk")] += 1
    shard_utts_left = [set(s) for s in shards]
    shard_spks_left = [{utt2spk.get(u, "unk") for u in s} for s in shards]
    next_shard = 0
    files: list[tuple[str, str, str]] = []

    def pack_ready() -> None:
        nonlocal next_shard
        while (next_shard < len(shards)
               and not shard_utts_left[next_shard]
               and not shard_spks_left[next_shard]):
            i = next_shard
            pf = os.path.join(des, f"parquet_{i:09d}.tar")
            uf = os.path.join(des, f"utt2parquet_{i:09d}.json")
            sf = os.path.join(des, f"spk2parquet_{i:09d}.json")
            files.append((pf, uf, sf))
            pack_shard(shards[i], maps, pf, uf, sf, instruct=instruct)
            next_shard += 1

    def utt_done(utt: str, emb: np.ndarray, toks: np.ndarray) -> None:
        maps["utt2embedding"][utt] = emb
        maps["utt2speech_token"][utt] = toks
        spk = utt2spk.get(utt, "unk")
        spk_sum[spk] = emb + spk_sum.get(spk, 0.0)
        spk_n[spk] += 1
        spk_pending[spk] -= 1
        if spk_pending[spk] == 0:
            maps["spk2embedding"][spk] = (spk_sum[spk] / spk_n[spk]).astype(np.float32)
            for left in shard_spks_left:
                left.discard(spk)
        for left in shard_utts_left:
            if utt in left:
                left.discard(utt)
                break

    def on_batch(names, embs, codes, code_len):
        for i, utt in enumerate(names):
            utt_done(utt, embs[i].astype(np.float32), codes[i, : code_len[i]].astype(np.int32))

    utts = load_all_utts(wav_scp)
    _pipelined(utts, fused(emb_apply, tok_apply), dev, batch_size, on_batch, between=pack_ready)
    pack_ready()

    _torch_save(maps["utt2embedding"], data_dir / "utt2embedding.pt")
    _torch_save(maps["spk2embedding"], data_dir / "spk2embedding.pt")
    _torch_save(maps["utt2speech_token"], data_dir / "utt2speech_token.pt")
    return make_lists(des, files)
