"""Training input pipeline: parquet shards -> processor chain -> padded
device batches.

Behavioral reference: cosyvoice/dataset/{dataset.py,processor.py} —
parquet_opener (:29-50), filter (:53-104), resample+peak-normalize
(:107-132), truncate (:135-153), compute_fbank (:156-181), compute_f0
(:184-206), parse_embedding (:209-224), shuffle(1000)/sort(500) (:248-297),
dynamic_batch by max_frames (:319-346), padding (:360-439), and
DistributedSampler's rank/worker striping (dataset.py:51-104).

The port's copy of fangyan_tts_tpu/data/dataset.py, on the port's
config.LLMConfig and data/lm_plan.py. Differences from the reference kept
from the JAX package:
- mel features are computed PER BATCH over the padded batch by `mel_fn`
  (`make_mel_fn`: ops/mel.matcha_mel on the card) instead of per utterance
  in dataloader workers; the host only decodes and resamples audio.
- batches are padded to bucketed shapes (next multiple of `pad_multiple`),
  so a training step sees a handful of shapes, not one per batch.
- host sharding is by (host_id, num_hosts) over shards + epoch-seeded
  shuffle, made even by construction (drops the ragged tail) — this
  replaces the reference's gloo join-group uneven-data dance
  (train_utils.py:217-235).
"""

from __future__ import annotations

import logging
import random
from io import BytesIO
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..config import LLMConfig
from .audio import read_wav, resample_poly
from .f0 import estimate_f0
from .lm_plan import build_plan, pad_plans_right


def shard_list(items: list, host_id: int, num_hosts: int, epoch: int, shuffle: bool = True) -> list:
    items = list(items)
    if shuffle:
        random.Random(epoch).shuffle(items)
    n_even = len(items) // num_hosts * num_hosts
    return items[host_id:n_even:num_hosts]


def parquet_opener(shards: Iterable[str], drop_audio: bool = False) -> Iterator[dict]:
    """drop_audio=True skips the audio_data column WHEN the shard carries
    the sample_rate/num_samples metadata columns (shards packed by this
    framework do; reference-made shards don't and are read in full). The
    LLM pipeline never touches samples — audio bytes dominate shard size
    (PCM), so pruning turns its shard reads from O(audio) into O(tokens)."""
    import pyarrow.parquet as pq

    for src in shards:
        try:
            pf = pq.ParquetFile(src)
            columns = None
            names = pf.schema_arrow.names
            if drop_audio and "sample_rate" in names and "num_samples" in names:
                columns = [n for n in names if n != "audio_data"]
            for batch in pf.iter_batches(batch_size=64, columns=columns):
                # column-wise .values then per-row dicts: pandas .loc row
                # indexing is slow for PCM-bearing rows
                df = batch.to_pandas()
                cols = {name: df[name].values for name in df.columns}
                for i in range(len(df)):
                    yield {k: v[i] for k, v in cols.items()}
        except Exception as ex:  # noqa: BLE001
            print(f"⚠️ failed to open {src}: {ex}")


def decode_filter(
    data: Iterator[dict],
    max_length: int = 40960,
    min_length: int = 100,
    token_max_length: int = 200,
    token_min_length: int = 1,
    decode_audio: bool = True,
) -> Iterator[dict]:
    """Decode audio bytes + apply the length gates (processor.py:53-104).
    Lengths are in 10ms frames like the reference.

    decode_audio=False reads only the WAV header for the duration gate —
    the LLM pipeline never touches the samples (its collate uses
    text/speech tokens + embedding only), and sample decode + resample
    dominate its host time. Gate decisions are identical either way."""
    import wave

    for s in data:
        try:
            if decode_audio:
                speech, sr = read_wav(BytesIO(s["audio_data"]))
                n = len(speech)
                s["speech"] = speech
            elif int(s.get("sample_rate") or 0) > 0:
                # shard metadata columns (pack_shard): no byte touch at all
                sr, n = int(s["sample_rate"]), int(s["num_samples"])
            else:
                with wave.open(BytesIO(s["audio_data"]), "rb") as w:
                    sr, n = w.getframerate(), w.getnframes()
        except Exception:  # noqa: BLE001 - non-wav container: skip (prep converts to wav)
            continue
        s.pop("audio_data", None)
        s["sample_rate"] = sr
        num_frames = n / sr * 100
        if not (min_length <= num_frames <= max_length):
            continue
        if not (token_min_length <= len(s["text_token"]) <= token_max_length):
            continue
        if len(s["speech_token"]) == 0:
            continue
        if "reject_speech_token" in s and len(s["reject_speech_token"]) == 0:
            continue
        yield s


def tokenize(data: Iterator[dict], tokenizer) -> Iterator[dict]:
    """processor.py:227-245: text + optional instruct -> token ids."""
    for s in data:
        s["text_token"] = np.asarray(tokenizer.encode(s["text"]), np.int32)
        if "instruct" in s and isinstance(s["instruct"], str):
            s["instruct_token"] = np.asarray(tokenizer.encode(s["instruct"]), np.int32)
        yield s


def resample(data: Iterator[dict], resample_rate: int = 24000, min_sample_rate: int = 16000) -> Iterator[dict]:
    for s in data:
        if s["sample_rate"] != resample_rate:
            if s["sample_rate"] < min_sample_rate:
                continue
            if "speech" in s:
                s["speech"] = resample_poly(s["speech"], s["sample_rate"], resample_rate)
            s["sample_rate"] = resample_rate
        if "speech" in s:  # header-only rows (llm mode) carry no samples
            peak = np.abs(s["speech"]).max()
            if peak > 1.0:
                s["speech"] = s["speech"] / peak * 0.9
        yield s


def truncate(data: Iterator[dict], truncate_length: int = 24960) -> Iterator[dict]:
    """processor.py:135-153: random crop / right-pad to fixed length (GAN)."""
    for s in data:
        wav = s["speech"]
        if len(wav) > truncate_length:
            start = random.randint(0, len(wav) - truncate_length)
            s["speech"] = wav[start : start + truncate_length]
        else:
            s["speech"] = np.pad(wav, (0, truncate_length - len(wav)))
        yield s


def parse_embedding(data: Iterator[dict], normalize: bool = True, use_spk_embedding: bool = False) -> Iterator[dict]:
    for s in data:
        emb = np.asarray(s["spk_embedding" if use_spk_embedding else "utt_embedding"], np.float32)
        if normalize:
            emb = emb / max(np.linalg.norm(emb), 1e-12)
        s["embedding"] = emb
        yield s


def shuffle(data: Iterator[dict], shuffle_size: int = 1000, seed: int = 0) -> Iterator[dict]:
    rng = random.Random(seed)
    buf: list[dict] = []
    for s in data:
        buf.append(s)
        if len(buf) >= shuffle_size:
            rng.shuffle(buf)
            yield from buf
            buf = []
    rng.shuffle(buf)
    yield from buf


def sort_by_frames(data: Iterator[dict], sort_size: int = 500) -> Iterator[dict]:
    buf: list[dict] = []

    def key(s):
        return len(s["speech"]) if "speech" in s else len(s["speech_token"])

    for s in data:
        buf.append(s)
        if len(buf) >= sort_size:
            buf.sort(key=key)
            yield from buf
            buf = []
    buf.sort(key=key)
    yield from buf


def dynamic_batch(data: Iterator[dict], max_frames_in_batch: int = 2000, hop: int = 480) -> Iterator[list[dict]]:
    """Batch until padded mel frames exceed the cap (processor.py:319-346)."""
    buf: list[dict] = []
    longest = 0

    def frames(s):
        return len(s["speech"]) // hop if "speech" in s else len(s["speech_token"]) * 2

    for s in data:
        f = frames(s)
        longest = max(longest, f)
        if longest * (len(buf) + 1) > max_frames_in_batch and buf:
            yield buf
            buf, longest = [s], f
        else:
            buf.append(s)
    if buf:
        yield buf


def _round_up(n: int, m: int) -> int:
    return max((n + m - 1) // m * m, m)


# per-key padding values for stacked microbatches: loss-masked targets pad
# with IGNORE_ID, length fields pad with 0 rows (masked everywhere), data 0
_STACK_PAD = {"targets": -1, "lengths": 0, "token_len": 0, "feat_len": 0}


def stack_microbatches(batches: Iterator[dict], accum: int) -> Iterator[dict]:
    """Group `accum` consecutive collated batches into ONE stacked batch
    with a leading (accum,) microbatch dim, padding each to the group's max
    (B, L) so train steps with in-step grad accumulation
    (trainer.make_*_train_step(accum=...)) see a fixed-shape stack. Pad
    rows carry lengths=0 / targets=IGNORE_ID, so they contribute nothing
    to the loss (llm.py forward masks by lengths; flow masks by feat_len).
    A sub-`accum` epoch remainder is DROPPED (logged) — the reference's
    accum loop likewise only steps the optimizer on full accum windows
    (train_utils.py:277-288) and its join-group tolerates uneven tails."""
    group: list[dict] = []
    dropped = 0
    for b in batches:
        group.append(b)
        if len(group) < accum:
            continue
        keys = group[0].keys()
        stacked = {}
        for k in keys:
            arrs = [np.asarray(g[k]) for g in group]
            shape = tuple(max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim))
            fill = _STACK_PAD.get(k, 0)
            out = np.full((accum, *shape), fill, arrs[0].dtype)
            for i, a in enumerate(arrs):
                out[(i, *map(slice, a.shape))] = a
            stacked[k] = out
        yield stacked
        group = []
    if group:
        dropped = len(group)
        logging.info("stack_microbatches: dropped %d sub-accum tail microbatches", dropped)


def make_mel_fn(device: str | torch.device | None = None) -> Callable:
    """`mel_fn` for the flow and hifigan collates: (B, T) float32 numpy audio
    at 24 kHz -> (B, 80, T // 480) float32 numpy, ops/mel.matcha_mel on
    `device` (CUDA unless the caller asks for the CPU)."""
    from ..ops.device import exact_fp32, resolve_device
    from ..ops.mel import matcha_mel

    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_fp32()

    @torch.inference_mode()
    def fn(audio: np.ndarray) -> np.ndarray:
        return matcha_mel(torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)).cpu().numpy()

    return fn


def collate_llm(batch: list[dict], cfg: LLMConfig, bistream_prob: float = 0.5, pad_multiple: int = 64, seed: int = 0, rng: random.Random | None = None) -> dict:
    """Batch -> padded LM training plans (llm.py:670-711 sequence layout).

    Pass a persistent `rng` so the bistream/unistream coin flip is fresh per
    sample across batches (matching the reference's per-sample
    random.random() < 0.5); seeding per-call would correlate same-size batches.
    """
    rng = rng if rng is not None else random.Random(seed)
    plans = [
        build_plan(
            cfg,
            s["text_token"].tolist(),
            np.asarray(s["speech_token"], np.int32).tolist(),
            instruct=s.get("instruct_token", np.zeros(0, np.int32)).tolist(),
            bistream=rng.random() < bistream_prob,
        )
        for s in batch
    ]
    length = _round_up(max(len(p.ids) for p in plans), pad_multiple)
    return pad_plans_right(plans, length)


def collate_flow(batch: list[dict], mel_fn: Callable, token_mel_ratio: int = 2, hop: int = 480, pad_multiple: int = 128) -> dict:
    """Batch -> flow training arrays; mel computed batched on device via
    `mel_fn((B, T) padded audio) -> (B, n_mels, T//hop)`."""
    t_max = _round_up(max(len(s["speech"]) for s in batch), pad_multiple * hop)
    audio = np.zeros((len(batch), t_max), np.float32)
    feat_len = np.zeros(len(batch), np.int32)
    for i, s in enumerate(batch):
        n = len(s["speech"]) // hop * hop
        audio[i, :n] = s["speech"][:n]
        feat_len[i] = n // hop
    mel = np.asarray(mel_fn(audio)).transpose(0, 2, 1)  # (B, L, 80)

    lt_max = mel.shape[1] // token_mel_ratio
    token = np.zeros((len(batch), lt_max), np.int32)
    token_len = np.zeros(len(batch), np.int32)
    emb = np.zeros((len(batch), 192), np.float32)
    for i, s in enumerate(batch):
        tok = np.asarray(s["speech_token"], np.int32)
        # trim to 2:1 alignment (processor.py:173-177)
        tl = min(feat_len[i] // token_mel_ratio, len(tok))
        token[i, :tl] = tok[:tl]
        token_len[i] = tl
        feat_len[i] = tl * token_mel_ratio
        emb[i] = s["embedding"]
    return {"token": token, "token_len": token_len, "feat": mel, "feat_len": feat_len, "embedding": emb}


def collate_hifigan(batch: list[dict], mel_fn: Callable, hop: int = 480, sample_rate: int = 24000) -> dict:
    """Batch -> GAN training arrays (audio fixed-length from truncate)."""
    t = len(batch[0]["speech"])
    audio = np.stack([s["speech"] for s in batch]).astype(np.float32)
    mel = np.asarray(mel_fn(audio)).transpose(0, 2, 1)
    pitch = np.stack([estimate_f0(s["speech"], sample_rate, hop) for s in batch]).astype(np.float32)
    return {"speech": audio, "speech_feat": mel, "pitch_feat": pitch}


def build_pipeline(
    data_list_path: str,
    tokenizer,
    mel_fn: Callable,
    mode: str = "llm",  # llm | flow | hifigan
    llm_cfg: LLMConfig | None = None,
    host_id: int = 0,
    num_hosts: int = 1,
    epoch: int = 0,
    max_frames_in_batch: int = 2000,
    use_spk_embedding: bool = False,
    shuffle_size: int = 1000,
    sort_size: int = 500,
) -> Iterator[dict]:
    """Full chain mirroring conf data_pipeline (cosyvoice3.yaml:169-194)."""
    with open(data_list_path, encoding="utf-8") as f:
        shards = [line.strip() for line in f if line.strip()]
    shards = shard_list(shards, host_id, num_hosts, epoch) or shards[host_id::num_hosts]

    it: Any = parquet_opener(shards, drop_audio=(mode == "llm"))
    it = tokenize(it, tokenizer)
    # llm collate never reads samples: header-only duration gating skips
    # the decode + scipy resample that dominate the llm pipeline's host time
    it = decode_filter(it, decode_audio=(mode != "llm"))
    it = resample(it)
    if mode == "hifigan":
        it = truncate(it)
    it = parse_embedding(it, use_spk_embedding=use_spk_embedding)
    it = shuffle(it, shuffle_size, seed=epoch)
    it = sort_by_frames(it, sort_size)
    collate_rng = random.Random(epoch)
    for batch in dynamic_batch(it, max_frames_in_batch):
        if mode == "llm":
            yield collate_llm(batch, llm_cfg, rng=collate_rng)
        elif mode == "flow":
            yield collate_flow(batch, mel_fn)
        elif mode == "hifigan":
            yield collate_hifigan(batch, mel_fn)
        else:
            raise ValueError(mode)
