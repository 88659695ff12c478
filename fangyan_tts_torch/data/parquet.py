"""Parquet corpus packing (stage 3) — layout-compatible with
tools/make_parquet_list.py:26-136 (the port's copy of
fangyan_tts_tpu/data/parquet.py).

Each shard `parquet_%09d.tar` (the .tar name is the reference's quirk; the
content is parquet) holds columns: utt, wav, audio_data (raw container
bytes), text, spk, utt_embedding, spk_embedding, speech_token
[+instruct] [+reject_speech_token]. Sidecars utt2parquet/spk2parquet json
maps and data.list / utt2data.list / spk2data.list indices.

File reads (IO-bound) go through a thread pool instead of the reference's
process pool.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def _load_pt(path: str | Path) -> dict:
    import torch

    return torch.load(str(path), map_location="cpu", weights_only=False)


def _as_np(x) -> np.ndarray:
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.asarray(x)


def pack_shard(
    utt_list: list[str],
    maps: dict,
    parquet_file: str,
    utt2parquet_file: str,
    spk2parquet_file: str,
    instruct: bool = False,
    dpo: bool = False,
) -> float:
    # pyarrow directly (not via pandas): no object-column DataFrame round
    # trip, and pyarrow takes numpy arrays without tolist() conversion; the
    # written schema/columns are the reference's
    import pyarrow as pa
    import pyarrow.parquet as pq

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=8) as ex:
        data_list = list(ex.map(lambda u: open(maps["utt2wav"][u], "rb").read(), utt_list))
    spks = [maps["utt2spk"][u] for u in utt_list]
    # duration metadata columns (EXTRA vs the reference schema — its readers
    # ignore unknown columns): lets the LLM training pipeline skip reading
    # audio_data entirely (dataset.parquet_opener column pruning; the filter
    # gate needs only sr/num_samples). 0/0 marks a non-wav container whose
    # duration must come from decoding.
    import wave
    from io import BytesIO

    meta = []
    for b in data_list:
        try:
            with wave.open(BytesIO(b), "rb") as w:
                meta.append((w.getframerate(), w.getnframes()))
        except Exception:  # noqa: BLE001 — non-wav container
            meta.append((0, 0))
    cols = {
        "utt": utt_list,
        "wav": [maps["utt2wav"][u] for u in utt_list],
        "audio_data": pa.array(data_list, type=pa.binary()),
        "sample_rate": np.asarray([m[0] for m in meta], np.int32),
        "num_samples": np.asarray([m[1] for m in meta], np.int32),
        "text": [maps["utt2text"][u] for u in utt_list],
        "spk": spks,
        "utt_embedding": [_as_np(maps["utt2embedding"][u]).astype(np.float32) for u in utt_list],
        "spk_embedding": [_as_np(maps["spk2embedding"][s]).astype(np.float32) for s in spks],
        "speech_token": [_as_np(maps["utt2speech_token"].get(u, [])).astype(np.int64) for u in utt_list],
    }
    if dpo:
        cols["reject_speech_token"] = [_as_np(maps["utt2reject_speech_token"][u]).astype(np.int64) for u in utt_list]
    if instruct:
        cols["instruct"] = [maps["utt2instruct"][u] for u in utt_list]
    # zstd on every column but audio_data, which stays UNCOMPRESSED: 16-bit
    # PCM is near-incompressible, and compressing it would dominate the shard
    # write. Per-column codecs are standard parquet; pyarrow readers
    # (dataset.parquet_opener, the reference's pandas path) read the mix.
    table = pa.table(cols)
    # per-column codecs key on LEAF paths (list columns: "<name>.list.element")
    leaf = lambda name, typ: f"{name}.list.element" if pa.types.is_list(typ) else name
    codecs = {
        leaf(f.name, f.type): ("none" if f.name == "audio_data" else "zstd")
        for f in table.schema
    }
    pq.write_table(table, parquet_file, compression=codecs)
    with open(utt2parquet_file, "w", encoding="utf-8") as f:
        json.dump({u: parquet_file for u in utt_list}, f, ensure_ascii=False, indent=2)
    with open(spk2parquet_file, "w", encoding="utf-8") as f:
        json.dump({s: parquet_file for s in set(spks)}, f, ensure_ascii=False, indent=2)
    return time.time() - t0


def make_parquet_list(
    src_dir: str | Path,
    des_dir: str | Path,
    num_utts_per_parquet: int = 1000,
    instruct: bool = False,
    dpo: bool = False,
) -> list[str]:
    """Full stage-3: read Kaldi dir + .pt artifacts, write shards + lists."""
    from .kaldi_io import read_scp

    src, des = Path(src_dir), Path(des_dir)
    des.mkdir(parents=True, exist_ok=True)
    maps = {
        "utt2wav": read_scp(src / "wav.scp"),
        "utt2text": read_scp(src / "text"),
        "utt2spk": read_scp(src / "utt2spk"),
        "utt2embedding": _load_pt(src / "utt2embedding.pt"),
        "spk2embedding": _load_pt(src / "spk2embedding.pt"),
        "utt2speech_token": _load_pt(src / "utt2speech_token.pt"),
    }
    if instruct:
        maps["utt2instruct"] = read_scp(src / "instruct")
    if dpo:
        maps["utt2reject_speech_token"] = _load_pt(str(src) + "_reject/utt2speech_token.pt")

    utts = list(maps["utt2wav"].keys())
    files = []
    for i, j in enumerate(range(0, len(utts), num_utts_per_parquet)):
        pf = os.path.join(des, f"parquet_{i:09d}.tar")
        uf = os.path.join(des, f"utt2parquet_{i:09d}.json")
        sf = os.path.join(des, f"spk2parquet_{i:09d}.json")
        pack_shard(utts[j : j + num_utts_per_parquet], maps, pf, uf, sf, instruct=instruct, dpo=dpo)
        files.append((pf, uf, sf))
    return make_lists(des, files)


def make_lists(des: str | Path, files: list[tuple[str, str, str]]) -> list[str]:
    """Write data.list / utt2data.list / spk2data.list index files."""
    des = Path(des)
    parquet_list = [pf for pf, _, _ in files]
    for name, entries in (
        ("data.list", parquet_list),
        ("utt2data.list", [uf for _, uf, _ in files]),
        ("spk2data.list", [sf for _, _, sf in files]),
    ):
        with open(des / name, "w", encoding="utf8") as f:
            f.write("".join(e + "\n" for e in entries))
    return parquet_list
