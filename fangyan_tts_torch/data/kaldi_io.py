"""Kaldi-format corpus files: wav.scp / text / utt2spk / spk2utt / instruct
(the port's copy of fangyan_tts_tpu/data/kaldi_io.py).

Byte-compatible with the layouts produced by the reference's dataset
generators (generate_dialect_dataset.py:619-669, generate_esd_dataset.py:107-131)
and consumed by its training recipes.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from pathlib import Path
from typing import Iterable, Mapping

REQUIRED_FILES = ("wav.scp", "text", "utt2spk", "spk2utt")
OPTIONAL_FILES = ("instruct", "utt2embedding.pt", "spk2embedding.pt", "utt2speech_token.pt")


def read_scp(path: str | Path) -> "OrderedDict[str, str]":
    """key<space>value-per-line files (wav.scp, utt2spk, instruct, text —
    for text/instruct the value may contain spaces)."""
    out: OrderedDict[str, str] = OrderedDict()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(maxsplit=1)
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def write_scp(path: str | Path, items: Mapping[str, str] | Iterable[tuple[str, str]]) -> int:
    it = items.items() if hasattr(items, "items") else items
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for k, v in it:
            f.write(f"{k} {v}\n")
            n += 1
    return n


def read_spk2utt(path: str | Path) -> "OrderedDict[str, list[str]]":
    out: OrderedDict[str, list[str]] = OrderedDict()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                out.setdefault(parts[0], []).extend(parts[1:])
    return out


def write_spk2utt(path: str | Path, spk2utt: Mapping[str, list[str]]) -> int:
    with open(path, "w", encoding="utf-8") as f:
        for spk, utts in spk2utt.items():
            f.write(f"{spk} {' '.join(utts)}\n")
    return len(spk2utt)


def spk2utt_from_utt2spk(utt2spk: Mapping[str, str]) -> "OrderedDict[str, list[str]]":
    out: OrderedDict[str, list[str]] = OrderedDict()
    for utt, spk in utt2spk.items():
        out.setdefault(spk, []).append(utt)
    return out


def write_kaldi_dir(
    out_dir: str | Path,
    wav_scp: Mapping[str, str],
    text: Mapping[str, str],
    utt2spk: Mapping[str, str],
    instruct: Mapping[str, str] | None = None,
) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_scp(out / "wav.scp", wav_scp)
    write_scp(out / "text", text)
    write_scp(out / "utt2spk", utt2spk)
    write_spk2utt(out / "spk2utt", spk2utt_from_utt2spk(utt2spk))
    if instruct is not None:
        write_scp(out / "instruct", instruct)


def validate_dir(data_dir: str | Path) -> dict:
    """Integrity check mirroring prepare_training_data.py:423-455: required
    vs optional file presence + line counts."""
    data_dir = Path(data_dir)
    result: dict = {"name": data_dir.name, "valid": True, "line_counts": {}}
    for fname in REQUIRED_FILES:
        p = data_dir / fname
        exists = p.exists()
        result[fname] = exists
        if exists:
            with open(p, "r", encoding="utf-8") as f:
                result["line_counts"][fname] = sum(1 for _ in f)
        else:
            result["valid"] = False
    for fname in OPTIONAL_FILES:
        result[fname] = (data_dir / fname).exists()
    return result


def list_dialect_dirs(dataset_dir: str | Path, exclude: tuple[str, ...] = ("combined",)) -> list[str]:
    """Subdirectories containing a `text` file (prepare_training_data.py:458-467)."""
    dataset_dir = Path(dataset_dir)
    out = []
    if dataset_dir.exists():
        for item in sorted(os.listdir(dataset_dir)):
            p = dataset_dir / item
            if p.is_dir() and not item.startswith(".") and item not in exclude and (p / "text").exists():
                out.append(item)
    return out
