"""Host-side audio I/O and resampling (fangyan_tts_tpu/data/audio.py).

WAV read and write with the standard library's `wave` and numpy; anything
else is decoded by an ffmpeg subprocess; durations of other containers by
mutagen, else pydub, else ffprobe (each imported or looked up only when a
non-wav file asks); MP3 (or anything) to 16 kHz wav by ffmpeg; polyphase
resampling with a Kaiser-windowed sinc filter through scipy's overlap-add
convolution.
"""

from __future__ import annotations

import functools
import shutil
import struct
import subprocess
import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """(float32 samples, sample rate); channels are averaged to mono.
    PCM 8/16/24/32. `path` may be a path or a binary file object."""
    src = path if hasattr(path, "read") else str(path)
    with wave.open(src, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def write_wav(path: str | Path, data: np.ndarray, sr: int) -> None:
    """float32 [-1, 1] mono -> PCM16 wav."""
    pcm = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def wav_duration(path: str | Path) -> float:
    with wave.open(str(path), "rb") as w:
        return w.getnframes() / float(w.getframerate())


@functools.lru_cache(maxsize=1)
def _duration_backend() -> str:
    try:
        import mutagen  # noqa: F401

        return "mutagen"
    except ImportError:
        pass
    try:
        import pydub  # noqa: F401

        return "pydub"
    except ImportError:
        pass
    if shutil.which("ffprobe"):
        return "ffprobe"
    return "wave-only"


def audio_duration(path: str | Path) -> float:
    """Duration in seconds, 0.0 on failure (stats_duration.py backend chain)."""
    p = str(path)
    if p.lower().endswith(".wav"):
        try:
            return wav_duration(p)
        except (wave.Error, OSError, EOFError, struct.error):
            pass
    backend = _duration_backend()
    try:
        if backend == "mutagen":
            import mutagen

            m = mutagen.File(p)
            return float(m.info.length) if m is not None else 0.0
        if backend == "pydub":
            from pydub import AudioSegment

            return len(AudioSegment.from_file(p)) / 1000.0
        if backend == "ffprobe":
            out = subprocess.run(
                ["ffprobe", "-v", "error", "-show_entries", "format=duration", "-of", "csv=p=0", p],
                capture_output=True, timeout=30,
            )
            return float(out.stdout.decode().strip()) if out.returncode == 0 else 0.0
    except Exception:  # noqa: BLE001 - any unreadable file counts as a failed one, as in the reference
        return 0.0
    return 0.0


def ffmpeg_to_wav16k(src: str | Path, dst: str | Path, sr: int = 16000, timeout: int = 30) -> tuple[bool, str]:
    """MP3/any -> mono 16k pcm_s16le WAV (prepare_training_data.py:96-117)."""
    if Path(dst).exists():
        return True, str(dst)
    try:
        r = subprocess.run(
            ["ffmpeg", "-y", "-i", str(src), "-ar", str(sr), "-ac", "1", "-acodec", "pcm_s16le", str(dst)],
            capture_output=True, timeout=timeout,
        )
        if r.returncode == 0:
            return True, str(dst)
        return False, f"FFmpeg error: {r.stderr.decode()[:100]}"
    except (OSError, subprocess.SubprocessError) as e:
        return False, str(e)


def load_audio(path: str | Path, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """A wav is read directly, anything else through ffmpeg; resampled to
    `target_sr` when given."""
    p = str(path)
    if p.lower().endswith(".wav"):
        data, sr = read_wav(p)
    else:
        if not shutil.which("ffmpeg"):
            raise RuntimeError(f"need ffmpeg to decode {p}")
        sr = target_sr or 16000
        r = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", p, "-f", "f32le", "-ac", "1", "-ar", str(sr), "-"],
            capture_output=True, timeout=120,
        )
        if r.returncode != 0:
            raise RuntimeError(f"ffmpeg decode failed: {r.stderr.decode()[:200]}")
        return np.frombuffer(r.stdout, dtype="<f4").copy(), sr
    if target_sr is not None and sr != target_sr:
        data = resample_poly(data, sr, target_sr)
        sr = target_sr
    return data, sr


@functools.lru_cache(maxsize=None)
def _resample_filter(up: int, down: int, num_zeros: int = 16, beta: float = 14.769656459379492):
    """Kaiser-windowed sinc lowpass for polyphase resampling, normalised so
    each polyphase branch has unit DC gain."""
    cutoff = 0.5 * min(1.0, up / down)
    half = num_zeros * max(up, down)
    t = (np.arange(-half, half + 1, dtype=np.float64)) / up
    sinc = 2 * cutoff * np.sinc(2 * cutoff * t)
    window = np.kaiser(2 * half + 1, beta)
    h = sinc * window
    h *= up / h.sum()
    return h.astype(np.float32)


def resample_poly(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample: zero-stuff by `up`, filter ("same" mode, by
    scipy's overlap-add convolution), keep every `down`-th sample."""
    if orig_sr == target_sr:
        return x
    g = np.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    h = _resample_filter(up, down)
    from scipy.signal import oaconvolve

    n = len(x)
    xe = np.zeros(n * up, np.float32)
    xe[::up] = x
    y = oaconvolve(xe, h, mode="same")
    return y[::down].astype(np.float32)
