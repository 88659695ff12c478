"""ctypes binding of the native C++ audio loader (csrc/audio_io.cpp at the
root of the repository), the port's copy of fangyan_tts_tpu/data/native.py.

The library is built at first use by g++ (a plain C interface, no PyTorch
headers) into `build/native/` beside the package (listed in .gitignore),
named by a hash of the source and the flags, so an edited source is rebuilt
and nothing under `csrc/` is ever written. The build goes to a temporary
file that is renamed into place, so processes that build at once do not
load a half-written library. Nothing here runs when the module is imported.

Every entry point keeps the JAX package's numpy fallback (host IO with the
same output); `loader()` says which of the two serves.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "audio_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no -march=native (csrc/build.sh has it): a library built on one host may be copied
# with the checkout to another, and must run there
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfangyan_audio_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ or c++) on PATH")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL | None:
    try:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        print(f"⚠️ native audio lib unavailable ({e}); using numpy fallbacks")
        return None
    lib.parse_wav.restype = ctypes.c_int64
    lib.parse_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.resample_poly.restype = ctypes.c_int64
    lib.resample_poly.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.load_wav_batch.restype = None
    lib.load_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int32,
    ]
    return lib


def available() -> bool:
    return _load() is not None


def loader() -> str:
    """Which loader serves the wav files: the native library and its path,
    or the numpy fallback."""
    return f"native C++ ({library_path()})" if available() else "numpy fallback (native library unavailable)"


def parse_wav_bytes(data: bytes, max_seconds: float = 60.0) -> tuple[np.ndarray, int]:
    """WAV container bytes -> (mono float32, sample_rate). Raises on parse error."""
    lib = _load()
    if lib is None:
        from io import BytesIO

        from .audio import read_wav

        return read_wav(BytesIO(data))
    max_out = int(max_seconds * 48000)
    out = np.empty(max_out, np.float32)
    rate = ctypes.c_int32(0)
    n = lib.parse_wav(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_out, ctypes.byref(rate))
    if n < 0:
        raise ValueError("not a parseable WAV buffer")
    return out[:n].copy(), int(rate.value)


def resample_native(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    lib = _load()
    from .audio import _resample_filter, resample_poly as np_resample

    if lib is None:
        return np_resample(x, orig_sr, target_sr)
    if orig_sr == target_sr:
        return np.asarray(x, np.float32)
    g = np.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    h = np.ascontiguousarray(_resample_filter(up, down))
    x = np.ascontiguousarray(x, np.float32)
    out_len = len(x) * up // down
    y = np.empty(out_len, np.float32)
    n = lib.resample_poly(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_len,
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(h),
        up, down,
    )
    return y[:n]


def load_wav_batch(paths: list[str], max_samples: int, threads: int = 8) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parallel batch WAV load -> (audio (B, max_samples) f32, lengths (B,),
    rates (B,)); failed files get length 0."""
    lib = _load()
    out = np.zeros((len(paths), max_samples), np.float32)
    lengths = np.zeros(len(paths), np.int64)
    rates = np.zeros(len(paths), np.int32)
    if lib is None:
        from .audio import read_wav

        for i, p in enumerate(paths):
            try:
                a, sr = read_wav(p)
            except (wave.Error, OSError, EOFError, ValueError):  # an unreadable file gets length 0
                continue
            n = min(len(a), max_samples)
            out[i, :n] = a[:n]
            lengths[i] = n
            rates[i] = sr
        return out, lengths, rates

    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    lib.load_wav_batch(
        arr, len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_samples, threads,
    )
    return out, lengths, rates
