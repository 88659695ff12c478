"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled at first use
by `nvcc` for sm_90a into its own shared library under `build/kernels/`
(beside the package, listed in .gitignore), named by a hash of the source
and the flags, and loaded with ctypes. Only the sources in the checkout are
used. `build_all` starts one nvcc per source at once. Nothing here runs
when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("decode_attention", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_fns: dict = {}  # loaded C entry points by source name
build_logs: dict[str, str] = {}  # nvcc's output (ptxas register / spill report) per built source

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "decode_attention": ("fangyan_decode_attention", [_P] * 9 + [ctypes.c_longlong] + [_I] * 6 + [_P]),
    "flash_attention": ("fangyan_chunk_flash_attention", [_P] * 5 + [_I] * 5 + [_P]),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    so = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, so = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, so)


def build_all(names: tuple[str, ...] = SOURCES) -> None:
    """Compile every listed kernel that is not built yet, all nvcc processes
    at once."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def load(name: str):
    """The C entry point of csrc/<name>.cu (ctypes function with its
    argument types set), building and loading it at first use."""
    fn = _fns.get(name)
    if fn is None:
        build_all((name,))
        with _lock:
            lib = ctypes.CDLL(str(_target(name)))
            fname, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if code != 0:
        raise RuntimeError(f"csrc/{name}.cu launch failed with cudaError_t {code}")
