"""Build and load the port's hand-written kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled at first use
by `nvcc` for sm_90a into its own shared library under `build/kernels/`
(beside the package, listed in .gitignore), named by a hash of the source,
every shared header `csrc/*.cuh` and the flags, and loaded with ctypes.
Only the sources in the checkout are used. `build_all` starts one nvcc per
source at once. Each `csrc/<name>_triton.py` holds Triton kernels, which
`triton(name)` imports once (Triton compiles a kernel at its first launch).
Nothing here runs when a module is imported: the CPU has no Triton and no
nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("decode_attention", "flash_attention", "int4_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_fns: dict = {}  # loaded C entry points by entry name
build_logs: dict[str, str] = {}  # nvcc's output (ptxas register / spill report) per built source

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# entry -> (source, C function, argument types); an entry named <source>_f32
# is the source's float32 route
_SIGNATURES = {
    "decode_attention": ("decode_attention", "fangyan_decode_attention", [_P] * 8 + [_LL] * 3 + [_I] * 9 + [_P]),
    "decode_attention_f32": ("decode_attention", "fangyan_decode_attention_f32",
                             [_P] * 8 + [_LL] * 3 + [_I] * 9 + [_P]),
    "flash_attention": ("flash_attention", "fangyan_chunk_flash_attention", [_P] * 5 + [_I] * 5 + [_LL] * 9 + [_P]),
    "flash_attention_f32": ("flash_attention", "fangyan_chunk_flash_attention_f32",
                            [_P] * 5 + [_I] * 5 + [_LL] * 9 + [_P]),
    "int4_matmul": ("int4_matmul", "fangyan_int4_matmul", [_P] * 4 + [_I] * 7 + [_P]),
    "int4_matmul_f32": ("int4_matmul", "fangyan_int4_matmul_f32", [_P] * 4 + [_I] * 7 + [_P]),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a header edit must not load a stale library
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


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


def load(entry: str):
    """The C entry point `entry` of _SIGNATURES (a ctypes function with its
    argument types set), building and loading its source at first use."""
    fn = _fns.get(entry)
    if fn is None:
        source, fname, argtypes = _SIGNATURES[entry]
        build_all((source,))
        with _lock:
            lib = ctypes.CDLL(str(_target(source)))
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[entry] = fn
    return fn


def check(entry: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if code != 0:
        source, fname = _SIGNATURES[entry][:2]
        raise RuntimeError(f"csrc/{source}.cu {fname} failed with cudaError_t {code}")


@functools.lru_cache(maxsize=None)
def triton(name: str):
    """The module of csrc/<name>_triton.py, imported as fangyan_<name>_triton
    at the first call. Call it where a kernel launches, never at import."""
    spec = importlib.util.spec_from_file_location(f"fangyan_{name}_triton", CSRC / f"{name}_triton.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
