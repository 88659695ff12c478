"""Parameter trees in flax's msgpack format, without flax or msgpack
(fangyan_tts_tpu/train/checkpoint.py `save_params` / `load_params`), and
the JAX package's training-checkpoint helpers `load_meta` (the json
sidecar), `average_checkpoints` and `select_val_best` (by the sidecars'
cv_loss).

A file is one msgpack map: nested maps of str keys whose leaves are arrays.
flax writes an array as ext type 1, whose payload is the msgpack of
(shape, dtype name, C-order bytes), a numpy scalar as ext type 3 with the
same payload, and a leaf over 2**30 bytes as a map
{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
"chunks": {"0": flat piece, ...}}. This module reads and writes that subset
of msgpack: maps, str, bin, int, float, nil, bool, arrays and those two ext
types. Anything else raises.

numpy has no bfloat16: such a leaf is read as a torch.bfloat16 tensor
(through a uint16 view), and a torch tensor of any dtype may be written.
Every other leaf is read as a numpy array (a numpy scalar for ext type 3).
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax's chunk size in bytes
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

_TORCH_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.uint8: "uint8", torch.bool: "bool",
}


# ---------------------------------------------------------------- decoding

_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
# the length field of bin 8/16/32, str 8/16/32, array 16/32, map 16/32 and ext 8/16/32
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
            0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


class _Reader:
    def __init__(self, data: bytes | memoryview):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _LENGTHS:
            n = self.unpack(_LENGTHS[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if b in (0xD9, 0xDA, 0xDB):
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.obj() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset flax writes")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _array_from_payload(data)
        if code == _EXT_NPSCALAR:
            arr = _array_from_payload(data)
            return arr[()] if isinstance(arr, np.ndarray) else arr
        raise ValueError(f"msgpack ext type {code} is not an array or numpy scalar")


def _array_from_payload(data: memoryview) -> np.ndarray | torch.Tensor:
    r = _Reader(data)
    shape, name, buf = r.obj()
    if isinstance(name, (bytes, memoryview)):
        name = bytes(name).decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        u16 = np.frombuffer(buf, dtype="<u2").copy()
        return torch.from_numpy(u16).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore: bytes -> the nested tree."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


# ---------------------------------------------------------------- encoding


def _pack_int(v: int, out: list) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for lim, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
                               (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= lim:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for lim, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"), (-0x80000000, 0xD2, ">i"),
                               (-0x8000000000000000, 0xD3, ">q")):
            if v >= lim:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, fix: tuple[int, int] | None, codes: tuple[int, int, int], out: list) -> None:
    """A length header: the fix form (base, limit) when it fits, else the 8-,
    16- or 32-bit form (codes; None where a form does not exist)."""
    if fix is not None and n < fix[1]:
        out.append(bytes([fix[0] | n]))
        return
    for lim, code, fmt in ((0xFF, codes[0], ">B"), (0xFFFF, codes[1], ">H"), (0xFFFFFFFF, codes[2], ">I")):
        if code is not None and n <= lim:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _pack_len(n, None, (0xC7, 0xC8, 0xC9), out)
        out.append(struct.pack(">b", code))
    out.append(data)


def _array_payload(x: np.ndarray | torch.Tensor) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        name = _TORCH_DTYPE_NAMES[x.dtype]
        shape = tuple(x.shape)
        buf = (x.view(torch.uint16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    else:
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be written")
        name, shape, buf = x.dtype.name, x.shape, x.tobytes("C")
    out: list = []
    _pack([list(shape), name, buf], out)
    return b"".join(out)


def _pack(v: Any, out: list) -> None:
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _pack_int(v, out)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _pack_len(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        _pack_len(len(v), None, (0xC4, 0xC5, 0xC6), out)
        out.append(bytes(v))
    elif isinstance(v, dict):
        _pack_len(len(v), (0x80, 16), (None, 0xDE, 0xDF), out)
        for k, x in v.items():
            _pack(k, out)
            _pack(x, out)
    elif isinstance(v, list):
        _pack_len(len(v), (0x90, 16), (None, 0xDC, 0xDD), out)
        for x in v:
            _pack(x, out)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _pack_ext(_EXT_NDARRAY, _array_payload(v), out)
    elif isinstance(v, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_payload(np.asarray(v)), out)
    else:
        raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def _itemsize(x: np.ndarray | torch.Tensor) -> int:
    return x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize


def _chunk(tree: Any) -> Any:
    """Leaves over MAX_CHUNK_SIZE bytes become flax's chunked-array maps."""
    if isinstance(tree, dict):
        return {str(k): _chunk(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        size = tree.numel() if isinstance(tree, torch.Tensor) else tree.size
        if size * _itemsize(tree) > MAX_CHUNK_SIZE:
            per = max(1, int(MAX_CHUNK_SIZE / _itemsize(tree)))
            flat = tree.reshape(-1)
            pieces = [flat[i : i + per] for i in range(0, size, per)]
            return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                    "chunks": {str(i): p for i, p in enumerate(pieces)}}
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """flax.serialization.msgpack_serialize for a nested dict of arrays."""
    out: list = []
    _pack(_chunk(tree), out)
    return b"".join(out)


# ---------------------------------------------------------------- files


def _sorted(tree: Any) -> Any:
    """Maps in key order, as the JAX package's save_params writes them (its
    jax.tree.map rebuilds every dict sorted), so both write the same bytes."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def save_params(path: str | Path, params: Any, meta: dict | None = None) -> None:
    """Write `params` (nested dicts of numpy arrays or torch tensors, keys
    sorted) as flax msgpack; `meta`, when given, to the json sidecar
    `<path>.json`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(_sorted(params)))
    if meta is not None:
        with open(str(path) + ".json", "w", encoding="utf-8") as f:
            json.dump(meta, f, ensure_ascii=False, indent=2)


def load_params(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def load_meta(path: str | Path) -> dict | None:
    """The json sidecar `<path>.json` that save_params wrote with `meta`, or
    None."""
    p = str(path) + ".json"
    if os.path.exists(p):
        with open(p, encoding="utf-8") as f:
            return json.load(f)
    return None


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _mean(*xs):
    """np.mean over the stacked leaves, as the JAX package averages; a
    bfloat16 leaf (a torch tensor here) is averaged in float32 and kept
    bfloat16."""
    if isinstance(xs[0], torch.Tensor):
        return torch.stack([x.float() for x in xs]).mean(dim=0).to(xs[0].dtype)
    return np.mean(np.stack(xs), axis=0)


def average_checkpoints(paths: list[str | Path]) -> Any:
    """The element-wise mean of N checkpoints' trees (bin/average_model.py)."""
    return _tree_map(_mean, *(load_params(p) for p in paths))


def select_val_best(ckpt_dir: str | Path, n: int = 5) -> list[str]:
    """The N checkpoints of `ckpt_dir` with the lowest cv_loss in their json
    sidecars."""
    scored = []
    for p in sorted(Path(ckpt_dir).glob("*.msgpack")):
        meta = load_meta(p)
        if meta and "cv_loss" in meta:
            scored.append((meta["cv_loss"], str(p)))
    scored.sort()
    return [p for _, p in scored[:n]]
