"""CUDA graphs of the batched decode step (models/llm.generate_speech_tokens).

On the card one decode step of the LM is about 800 small launches (24
layers of norms, projections, rope, decode attention and MLP, and the
sampler). Issued one by one, the host takes far longer to issue them than
the device takes to run them. A CUDA graph holds one whole step, the
sampling and `decode_step`, and a replay issues it in one launch.

A graph reads and writes fixed addresses, so each bucket keeps its own
state (`Bucket.state`, an llm.BatchDecode): the backbone's cache of exactly
cache_len slots (Qwen2's K/V, whose decode-attention wrapper encodes its TMA
maps from the cache's address, so a captured launch keeps the maps of its
capture; or the MLA-MoE backbone's latent cache), the
logits, the RAS window, done, counts, the output, the device step count,
the per-row inputs and the step's uniforms. A call copies its inputs in and
prefills eagerly into the zeroed cache. Where the bucket has no graph yet,
its first step runs eagerly on the capture stream (a real step, which also
warms that stream up) and the next one is captured there. Every step after
that, in this call and in later calls of the bucket, is a replay.

The rules, from what the code can observe:
- `bucket` gives None, and the decode runs eagerly through the same step
  body, for tensors off the card and for a model with a tensor-parallel
  layer (qwen2.TPDense: its collectives cannot be captured).
- A bucket is keyed on what its captured shapes and constants depend on:
  B, max_new_tokens, cache_len, the model's LLMConfig (the sampling
  constants and the backbone are part of the graph), the cache and compute
  dtypes, the
  device and whether inference mode is on (a tensor made in it cannot be
  written in place outside it). The prompt length enters only through the
  state.
- A graph serves only while every parameter and buffer of the model has
  the storage and `_version` it had at the capture, checked once a call:
  an optimizer step or a swapped module (quantize_llm) forces a new
  capture on the bucket's state.
- At most MAX_BUCKETS buckets a model, the least recently used dropped
  first, with its graph and its state. The model is held weakly.
- A bucket another thread is decoding in is not waited for: the call runs
  eagerly on a state of its own. Captures on one device take turns (a
  lock a device around the eager step and the capture), since they share
  the device's capture stream: a launch another thread made on it while
  it captures would land in the graph.
- The kernel wrappers count no launch while their stream captures; the
  bucket keeps the tally of the launches its capture recorded, by route
  name (ops/device.launched, captured_launches), and each replay adds it
  to ops/device.launches. Captures and replayed steps are counted by the
  tracer alone (models/llm: `llm.graph_captures`, `llm.graph_steps`, under
  utils/profiling.recording() or a profiler). The MLA-MoE backbone's MoE
  counters live on the model, not in the state: a replay adds to the same
  device tensor an eager step does.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import weakref
from collections import OrderedDict

import torch

from ..ops import device as kernel_device
from .qwen2 import TPDense

MAX_BUCKETS = 8  # a model's buckets kept at once (the datagen cell uses 6)

_lock = threading.Lock()
_stores: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # model -> OrderedDict(key -> Bucket)
_capturing: dict = {}  # device -> the lock its captures take turns on
_streams: dict = {}  # device -> the side stream that captures (used under the device's lock)


def eligible(model: torch.nn.Module, device: torch.device) -> bool:
    """Whether the decode of `model` on `device` may run from graphs."""
    return device.type == "cuda" and not any(isinstance(m, TPDense) for m in model.modules())


def key(model: torch.nn.Module, shape: tuple, device: torch.device) -> tuple:
    """A bucket's key: `shape` (the state's B, max_new_tokens, cache_len
    and cache dtype), the model's config and compute dtype, the device and
    the inference mode."""
    return (*shape, model.cfg, model.dtype, device, torch.is_inference_mode_enabled())


def fingerprint(model: torch.nn.Module) -> tuple:
    """The storage and version of every parameter and buffer."""
    return tuple((t.data_ptr(), t._version) for t in itertools.chain(model.parameters(), model.buffers()))


def _record(step, dev: torch.device) -> tuple:
    """Run `step` once eagerly on the device's capture stream, then capture
    it there (the capture runs nothing). Returns the graph and the tally of
    the launches it holds."""
    side = _streams.get(dev)
    if side is None:
        side = _streams[dev] = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        step()
        graph = torch.cuda.CUDAGraph()
        with kernel_device.captured_launches() as tally:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                step()
            finally:
                graph.capture_end()
    main.wait_stream(side)
    return graph, tally


class Bucket:
    """One bucket's state, its graph once captured, the model's fingerprint
    at the capture and the wrappers' launches the graph holds."""

    def __init__(self, state, prints: tuple):
        self.state = state
        self.prints = prints
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: collections.Counter = collections.Counter()  # route name -> launches a replay adds
        self.busy = threading.Lock()

    def capture(self, step) -> None:
        """Run `step` once eagerly, then capture it as the bucket's graph
        (_record), while no other capture runs on the device."""
        dev = self.state.out.device
        with _lock:
            turn = _capturing.setdefault(dev, threading.Lock())
        with turn:
            self.graph, self.launches = _record(step, dev)

    def replay(self) -> None:
        self.graph.replay()
        kernel_device.launches.update(self.launches)


@contextlib.contextmanager
def bucket(model: torch.nn.Module, shape: tuple, device: torch.device, make_state):
    """The bucket of this decode (see `key` for `shape`), held for the
    block, or None where the decode runs eagerly (not eligible, or the
    bucket is busy). make_state() builds a new bucket's state."""
    if not eligible(model, device):
        yield None
        return
    k = key(model, shape, device)
    prints = fingerprint(model)
    with _lock:
        store = _stores.setdefault(model, OrderedDict())
        for stale in [s for s in store.values() if s.prints != prints and not s.busy.locked()]:
            stale.graph, stale.prints = None, prints  # the state serves a new capture
        got = store.get(k)
        if got is None:
            got = store[k] = Bucket(make_state(), prints)
            while len(store) > MAX_BUCKETS:
                store.popitem(last=False)
        store.move_to_end(k)
        if got.prints != prints or not got.busy.acquire(blocking=False):
            got = None
    try:
        yield got
    finally:
        if got is not None:
            got.busy.release()
