"""Epoch executor: the train loop, cross-validation, checkpoints and metrics
(fangyan_tts_tpu/train/executor.py).

Per-step metrics every `log_interval` batches, `step_N` checkpoints every
`save_per_step` steps, an `epoch_N_whole` checkpoint at the end of each
epoch, each with a json sidecar {"epoch", "step"} and, when CV data is
given, the utterance-weighted CV metrics as `cv_<name>` and `cv_loss` (read
by train/checkpoint.select_val_best); an empty CV set is skipped with a
warning. Checkpoints are written in the JAX package's layout
(models/from_jax.to_jax_tree, then train/checkpoint.save_params), so the
JAX package and the port's model directory read them.

The train step owns the device work; the loop reads its metrics back once
per logged step and once per checkpoint.

Under a mesh every process runs the loop on the same batches (a sharded
step takes its own rows); `main` is False on every process but one, which
alone prints, logs and writes (a checkpoint's gather runs on all).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from .checkpoint import save_module


class MetricsLogger:
    """JSONL metrics sink: one record {"tag", "step", "time", metrics...} a line."""

    def __init__(self, path: str | Path | None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a", encoding="utf-8")
        else:
            self._f = None

    def log(self, tag: str, step: int, metrics: dict) -> None:
        rec = {"tag": tag, "step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items() if np.ndim(v) == 0})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()


class Executor:
    def __init__(
        self,
        train_step: Callable,  # (state, batch, rng) -> (state, metrics)
        model_dir: str | Path,
        log_interval: int = 100,
        save_per_step: int = -1,
        metrics_path: str | Path | None = None,
        main: bool = True,
    ):
        self.train_step = train_step
        self.model_dir = Path(model_dir)
        self.main = main
        if main:
            self.model_dir.mkdir(parents=True, exist_ok=True)
        self.log_interval = log_interval
        self.save_per_step = save_per_step
        self.metrics = MetricsLogger((metrics_path or self.model_dir / "metrics.jsonl") if main else None)

    def train_one_epoch(self, state, data: Iterable[dict], epoch: int, rng: torch.Generator | None = None,
                        cv_data=None, cv_fn=None):
        """One pass over `data`; `rng` goes to every step (the flow step
        draws from it). cv_data is iterated at every checkpoint, so pass a
        re-iterable one (a list, or an object whose __iter__ builds the CV
        pipeline anew) to give each checkpoint the whole CV set. Returns
        (state, rng)."""
        t0 = time.time()
        n = 0
        for batch_idx, batch in enumerate(data):
            state, metrics = self.train_step(state, batch, rng)
            n += 1
            step = int(state.step)
            if batch_idx % self.log_interval == 0 and self.main:
                m = {k: float(v) for k, v in metrics.items()}
                rate = n / (time.time() - t0)
                print(f"epoch {epoch} step {step} " + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                      + f" ({rate:.2f} it/s)", flush=True)
                self.metrics.log("train", step, m)
            if self.save_per_step > 0 and step % self.save_per_step == 0 and step > 0:
                self._save(state, epoch, step, cv_data, cv_fn, suffix=f"step_{step}")
        self._save(state, epoch, int(state.step), cv_data, cv_fn, suffix=f"epoch_{epoch}_whole")
        return state, rng

    def cross_validate(self, state, cv_data: Iterable[dict], cv_fn: Callable) -> dict:
        """Utterance-weighted mean of cv_fn(state.params, batch)'s metrics,
        without gradients; {} (and a warning) for an empty CV set."""
        totals: dict[str, float] = {}
        total_utts = 0
        with torch.no_grad():
            for batch in cv_data:
                metrics = cv_fn(state.params, batch)
                bsz = int(np.shape(next(iter(batch.values())))[0])
                total_utts += bsz
                for k, v in metrics.items():
                    totals[k] = totals.get(k, 0.0) + float(v) * bsz
        if total_utts == 0:
            if self.main:
                print("⚠️ empty CV set — skipping validation")
            return {}
        return {k: v / total_utts for k, v in totals.items()}

    def _save(self, state, epoch: int, step: int, cv_data, cv_fn, suffix: str) -> None:
        meta = {"epoch": epoch, "step": step}
        if cv_data is not None and cv_fn is not None:
            cv = self.cross_validate(state, cv_data, cv_fn)
            meta.update({f"cv_{k}": v for k, v in cv.items()})
            if "loss" in cv:
                meta["cv_loss"] = cv["loss"]
            self.metrics.log("cv", step, cv)
            if self.main:
                print(f"CV @ step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in cv.items()), flush=True)
        save_module(self.model_dir / f"{suffix}.msgpack", state.params, meta=meta)
