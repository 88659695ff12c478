"""Comparisons that decide `correct`: the program's outputs against the
plain float32 references, on numbers that do not depend on how the program
batched or padded its work.
"""

from __future__ import annotations

import numpy as np
import torch

# FSQ silent and breath tokens, and the longest run of them an utterance keeps
SILENT_TOKENS = frozenset((1, 2, 28, 29, 55, 248, 494, 2241, 2242, 2322, 2323))
MAX_SILENT_RUN = 5


def suppress_silent_runs(tokens) -> np.ndarray:
    """Drop silent tokens beyond MAX_SILENT_RUN in a row."""
    out, run = [], 0
    for t in (int(x) for x in tokens):
        run = run + 1 if t in SILENT_TOKENS else 0
        if run <= MAX_SILENT_RUN:
            out.append(t)
    return np.asarray(out, np.int64)


def greedy_gap(logits: torch.Tensor, served, allowed: int) -> float:
    """Widest gap by which a served token's reference logit lies below the
    reference's best among the first `allowed` ids (the stop ids are masked
    while an utterance is shorter than its minimum length)."""
    lg = logits[:, :allowed].float()
    idx = torch.as_tensor(np.asarray(served, np.int64), device=lg.device)
    if int(idx.max()) >= allowed or int(idx.min()) < 0:
        return float("inf")
    return float((lg.max(dim=1).values - lg.gather(1, idx[:, None])[:, 0]).max())


def mean_gap(logits: torch.Tensor, served, allowed: int) -> float:
    """greedy_gap's mean over the served tokens."""
    lg = logits[:, :allowed].float()
    idx = torch.as_tensor(np.asarray(served, np.int64), device=lg.device).clamp(0, allowed - 1)
    return float((lg.max(dim=1).values - lg.gather(1, idx[:, None])[:, 0]).mean())


def rel_err(got, ref) -> float:
    """||got - ref|| / ||ref||, float64."""
    got = torch.as_tensor(got).double().cpu()
    ref = torch.as_tensor(ref).double().cpu()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        return float("inf")
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def spectral_err(got, ref, n_fft: int = 1024, hop: int = 256) -> float:
    """Relative error of STFT magnitudes (Hann window), which a drift of the
    source's phase leaves alone while it catches wrong or missing sound."""
    got = torch.as_tensor(np.asarray(got, np.float64))
    ref = torch.as_tensor(np.asarray(ref, np.float64))
    if got.shape != ref.shape or not torch.isfinite(got).all() or ref.numel() < n_fft:
        return float("inf")
    win = torch.hann_window(n_fft, dtype=torch.float64)
    mg = torch.stft(got, n_fft, hop, window=win, return_complex=True, center=False).abs()
    mr = torch.stft(ref, n_fft, hop, window=win, return_complex=True, center=False).abs()
    return float((mg - mr).norm() / mr.norm().clamp_min(1e-30))


def int8_rounded(w: torch.Tensor) -> torch.Tensor:
    """w rounded to symmetric int8 per output channel (its first axis) and back."""
    scale = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True).clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127) * scale
