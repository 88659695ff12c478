"""Lightweight F0 (pitch) estimator for GAN training targets (the port's
copy of fangyan_tts_tpu/data/f0.py).

Replaces the reference's pyworld harvest->dio->stonemask chain
(cosyvoice/dataset/processor.py:184-206) — pyworld is a C++ binary dep not
present here. YIN-style tracker: cumulative-mean-normalized difference
(CMND) per frame with absolute-threshold pick, an octave-up correction for
subharmonic locking, parabolic lag interpolation, and a voiced-only median
filter — on the mel frame grid like the reference. Validated on tone AND
speech-like fixtures (glottal source + formants + jitter + aspiration) in
tests/test_f0.py: voiced MAE < 3 Hz, octave-error rate < 1%, incl. the
octave-prone <90 Hz register.
"""

from __future__ import annotations

import numpy as np


def estimate_f0(
    speech: np.ndarray,
    sample_rate: int = 24000,
    hop_size: int = 480,
    f0_min: float = 60.0,
    f0_max: float = 500.0,
    yin_threshold: float = 0.15,
    voicing_threshold: float = 0.45,
) -> np.ndarray:
    """speech: (T,) float32 -> f0 per hop frame (T//hop,); 0 where unvoiced.

    yin_threshold: CMND absolute threshold (YIN step 4) — first dip below it
    wins, preferring the fundamental over subharmonics.
    voicing_threshold: frames whose best CMND exceeds it are unvoiced.
    """
    lag_min = int(sample_rate / f0_max)
    lag_max = int(sample_rate / f0_min)
    # 3 pitch periods of the lowest trackable f0: short windows let formant
    # ringing out-correlate sparse low-pitch pulses (measured in test_f0)
    frame_len = 3 * lag_max
    win = frame_len - lag_max  # fixed-length YIN correlation window
    n_frames = len(speech) // hop_size
    f0 = np.zeros(n_frames, np.float32)
    pad = np.pad(speech.astype(np.float64), (0, frame_len))
    taus = np.arange(lag_max + 1)
    for i in range(n_frames):
        fr = pad[i * hop_size : i * hop_size + frame_len]
        fr = fr - fr.mean()
        cs = np.cumsum(fr * fr)
        if cs[-1] < 1e-8:
            continue
        # d(tau) = sum_{t<win} (x[t] - x[t+tau])^2, cross term via FFT
        e0 = cs[win - 1]
        e_tau = cs[taus + win - 1] - np.concatenate([[0.0], cs[:lag_max]])
        spa = np.fft.rfft(fr[:win], n=2 * frame_len)
        spb = np.fft.rfft(fr, n=2 * frame_len)
        cc = np.fft.irfft(np.conj(spa) * spb)[: lag_max + 1]
        d = e0 + e_tau - 2.0 * cc
        d[0] = 0.0
        cmnd = np.ones(lag_max + 1)
        run = np.cumsum(d[1:])
        cmnd[1:] = d[1:] * np.arange(1, lag_max + 1) / np.maximum(run, 1e-12)

        seg = cmnd[lag_min:lag_max]
        below = np.where(seg < yin_threshold)[0]
        if below.size:
            k = int(below[0])
            while k + 1 < seg.size and seg[k + 1] < seg[k]:
                k += 1
            k += lag_min
        else:
            k = int(np.argmin(seg)) + lag_min
        if cmnd[k] > voicing_threshold:
            continue
        # octave-up correction: jitter can leave the fundamental dip shallow
        # while lag 2k/3k/4k dips deeper (periods average out) — prefer the
        # smallest strong divisor lag (stonemask-style refinement)
        for div in (4, 3, 2):
            kd = int(round(k / div))
            if kd >= lag_min:
                lo, hi = max(lag_min, kd - 3), min(lag_max, kd + 4)
                kd = int(np.argmin(cmnd[lo:hi])) + lo
                if cmnd[kd] < cmnd[k] + 0.12 and cmnd[kd] < voicing_threshold:
                    k = kd
                    break
        # parabolic interpolation around the dip (sub-sample lag)
        kf = float(k)
        if 1 <= k < lag_max:
            a, b, c = cmnd[k - 1], cmnd[k], cmnd[k + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            kf = k + float(np.clip(shift, -1, 1))
        f0[i] = sample_rate / kf
    return _median_smooth_voiced(f0)


def _median_smooth_voiced(f0: np.ndarray, width: int = 5) -> np.ndarray:
    """5-frame median filter over voiced frames only: removes isolated
    octave/tracking outliers without smearing voiced/unvoiced boundaries
    (pyworld's harvest produces comparably smooth contours)."""
    out = f0.copy()
    half = width // 2
    n = len(f0)
    for i in range(n):
        if f0[i] == 0:
            continue
        lo, hi = max(0, i - half), min(n, i + half + 1)
        win = f0[lo:hi]
        win = win[win > 0]
        if win.size:
            out[i] = np.median(win)
    return out
