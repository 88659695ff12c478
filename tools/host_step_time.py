"""Decode ms a step and flow seconds of the port's offline request, on one CUDA card.

    python3 tools/host_step_time.py [--root DIR] [--reps 7]

Builds chip_smoke.full_config()'s CosyVoice3 (every published width, the
cut depth; bf16, random weights from seed 0) with the package of this
checkout or, with `--root DIR`, of the checkout at DIR (`git archive` of a
parent commit unpacked there, its kernels built under DIR), and times,
after one warm-up, `reps` runs each of the `bench.py` request's decode
(`generate_tokens` of 30 text tokens at a min = max token ratio of 5: 150
decode steps) and of its flow call (`token2mel` of those tokens). The
decode loop is bound by the host's launches, so this measures what a
change to the Python around the kernels costs. Prints one JSON line: each
run's ms a decode step and flow seconds, their min and median, the
checkout and the card's name and power limit. Compare two checkouts only
within one call, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
if "--root" in sys.argv:  # the package of another checkout (chip_smoke below stays this one's)
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--root") + 1]).resolve()))

TEXT_TOKENS, RATIO = 30, 5.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="time the package of the checkout at this directory")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("host_step_time: no CUDA device", file=sys.stderr)
        return 2
    import fangyan_tts_torch
    from chip_smoke import card_line, full_config
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS
    from fangyan_tts_torch.ops import _build
    from fangyan_tts_torch.ops.device import exact_fp32

    exact_fp32()
    _build.build_all()
    tts = CosyVoice3TTS.random_init(full_config(), dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(0)
    text = rng.integers(0, 50000, TEXT_TOKENS).astype(np.int32)
    emb = rng.standard_normal(192).astype(np.float32)
    none_tok, none_feat = np.zeros(0, np.int32), np.zeros((0, 80), np.float32)
    step_ms, flow_s = [], []
    for rep in range(args.reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tokens = tts.generate_tokens(text, min_token_text_ratio=RATIO, max_token_text_ratio=RATIO)
        dt = time.perf_counter() - t
        steps = int(TEXT_TOKENS * RATIO)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mel = tts.token2mel(tokens, none_tok, none_feat, emb)
        torch.cuda.synchronize()
        df = time.perf_counter() - t
        if not np.isfinite(mel).all():
            raise AssertionError("host_step_time: the mel is not finite")
        if rep:  # the first run is the warm-up
            step_ms.append(1e3 * dt / steps)
            flow_s.append(df)
    print(json.dumps({"checkout": str(Path(fangyan_tts_torch.__file__).resolve().parent.parent),
                      "decode_ms_a_step": step_ms, "decode_min": min(step_ms),
                      "decode_median": statistics.median(step_ms), "flow_s": flow_s, "flow_min": min(flow_s),
                      "flow_median": statistics.median(flow_s), "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
