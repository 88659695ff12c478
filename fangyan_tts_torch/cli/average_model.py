"""Checkpoint averaging CLI (fangyan_tts_tpu/cli/average_model.py, the
reference's bin/average_model.py): the mean of the last N epoch checkpoints,
or of the N with the lowest cv_loss in their json sidecars (--val_best).

python -m fangyan_tts_torch.cli.average_model --dst_model avg.msgpack \
    --src_path exp/llm [--num 5] [--val_best]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dst_model", required=True)
    parser.add_argument("--src_path", required=True, help="checkpoint directory")
    parser.add_argument("--num", type=int, default=5)
    parser.add_argument("--val_best", action="store_true")
    args = parser.parse_args(argv)

    from ..train.checkpoint import average_checkpoints, load_meta, save_params, select_val_best

    src = Path(args.src_path)
    if args.val_best:
        paths = select_val_best(src, args.num)
        if not paths:
            raise SystemExit(f"no checkpoints with cv_loss sidecars in {src}")
        print("averaging val-best:")
    else:
        epochs = sorted(src.glob("epoch_*_whole.msgpack"), key=lambda p: int(p.stem.split("_")[1]))
        paths = [str(p) for p in epochs[-args.num:]]
        print("averaging last:")
    for p in paths:
        meta = load_meta(p) or {}
        print(f"  {p} (cv_loss={meta.get('cv_loss', 'n/a')})")
    avg = average_checkpoints(paths)
    save_params(args.dst_model, avg, meta={"averaged_from": [str(p) for p in paths]})
    print(f"wrote {args.dst_model}")


if __name__ == "__main__":
    main()
