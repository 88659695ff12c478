"""Stage 3: parquet packing (tools/make_parquet_list.py equivalent, same
flags and output layout as it and fangyan_tts_tpu/cli/make_parquet_list.py).

python -m fangyan_tts_torch.cli.make_parquet_list --src_dir <kaldi-dir> \
    --des_dir <out> [--num_utts_per_parquet 1000] [--instruct]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_utts_per_parquet", type=int, default=1000)
    parser.add_argument("--num_processes", type=int, default=1)  # compat; threads used
    parser.add_argument("--instruct", action="store_true", default=False)
    parser.add_argument("--src_dir", type=str, required=True)
    parser.add_argument("--des_dir", type=str, required=True)
    parser.add_argument("--dpo", action="store_true", default=False)
    args = parser.parse_args(argv)

    from ..data.parquet import make_parquet_list

    shards = make_parquet_list(
        args.src_dir, args.des_dir,
        num_utts_per_parquet=args.num_utts_per_parquet,
        instruct=args.instruct, dpo=args.dpo,
    )
    print(f"✅ wrote {len(shards)} parquet shards to {args.des_dir}")


if __name__ == "__main__":
    main()
