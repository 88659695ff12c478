#!/bin/bash
# Dialect fine-tuning recipe on fangyan_tts_torch, the counterpart of the
# JAX package's examples/dialect/run.sh (after the reference's
# examples/dialect/cosyvoice3/run.sh; stages 0-7, the same numbering).
#
#   bash fangyan_tts_torch/recipes/dialect/run.sh <stage> <stop_stage>   # from the repository root
#
# Env knobs: DATA_DIR (combined kaldi dir), EXP_DIR, PRETRAIN_DIR (converted
# checkpoints incl. campplus/s3tokenizer msgpacks + tokenizer/), MESH, and
# DEVICE (default cuda), passed as --device to every stage that runs a model
# (1, 2, 5 and 7; stages 0, 3 and 6 read and write files only).
set -e
stage=${1:-0}
stop_stage=${2:-7}

DATA_DIR=${DATA_DIR:-dataset/combined}
PARQUET_DIR=${PARQUET_DIR:-${DATA_DIR}/parquet}
EXP_DIR=${EXP_DIR:-exp/dialect/llm}
PRETRAIN_DIR=${PRETRAIN_DIR:-pretrained_models/Fun-CosyVoice3-0.5B}
MESH=${MESH:-dp=1}
DEVICE=${DEVICE:-cuda}
PY=${PY:-python}
# test/CI knobs (reference defaults when unset)
CONFIG=${CONFIG:-}                    # json config for tiny-dim runs
MAX_EPOCH=${MAX_EPOCH:-200}
MAX_FRAMES=${MAX_FRAMES:-2000}
NUM_UTTS_PER_PARQUET=${NUM_UTTS_PER_PARQUET:-1000}

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ]; then
  echo "stage 0: data check (instruct must exist)"
  $PY -m fangyan_tts_torch.cli.prepare_training_data --mode validate --dataset-dir "$(dirname "$DATA_DIR")"
  test -f "$DATA_DIR/instruct" || { echo "missing $DATA_DIR/instruct"; exit 1; }
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  echo "stage 1: speaker embedding extraction (campplus)"
  $PY -m fangyan_tts_torch.cli.extract_embedding --dir "$DATA_DIR" \
      --checkpoint "$PRETRAIN_DIR/campplus.msgpack" --device "$DEVICE"
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  echo "stage 2: speech token extraction (S3 tokenizer v3)"
  $PY -m fangyan_tts_torch.cli.extract_speech_token --dir "$DATA_DIR" \
      --checkpoint "$PRETRAIN_DIR/s3tokenizer.msgpack" --device "$DEVICE"
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  echo "stage 3: parquet packing (+train/cv split: last shard is cv)"
  $PY -m fangyan_tts_torch.cli.make_parquet_list --instruct \
      --num_utts_per_parquet "$NUM_UTTS_PER_PARQUET" \
      --src_dir "$DATA_DIR" --des_dir "$PARQUET_DIR"
  # last shard is cv; with a single shard train==cv (the reference's
  # run.sh:116-123 does the same for 1-parquet corpora)
  if [ "$(wc -l < "$PARQUET_DIR/data.list")" -le 1 ]; then
    cp "$PARQUET_DIR/data.list" "$PARQUET_DIR/train.data.list"
    cp "$PARQUET_DIR/data.list" "$PARQUET_DIR/cv.data.list"
  else
    head -n -1 "$PARQUET_DIR/data.list" > "$PARQUET_DIR/train.data.list"
    tail -n 1 "$PARQUET_DIR/data.list" > "$PARQUET_DIR/cv.data.list"
  fi
fi

# stage 4 in the reference rewrites relative->absolute paths; the packer
# already writes absolute shard paths.

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  echo "stage 5: LLM fine-tune (constantlr 1e-5, accum 2, bf16)"
  $PY -m fangyan_tts_torch.cli.train --model llm \
      --train_data "$PARQUET_DIR/train.data.list" \
      --cv_data "$PARQUET_DIR/cv.data.list" \
      --model_dir "$EXP_DIR" --mesh "$MESH" \
      --qwen_pretrain_path "$PRETRAIN_DIR/tokenizer" \
      ${CONFIG:+--config "$CONFIG"} \
      --max_frames_in_batch "$MAX_FRAMES" \
      --lr 1e-5 --scheduler constantlr --accum_grad 2 --max_epoch "$MAX_EPOCH" --device "$DEVICE"
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  echo "stage 6: average 5 val-best checkpoints"
  $PY -m fangyan_tts_torch.cli.average_model --val_best --num 5 \
      --src_path "$EXP_DIR" --dst_model "$EXP_DIR/llm.msgpack"
fi

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  echo "stage 7: export (torch.export programs + msgpack)"
  $PY -m fangyan_tts_torch.cli.export --model_dir "$PRETRAIN_DIR" \
      --output_dir "$EXP_DIR/export" --device "$DEVICE"
fi
