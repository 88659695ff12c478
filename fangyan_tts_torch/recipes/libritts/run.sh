#!/bin/bash
# LibriTTS full-stack recipe on fangyan_tts_torch, the counterpart of the
# JAX package's examples/libritts/run.sh: data prep stages 1-3, then llm /
# flow / hifigan training, averaging, export (after the reference's
# examples/libritts/cosyvoice3/run.sh:19-55).
#
#   bash fangyan_tts_torch/recipes/libritts/run.sh <stage> <stop_stage>   # from the repository root
#
# Env knobs: DATA_DIR (kaldi dir with wav.scp/text/utt2spk/spk2utt),
# EXP_DIR, PRETRAIN_DIR, MESH, and DEVICE (default cuda), passed as --device
# to every stage that runs a model (1, 2, 5 and 7).
# The JAX package's run_dpo.sh has no counterpart here: its `train --dpo`
# is a flag the JAX CLI never reads, and the port's CLI refuses it.
set -e
stage=${1:-0}
stop_stage=${2:-7}

DATA_DIR=${DATA_DIR:-dataset/libritts}
PARQUET_DIR=${PARQUET_DIR:-${DATA_DIR}/parquet}
EXP_DIR=${EXP_DIR:-exp/libritts}
PRETRAIN_DIR=${PRETRAIN_DIR:-pretrained_models/Fun-CosyVoice3-0.5B}
MESH=${MESH:-dp=1}
DEVICE=${DEVICE:-cuda}
PY=${PY:-python}

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
  $PY -m fangyan_tts_torch.cli.make_parquet_list \
      --src_dir "$DATA_DIR" --des_dir "$PARQUET_DIR"
  head -n -1 "$PARQUET_DIR/data.list" > "$PARQUET_DIR/train.data.list"
  tail -n 1 "$PARQUET_DIR/data.list" > "$PARQUET_DIR/cv.data.list"
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  for model in llm flow; do
    echo "stage 5: train $model"
    $PY -m fangyan_tts_torch.cli.train --model $model \
        --train_data "$PARQUET_DIR/train.data.list" \
        --cv_data "$PARQUET_DIR/cv.data.list" \
        --model_dir "$EXP_DIR/$model" --mesh "$MESH" \
        --qwen_pretrain_path "$PRETRAIN_DIR/tokenizer" \
        --lr 1e-5 --scheduler constantlr --accum_grad 2 --max_epoch 200 --device "$DEVICE"
  done
  echo "stage 5: train hifigan (GAN loop: alternating gen/disc steps)"
  $PY -m fangyan_tts_torch.cli.train_gan \
      --train_data "$PARQUET_DIR/train.data.list" \
      --model_dir "$EXP_DIR/hifigan" --device "$DEVICE"
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  echo "stage 6: average 5 val-best checkpoints per model"
  for model in llm flow; do
    $PY -m fangyan_tts_torch.cli.average_model --val_best --num 5 \
        --src_path "$EXP_DIR/$model" --dst_model "$EXP_DIR/$model.msgpack"
  done
fi

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  echo "stage 7: export (torch.export programs + msgpack)"
  $PY -m fangyan_tts_torch.cli.export --model_dir "$PRETRAIN_DIR" \
      --output_dir "$EXP_DIR/export" --device "$DEVICE"
fi
