#!/bin/bash
# MagicData-read recipe on fangyan_tts_torch, the counterpart of the JAX
# package's examples/magicdata-read/run.sh (after the reference's
# examples/magicdata-read/cosyvoice/run.sh, which is the libritts recipe
# with openslr-68 paths and dev/test/train set names). The libritts runner
# is parameterized by DATA_DIR, so this wrapper points it at the magicdata
# kaldi dir; DEVICE (default cuda) passes through.
#
#   bash fangyan_tts_torch/recipes/magicdata-read/run.sh <stage> <stop_stage>   # from the repository root
#
# Expects DATA_DIR to hold kaldi files for the merged dev/test/train sets
# (openslr.org/resources/68; local/prepare_data.py equivalent:
# python -m fangyan_tts_torch.cli.prepare_training_data --mode convert/validate).
set -e
DATA_DIR=${DATA_DIR:-dataset/magicdata-read} \
EXP_DIR=${EXP_DIR:-exp/magicdata-read} \
  exec bash "$(dirname "$0")/../libritts/run.sh" "$@"
