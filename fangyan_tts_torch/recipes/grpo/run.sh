#!/usr/bin/env bash
# GRPO recipe on fangyan_tts_torch, the counterpart of the JAX package's
# examples/grpo/run.sh (after the reference's examples/grpo/cosyvoice2/run.sh:
# data prep -> reward server -> GRPO training -> CER eval).
#
#   bash fangyan_tts_torch/recipes/grpo/run.sh   # from the repository root
#
# Env knobs: MODEL_DIR, and DEVICE (default cuda), passed as --device to the
# reward server, the trainer and the evaluation.

set -eou pipefail

stage=0
stop_stage=3

model_dir=${MODEL_DIR:-pretrained/CosyVoice3-0.5B}
device=${DEVICE:-cuda}
data_dir=data/grpo
exp_dir=exp/grpo
reward_port=50002

log() { echo -e "$(date '+%Y-%m-%d %H:%M:%S') $*"; }

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ]; then
  log "stage 0: prepare transcript jsonl (any {'text': ...} jsonl works; the
  reference uses aishell-3 metadata from voxbox)"
  mkdir -p $data_dir
  # expects $data_dir/raw.jsonl provided by the user (e.g. aishell-3.jsonl)
  head -n 8000 $data_dir/raw.jsonl > $data_dir/train.jsonl
  tail -n 100 $data_dir/raw.jsonl > $data_dir/test.jsonl
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: start the token2wav+ASR reward server (keep it running)"
  python -m fangyan_tts_torch.runtime.token2wav_asr_server \
    --model_dir $model_dir --port $reward_port --asr funasr --device $device &
  echo $! > $exp_dir.reward.pid
  sleep 10
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: GRPO training (rollouts -> -CER reward -> clipped-PG update)"
  python -m fangyan_tts_torch.cli.grpo_train \
    --model_dir $model_dir \
    --data $data_dir/train.jsonl \
    --out_dir $exp_dir \
    --steps 200 --prompts_per_step 4 --group_size 8 \
    --lr 1e-6 --kl_coef 0.01 \
    --reward_url http://localhost:$reward_port --device $device
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: eval — synthesize the test set with the GRPO checkpoint and
  score CER via the reward server (infer_dataset.py analogue)"
  DEVICE=$device python - <<'PY'
import json, glob, numpy as np, urllib.request, io, wave, os
from fangyan_tts_torch.cli.compare_inference import load_model
from fangyan_tts_torch.train.grpo import cer

model_dir = os.environ.get("MODEL_DIR", "pretrained/CosyVoice3-0.5B")
exp = sorted(glob.glob("exp/grpo/llm_grpo_step*.msgpack"))[-1]
cv = load_model(model_dir, exp, device=os.environ["DEVICE"])  # the GRPO LLM loaded into the model
errs = []
for line in open("data/grpo/test.jsonl", encoding="utf-8"):
    text = json.loads(line)["text"]
    for seg in cv.frontend.text_normalize(text):
        mi = {"text": cv.frontend.extract_text_token(seg)}
        audio = np.concatenate([o["tts_speech"] for o in cv.model.tts(**mi)])
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1); w.setsampwidth(2); w.setframerate(24000)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
        req = urllib.request.Request("http://localhost:50002/asr", data=buf.getvalue(),
                                     headers={"Content-Type": "audio/wav"})
        hyp = json.loads(urllib.request.urlopen(req, timeout=300).read())["text"]
        errs.append(cer(seg, hyp))
print(f"test CER: {float(np.mean(errs)):.4f} over {len(errs)} segments")
PY
fi
