"""Drive the PyTorch/CUDA port (fangyan_tts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase; needs one CUDA card
    python3 chip_smoke.py --phases 1,2,3     # build and check the kernels only
    python3 chip_smoke.py --phases 1,2,3,8   # the streaming slice alone
    python3 chip_smoke.py --phases 1,2,3,9   # the serving slice alone
    python3 chip_smoke.py --phases 1,2,3,10  # the CosyVoice2 / CosyVoice1 families alone
    python3 chip_smoke.py --phases 1,2,3,11  # data prep stages 0-4 alone
    python3 chip_smoke.py --phases 1,2,3,11,12  # data prep, then training, alone
    python3 chip_smoke.py --phases 1,2,3,13  # the rest of training (GAN, DPO, GRPO) alone
    python3 chip_smoke.py --phases 1,2,3,14  # dataset generation, evaluation and the token2wav server alone
    python3 chip_smoke.py --phases 1,2,3,15  # export, the dialect recipe and the subsampling layers alone
    python3 chip_smoke.py --phases 1,2,3,16  # two processes on the card: TP decode, TP token2wav, dp training
    python3 chip_smoke.py --phases 17        # the MLA-MoE speech LM at full width alone (Triton kernels, no build)

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 off
  2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     all at once) and print the build time and ptxas report
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (the single requests', and the batches of 16 as
     worked out from their own buckets, and the streaming requests' decode
     caches and window lengths, from infer/tts.stream_buckets and the
     flow window, and phase 9's continuous batches at B = 4 and 8 and every
     flow call of its groups, from the schedulers' own formulas:
     infer/tts.stream_buckets and infer/batch_stream.flow_shapes), and
     phase 13's GRPO rollouts (decode at B = 4 prompts x 8 rollouts and its
     cache, flash at every length bucket a rollout can reach, from
     train/grpo.rollout_buckets), with the tolerances below, and
     decode attention also with a row that has no open slot, write slots on
     a block boundary of its launch plan, one long cache (S = 4096) and
     strided q / k_new / v_new views (bit-equal to the contiguous call), and
     at the continuous batches with a write slot and a window per row (one
     row at slot 0, one on a block boundary, one at S - 1, a free row past
     S), each row bit-equal to a B = 1 call on it alone;
     flash attention also at window lengths that are no multiple of 64, and
     at 2N rows with each row's own mel_len (the young buckets);
     kernel, plain and library times (timed only:
     scaled_dot_product_attention for the attention kernels, F.linear on the
     dequantized weight for int4_matmul); phase 14's shapes (the dataset
     CLI's batches of 16, compare_inference's and run_eval's requests) too;
     then each kernel's float32 route against its plain version in float64
     on the same float32 inputs at the float32 paths' shapes (phase 4's
     float32 batch and float32 API request, from infer/tts.batch_buckets
     and the API request's buckets; int4 also at M = 1, 8 and 16, the
     decode tile's buckets and edge, and 17 and 100 on the prefill tile,
     each call bit-equal to a second one; decode attention also at B = 4,
     S = 256 with a row that has no open slot, S = 4096 and the GRPO
     rollout bucket's B = 32, S = 384, each call bit-equal to a second
     one, all four shapes timed; flash also at L = 129 with a row of
     mel_len 0), timed against its plain version in float32 and SDPA /
     F.linear in float32 (TF32 off); phase 15's shapes:
     the exported flow_solve's (2 x 16 heads, L = 512, timed) and the
     recipe model's (its 2 heads, its decode's 2 layers, 2 query heads and
     1 KV head); phase 16's (mp_spec: each rank's half of the heads, decode
     attention at 1 KV head and 7 query heads, flash at 8 heads, timed);
     and the DiT's AdaLN kernel (ops/adaln) at the datagen cell's flow
     buckets, with and without the gated residual, and one float32 shape,
     timed by graph replay against its bytes bound and the plain chain
     (check_adaln); the LM backbones' residual + RMSNorm and Qwen2 qkv
     epilogue kernels (ops/rms_norm, ops/qkv_rope) at the datagen cells'
     decode and prefill rows, timed against their plain chains
     (check_rms_norm_qkv_rope)
  4. a small model on the card against the same weights on the CPU
     (plain versions), bf16 and then int8 LLM + int4 MLP + int8 DiT; then
     at CosyVoice3-0.5B's full width (full_config's depth) with random
     weights: three requests through CosyVoice3TTS.tts (bf16), and two
     batched requests of 16
     through batch_synthesize, (a) in the int8 LLM mode and (b) in the
     int8 + int4 MLP + int8 DiT mode; the kernel launch counts are set to
     0 before each run and read after it, and each run fails if it
     launched a kernel at a shape that phase 3 did not check; then the
     public API: a full-width model directory written by the port
     (config.json, the msgpack checkpoints with bf16 leaves, CAM++ and S3),
     a 5 s prompt wav at 24 kHz, AutoModel(dir) and one
     inference_zero_shot through the byte tokenizer and text_normalize,
     with its launches counted as above; float32: the small model
     in float32 card against CPU, greedy (on the bf16 KV cache both
     packages keep: vc mel and wav within F32_REL_TOL; on a float32 KV
     cache and in the int4 MLP mode: tokens equal, mel, wav and logits
     within F32_REL_TOL), one full-width float32 request through
     `python -m fangyan_tts_torch.runtime.offline_inference --no-fp16` on
     the model directory (flash on its float32 route, n_timesteps x depth
     a flow call; decode one a layer and step on the bf16 cache), and a full-width float32 batch in
     the int4 MLP mode on a float32 KV cache (all three float32 routes,
     launches counted); then the batched decode's CUDA graphs
     (models/decode_graphs) against the same loop run eagerly
     (graph_check). A decode step counts where it runs: an eager
     decode_step call (the one a capture records runs nothing) or a replay
  5. the flow and vocoder stages under torch.profiler, for the 150-token
     request and the batched requests (a) int8 and (b): device busy time,
     idle share, device operations, largest kernels
  7. the prompt frontend at full size, random weights (no kernel of its
     own): CAM++ and S3 at the 5 s and the 30 s bucket in float32 on the
     card against the same weights on the CPU, then in bf16 (what the
     frontend serves) against float32, and the frontend's times
  8. streaming, CosyVoice3TTS.tts(stream=True) at full width with random
     weights: warmup_streaming timed; S1 first chunk (bench.py's
     bench_first_chunk; a warm-up stream and a timed one), S2 solo stream (bench_solo_streaming: 320 tokens,
     window hops), S3 a zero-shot stream (60 prompt tokens, 400 tokens), S4
     AutoModel(dir).inference_zero_shot(stream=True) on phase 4's model
     directory, S5 a bistream text generator (stopped after 100 tokens); S1
     and S3 again with the speculative first hop and the token prefetch
     thread off, held to the runs with both on; first-chunk ms, RTF and the
     per-hop budget (the tracer's stream.* spans); launches counted per run and every
     shape held to phase 3's checks as in phase 4; one young KV hop and one
     window hop of S2 under torch.profiler; and a small model's vc stream
     across the window boundary on the card against the CPU
  9. serving at full width with random weights: (a) bench.py's async
     streaming workload (each client 10 text tokens, 200 speech tokens, no
     prompt) through an LLMScheduler and a StreamScheduler of width 4, then
     8: one measured round, aggregate RTF, each stream's
     first chunk ms, both schedulers' batching (rows / steps), the p99 and
     max arrival gap and the underruns (gaps over one hop of audio); (c) four
     fixed-token sessions of 320 tokens through a width-4 StreamScheduler
     against the same sessions streamed solo (within 5e-2 of max |solo|,
     equal chunk lengths), and four greedy decodes through a width-4
     LLMScheduler against their solo decodes (equal up to the first
     near-tie, the agreeing prefixes printed); (b) the port's HTTP server in
     this process on 127.0.0.1 with phase 4's model directory and
     --batched_streams 4, four concurrent /inference_zero_shot clients
     through runtime/http_client (well-formed int16 PCM each); every run's
     decode launches one a layer and scheduler step, its flash launches
     n_timesteps x depth a flow call, its hops those its token counts imply, and every shape held to
     phase 3's checks
  10. the CosyVoice2 and CosyVoice1 families with random weights: small v2
     (bf16, then float32 with its logits on a float32 KV cache) and v1
     (float32) models on the card against the CPU; then
     CosyVoice2-0.5B's widths (its LM at FULL_LLM_LAYERS layers) in bf16:
     the 150-token bench request through
     CosyVoice2TTS.tts (one run, then its stages under torch.profiler), a
     200-token stream, a v2 model directory written by
     the port through AutoModel(dir).inference_zero_shot with phase 4's 5 s
     prompt, and four greedy decodes through a width-4 LLMScheduler against
     their solo decodes; then CosyVoice-300M in float32: one offline request
     of 300 speech tokens and one stream, through the byte tokenizer. Every
     v2 run's decode launches are one a layer and decode step and its
     shapes held to
     phase 3's checks (phase 3 works the v2 caches out from
     infer/tts_v12.v2_decode_buckets); every v1 run launches no kernel
  11. data prep stages 0-4 at bench.py's full width (bench_data_prep: 128
     synthesized wavs of 5-30 s, 8 speakers, batch 64, 64 utterances a
     parquet shard) with full-size CAM++ and S3, random weights, bf16 as the
     CLIs run them: stage 0 (the Kaldi directory, validated), stages 1+2
     (data/extract.extract_all) and, when pyarrow imports, stages 0-4
     (prepare_corpus, then data/dataset.build_pipeline's first LLM batch);
     a warm-up pass and two timed passes of the fused route (utt/s and
     seconds of audio a second); the fused route against the separate
     stages (extract_embeddings + extract_speech_tokens, each its own load
     and upload) and the two extraction CLIs (--checkpoint) against the
     separate stages, x-vectors within 1e-5 and codes equal; every artifact read back
     with wav.scp's keys; the peak memory of each bucket's batch and of a
     batch of 64 at 30 s; one 30 s batch under torch.profiler; float32 on the
     card against the CPU on a 5, 10, 20 and 30 s utterance (phase 7's
     limits) and bf16 against float32 (recorded); the audio loader and the
     kernel launches (none: no kernel of the port is on this path)
  12. training: one LM train step on the card in bf16 against the same step
     on the CPU in float32 (small model, same weights and batch), and one
     flow step in float32 on both with the same draws: loss and grad_norm;
     bench.py's bench_train at full width: the CosyVoice3-0.5B LM at
     full_config's depth (remat "full", bf16 compute, float32 parameters
     and Adam, accum 2 x (8 x 256)),
     a warm-up and four timed steps (ms a step, tokens/s, peak memory, each
     step's loss), one step under torch.profiler, the same at accum 2 x
     (64 x 256) (bench.py's max-throughput point), one step with remat off
     for its peak memory, and the DiT flow (float32, 4 x 200 mel frames), a
     warm-up and two timed steps and one under the profiler; the
     kernel wrappers raise on CUDA inputs that require grad; then
     `python -m fangyan_tts_torch.cli.train` for the LM and the flow, one
     epoch each on phase 11's corpus (shard 0 the train list, shard 1 the CV
     list) with the JAX executor's checkpoints and sidecars checked,
     cli.average_model --val_best --num 2, and the averaged LM in a copy of
     phase 4's model directory (a fresh one without phase 4) for one
     inference_zero_shot; the training launches no kernel of the port
  13. the rest of training: small models card against CPU (each GAN turn
     in float32, a DPO step and a GRPO update in bf16 against float32 on the
     CPU); at full width the vocoder's GAN turns (full_config().hift and
     the full MultipleDiscriminator, float32, on one batch of 38 crops of
     24,960 samples as the recipe's pipeline gives it: ms a turn, peak
     memory, one turn of each under torch.profiler) and a DPO step of the
     CosyVoice3-0.5B LM (full_config) with a frozen copy (8 pairs x 256
     tokens: ms, tokens/s, peak); these steps launch no kernel; then
     `python -m fangyan_tts_torch.cli.grpo_train` at its defaults (4
     prompts x 8 rollouts, echo reward) for one iteration on phase 4's
     model directory (a fresh one without phase 4), each iteration's wall
     split into rollouts, token2wav and update, its decode launches held to
     one a layer and decode step and the steps to what the rollouts'
     lengths imply, its flash launches to n_timesteps x depth a token2mel
     call, none in the update, every
     shape held to phase 3's checks; and `python -m
     fangyan_tts_torch.cli.train_gan` for one epoch on phase 11's corpus,
     its generator checkpoint loaded as AutoModel loads a vocoder and run on
     one mel
  14. dataset generation and evaluation at full width (full_config,
     random weights, bf16 as the CLIs load it) on phase 4's model directory
     and 5 s prompt, within DG_PHASE_LIMIT_S: `cli.generate_dialect_dataset
     --backend cuda --mode hunan` on a 24-line transcript and an 8-line
     hunan.txt (32 utterances, 2 batches of 16; wall with and without the
     load, utt/s, batch RTF; the index read back against the wavs; the
     first batch bit-equal to a direct batch_synthesize on a fresh load; a
     rerun launches nothing); `cli.evaluate.run_eval` of 4 pairs (CER 0 with
     an ASR stub that returns each target, SS in [-1, 1], a wav against
     itself at 1); `runtime.token2wav_asr_server.serve` in this process on
     127.0.0.1 with a RemoteToken2Wav stream of DG_STREAM_TOKENS tokens
     against the in-process Token2WavSession; `cli.compare_inference
     --dialects hunan --num_texts 1` with the directory's own LLM as the
     fine-tuned one (each fine-tuned wav bit-equal to its original); every
     run's launches counted and its shapes held to phase 3's checks
  15. export, the recipe and the subsampling layers: (a) `python -m
     fangyan_tts_torch.cli.export --check` on the full-width model directory
     (full_config, bf16, --n_tokens EXPORT_TOKENS), its export times,
     sizes, launches and shapes recorded; the three .pt2 programs loaded in
     a fresh process that imports only the port, run on the card and held
     to eager (the loaded flow_solve launches the flash kernel n_timesteps x
     depth times), timed against eager, peak memory; (b) the dialect recipe
     (fangyan_tts_torch/recipes/dialect/run.sh 0 7, DEVICE=cuda) on a
     12-utterance corpus and a small model with heads of 64, each stage's
     artifacts, shapes and launches checked, stage 7's flow_solve run on
     the card, then `cli.compare_inference` on its fine-tuned LLM; (c) the
     subsampling layers float32 card against CPU; (a) runs beside (c) and
     (b)
  16. two processes on the card over gloo (parallel/launch.spawn; nccl
     refuses two ranks on one device) at full_config's widths, within
     MP_PHASE_LIMIT_S: (a) the 150-token request's greedy decode through a
     TP=2 LM (float32 weights, the bf16 cache: decode attention with one KV
     head and 7 query heads a rank), tokens equal to one process up to the
     first near-tie (the step and both margins printed where one flips),
     then the same decode teacher-forced on the one process's picks, every
     logits row within MP_LOGIT_TOL; (a') the same request teacher-forced
     through a TP=2 LM with request (b)'s int8 LLM and int4 MLP (bf16: the
     int4 kernel on each rank's half of the MLP), every logits row within
     MP_LOGIT_TOL; (b) two hops of a TP=2 shard_token2wav stream, bf16
     (hop 2 a window hop: flash attention with 8 heads a rank), mel within
     MP_MEL_TOL of one process; (c) a dp=2 LM train step within
     SMALL_REL_TOL of the one-process step on the same global batch;
     process 0 runs each unsharded first; each sharded run's launches
     (counts set to 0 before it) held to its steps and flow call, its
     kernel shapes to phase 3's checks (phase 3 checks and times every new
     shape, from mp_spec); the times printed (two processes on one card,
     gloo through the host: no multi-GPU speed)
  17. the MLA-MoE speech LM (Moonlight-16B-A3B's decoder in CosyVoice3,
     models/mla_moe.py) at full width, within DG_PHASE_LIMIT_S: (a) the two
     Triton kernels against their plain versions at the datagen cell's
     shapes: the expert kernel at a decode call (16 rows, 6 experts each,
     routed by a real layer's router) and at a 1.5 k-row prefill, the MLA
     decode kernel at B = 16 over caches of 128, 256 and 512 slots with
     ragged windows (the row write checked bit-equal), each timed from a
     CUDA graph of MOON_REPS calls beside its bound and its plain version
     (the experts' by the host's clock: its host reads keep it out of a
     graph); (b) one 16-row
     batch_synthesize (the first call captures its bucket, the second
     replays every step), its launches held to what its steps imply and,
     under the device trace, the traced kernels equal to the wrappers'
     counts, graph steps at least 97 % of its steps; one request through
     tts(stream=False), its audio 960 samples a kept token, its decode
     replayed from a graph; (c) the same decode
     run eagerly: tokens and logits bit-equal to the graphs'; (d) prefill
     and every graph-replayed decode step's logits of MOON_CHECK_ROWS rows
     held to the float32 reference's full forward
     (benchmark/reference/moonlight_lm.py) by the datagen cell's greedy-gap
     limits, the logits' relative error printed
  6. one JSON line of per-kernel results, the float32 routes included
     (printed after phases 7 to 17)
Phases 8 to 17 run after phase 4's requests and before the profiler passes
of phases 5 and 7 (phase 8 runs S1 twice and S2, S3 and S4 once each,
phase 9's async and HTTP rounds have no warm-up round, phase 10 runs its v2
offline request and stream once each, phase 5 profiles the batched
requests (a) and (b) in their serving modes only, and only the flow and
vocoder stages of every request, and phase 13 runs one GRPO iteration, to
leave phases 10-15 their time);
a probe of the host's cost of one eager launch is logged at the start,
around phases 8, 9, 10, 11, 12, 13, 14, 15 and 16 and at the end; the last line
before the card's is the whole script's time.
The last line is {"ok": true, "device": {...}} and the exit code is 0 only
when every phase passed. Without a CUDA card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

# Kernel check inputs: k and v are N(0, 1) and q is N(0, QK_SCALE^2), so
# the scaled scores have a standard deviation of QK_SCALE and the softmax
# puts its weight on a few keys, as a trained model's does; the outputs are
# then of order 0.1-1 (their mean |.| is printed beside each limit).
QK_SCALE = 2.0
# Past L = FLASH_KEYS * e^(QK_SCALE^2) (about 1,365) the flash checks scale q up with ln L, so that the softmax
# keeps its weight on about FLASH_KEYS keys (exp(-scale^2) of L) and the outputs stay of the order they have at
# the shorter lengths (flash_q_scale); decode attention's windows are shorter.
FLASH_KEYS = 25
# Each kernel is held to its plain version run in float32 on the same bf16
# inputs (max |kernel - plain f32| over the valid rows):
DECODE_ATOL = 1e-2  # the kernel rounds only its output to bf16
FLASH_ATOL = 1.5e-2  # the kernel also rounds P to bf16 before P.V
INT4_ATOL = 3e-2  # the kernel rounds only its output to bf16: half an ulp of outputs up to about 5
MAX_LIMIT_SHARE = 0.15  # each limit must stay under this share of the mean |output| it is held to
# the AdaLN kernel rounds x' once (half an ulp, 1/64 at |x'| < 8, which the norm carries times rstd (1 + scale),
# up to about 3 here) and the norm once (another 1/64)
ADALN_ATOL = 1e-1
# The AdaLN checks (phase 3): the datagen cell's flow buckets (frames of its 2B = 32-row DiT calls), one float32
# shape (2B, L), the modulation's spread, and the least share of its bytes bound the kernel must reach with the
# residual at ADALN_GATE_FRAMES
ADALN_FRAMES = (384, 512, 640, 768, 896, 1024)
ADALN_F32_SHAPE = (2, 1344)
ADALN_MOD_STD = 0.5
ADALN_GATE_FRAMES, ADALN_MIN_BOUND_SHARE = 640, 0.6
# The LM kernels (phase 3): each rounds its outputs once. The norm's plain route also rounds once, after float32
# statistics summed in another order, so its error is held to the plain route's times LLM_NORM_SLACK (both carry
# the rounding of x + y, half an ulp of values up to about 8, times rstd * w); the qkv epilogue's plain route rounds
# four times. At a decode shape each kernel must take under LLM_FUSED_MAX_SHARE of its plain chain's device time.
LLM_NORM_ATOL, LLM_QKV_ATOL = 6e-2, 3e-2
LLM_F32_ATOL = 1e-5
LLM_NORM_SLACK = 1.05
LLM_FUSED_MAX_SHARE = 0.25
# and it must be at least as close to that as the plain version run in bf16
# (the precision the JAX package's path runs at), whose scores and
# probabilities are rounded to bf16.
SMALL_REL_TOL = 5e-2  # small model, bf16 on the card vs bf16 plain on the CPU
# Phase 7, CAM++ and S3 float32 on the card vs the CPU: the x-vector within
# CAM++'s own limits (tests/test_campplus_parity.py), the S3 code lengths
# equal and at least this share of the valid frames' codes equal.
XVEC_ATOL, XVEC_RTOL = 2e-4, 2e-3
S3_CODES_EQUAL = 0.995

# The batched decode's CUDA graphs (phase 4, graph_check), on the full-width bf16 LM: B = 16 greedy rows of
# text lengths within each of GRAPH_GREEDY_LENS at GRAPH_RATIO speech tokens a text token (min = max, so three
# buckets: max_new 64, 128 and 256); B = 4 sampled rows (top_k 25, one seeded generator) of GRAPH_SAMPLED_LENS; and
# under the profiler a bucket of its own (GRAPH_TRACED_LENS, max_new 320), captured there.
GRAPH_RATIO = 6.0
GRAPH_GREEDY_LENS = ((6, 10), (11, 20), (21, 40))
GRAPH_SAMPLED_LENS, GRAPH_TRACED_LENS = (8, 16), (41, 50)

# The API request (phase 4): a zh sentence and prompt text through the byte
# tokenizer (3 ids a character), and a 5 s prompt wav at 24 kHz.
API_TEXT = "你好，今天天气不错。"
API_PROMPT_TEXT = "希望你以后能够做得比我还好呦。"
API_PROMPT_SECONDS = 5
# Streaming (phase 8): the TTS objects' window (CosyVoice3TTS.stream_window_tokens)
# and the bistream cache (infer/bistream.inference_bistream's cache_len)
STREAM_WINDOW = 300
BISTREAM_CACHE = 2048
# Random weights never sample a stop id, so S5 would run to the bistream cap
# of 1,500 tokens. Its eos is forced once it has 5 speech tokens a text token
# (bench.py's batched ratio): 100 for its 20 text tokens, 60 of them in the
# text phase (a forced fill every 15) and 40 after the text ends.
S5_TOKENS = 100
# S1 and S3 with speculation and prefetch off against both on, from one
# generator seed: the same chunk lengths, the samples within this
SPEC_ATOL = 1e-5
# Serving (phase 9). (a) bench.py's bench_async_streaming: each client 10 text
# tokens, exactly 200 speech tokens (min = max ratio 20), no prompt, its own
# random x-vector, through an LLMScheduler and a StreamScheduler of the
# client count's width.
SERVE_TEXT_TOKENS, SERVE_RATIO, SERVE_WIDTHS = 10, 20.0, (4, 8)
# (b) four concurrent HTTP /inference_zero_shot clients on phase 4's model
# directory and prompt wav, each with its own sentence, through a server of
# --batched_streams HTTP_WIDTH
HTTP_TEXTS = ("你好。", "早上好。", "谢谢你。", "再见了。")
HTTP_WIDTH = 4
# (c) batched against solo on the card: four fixed-token sessions of
# BATCH_TOKENS through a width-4 StreamScheduler, each held to its solo stream
# within BATCH_REL_TOL of max |solo| (SMALL_REL_TOL's card limit); and four greedy
# decodes of GREEDY_RATIO tokens a text token through a width-4
# LLMScheduler, each equal to its solo decode up to the first step whose two
# best logits lie within GREEDY_TIE (a bf16 GEMM rounds differently at M = 1
# and at M = N)
BATCH_TOKENS, BATCH_REL_TOL = 320, 5e-2
GREEDY_RATIO, GREEDY_TIE = 10.0, 2e-2
# The v1/v2 families (phase 10). v2 offline: the bench workload, 30 text
# tokens and exactly 150 speech tokens (min = max ratio 5); v2 stream: 10
# text tokens, 200 speech tokens (ratio 20); v1: a sentence of 15 byte-
# tokenizer ids, 300 speech tokens (ratio 20, 6 s at 50 Hz).
V2_TEXT_TOKENS, V2_RATIO = 30, 5.0
V2_STREAM_TEXT_TOKENS, V2_STREAM_RATIO = 10, 20.0
V1_TEXT, V1_RATIO = "你好世界。", 20.0
# The small v1 model on the card against the CPU, both float32 with TF32
# off: only the order of the sums differs (the v1 source's phase is a
# float32 cumulative sum at the sample rate, which that order moves most).
V1_REL_TOL = 1e-3

# Data prep (phase 11): bench.py's bench_data_prep corpus, 128 utterances whose
# durations cycle through DP_SECONDS (mean 13.25 s), 8 speakers of 16 in speaker-
# major order, at its batch of 64 and 64 utterances a parquet shard. The float32
# card-vs-CPU check takes one utterance of each of DP_CHECK_SECONDS' buckets and
# holds it to phase 7's limits; the fused route and the CLIs are held to the
# separate stages' library calls within DP_ROUTE_ATOL (x-vectors), codes equal.
DP_UTTS, DP_SECONDS, DP_SPEAKERS = 128, (5, 6, 8, 10, 12, 15, 20, 30), 8
DP_BATCH, DP_SHARD = 64, 64
DP_CHECK_SECONDS = (5, 10, 20, 30)
DP_ROUTE_ATOL = 1e-5

# Training (phase 12). bench.py's bench_train (bench.py:323-378): CosyVoice3-0.5B's LM (full_config) with remat
# "full", bf16 compute, float32 parameters and Adam, accum 2 microbatches of 8 x 256 tokens, a warm-up step and
# TRAIN_STEPS timed ones; the DiT flow (dim 1024 at full_config's depth, float32) on 4 x 200 mel frames, a warm-up
# and FLOW_STEPS timed steps. The
# small models' train steps on the card against the CPU: the LM in bf16 against float32 within SMALL_REL_TOL,
# the flow float32 on both within FLOW_TRAIN_REL_TOL (TF32 off). The CLIs train one epoch each on phase 11's
# corpus (shard 0 the train list, shard 1 the CV list) with a step checkpoint every TRAIN_SAVE_PER_STEP steps.
TRAIN_B, TRAIN_T, TRAIN_ACCUM, TRAIN_STEPS = 8, 256, 2, 4
TRAIN_MAX_B = 64  # bench.py's max-throughput point (llm_train_max_tokens_per_s_per_chip), three timed steps
FLOW_TRAIN_B, FLOW_TRAIN_TOKENS, FLOW_STEPS = 4, 100, 2
FLOW_TRAIN_REL_TOL = 1e-3
TRAIN_SAVE_PER_STEP = 8

# The rest of training (phase 13). The small models' GAN turns float32 on the card and the CPU within
# GAN_TRAIN_REL_TOL; the DPO step and the GRPO update bf16 on the card against float32 on the CPU within
# SMALL_REL_TOL. At full width: the GAN turns on one batch as the recipe's pipeline gives it (GAN_ROWS crops of
# GAN_CROP samples, max_frames_in_batch 2000), a warm-up pair and GAN_STEPS timed pairs; a DPO step of
# DPO_PAIRS chosen / rejected pairs of DPO_T tokens, a warm-up and DPO_STEPS timed steps. cli.grpo_train at its
# defaults (GRPO_PROMPTS prompts x GRPO_GROUP rollouts, the echo reward) for GRPO_ITERS iterations on
# GRPO_TEXTS (12 byte-tokenizer ids each: rollouts of 24 to 240 tokens).
GAN_TRAIN_REL_TOL = 1e-3
GAN_CROP = 24960  # data/dataset.truncate
GAN_ROWS = 2000 // (GAN_CROP // 480)  # dynamic_batch at max_frames_in_batch 2000: 38 crops of 52 frames
GAN_STEPS = 2
DPO_PAIRS, DPO_T, DPO_STEPS = 8, 256, 2
GRPO_TEXTS = ("你好吗。", "早上好。", "谢谢你。", "再见了。")
GRPO_PROMPTS, GRPO_GROUP, GRPO_ITERS = 4, 8, 1  # one iteration: phase 14 needs the time

# The float32 routes. Each kernel's float32 route is held to its plain version run in float64 on the same
# float32 inputs (max |kernel - plain f64| over the valid rows), within these limits, each under F32_LIMIT_SHARE
# of the mean |output| it is held to (the products run in float32 FMAs, no TF32: about 1e-6 of the output).
DECODE_F32_ATOL = 2e-5
FLASH_F32_ATOL = 2e-5
INT4_F32_ATOL = 1e-4  # sums of up to 4,864 products of order one
ADALN_F32_ATOL = 1e-5  # float32 statistics over 1,024 elements, outputs up to about 8
F32_LIMIT_SHARE = 1e-3
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (the float32 routes' bound)
# A float32 model on the card against the CPU (phases 4 and 10): mel, wav and, on a float32 KV cache, the logits
# within this share of the CPU's max |.|
F32_REL_TOL = 1e-3
# Phase 4's float32 batch at full width: F32_B texts of F32_TEXT_TOKENS tokens, min = max ratio F32_RATIO
F32_B, F32_TEXT_TOKENS, F32_RATIO = 4, 12, 5.0
# Dataset generation and evaluation (phase 14): an aishell transcript of DG_AISHELL_LINES lines and a hunan.txt
# of DG_DIALECT_LINES, each text DG_CHARS characters of DG_POOL (15 byte-tokenizer ids: 30-300 speech tokens),
# 32 utterances in two batches of 16; run_eval on DG_EVAL_TEXTS; a RemoteToken2Wav stream of DG_STREAM_TOKENS
# tokens (past the 300-token window, so that its window hops run the flash kernel); the phase within
# DG_PHASE_LIMIT_S seconds.
DG_AISHELL_LINES, DG_DIALECT_LINES, DG_CHARS = 24, 8, 5
DG_POOL = "的一是在不了有和人这中大为上个国我以要他时来用们生到作地于出就分对成会可主发年动同工也能下过子说产种面而方后多定行学法所民得经"
DG_EVAL_TEXTS = ("你好。", "早上好。", "谢谢你。", "再见了。")
DG_STREAM_TOKENS = 400
DG_PHASE_LIMIT_S = 150
# compare_inference's sentences (39 and 45 byte-tokenizer ids) run to 20 x their ids with random weights: two took
# 59.8 s of a 114.4 s phase 14 on an H100 80GB HBM3 at 700 W (host-bound decode steps); one keeps the phase inside
# its limit on a host whose launches cost 1.4 x that one's
DG_COMPARE_TEXTS = 1
# Phase 17 (the MLA-MoE LM at full width): kernel times from a CUDA graph of MOON_REPS calls; the kernels held to
# their plain versions within MOON_KERNEL_TOL (relative error: bf16 rounding of the intermediate and of the
# probabilities, summed in another order); a 16-row batch of texts of MOON_TEXT_TOKENS at 6 speech tokens each;
# MOON_CHECK_ROWS of its rows' logits held to the float32 reference by the datagen cell's own limits (greedy gap and
# its mean, benchmark/workloads/cv3moon.datagen_b16.json): bf16 hidden states flip near-tied experts, so the logits'
# relative error (printed) is no tight measure at this depth
MOON_REPS = 20
MOON_KERNEL_TOL = 2e-2
MOON_TEXT_TOKENS = (6, 9, 12, 16, 20, 24, 30, 40)
MOON_CHECK_ROWS = 2
MOON_CELL = Path(__file__).resolve().parent / "benchmark" / "workloads" / "cv3moon.datagen_b16.json"

# Export, the recipe, the subsampling layers (phase 15): cli.export's --n_tokens (flow_solve at 2 x 256 = 512 frames);
# the recipe's corpus and epochs (stage 6 averages 5 checkpoints); the subsampling layers float32 card against CPU
# within SUB_REL_TOL of max |.| (cuDNN may take a Winograd or FFT algorithm for a float32 convolution).
EXPORT_TOKENS = 256
RECIPE_UTTS, RECIPE_EPOCHS = 12, 5
SUB_REL_TOL = 1e-4

# The full-width models (CosyVoice3-0.5B, and CosyVoice2-0.5B's LM in phase 10) run at every published width and a
# cut depth (full_config): FULL_LLM_LAYERS of the Qwen LM's 24 layers and FULL_DIT_DEPTH of the DiT's 22 blocks.
# Most phases are host-bound (a decode step's launches, the export's trace), and at full depth the whole script took
# 1,087.5 s on an H100 80GB HBM3 at 700 W, phase 14 116.7 s of it, and phase 14 158.7 s on a host whose decode
# steps took 1.3-1.4 x as long.
FULL_LLM_LAYERS, FULL_DIT_DEPTH = 6, 6

# Multi-process on one card (phase 16): MP_RANKS processes on card 0 over gloo (nccl refuses two ranks on one
# device) run full_config() sharded: (a) the 150-token request (MP_TEXT_TOKENS text tokens, min = max ratio MP_RATIO)
# through a TP=2 LM, greedy, float32 weights from MP_SEED: tokens equal to one process up to the first near-tie
# (GREEDY_TIE); then teacher-forced on the one process's picks, every logits row within MP_LOGIT_TOL of max |.|
# (the decode runs in the bf16 cache); (a') teacher-forced as well through a TP=2 LM with the int8 LLM and int4
# MLP, bf16; (b) a TP=2 shard_token2wav, bf16, two hops of a stream of MP_STREAM_TOKENS tokens with a window of
# MP_WINDOW tokens (hop 1 the KV-cached estimator, hop 2 a window hop: the flash kernel), mel within MP_MEL_TOL of
# max |.|; (c) a dp=2 LM train step on one global batch of MP_TRAIN_B x MP_TRAIN_T tokens (bf16 compute) within
# SMALL_REL_TOL of the one-process step. The phase within MP_PHASE_LIMIT_S seconds.
MP_RANKS, MP_SEED = 2, 0
MP_TEXT_TOKENS, MP_RATIO = 30, 5.0
MP_WINDOW, MP_STREAM_TOKENS = 50, 80
MP_TRAIN_B, MP_TRAIN_T = 8, 256
MP_LOGIT_TOL = MP_MEL_TOL = 5e-2
MP_PHASE_LIMIT_S = 90

CARDS_USED = 1  # every phase runs on card 0
# kernel names the profile reports
PORT_KERNELS = ("decode_attention", "flash_attention", "int4_matmul", "fangyan_adaln", "fangyan_rms_norm",
                "fangyan_qkv_rope")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12


_START = time.perf_counter()


def full_config():
    """CosyVoiceConfig() with FULL_LLM_LAYERS Qwen layers and FULL_DIT_DEPTH
    DiT blocks; every width, vocabulary and head count as published."""
    from dataclasses import replace

    from fangyan_tts_torch.config import CosyVoiceConfig

    cfg = CosyVoiceConfig()
    return replace(cfg, llm=replace(cfg.llm, qwen=replace(cfg.llm.qwen, num_hidden_layers=FULL_LLM_LAYERS)),
                   flow=replace(cfg.flow, dit=replace(cfg.flow.dit, depth=FULL_DIT_DEPTH)))


def log(msg: str, stamp: bool = True) -> None:
    """Print a line, by default after the seconds since the script started."""
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}" if stamp else msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph,
    replayed `reps` times between two CUDA events (host launch cost
    excluded). Inputs stay in the 50 MB L2 between calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def eager_ms(fn, iters: int = 50) -> float:
    """Wall time of one eager call, launch cost included (what the main
    path pays per call)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def launch_probe(results: dict, label: str) -> float:
    """The host's cost of one eager launch now: the wall µs a call of 2,000
    one-element adds (the device takes about 2 µs each). Logged at points
    of the run, to show what the launch-bound paths pay there."""
    import torch

    x = torch.zeros(1, device="cuda")
    us = eager_ms(lambda: x.add_(1.0), iters=2000) * 1e3
    results.setdefault("launch_probe_us", {})[label] = us
    log(f"host launch probe ({label}): {us:.2f} us an eager launch")
    return us


def cycling(fn, n: int):
    """A call that passes 0, 1, ..., n-1, 0, ... to `fn` on successive calls
    (to walk over n copies of a weight, as the layers of a model do)."""
    it = itertools.cycle(range(n))
    return lambda: fn(next(it))


def flash_q_scale(l: int) -> float:
    """q's scale in the flash checks at L keys (see FLASH_KEYS)."""
    return max(QK_SCALE, math.sqrt(math.log(l / FLASH_KEYS)))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def held(name: str, err: float, err_bf16: float, limit: float, scale: float) -> str:
    """Check a kernel's max error `err` against its plain version in float32:
    within `limit`, and no larger than the bf16 plain version's `err_bf16`.
    `scale` is the mean |plain f32| over the valid rows; a limit over
    MAX_LIMIT_SHARE of it would be too loose for this data, and raises."""
    if limit > MAX_LIMIT_SHARE * scale:
        raise AssertionError(f"{name}: limit {limit:.1e} is over {MAX_LIMIT_SHARE} of the mean |output| "
                             f"{scale:.3e}; the check would be too loose for this data")
    msg = (f"max|kernel-plain f32|={err:.3e} (limit {limit:.1e} = {limit / scale:.3f} of mean|plain f32|="
           f"{scale:.3e}; max|plain bf16-plain f32|={err_bf16:.3e})")
    if not err <= min(limit, err_bf16):
        raise AssertionError(f"{name} kernel disagrees with its plain version: {msg}")
    return msg


def batch_requests_spec() -> tuple[dict, dict]:
    """The batch_synthesize arguments of requests (a) and (b) (see
    batched_requests)."""
    rng = np.random.default_rng(1)
    xvec = rng.standard_normal(192).astype(np.float32)
    req_a = dict(texts=[rng.integers(0, 50000, 30).astype(np.int32) for _ in range(16)], flow_embedding=xvec,
                 min_token_text_ratio=5, max_token_text_ratio=5)
    req_b = dict(texts=[rng.integers(0, 50000, int(n)).astype(np.int32) for n in rng.integers(12, 41, 16)],
                 flow_embedding=xvec, prompt_text=rng.integers(0, 50000, 10).astype(np.int32),
                 llm_prompt_speech_token=rng.integers(0, 6561, 50).astype(np.int32),
                 flow_prompt_speech_token=rng.integers(0, 6561, 50).astype(np.int32),
                 prompt_speech_feat=(rng.standard_normal((100, 80)) * 0.5).astype(np.float32),
                 min_token_text_ratio=5, max_token_text_ratio=5)
    return req_a, req_b


def batch_shapes(req: dict) -> dict:
    """The kernel shapes a batch_synthesize request gives, from the port's
    own buckets (infer/tts.batch_buckets): B rows, a prefill of B x tp rows,
    the cache length, and the flow length of the longest row (the requests'
    min and max ratios are equal, so every row stops at its max length)."""
    from fangyan_tts_torch.infer.tts import batch_buckets

    cfg = full_config()
    texts, ratio = req["texts"], req["max_token_text_ratio"]
    _, tp, _, cache_len = batch_buckets(cfg.llm, texts, req.get("prompt_text", np.zeros(0, np.int32)),
                                        req.get("llm_prompt_speech_token", np.zeros(0, np.int32)), ratio)
    longest = max(int(len(t) * ratio) for t in texts) + len(req.get("flow_prompt_speech_token", ()))
    return dict(b=len(texts), tp=tp, prefill_m=len(texts) * tp, cache_len=cache_len,
                l_mel=-(-longest // 64) * 64 * cfg.token_mel_ratio)


def api_request_spec() -> dict:
    """The API request's lengths and kernel shapes, fixed before any model
    runs by the byte tokenizer, text_normalize and the 5 s prompt bucket:
    the text and prompt-text ids, the prompt tokens (S3's 25 Hz codes of the
    16 kHz prompt, cut to half the 24 kHz mel frames), the decode cache
    length (CosyVoice3TTS.generate_tokens's buckets), and every flow length
    the decode can give: the tokens it keeps run from 0 (silent runs are
    dropped) to max_len, padded with the prompt tokens to a multiple of 32,
    times 2 mel frames a token."""
    import warnings

    from fangyan_tts_torch.data.lm_plan import build_prompt_plan
    from fangyan_tts_torch.infer.frontend import Frontend
    from fangyan_tts_torch.tokenizer import get_qwen_tokenizer

    cfg = full_config()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fe = Frontend(get_qwen_tokenizer(None, True, "cosyvoice3"), cfg, device="cpu")
    segs = fe.text_normalize(API_TEXT)
    assert len(segs) == 1, segs
    text = fe.extract_text_token(segs[0])
    prompt_text = fe.extract_text_token(fe.text_normalize(API_PROMPT_TEXT, split=False))
    mel_frames_16k = API_PROMPT_SECONDS * 16000 // 160
    n_prompt = min(API_PROMPT_SECONDS * cfg.sample_rate // cfg.mel.hop_size // 2, ((mel_frames_16k + 1) // 2 + 1) // 2)
    plan = build_prompt_plan(cfg.llm, np.concatenate([prompt_text, text]).tolist(), [0] * n_prompt)
    up = lambda n, m: -(-n // m) * m
    tp = up(len(plan.ids), 64)
    max_len = int(len(text) * 20.0)
    cache_len = up(tp + max(up(max(max_len, 1), 64), 64), 128)
    flash_l = sorted({up(n_prompt + n, 32) * cfg.token_mel_ratio for n in range(max_len + 1)})
    return dict(text_ids=len(text), prompt_text_ids=len(prompt_text), prompt_tokens=n_prompt, plan_len=len(plan.ids),
                tp=tp, max_len=max_len, cache_len=cache_len, flash_l=flash_l)


def stream_requests_spec() -> tuple[dict, list]:
    """The streaming requests' tts arguments (S1-S3, random bf16 weights take
    them) and S5's text chunks. S1 and S2 are bench.py's
    bench_first_chunk and bench_solo_streaming: 10 and 16 text tokens, min =
    max ratio 20 (200 and 320 tokens), no prompt. S3 is a zero-shot stream:
    10 prompt-text tokens, 60 prompt speech tokens (prompt_pad 15), a
    120-frame prompt mel, an x-vector, and 20 text tokens forced to 400
    tokens."""
    rng = np.random.default_rng(8)
    xvec = rng.standard_normal(192).astype(np.float32)
    ratio = dict(min_token_text_ratio=20.0, max_token_text_ratio=20.0)
    prompt = rng.integers(0, 6561, 60).astype(np.int32)
    reqs = {
        "S1": dict(text=rng.integers(0, 50000, 10).astype(np.int32), flow_embedding=xvec, **ratio),
        "S2": dict(text=rng.integers(0, 50000, 16).astype(np.int32), flow_embedding=xvec, **ratio),
        "S3": dict(text=rng.integers(0, 50000, 20).astype(np.int32), prompt_text=rng.integers(0, 50000, 10).astype(np.int32),
                   llm_prompt_speech_token=prompt, flow_prompt_speech_token=prompt,
                   prompt_speech_feat=(rng.standard_normal((120, 80)) * 0.5).astype(np.float32), flow_embedding=xvec,
                   **ratio),
    }
    return reqs, [rng.integers(0, 50000, 5).astype(np.int32) for _ in range(4)]


def stream_shapes(api: dict) -> dict:
    """The kernel shapes of the streaming requests: the decode caches of
    S1-S3 and of the API stream (infer/tts.stream_buckets, the function
    _stream_tokens uses), with the last slot each can write and its first
    valid slot, and the bistream cache; the flash window lengths (P + W) * 2
    for the prompt lengths the streams take (none, S3's 60, the API's),
    each the CFG pair with every frame valid."""
    from fangyan_tts_torch.infer.tts import stream_buckets

    cfg = full_config()
    decode = []
    reqs, _ = stream_requests_spec()
    zeros = np.zeros(0, np.int32)
    for name, r in reqs.items():
        plan, tp, cache_len, _, max_len = stream_buckets(cfg.llm, r["text"], r.get("prompt_text", zeros),
                                                         r.get("llm_prompt_speech_token", zeros), 20.0, 20.0)
        decode.append((name, cache_len, tp + max_len + 31, tp - len(plan.ids)))  # a chunk runs on past max_len
    plan, tp, cache_len, _, max_len = stream_buckets(
        cfg.llm, np.zeros(api["text_ids"], np.int32), np.zeros(api["prompt_text_ids"], np.int32),
        np.zeros(api["prompt_tokens"], np.int32), 2.0, 20.0)
    decode.append(("S4 API", cache_len, tp + max_len + 31, tp - len(plan.ids)))
    decode.append(("S5 bistream", BISTREAM_CACHE, BISTREAM_CACHE - 1, 0))
    prompts = sorted({0, len(reqs["S3"]["flow_prompt_speech_token"]), api["prompt_tokens"]})
    return dict(decode=decode, flash_l=[(p + STREAM_WINDOW) * cfg.token_mel_ratio for p in prompts])


def serving_spec(api: dict) -> dict:
    """The kernel shapes of phase 9, from the schedulers' own buckets: the
    LLMScheduler's decode at its width and the bucket of
    infer/tts.stream_buckets (its formula), with a per-row write slot and
    window; and every flow call of the StreamScheduler's groups
    (infer/batch_stream.flow_shapes) for (a) and (c) (no prompt) and for (b)
    (the API prompt), as {(rows, L): kind}. The HTTP requests' text ids come
    from the byte tokenizer and text_normalize, as the API request's do."""
    import warnings

    from fangyan_tts_torch.infer.batch_stream import flow_shapes
    from fangyan_tts_torch.infer.frontend import Frontend
    from fangyan_tts_torch.infer.tts import stream_buckets
    from fangyan_tts_torch.tokenizer import get_qwen_tokenizer

    cfg = full_config()
    zeros = np.zeros(0, np.int32)
    decode = set()
    for width in SERVE_WIDTHS:
        _, tp, s, _, _ = stream_buckets(cfg.llm, np.zeros(SERVE_TEXT_TOKENS, np.int32), zeros, zeros, SERVE_RATIO,
                                        SERVE_RATIO)
        decode.add((width, s, tp))
    _, tp, s, _, _ = stream_buckets(cfg.llm, np.zeros(SERVE_TEXT_TOKENS, np.int32), zeros, zeros, GREEDY_RATIO,
                                    GREEDY_RATIO)
    decode.add((4, s, tp))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fe = Frontend(get_qwen_tokenizer(None, True, "cosyvoice3"), cfg, device="cpu")
    http_ids = []
    for text in HTTP_TEXTS:
        segs = fe.text_normalize(text)
        assert len(segs) == 1, segs
        http_ids.append(len(fe.extract_text_token(segs[0])))
        _, tp, s, _, _ = stream_buckets(cfg.llm, np.zeros(http_ids[-1], np.int32),
                                        np.zeros(api["prompt_text_ids"], np.int32),
                                        np.zeros(api["prompt_tokens"], np.int32))
        decode.add((HTTP_WIDTH, s, tp))
    flash: dict = {}
    for n_prompt, width in [(0, w) for w in SERVE_WIDTHS] + [(api["prompt_tokens"], HTTP_WIDTH)]:
        for kind, shapes in flow_shapes(cfg, STREAM_WINDOW, n_prompt, width).items():
            for sh in shapes:
                flash.setdefault(sh, kind)
    return dict(decode=sorted(decode), flash=flash, http_ids=http_ids)


def _checked(results: dict, kernel: str, key: tuple) -> None:
    results.setdefault("checked", {}).setdefault(kernel, set()).add(key)


# ---------------------------------------------------------------- phase 3


def serving_decode_rows(b: int, s: int, tp: int, kv: int = 2) -> tuple[list, list]:
    """(write slots, first valid slots) of a B-row continuous batch at cache
    S: one row at slot 0, one at the first block boundary of the launch
    plan, one at S - 1 and a free row whose slot runs past S (clamped to
    S - 1, every slot open), the rest at random depths past the prompt
    bucket tp; each row's window is [first, slot + 1)."""
    from fangyan_tts_torch.ops import decode_attention as da

    rng = np.random.default_rng(b * 1000 + s)
    edge = da.plan(b, s, kv)[1]
    idx = [0, edge, s - 1, s + 37] + [int(v) for v in rng.integers(tp, s - 1, b - 4)]
    starts = [0, tp // 2, 5, 0] + [int(v) for v in rng.integers(0, tp, b - 4)]
    return idx, starts


def check_decode_rows(results: dict, serving: dict) -> None:
    """Decode attention at the continuous batch's shapes: each row of a B-row
    call (its own write slot and window) bit-equal to a B = 1 call on that
    row alone, output and cache writes (plan(1, S) = plan(B, S) here)."""
    import torch

    from fangyan_tts_torch.ops import decode_attention as da

    nl, kv, hd, qh = FULL_LLM_LAYERS, 2, 64, 14
    gen = torch.Generator(device="cuda").manual_seed(3)
    for b, s, tp in serving["decode"]:
        idx_list, starts = serving_decode_rows(b, s, tp, kv)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        q = (torch.randn((b, qh, hd), generator=gen, device="cuda") * QK_SCALE).to(torch.bfloat16)
        kn, vn, ck, cv = rnd(b, kv, hd), rnd(b, kv, hd), rnd(nl, b, s, kv, hd), rnd(nl, b, s, kv, hd)
        idx = torch.tensor(idx_list, dtype=torch.int32, device="cuda")
        slot = torch.arange(s, device="cuda")[None, :]
        first = torch.tensor(starts, device="cuda")[:, None]
        bias = torch.where((slot >= first) & (slot <= torch.clamp(idx, max=s - 1)[:, None]), 0.0, -1e10).float()
        same = True
        for layer in (0, nl - 1):
            ckb, cvb = ck.clone(), cv.clone()
            out_b = da.decode_attention(q, kn, vn, ckb, cvb, idx, bias, layer)
            for r in range(b):
                ckr, cvr = ck[:, r : r + 1].clone(), cv[:, r : r + 1].clone()
                out_r = da.decode_attention(q[r : r + 1], kn[r : r + 1], vn[r : r + 1], ckr, cvr, idx[r : r + 1],
                                            bias[r : r + 1].contiguous(), layer)
                same &= (torch.equal(out_b[r : r + 1], out_r) and torch.equal(ckb[:, r : r + 1], ckr)
                         and torch.equal(cvb[:, r : r + 1], cvr))
        torch.cuda.synchronize()
        _checked(results, "decode_attention", (1, s, kv, qh))
        log(f"decode_attention B={b} S={s} (continuous batch, plan {da.plan(b, s, kv)}; B=1 plan "
            f"{da.plan(1, s, kv)}): slots {idx_list}, windows from {starts}: every row bit-equal to a B=1 call "
            f"on it alone (output and cache writes, layers 0 and {nl - 1})={same}")
        results.setdefault("decode_rows_bit_equal", {})[f"B={b} S={s} tp={tp}"] = same
        if not same:
            raise AssertionError(f"decode_attention B={b} S={s}: a row differs from the B=1 call on it")


def check_decode(results: dict, batches: list[dict], api: dict, stream: dict, serving: dict, v12: dict,
                 grpo: dict, dg: dict | None = None, ex: dict | None = None, mp: dict | None = None) -> None:
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import decode_attention as da

    nl, kv, hd, qh = FULL_LLM_LAYERS, 2, 64, 14
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    # S = 256: the 150-token requests' cache (B = 4: a write past the end, clamped, and a row with no
    # open slot, start 256); S = 768: the zero-shot request's; B = 16: the batched requests' caches,
    # left-padded rows whose first valid slot differs; B = 2: write slots on each side of the first
    # block boundary of the launch plan; S = 4096: one long cache (a block of 512 slots)
    starts16 = [int(v) for v in np.random.default_rng(5).integers(0, 40, 16)]
    edge = da.plan(2, 256, kv)[1]
    shapes = [(1, 256, [100], [0]), (4, 256, [0, 100, 255, 300], [0, 0, 0, 256]), (1, 768, [700], [0]),
              (2, 256, [edge - 1, edge], [0, 0]), (1, 4096, [4000], [0])]
    # phase 10's v2 decodes, each at its own last write slot and first valid slot (tts_v12's formulas)
    for label, b, s, idx, start in v12["decode"]:
        shapes.append((b, s, idx, start, label))
    for s in sorted({sh["cache_len"] for sh in batches}):
        shapes.append((16, s, [s - 56] * 16, starts16))
    if api["cache_len"] not in {sh[1] for sh in shapes if sh[0] == 1}:  # the API request's cache
        s = api["cache_len"]
        shapes.append((1, s, [api["tp"] + api["max_len"] - 1], [api["tp"] - api["plan_len"]]))
    for _, s, idx, start in stream["decode"]:  # the streams' caches (one row each), not checked above
        if s not in {sh[1] for sh in shapes if sh[0] == 1}:
            shapes.append((1, s, [idx], [start]))
    for b, s, tp in serving["decode"] + v12["sched"]:  # the continuous batches: a write slot and a window per row
        shapes.append((b, s, *serving_decode_rows(b, s, tp, kv)))
    # phase 13's GRPO rollouts: prompts x group left-padded rows, each at the last slot a rollout can write
    shapes.append((grpo["b"], grpo["cache_len"], [grpo["tp"] + grpo["max_new"] - 1] * grpo["b"], grpo["starts"],
                   "GRPO rollouts"))
    if dg is not None:  # phase 14: the dataset CLI's batches of 16, compare_inference's and run_eval's requests
        c = dg["cli"]
        shapes.append((16, c["cache_len"], [c["last"]] * 16, c["starts"], "phase 14 CLI batch"))
        for r in dg["single"]:
            if r["cache_len"] not in {sh[1] for sh in shapes if sh[0] == 1}:
                shapes.append((1, r["cache_len"], [r["last"]], [r["start"]], "phase 14 " + r["label"]))
    if ex is not None:  # phase 15 (b): the recipe's compare_inference on its small model (its own layers and heads)
        for r in ex["recipe"]["single"]:
            shapes.append((1, r["cache_len"], [r["last"]], [r["start"]], "phase 15 recipe " + r["label"],
                           ex["recipe"]["decode_dims"]))
    if mp is not None:  # phase 16: the TP=2 decode of the 150-token request, each rank's half of the heads
        shapes.append((1, mp["cache_len"], [mp["last"]], [mp["start"]], "phase 16 TP=2",
                       (FULL_LLM_LAYERS, mp["kv"], mp["qh"])))
    for b, s, idx_list, starts, *label in shapes:
        nl, kv, qh = label.pop() if len(label) > 1 else (FULL_LLM_LAYERS, 2, 14)  # (layers, KV heads, query heads)
        _checked(results, "decode_attention", (b, s, kv, qh))
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q = (torch.randn((b, qh, hd), generator=gen, device=dev) * QK_SCALE).to(torch.bfloat16)
        kn, vn = rnd(b, kv, hd), rnd(b, kv, hd)
        ck, cv = rnd(nl, b, s, kv, hd), rnd(nl, b, s, kv, hd)
        idx = torch.tensor(idx_list, dtype=torch.int32, device=dev)
        valid = torch.clamp(idx, max=s - 1) + 1
        slot = torch.arange(s, device=dev)[None, :]
        first = torch.tensor(starts, device=dev)[:, None]
        bias = torch.where((slot >= first) & (slot < valid[:, None]), 0.0, -1e10).float().contiguous()
        # the caller's layout too: q, k_new and v_new as views of one fused qkv row per batch row
        # (models/qwen2.py), which must give the contiguous call's output and writes bit for bit
        qkv = torch.cat([q.reshape(b, -1), kn.reshape(b, -1), vn.reshape(b, -1)], dim=1)
        views = (qkv[:, : qh * hd].view(b, qh, hd), qkv[:, qh * hd: (qh + kv) * hd].view(b, kv, hd),
                 qkv[:, (qh + kv) * hd:].view(b, kv, hd))
        ck4, cv4 = ck.clone(), cv.clone()
        out_v = da.decode_attention(*views, ck4, cv4, idx, bias, 0)
        ck5, cv5 = ck.clone(), cv.clone()
        out_c = da.decode_attention(q, kn, vn, ck5, cv5, idx, bias, 0)
        torch.cuda.synchronize()
        same = torch.equal(out_v, out_c) and torch.equal(ck4, ck5) and torch.equal(cv4, cv5)
        log(f"decode_attention B={b} S={s} plan {da.plan(b, s, kv)} (blocks a cluster, slots a block): strided "
            f"q/k_new/v_new views (batch stride {qkv.stride(0)}) equal to the contiguous call={same}")
        if not same:
            raise AssertionError("decode_attention kernel on strided views differs from the contiguous call")
        del ck4, cv4, ck5, cv5
        for layer in (0, nl - 1):
            ck1, cv1, ck2, cv2, ck3, cv3 = ck.clone(), cv.clone(), ck.clone(), cv.clone(), ck.clone(), cv.clone()
            out_k = da.decode_attention(q, kn, vn, ck1, cv1, idx, bias, layer).float()
            out_p = da.decode_attention_plain(q, kn, vn, ck2, cv2, idx, bias, layer).float()
            # the plain version in float32 on the same inputs (a float32 q makes it cast K and V up)
            out_f = da.decode_attention_plain(q.float(), kn, vn, ck3, cv3, idx, bias, layer)
            torch.cuda.synchronize()
            err = (out_k - out_f).abs().max().item()
            msg = held("decode_attention", err, (out_p - out_f).abs().max().item(), DECODE_ATOL,
                       out_f.abs().mean().item())
            caches_equal = all(torch.equal(a, c) for a, c in ((ck1, ck2), (cv1, cv2), (ck1, ck3), (cv1, cv3)))
            finite = bool(torch.isfinite(out_k).all())
            rows.append(dict(b=b, layer=layer, err=err, caches_equal=caches_equal))
            log(f"decode_attention B={b} S={s} L={nl} layer={layer} idx={idx_list[:4]} starts={starts[:4]}: {msg} "
                f"caches bit-equal={caches_equal} finite={finite}")
            if not (caches_equal and finite):
                raise AssertionError("decode_attention kernel wrote other cache rows than its plain version")
        # timing at this shape (layer 0)
        run_k = lambda: da.decode_attention(q, kn, vn, ck, cv, idx, bias, 0)
        ms_k, ms_e = time_ms(run_k), eager_ms(run_k)
        ms_p = time_ms(lambda: da.decode_attention_plain(q, kn, vn, ck, cv, idx, bias, 0))
        kl = ck[0].permute(0, 2, 1, 3).contiguous()  # (B, KV, S, hd)
        vl = cv[0].permute(0, 2, 1, 3).contiguous()
        mask = (bias == 0)[:, None, None, :]
        q4 = q[:, :, None, :]
        ms_l = time_ms(lambda: F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask, enable_gqa=True))
        # what this data needs: q and out, the new rows read and written, K and
        # V of the slots the bias leaves open (a masked slot's weight is exactly
        # 0), the whole bias and idx; two products per (query head, open slot)
        open_slots = int((bias > -1e9).sum().item())
        nbytes = 2 * (b * qh * hd) * 2 + 2 * (b * kv * hd) * 2 * 2 + 2 * (open_slots * kv * hd) * 2 + b * s * 4 + b * 4
        flops = 2 * 2 * qh * hd * open_slots
        bms, by = bound(nbytes, flops)
        results.setdefault("decode_timing", []).append(
            dict(b=b, s=s, kv=kv, qh=qh, ms=ms_k, eager_ms=ms_e, plain_ms=ms_p, library_ms=ms_l, bound_ms=bms, bound_by=by,
                 label=label[0] if label else ""))
        log(f"decode_attention B={b} S={s}{' (' + label[0] + ')' if label else ''}: kernel {ms_k * 1e3:.2f} us (eager call {ms_e * 1e3:.1f} us), "
            f"plain {ms_p * 1e3:.1f} us, "
            f"sdpa {ms_l * 1e3:.1f} us, bound {bms * 1e3:.3f} us ({by})")
    results["decode_err"] = max(r["err"] for r in rows)


def check_flash(results: dict, batches: list[dict], api: dict, stream: dict, serving: dict, grpo: dict,
                dg: dict | None = None, ex: dict | None = None, mp: dict | None = None) -> None:
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import flash_attention as fa
    from fangyan_tts_torch.ops.masks import chunk_attn_mask

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = []
    # L = 320: the 150-token requests (CFG pair, one length); L = 1344: the zero-shot request;
    # 2B = 32 rows: the batched requests, ragged mel_len, each length twice (the CFG pair)
    rag = np.random.default_rng(6)
    shapes = [(320, (320, 250)), (448, (448, 301)), (1344, (1300, 1300))]
    for l in sorted({sh["l_mel"] for sh in batches}):
        shapes.append((l, tuple(int(v) for v in rag.integers(l * 5 // 8, l + 1, 16)) * 2))
    # the streaming windows: the CFG pair, every frame valid, L = (P + W) * 2 (no multiple of 64)
    shapes += [(l, (l, l)) for l in stream["flash_l"]]
    # the serving groups (phase 9): window hops and the cohort finalize at 2N rows, every frame valid; the
    # bucketed young hops at 2N rows, each row its own mel_len (a row without a hop has 2 frames), timed at
    # the 200-token streams' largest bucket (L = 384); every other flow shape of the groups checked untimed
    # (a young hop or finalize of one slot: its tokens padded to 32 frames the second)
    def serving_mel(rows: int, l: int, kind: str) -> tuple:
        if kind == "young":
            return tuple(int(v) for v in rag.integers(2, l + 1, rows // 2)) * 2
        return (l - 6,) * rows if kind == "slot finalize" else (l,) * rows

    known = {(len(mel), l) for l, mel in shapes}
    serving_timed = [(rows, l, kind) for (rows, l), kind in sorted(serving["flash"].items())
                     if rows > 2 and (kind == "window" or l == 384) and (rows, l) not in known]
    shapes += [(l, serving_mel(rows, l, kind)) for rows, l, kind in serving_timed]
    if ex is not None:  # phase 15 (a): the exported flow_solve's CFG pair at 2 x --n_tokens frames, every frame valid
        l = ex["export"]["flash_l"]
        shapes.append((l, (l, l)))
    # the DiT's own layout too: q and k (B, L, H*D) projections and v a slice of the (B, L, 3*H*D) qkv
    # buffer, each viewed as (B, H, L, D) without a copy (models/dit.py); L = 1344, the larger batch, the
    # streaming windows and the serving groups' timed shapes
    strided = {1344, max(sh["l_mel"] for sh in batches), *stream["flash_l"], *(l for _, l, _ in serving_timed),
               *([ex["export"]["flash_l"]] if ex is not None else [])}
    runs = [(sh, "contiguous") for sh in shapes] + [(sh, "strided") for sh in shapes if sh[0] in strided]
    # the API request's CFG pair at every length its decode can give, checked and not timed (the
    # longest is its run to max_len, as the zero-shot request's)
    known = {(len(mel), l) for l, mel in shapes}
    runs += [((l, (l - 6, l - 6)), "untimed") for l in api["flash_l"] if (2, l) not in known]
    known |= {(2, l) for l in api["flash_l"]}
    # phase 13's GRPO token2mel calls: the CFG pair at every length bucket a rollout can reach
    runs += [((l, (l - 6, l - 6)), "untimed") for l in grpo["flash_l"] if (2, l) not in known]
    known |= {(2, l) for l in grpo["flash_l"]}
    if dg is not None:  # phase 14: the CLI's 2 x 16 rows at every flow length, the single requests' CFG pairs
        runs += [((l, tuple(int(v) for v in rag.integers(l // 4, l + 1, 16)) * 2), "untimed")
                 for l in dg["cli"]["flash_l"] if (32, l) not in known]
        known |= {(32, l) for l in dg["cli"]["flash_l"]}
        for r in dg["single"]:
            runs += [((l, (l - 6, l - 6)), "untimed") for l in r["flash_l"] if (2, l) not in known]
            known |= {(2, l) for l in r["flash_l"]}
    runs += [((l, serving_mel(rows, l, kind)), "untimed") for (rows, l), kind in sorted(serving["flash"].items())
             if (rows, l) not in known]
    if ex is not None:  # phase 15 (b): the recipe's small DiT (its own heads): stage 7's export, compare_inference's pairs
        rec = ex["recipe"]
        runs += [((l, (l, l)), "untimed", rec["heads"]) for l in rec["export_l"]]
        runs += [((l, (l - 6, l - 6)), "untimed", rec["heads"]) for l in rec["flash_l"] if l not in rec["export_l"]]
    if mp is not None:  # phase 16: the TP=2 window hop's CFG pair, each rank's half of the heads, timed; the DiT's views
        runs += [((mp["flash_l"], (mp["flash_l"],) * 2), layout, mp["heads"]) for layout in ("contiguous", "strided")]
    for (l, mel), layout, *heads in runs:
        b, h, d = len(mel), (heads[0] if heads else 16), 64
        _checked(results, "chunk_flash_attention", (b, l, h))
        rnd = lambda shape, scale: (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
        if layout in ("contiguous", "untimed"):
            q, k, v = rnd((b, h, l, d), flash_q_scale(l)), rnd((b, h, l, d), 1.0), rnd((b, h, l, d), 1.0)
        else:
            heads = lambda t: t.reshape(b, l, h, d).transpose(1, 2)
            qkv = rnd((b, l, 3 * h * d), 1.0)
            q, k = heads(rnd((b, l, h * d), flash_q_scale(l))), heads(rnd((b, l, h * d), 1.0))
            v = heads(qkv[..., 2 * h * d:])
        mel_len = torch.tensor(mel, dtype=torch.int32, device=dev)
        for chunk in (0, 50):
            out_k = fa.chunk_flash_attention(q, k, v, mel_len, chunk)
            out_p = fa.chunk_flash_attention_plain(q, k, v, mel_len, chunk)
            out_f = fa.chunk_flash_attention_plain(q.float(), k.float(), v.float(), mel_len, chunk)
            same = True
            if layout == "strided":  # the layout must not change a bit of the result
                same = torch.equal(out_k, fa.chunk_flash_attention(*(t.contiguous() for t in (q, k, v)), mel_len, chunk))
            torch.cuda.synchronize()
            valid = lambda t: torch.cat([t[bi, :, :mel[bi]].float().flatten() for bi in range(b)])  # rows < mel_len
            vk, vp, vf = valid(out_k), valid(out_p), valid(out_f)
            err = (vk - vf).abs().max().item()
            msg = held("chunk_flash_attention", err, (vp - vf).abs().max().item(), FLASH_ATOL, vf.abs().mean().item())
            finite = bool(torch.isfinite(out_k.float()).all())
            errs.append(err)
            log(f"chunk_flash_attention ({b},{h},{l},{d}) {layout} chunk={chunk} mel_len={mel[:4]}: {msg} "
                f"all rows finite={finite}" + (f" equal to the contiguous call={same}" if layout == "strided" else ""))
            if not (finite and same):
                raise AssertionError("chunk_flash_attention kernel gave a row that is not finite, or a strided "
                                     "call that differs from the contiguous one")
            if layout == "untimed":
                continue
            run_k = lambda: fa.chunk_flash_attention(q, k, v, mel_len, chunk)
            ms_k, ms_e = time_ms(run_k), eager_ms(run_k)
            ms_p = time_ms(lambda: fa.chunk_flash_attention_plain(q, k, v, mel_len, chunk))
            mask = chunk_attn_mask(mel_len, l, chunk)[:, None]  # (B, 1, L, L) bool, built outside the timing
            ms_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            pairs = int(mask.sum().item()) * h  # (query, key) pairs this data needs
            # q and out over every row; K and V only below each row's mel_len
            nbytes = 2 * b * h * l * d * 2 + sum(min(m, l) for m in mel) * h * d * 2 * 2 + b * 4
            bms, by = bound(nbytes, 4 * d * pairs)
            results.setdefault("flash_timing", []).append(
                dict(b=b, l=l, h=h, chunk=chunk, layout=layout, ms=ms_k, eager_ms=ms_e, plain_ms=ms_p, library_ms=ms_l,
                     bound_ms=bms, bound_by=by, dense_bound_ms=4 * b * h * l * l * d / BF16_FLOP_PER_S * 1e3))
            log(f"chunk_flash_attention B={b} L={l} {layout} chunk={chunk}: kernel {ms_k * 1e3:.2f} us (eager call "
                f"{ms_e * 1e3:.1f} us), plain {ms_p * 1e3:.1f} us, "
                f"sdpa {ms_l * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by})")
    results["flash_err"] = max(errs)


def check_int4(results: dict, batch_b: dict, mp: dict | None = None) -> None:
    """int4_matmul at the LLM's MLP shapes: M = 1 and 512, and the two that
    request (b) runs, its decode (M = B = 16) and its prefill (M = B x tp);
    and one M on each side of the launch plan's route boundary (16 | 17,
    between the 16-token decode blocks and the 128-token blocks) and
    M = 100, which is no multiple of a tile. The block's channels (64, 128 or
    256) and the cluster split follow from M and N; gate_up_proj and
    down_proj at these M take each of them. With `mp`, also phase 16's
    TP=2 int4 decode: each rank's half of the MLP (gate_up_proj's columns,
    down_proj's rows) at its prefill M and its decode M = 1.
    The weights are N(0, 1/K) quantized by the port, x is N(0, 1), so
    outputs are of order one. Times cycle over 24 weight copies (the 24
    layers), so the packed weight is read from device memory and not from
    L2, as on the main path."""
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import int4_matmul as i4
    from fangyan_tts_torch.ops.quant import quantize_int4_packed, unpack_int4

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    errs = []
    edges = {i4.DECODE_TILE_M, i4.DECODE_TILE_M + 1, 100}
    ms = sorted({1, 512, batch_b["b"], batch_b["prefill_m"]} | edges)
    cases = [("gate_up_proj", 896, 9728, ms), ("down_proj", 4864, 896, ms)]
    if mp is not None:
        cases += [(f"{name} TP=2", k, n, sorted(mp["int4_m"])) for name, k, n in mp["int4"]]
    for name, k, n, m_list in cases:
        copies = [quantize_int4_packed(torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k))
                  for _ in range(24)]
        w, s = copies[0]
        # the library call's weight: dequantized, scale folded in, torch's (N, K)
        lib_w = [(unpack_int4(wc).float() * sc).t().contiguous().to(torch.bfloat16) for wc, sc in copies]
        for m in m_list:
            _checked(results, "int4_matmul", (m, k, n))
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            out_k = i4.int4_matmul(x, w, s).float()
            out_p = i4.int4_matmul_plain(x, w, s).float()
            out_f = i4.int4_matmul_plain(x.float(), w, s)
            torch.cuda.synchronize()
            err = (out_k - out_f).abs().max().item()
            msg = held("int4_matmul", err, (out_p - out_f).abs().max().item(), INT4_ATOL, out_f.abs().mean().item())
            finite = bool(torch.isfinite(out_k).all())
            errs.append(err)
            tile_m, tile_n, cs, per = i4.plan(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
            log(f"int4_matmul {name} M={m} K={k} N={n} (block {tile_m} tokens x {tile_n} channels, cluster {cs} x "
                f"{per} K steps): {msg} finite={finite}")
            if not finite:
                raise AssertionError("int4_matmul kernel gave a value that is not finite")
            run_k = cycling(lambda i: i4.int4_matmul(x, *copies[i]), len(copies))
            ms_k, ms_e = time_ms(run_k, iters=len(copies)), eager_ms(run_k, iters=2 * len(copies))
            ms_p = time_ms(cycling(lambda i: i4.int4_matmul_plain(x, *copies[i]), len(copies)), iters=len(copies))
            ms_l = time_ms(cycling(lambda i: F.linear(x, lib_w[i]), len(copies)), iters=len(copies))
            nbytes = m * k * 2 + k * n // 2 + n * 4 + m * n * 2
            bms, by = bound(nbytes, 2 * m * k * n)
            results.setdefault("int4_timing", []).append(
                dict(proj=name, m=m, k=k, n=n, tile_m=tile_m, tile_n=tile_n, cluster=cs, ms=ms_k, eager_ms=ms_e,
                     plain_ms=ms_p, library_ms=ms_l, bound_ms=bms, bound_by=by))
            log(f"int4_matmul {name} M={m}: kernel {ms_k * 1e3:.2f} us (eager call {ms_e * 1e3:.1f} us), "
                f"plain {ms_p * 1e3:.1f} us, F.linear on the dequantized weight {ms_l * 1e3:.2f} us, "
                f"bound {bms * 1e3:.3f} us ({by})")
        del copies, lib_w
    results["int4_err"] = max(errs)


def check_adaln(results: dict) -> None:
    """The DiT's AdaLN kernel (ops/adaln) at the datagen cell's flow calls,
    2B = 32 rows of each bucket's frames (ADALN_FRAMES), D = 1,024, bf16,
    with the gated residual and without (the two calls of a block); and one
    float32 shape (ADALN_F32_SHAPE). x and y N(0, 1); scale, shift and gate
    N(0, ADALN_MOD_STD^2), taken as row views of one (B, 6D) modulation as
    the DiT takes them. bf16: x' and the norm held to the plain version in
    float32 on the same inputs, and no farther from it than the plain
    version in bf16 (held); float32: to the plain version in float64
    (held_f32). Each bf16 shape timed by graph replay against its bytes
    (8 bytes an element with the residual, 4 without) and the plain chain."""
    import torch

    from fangyan_tts_torch.ops import adaln as an

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(23)
    d = 1024
    cases = [(32, l, torch.bfloat16) for l in ADALN_FRAMES] + [(*ADALN_F32_SHAPE, torch.float32)]
    errs = []
    for b, l, dt in cases:
        mod = (torch.randn((b, 6 * d), generator=gen, device=dev) * ADALN_MOD_STD).to(dt)
        shift, scale, gate = mod.chunk(6, dim=-1)[:3]
        x = torch.randn((b, l, d), generator=gen, device=dev).to(dt)
        y = torch.randn((b, l, d), generator=gen, device=dev).to(dt)
        wide = torch.float64 if dt == torch.float32 else torch.float32
        for res in ((), (y, gate)):
            got = an.adaln(x, scale, shift, *res)
            ref = an.adaln_plain(*(t.to(wide) for t in (x, scale, shift, *res)))
            low = an.adaln_plain(x, scale, shift, *res)
            torch.cuda.synchronize()
            err = max((g.to(wide) - r).abs().max().item() for g, r in zip(got, ref))
            err_low = max((g.to(wide) - r).abs().max().item() for g, r in zip(low, ref))
            scale_out = ref[1].abs().mean().item()
            if dt == torch.float32:
                msg = held_f32("adaln_f32", err, err_low, ADALN_F32_ATOL, scale_out)
            else:
                msg = held("adaln", err, err_low, ADALN_ATOL, scale_out)
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            errs.append(err)
            kind = "residual" if res else "no residual"
            log(f"adaln {dt} 2B={b} L={l} D={d} {kind}: {msg} finite={finite}")
            if not finite:
                raise AssertionError("adaln kernel gave a value that is not finite")
            if dt != torch.bfloat16:
                continue
            ms_k = time_ms(lambda: an.adaln_fused(x, scale, shift, *res), iters=10, reps=3)
            ms_e = eager_ms(lambda: an.adaln_fused(x, scale, shift, *res), iters=20)
            ms_p = time_ms(lambda: an.adaln_plain(x, scale, shift, *res), iters=10, reps=3)
            bms, by = bound((8 if res else 4) * b * l * d, 0)
            results.setdefault("adaln_timing", []).append(dict(
                rows=b * l, l=l, d=d, residual=bool(res), ms=ms_k, eager_ms=ms_e, plain_ms=ms_p, bound_ms=bms,
                bound_by=by, bound_share=bms / ms_k))
            log(f"adaln 2B={b} L={l} {kind}: kernel {ms_k * 1e3:.2f} us ({100 * bms / ms_k:.1f}% of its bound, "
                f"eager call {ms_e * 1e3:.1f} us), plain {ms_p * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by})")
    results["adaln_err"] = max(errs)
    mid = next(r for r in results["adaln_timing"] if r["l"] == ADALN_GATE_FRAMES and r["residual"])
    if mid["bound_share"] < ADALN_MIN_BOUND_SHARE:
        raise AssertionError(f"adaln at 2B=32 L={ADALN_GATE_FRAMES} with the residual reaches "
                             f"{100 * mid['bound_share']:.1f}% of its bytes bound, under "
                             f"{100 * ADALN_MIN_BOUND_SHARE:.0f}%")


def llm_prefill_rows() -> list[int]:
    """The datagen cells' prefill lengths: batch_synthesize's left-padded tp
    (infer/tts.batch_buckets) of each batch of 16 of the traffic's text
    lengths, behind its instruct prompt."""
    from benchmark.harness import Cell
    from benchmark.traffic.batch_offline import text_lengths
    from fangyan_tts_torch.infer.tts import batch_buckets

    p = Cell("cv3.datagen_b16").spec["params"]
    lens = sorted(int(n) for n in text_lengths(p))
    none, instruct = np.zeros(0, np.int32), np.zeros(p["instruct_tokens"], np.int32)
    return sorted({batch_buckets(full_config().llm, [np.zeros(n, np.int32) for n in lens[i: i + p["batch"]]],
                                 instruct, none, p["tokens_per_text_token"])[1]
                   for i in range(0, len(lens), p["batch"])})


def check_rms_norm_qkv_rope(results: dict) -> None:
    """The LM backbones' kernels at the datagen cells' 16 rows: residual +
    RMSNorm (ops/rms_norm) at D = 896 (Qwen2) and 2,048 (MLA-MoE), with
    and without the residual, and at the MLA's strided (16, 512) split of a
    576-wide row; the Qwen2 qkv epilogue (ops/qkv_rope, 14 + 2 + 2 heads of
    64) with the bias and without it; each at a decode step's one row and
    at the prefill's tp rows (llm_prefill_rows), bf16, and one float32
    prefill each; and the epilogue of one shard of a TP = 2 layer (7 + 1 +
    1 heads, no bias: tp_dense adds it) at one row and the longest
    prefill. Held to the plain route on the same inputs in float32 (float64
    for float32 inputs); timed by graph replay at the decode shapes and the
    longest prefill against the plain chain (not the TP shard's)."""
    import torch

    from fangyan_tts_torch.models.qwen2 import rope_cos_sin
    from fangyan_tts_torch.ops import qkv_rope as qr
    from fangyan_tts_torch.ops import rms_norm as rn

    gen = torch.Generator(device="cuda").manual_seed(29)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    tps = llm_prefill_rows()
    cases = [("rms_norm", d, t, torch.bfloat16, None) for d in (896, 2048, 512) for t in (1, *tps)]
    cases += [("qkv_rope", 1152, t, torch.bfloat16, (14, 2)) for t in (1, *tps)]
    cases += [("rms_norm", 896, tps[-1], torch.float32, None), ("qkv_rope", 1152, tps[-1], torch.float32, (14, 2))]
    cases += [("qkv_rope", 576, t, torch.bfloat16, (7, 1)) for t in (1, tps[-1])]
    errs, timing = {"rms_norm": [], "qkv_rope": []}, results.setdefault("llm_fused_timing", [])
    for kernel, d, t, dt, heads in cases:
        wide = torch.float64 if dt == torch.float32 else torch.float32
        if kernel == "rms_norm":
            w = 1 + 0.1 * rnd(d)
            x = (rnd(16, t, 576)[..., :512] if d == 512 else rnd(16, t, d)).to(dt)  # the MLA's kv_a split
            variants = [((None,), "no residual")] if d == 512 else \
                [((None,), "no residual"), ((rnd(16, t, d).to(dt),), "residual")]
            fused = lambda y: rn.rms_norm_fused(x, w, 1e-6, y)
            plain = lambda y, cast=None: rn.rms_norm_plain(*((x, w, 1e-6, y) if cast is None else
                                                            (x.to(cast), w, 1e-6, None if y is None else y.to(cast))))
        else:
            qkv = rnd(16, t, d).to(dt)
            cos, sin = rope_cos_sin(torch.randint(0, 400, (16, t), generator=gen, device="cuda"), 64, 1e6, dtype=dt)
            variants = [((None,), "no bias")] + ([] if heads == (7, 1) else [((0.5 * rnd(d),), "bias")])
            fused = lambda b: qr.qkv_rope_fused(qkv, b, cos, sin, *heads)
            plain = lambda b, cast=None: qr.qkv_rope_plain(*((qkv, b, cos, sin) if cast is None else
                                                            (qkv.to(cast), b, cos.to(cast), sin.to(cast))), *heads)
        for (arg,), kind in variants:
            got, ref, low = fused(arg), plain(arg, wide), plain(arg)
            torch.cuda.synchronize()
            err = max((g.to(wide) - r).abs().max().item() for g, r in zip(got, ref))
            err_low = max((g.to(wide) - r).abs().max().item() for g, r in zip(low, ref))
            scale_out = ref[-1].abs().mean().item()
            name = f"{kernel} {dt} (16, {t}, {d}) {kind}" + (f", {heads[0]} + {heads[1]} heads" if heads else "")
            if dt == torch.float32:
                msg = held_f32(name, err, err_low, LLM_F32_ATOL, scale_out)
            elif kernel == "rms_norm":
                if not torch.equal(got[0], low[0]):
                    raise AssertionError(f"{name}: x + y differs from the plain route's")
                msg = held(name, err, LLM_NORM_SLACK * err_low, LLM_NORM_ATOL, scale_out)
            else:
                msg = held(name, err, err_low, LLM_QKV_ATOL, scale_out)
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"{name}: a value that is not finite")
            errs[kernel].append(err)
            log(f"{name}: {msg}")
            if dt != torch.bfloat16 or t not in (1, tps[-1]) or heads == (7, 1):
                continue
            ms_k = time_ms(lambda: fused(arg))
            ms_p = time_ms(lambda: plain(arg))
            n = 16 * t * d * 2  # bytes of one bf16 operand
            if kernel == "rms_norm":  # x in, the norm out (and y in, x' out), the float32 weight
                nbytes = n * (2 if arg is None else 4) + 4 * d
            else:  # qkv in, q, k and v out (and the float32 bias)
                nbytes = 2 * n + (0 if arg is None else 4 * d)
            bms, by = bound(nbytes, 0)
            timing.append(dict(kernel=kernel, rows=16 * t, t=t, d=d, kind=kind, ms=ms_k, plain_ms=ms_p, bound_ms=bms,
                               bound_by=by))
            log(f"{name}: kernel {ms_k * 1e3:.2f} us, plain {ms_p * 1e3:.2f} us ({100 * ms_k / ms_p:.1f}%), bound "
                f"{bms * 1e3:.3f} us ({by})")
            if t == 1 and ms_k > LLM_FUSED_MAX_SHARE * ms_p:
                raise AssertionError(f"{name}: the kernel takes {100 * ms_k / ms_p:.1f}% of its plain chain's "
                                     f"device time, over {100 * LLM_FUSED_MAX_SHARE:.0f}%")
    results.update({f"{k}_err": max(v) for k, v in errs.items()})


# ---------------------------------------------------------------- phase 4


def _small_config():
    """A small CosyVoice3 configuration with head dim 64, as the kernels take,
    and greedy sampling."""
    from fangyan_tts_torch.config import CosyVoiceConfig, DiTConfig, FlowConfig, HiFTConfig, LLMConfig, QwenConfig

    qwen = QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, vocab_size=300)
    llm = LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=50, extra_tokens=8, qwen=qwen,
                    top_k=1, tau_r=1.1)
    dit = DiTConfig(dim=128, depth=2, heads=2, dim_head=64, static_chunk_size=10)
    return CosyVoiceConfig(llm=llm, flow=FlowConfig(vocab_size=50, dit=dit, n_timesteps=4, pre_lookahead_channels=64),
                           hift=HiFTConfig(base_channels=64, f0_cond_channels=32))


def _small_logits(t, cache_dtype) -> np.ndarray:
    """The small LLM's prefill and four teacher-forced decode steps' logits,
    on a KV cache of `cache_dtype`."""
    import torch

    from fangyan_tts_torch.models.qwen2 import init_cache

    llm, dev = t.cfg.llm, t.device
    with torch.inference_mode():
        ids = torch.tensor([[llm.sos] + list(range(3, 15)) + [llm.task_id]], device=dev)
        src = torch.tensor([[1] + [0] * 12 + [1]], device=dev)
        lens = torch.tensor([14], device=dev)
        cache = init_cache(llm.qwen, 1, 64, dtype=cache_dtype, device=dev)
        out = [t.llm.decode_logits(t.llm.prefill_leftpad(src, ids, lens, cache))]
        start = torch.zeros(1, dtype=torch.int32, device=dev)
        for i, tok in enumerate([5, 9, 17, 33]):
            pos = torch.tensor([[14 + i]], device=dev)
            out.append(t.llm.decode_step(torch.tensor([tok], device=dev), pos, start, 14 + i + 1, cache))
        return torch.stack(out).float().cpu().numpy()


def small_reference_check() -> None:
    """A small bf16 model (head dim 64, as the kernels take) on the card
    against the same weights on the CPU, where the plain versions run."""
    import torch

    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    cfg = _small_config()
    ref = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16, device="cpu", seed=3)
    sd = lambda m: {k: v.clone() for k, v in m.state_dict().items()}
    gpu = CosyVoice3TTS(cfg, sd(ref.llm), sd(ref.flow), sd(ref.hift), dtype=torch.bfloat16, device="cuda")
    logits = lambda t: _small_logits(t, torch.bfloat16)  # LLM: prefill + teacher-forced decode logits
    rel = _rel

    rng = np.random.default_rng(0)
    req = dict(source_speech_token=rng.integers(0, 50, 37).astype(np.int32),
               flow_prompt_speech_token=rng.integers(0, 50, 6).astype(np.int32),
               prompt_speech_feat=(rng.standard_normal((12, 80)) * 0.5).astype(np.float32),
               flow_embedding=rng.standard_normal(192).astype(np.float32))
    for mode in ("bf16", "int8 LLM with int4 MLP, int8 DiT"):
        if mode != "bf16":
            for t in (gpu, ref):
                t.quantize_llm(int4_mlp=True)
                t.quantize_flow()
        lg_g, lg_c = logits(gpu), logits(ref)
        r_llm = rel(lg_g, lg_c)
        argmax_eq = float((lg_g.argmax(-1) == lg_c.argmax(-1)).mean())
        mel_g, mel_c = (t.token2mel(req["source_speech_token"], req["flow_prompt_speech_token"],
                                    req["prompt_speech_feat"], req["flow_embedding"]) for t in (gpu, ref))
        wav_g = next(gpu.tts(**req))["tts_speech"]
        wav_c = next(ref.tts(**req))["tts_speech"]
        r_mel, r_wav = rel(mel_g, mel_c), rel(wav_g, wav_c)
        ok = max(r_llm, r_mel, r_wav) <= SMALL_REL_TOL and wav_g.shape == wav_c.shape and np.isfinite(wav_g).all()
        log(f"small model card vs CPU ({mode}): logits rel {r_llm:.3e} (argmax agreement {argmax_eq:.2f}), "
            f"mel rel {r_mel:.3e}, wav rel {r_wav:.3e} (limit {SMALL_REL_TOL}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the port on the card disagrees with its CPU path on a small model ({mode})")


def clocked(stage: dict, name: str, fn, note=None):
    """`fn` with its wall time (synchronised before and after) added to
    stage[name]; note(args, kwargs, result) sees each call."""
    import torch

    def inner(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        stage[name] = stage.get(name, 0.0) + time.perf_counter() - t
        if note is not None:
            note(a, k, out)
        return out
    return inner


GRAPHS = {"captures": 0, "replays": 0}  # decode-graph captures and replayed steps in this process


def count_graphs() -> dict:
    """From now on count every decode graph's capture and replay (one
    replay a decode step) in GRAPHS, by wrapping models/decode_graphs'
    Bucket once a process. The counts only grow: take differences."""
    from fangyan_tts_torch.models import decode_graphs

    bucket = decode_graphs.Bucket
    if getattr(bucket.replay, "counted", False):
        return GRAPHS
    capture, replay = bucket.capture, bucket.replay

    def counted_capture(self, step):
        capture(self, step)
        GRAPHS["captures"] += 1

    def counted_replay(self):
        replay(self)
        GRAPHS["replays"] += 1

    counted_replay.counted = True
    bucket.capture, bucket.replay = counted_capture, counted_replay
    return GRAPHS


class StepCount:
    """Decode steps run since the last reset(), as `value`: the eager
    decode_step calls `bump` counts (a CUDA graph's capture calls
    decode_step and runs nothing: not counted), and the steps the batched
    decode replayed from its graphs (GRAPHS["replays"]; a run's replays are
    all its own, as the runs here do not overlap). Printed, it says how
    many steps were replayed: their kernel launches are the tallies the
    graphs' captures recorded (ops/device.captured_launches), checked
    against the device trace once a bucket in graph_check."""

    def __init__(self):
        self.eager = 0
        self.base = self._replays()

    @staticmethod
    def _replays() -> int:
        return count_graphs()["replays"]

    def bump(self) -> None:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            self.eager += 1

    def reset(self) -> None:
        self.eager, self.base = 0, self._replays()

    @property
    def replayed(self) -> int:
        return self._replays() - self.base

    @property
    def value(self) -> int:
        return self.eager + self.replayed

    def __str__(self) -> str:
        return f"{self.value} ({self.replayed} replayed from CUDA graphs)" if self.replayed else str(self.value)


def counted_steps(tts) -> StepCount:
    """Count the LLM's decode steps (a StepCount)."""
    steps = StepCount()
    inner_step = tts.llm.decode_step

    def step(*a, **k):
        steps.bump()
        return inner_step(*a, **k)

    tts.llm.decode_step = step
    return steps


def _count(results: dict, counts: dict) -> None:
    """Add one main-path run's kernel launches to the totals."""
    tot = results.setdefault("launches", {})
    for k, v in counts.items():
        tot[k] = tot.get(k, 0) + v


def hook_kernels() -> tuple[dict, callable]:
    """Hook the models' kernel entry points (decode attention (B, S, KV
    heads, query heads), flash attention (rows, L, heads), int4 matmul (M,
    K, N)) to record each call's shape
    by route (a float32 input's under <kernel>_f32) into the returned dict;
    the second value undoes the hooks. The hooks count nothing: the launch
    counters stay in the wrappers."""
    import torch

    from fangyan_tts_torch.models import dit, qwen2

    hooks = ((qwen2, "decode_attention", lambda a: (a[3].shape[1], a[3].shape[2], a[3].shape[3], a[0].shape[1])),
             (dit, "chunk_flash_attention", lambda a: (a[0].shape[0], a[0].shape[2], a[0].shape[1])),
             (qwen2, "int4_matmul", lambda a: (a[0].numel() // a[0].shape[-1], a[0].shape[-1], a[1].shape[1])))
    seen: dict = {}
    saved = []
    for mod, name, key in hooks:
        inner = getattr(mod, name)
        saved.append((mod, name, inner))

        def hooked(*a, _inner=inner, _name=name, _key=key, **k):
            route = _name + ("_f32" if a[0].dtype == torch.float32 else "")  # the wrappers pick the route so
            seen.setdefault(route, set()).add(tuple(int(v) for v in _key(a)))
            return _inner(*a, **k)
        setattr(mod, name, hooked)

    def restore():
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    return seen, restore


def hold_shapes(results: dict, label: str, seen: dict) -> None:
    """Log the kernel shapes a run launched; fail if phase 3 ran and did not
    check one of them."""
    log(f"kernel shapes of {label}: " + "; ".join(f"{k} {sorted(v)}" for k, v in sorted(seen.items())))
    if "checked" in results:
        missing = {k: sorted(set(map(tuple, v)) - results["checked"].get(k, set())) for k, v in seen.items()}
        if any(missing.values()):
            raise AssertionError(f"{label} launched kernel shapes that phase 3 did not check: {missing}")


@contextlib.contextmanager
def kernel_shapes(results: dict, label: str):
    """Record the shape of every kernel call the models make inside the
    block (hook_kernels); after it, fail if phase 3 ran and did not check
    one of them."""
    seen, restore = hook_kernels()
    try:
        yield
    finally:
        restore()
    hold_shapes(results, label, seen)


def full_path(results: dict, card: str):
    """The three single offline requests through CosyVoice3TTS.tts, bf16."""
    import torch

    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    cfg = full_config()
    t0 = time.perf_counter()
    tts = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"random_init at full width (bf16, cuda): {time.perf_counter() - t0:.2f} s")

    # per-stage clocks and counts: wrap the instance's stage methods
    stage = {}
    steps = counted_steps(tts)
    mel_frames = []
    n_tokens = []
    tts.generate_tokens = clocked(stage, "llm", tts.generate_tokens, lambda a, k, out: n_tokens.append(len(out)))
    tts.token2mel = clocked(stage, "flow", tts.token2mel)
    tts.vocode = clocked(stage, "vocoder", tts.vocode, lambda a, k, out: mel_frames.append(a[0].shape[0]))

    rng = np.random.default_rng(0)
    text = rng.integers(0, 50000, 30).astype(np.int32)
    xvec = rng.standard_normal(192).astype(np.float32)
    zs = dict(text=text, prompt_text=rng.integers(0, 50000, 10).astype(np.int32),
              llm_prompt_speech_token=rng.integers(0, 6561, 50).astype(np.int32),
              flow_prompt_speech_token=rng.integers(0, 6561, 50).astype(np.int32),
              prompt_speech_feat=(rng.standard_normal((100, 80)) * 0.5).astype(np.float32), flow_embedding=xvec)
    fixed = dict(text=text, flow_embedding=xvec, min_token_text_ratio=5, max_token_text_ratio=5)
    requests = [("150 tokens (bench.py workload)", fixed), ("zero-shot prompt", zs),
                ("150 tokens, speed 1.1", dict(fixed, speed=1.1))]

    for name, req in requests:
        stage.clear()
        steps.reset()
        _zero_launches()
        with kernel_shapes(results, f"request '{name}'"):
            t = time.perf_counter()
            wav = next(tts.tts(**req))["tts_speech"]
            wall = time.perf_counter() - t
        counts = _launches(ATTENTION_ROUTES + ("adaln",) + LLM_ROUTES)
        _count(results, counts)
        n_dec, n_flash, n_adaln = (counts[k] for k in ATTENTION_ROUTES + ("adaln",))
        llm = {k: counts[k] for k in LLM_ROUTES}
        want_llm = llm_want(cfg.llm.qwen.num_hidden_layers, 1 + steps.value)
        frames = mel_frames[-1]
        audio_s = len(wav) / cfg.sample_rate
        ok = (np.isfinite(wav).all() and np.abs(wav).max() <= 0.99 and len(wav) == frames * 480
              and n_dec == cfg.llm.qwen.num_hidden_layers * steps.value and steps.value > 0
              and n_flash == cfg.flow.dit.depth * cfg.flow.n_timesteps
              and n_adaln == (2 * cfg.flow.dit.depth + 1) * cfg.flow.n_timesteps and llm == want_llm)
        tok_s = n_tokens[-1] / stage["llm"]
        log(f"request '{name}': {n_tokens[-1]} tokens in {steps} decode steps, {frames} mel frames, "
            f"{audio_s:.2f} s audio; decode {stage['llm']:.3f} s ({tok_s:.1f} tok/s, "
            f"{stage['llm'] / steps.value * 1e3:.2f} ms/step), flow {stage['flow']:.3f} s, "
            f"vocoder {stage['vocoder']:.3f} s, wall {wall:.3f} s, RTF {wall / audio_s:.4f}; "
            f"launches decode {n_dec} flash {n_flash} adaln {n_adaln} {llm} (derived {want_llm}) "
            f"[{card}] {'OK' if ok else 'FAIL'}")
        results.setdefault("requests", []).append(dict(
            name=name, tokens=n_tokens[-1], steps=steps.value, mel_frames=frames, tok_s=tok_s, audio_s=audio_s, llm_s=stage["llm"],
            flow_s=stage["flow"], vocoder_s=stage["vocoder"], wall_s=wall, rtf=wall / audio_s,
            decode_launches=n_dec, flash_launches=n_flash, adaln_launches=n_adaln, llm_launches=llm))
        if not ok:
            raise AssertionError(f"request '{name}' failed its checks")
    return tts, fixed


def prompt_audio(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Speech-like float32 audio: a voiced harmonic series on a gliding f0
    (100-200 Hz), a syllable-rate envelope with pauses, and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 150.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t) + 15.0 * np.sin(2 * np.pi * 2.3 * t + 1.0)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(h * phase + h) / h for h in range(1, 13))
    env = np.sin(2 * np.pi * 3.1 * t) ** 2 * (np.sin(2 * np.pi * 0.23 * t) > -0.6)
    x = env * voiced + 0.05 * rng.standard_normal(t.size)
    return (0.8 * x / np.abs(x).max()).astype(np.float32)


def frontend_states(seed: int = 7) -> tuple[dict, dict]:
    """Full-size CAM++ and S3 tokenizer state_dicts, float32, made on the
    card from `seed`. Weights N(0, gain^2 / fan_in): gain sqrt(2) for CAM++'s
    ReLU layers, so activations stay of order one through its 52 dense
    layers; BatchNorm running var U(0.5, 1.5), mean and bias N(0, 0.01),
    scale 1 + N(0, 0.01). S3: gain 1, 4 on conv1 (the whisper mel varies
    little), LayerNorm scale 1 + N(0, 0.01), biases 0, so that its codes vary
    from frame to frame."""
    import torch

    from fangyan_tts_torch.models.campplus import CAMPPlus
    from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(ctor, gain: float, gains: dict, bias_std: float) -> dict:
        with torch.device("meta"):
            skel = ctor()
        out = {}
        for k, v in skel.state_dict().items():
            leaf = k.rsplit(".", 1)[-1]
            normal = lambda std: torch.randn(v.shape, generator=gen, device="cuda") * std
            if v.dim() >= 2:
                g = next((gv for pre, gv in gains.items() if k.startswith(pre)), gain)
                out[k] = normal(g / math.sqrt(math.prod(v.shape[1:])))
            elif leaf == "var":
                out[k] = torch.rand(v.shape, generator=gen, device="cuda") + 0.5
            elif leaf == "scale":
                out[k] = 1.0 + normal(0.1)
            else:  # BatchNorm mean, biases
                out[k] = normal(bias_std)
        return out

    return make(CAMPPlus, math.sqrt(2.0), {}, 0.1), make(S3TokenizerV3, 1.0, {"conv1.": 4.0}, 0.0)


@contextlib.contextmanager
def api_model_dir(tts, states: tuple[dict, dict], cfg=None):
    """The full-width model of `tts` written to a model directory as the JAX
    package lays one out (config.json of `cfg`, tts.cfg by default, llm /
    flow / hift msgpack with bf16 leaves through from_jax.to_jax_tree and
    the port's save_params, campplus.msgpack and s3tokenizer.msgpack from
    `states`) with a 5 s prompt wav at 24 kHz, under build/ (ignored by
    git); removed after."""
    import tempfile
    from pathlib import Path

    import torch

    from fangyan_tts_torch.config import config_to_json
    from fangyan_tts_torch.data.audio import write_wav
    from fangyan_tts_torch.models.campplus import CAMPPlus
    from fangyan_tts_torch.models.from_jax import to_jax_tree
    from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3
    from fangyan_tts_torch.train.checkpoint import save_params

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="api_model_") as tmp:
        d = Path(tmp)
        t0 = time.perf_counter()
        (d / "config.json").write_text(config_to_json(tts.cfg if cfg is None else cfg))
        for name, m in (("llm", tts.llm), ("flow", tts.flow), ("hift", tts.hift)):
            save_params(d / f"{name}.msgpack", to_jax_tree(m.state_dict(), m))
        bf16 = lambda sd: {k: v.to(torch.bfloat16) if v.dim() >= 2 else v for k, v in sd.items()}
        with torch.device("meta"):
            skels = CAMPPlus(), S3TokenizerV3()
        for name, sd, skel in zip(("campplus", "s3tokenizer"), states, skels):
            save_params(d / f"{name}.msgpack", to_jax_tree(bf16(sd), skel))
        write_wav(d / "prompt.wav", prompt_audio(API_PROMPT_SECONDS, 24000, seed=5), 24000)
        mb = sum(f.stat().st_size for f in d.iterdir()) / 2**20
        log(f"API model directory written: {', '.join(sorted(f.name for f in d.iterdir()))} ({mb:.0f} MiB) in "
            f"{time.perf_counter() - t0:.2f} s")
        yield d


def api_request(results: dict, card: str, d, api: dict, key: str = "api_request", count: bool = True) -> None:
    """The public API on the card: AutoModel(d) on the model directory of
    api_model_dir and one inference_zero_shot of a zh sentence through the
    byte tokenizer and text_normalize. Launches counted as in full_path
    (added to the main path's totals with `count`); the result is stored
    under results[key]."""
    import torch

    from fangyan_tts_torch.api import AutoModel

    cfg = full_config()
    t0 = time.perf_counter()
    model = AutoModel(str(d))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stage: dict = {}
    steps = counted_steps(model.model)
    mel_frames, prompts = [], []
    prompt_inputs = model.frontend.frontend_zero_shot
    model.model.generate_tokens = clocked(stage, "llm", model.model.generate_tokens)
    model.model.token2mel = clocked(stage, "flow", model.model.token2mel)
    model.model.vocode = clocked(stage, "vocoder", model.model.vocode,
                                 lambda a, k, out: mel_frames.append(a[0].shape[0]))
    model.frontend.frontend_zero_shot = clocked(stage, "frontend", model.frontend.frontend_zero_shot,
                                                lambda a, k, out: prompts.append(out))
    _zero_launches()
    with kernel_shapes(results, "API request"):
        t = time.perf_counter()
        outs = list(model.inference_zero_shot(API_TEXT, API_PROMPT_TEXT, str(d / "prompt.wav")))
        wall = time.perf_counter() - t
    # the request paid the frontend's first-use costs; the same prompt again, warm
    warm_ms = eager_ms(lambda: prompt_inputs(API_TEXT, API_PROMPT_TEXT, str(d / "prompt.wav")), iters=3)
    n_dec, n_flash = _launches(ATTENTION_ROUTES).values()
    if count:
        _count(results, {"decode_attention": n_dec, "chunk_flash_attention": n_flash})
    wav = outs[0]["tts_speech"]
    mi = prompts[0]
    lengths = tuple(len(mi[k]) for k in ("text", "prompt_text", "llm_prompt_speech_token", "prompt_speech_feat"))
    want_lengths = (api["text_ids"], api["prompt_text_ids"], api["prompt_tokens"], 2 * api["prompt_tokens"])
    audio_s = len(wav) / cfg.sample_rate
    ok = (len(outs) == 1 and np.isfinite(wav).all() and np.abs(wav).max() <= 0.99 and len(wav) == mel_frames[0] * 480
          and steps.value > 0 and n_dec == cfg.llm.qwen.num_hidden_layers * steps.value
          and n_flash == cfg.flow.dit.depth * cfg.flow.n_timesteps and lengths == want_lengths
          and np.isfinite(mi["llm_embedding"]).all() and mi["llm_embedding"].shape == (192,))
    log(f"{key}: AutoModel load {load_s:.2f} s; inference_zero_shot: text/prompt-text ids, prompt tokens, "
        f"prompt mel frames {lengths} (derived {want_lengths}); frontend {stage['frontend']:.3f} s (first call; "
        f"{warm_ms:.1f} ms warm), "
        f"{steps} decode steps in {stage['llm']:.3f} s ({stage['llm'] / steps.value * 1e3:.2f} ms/step), flow "
        f"{stage['flow']:.3f} s, vocoder {stage['vocoder']:.3f} s, {mel_frames[0]} mel frames, {audio_s:.2f} s "
        f"audio, wall {wall:.3f} s, RTF {wall / audio_s:.4f}; launches decode {n_dec} flash {n_flash} [{card}] "
        f"{'OK' if ok else 'FAIL'}")
    results[key] = dict(load_s=load_s, frontend_s=stage["frontend"], frontend_warm_ms=warm_ms,
                                  llm_s=stage["llm"],
                                  flow_s=stage["flow"], vocoder_s=stage["vocoder"], steps=steps.value,
                                  mel_frames=mel_frames[0], audio_s=audio_s, wall_s=wall, rtf=wall / audio_s,
                                  decode_launches=n_dec, flash_launches=n_flash)
    if not ok:
        raise AssertionError(f"{key} failed its checks")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 7


def frontend_phase(results: dict, card: str, states: tuple[dict, dict]) -> None:
    """CAM++ and S3 at full size on the 5 s and the 30 s prompt bucket:
    float32 on the card against float32 on the CPU (the same weights and
    audio, the features made on each device), then the bf16 frontend that
    the API serves against float32 on the card, and its times."""
    import warnings

    import torch

    from fangyan_tts_torch.data.audio import resample_poly
    from fangyan_tts_torch.infer.frontend import Frontend, _pad_bucket, make_campplus_fn, make_s3_fn
    from fangyan_tts_torch.infer.tts import _load
    from fangyan_tts_torch.models.campplus import CAMPPlus
    from fangyan_tts_torch.models.from_jax import to_jax_tree
    from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3
    from fangyan_tts_torch.ops.mel import kaldi_fbank, whisper_logmel
    from fangyan_tts_torch.tokenizer import get_qwen_tokenizer

    camp_sd, s3_sd = states
    models = {dev: (_load(CAMPPlus, camp_sd, torch.device(dev)), _load(S3TokenizerV3, s3_sd, torch.device(dev)))
              for dev in ("cuda", "cpu")}
    with torch.device("meta"):
        skels = CAMPPlus(), S3TokenizerV3()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok = get_qwen_tokenizer(None, True, "cosyvoice3")
    fe = Frontend(tok, full_config(), make_campplus_fn(to_jax_tree(camp_sd, skels[0])),
                  make_s3_fn(to_jax_tree(s3_sd, skels[1])))  # bf16 on the card, as the API builds them
    audio = prompt_audio(30.0, 16000, seed=3)
    rows = []
    for label, seconds in (("5 s", 4.3), ("30 s", 30.0)):
        wav = audio[: int(seconds * 16000)]
        padded, n = _pad_bucket(wav, 16000)
        out = {}
        for dev, (cm, sm) in models.items():
            with torch.inference_mode():
                y = torch.from_numpy(padded)[None].to(dev)
                fb = kaldi_fbank(y)
                frames = max((n - 400) // 160 + 1, 1)
                mask = (torch.arange(fb.shape[1], device=dev) < frames)[None, :, None].float()
                feat = (fb - (fb * mask).sum(dim=1, keepdim=True) / frames) * mask
                xvec = cm(feat)[0]
                x, code_len = sm.encode(whisper_logmel(y), torch.tensor([n // 160], device=dev))
                codes, bounded = sm.fsq(x)
            out[dev] = (xvec.cpu().numpy(), codes[0].cpu().numpy(), int(code_len[0]), bounded[0].float().cpu().numpy())
        (xg, cg, lg, bg), (xc, cc, lc, bc) = out["cuda"], out["cpu"]
        xerr = float(np.abs(xg - xc).max())
        xvec_ok = bool(np.allclose(xg, xc, atol=XVEC_ATOL, rtol=XVEC_RTOL))
        valid = min(lg, lc)
        same = float((cg[:valid] == cc[:valid]).mean())
        n_diff = int((cg[:valid] != cc[:valid]).sum())
        gap = float(np.abs(bg[:valid] - bc[:valid]).max())
        # bf16, as served, against float32 on the card
        x16 = fe.extract_spk_embedding(wav)
        c16 = fe.extract_speech_token(wav)
        cos = float(np.dot(x16, xg) / (np.linalg.norm(x16) * np.linalg.norm(xg)))
        same16 = float((c16[:lg] == cg[: len(c16)]).mean()) if len(c16) == lg else float("nan")
        wav24 = resample_poly(wav, 16000, 24000)
        times = dict(fbank_campplus_ms=eager_ms(lambda: fe.extract_spk_embedding(wav), iters=5),
                     whisper_s3_ms=eager_ms(lambda: fe.extract_speech_token(wav), iters=5),
                     matcha_mel_ms=eager_ms(lambda: fe.extract_speech_feat(wav24), iters=5),
                     prompt_features_ms=eager_ms(lambda: fe._prompt_features(wav), iters=5))
        ok = xvec_ok and lg == lc and same >= S3_CODES_EQUAL and len(c16) == lg and np.isfinite(x16).all()
        row = dict(bucket=label, seconds=seconds, xvec_max_abs_err=xerr, xvec_ok=xvec_ok, code_len=(lg, lc),
                   codes_equal=same, codes_differ=n_diff, fsq_gap=gap, unique_codes=int(len(np.unique(cg[:lg]))),
                   bf16_codes_equal=same16, bf16_xvec_cos=cos, **times)
        rows.append(row)
        log(f"frontend {label} prompt ({seconds} s in the {len(padded) // 16000} s bucket): CAM++ card vs CPU float32 "
            f"max|diff| {xerr:.3e} (atol {XVEC_ATOL}, rtol {XVEC_RTOL}) {'OK' if xvec_ok else 'FAIL'}, x-vector "
            f"mean|.| {np.abs(xc).mean():.3f}; S3 code lengths {lg} / {lc}, codes equal on {same:.4f} of the valid "
            f"frames ({n_diff} differ, limit {S3_CODES_EQUAL}; {row['unique_codes']} distinct codes), largest gap "
            f"in the pre-round FSQ value {gap:.3e}; bf16 vs float32: codes equal {same16:.4f}, x-vector cosine "
            f"{cos:.6f} {'OK' if ok else 'FAIL'}")
        log(f"frontend {label} times (bf16, wall, mean of 5 after 5 warm-up calls): fbank + CAM++ "
            f"{times['fbank_campplus_ms']:.2f} ms, "
            f"whisper mel + S3 {times['whisper_s3_ms']:.2f} ms, matcha mel (24 kHz) {times['matcha_mel_ms']:.2f} ms, "
            f"_prompt_features {times['prompt_features_ms']:.2f} ms [{card}]")
        if not ok:
            raise AssertionError(f"the frontend at the {label} prompt failed its checks")
        row["profile"] = _profile({"fbank + CAM++": lambda: fe.extract_spk_embedding(wav),
                                   "whisper mel + S3": lambda: fe.extract_speech_token(wav),
                                   "matcha mel": lambda: fe.extract_speech_feat(wav24),
                                   "_prompt_features": lambda: fe._prompt_features(wav)}, card, f"frontend {label}")
    results["frontend"] = rows


def batched_requests(results: dict, card: str) -> dict:
    """The dataset-generation path: 16 utterances a request through
    CosyVoice3TTS.batch_synthesize at full width, random bf16 weights.
    (a) bench.py's bs16 workload in the runner's default int8 LLM mode: 16
    texts of 30 tokens, no prompt, exactly 150 tokens a row. (b) the int8
    LLM with an int4 MLP and an int8 DiT: 16 texts of 12-40 tokens sharing
    a voice prompt. Each request runs twice (the first run pays the card's
    first-use costs at these shapes); launches are counted on each run."""
    import torch

    from fangyan_tts_torch.infer.tts import CosyVoice3TTS, suppress_silent_runs

    cfg = full_config()
    nl, depth, nt = cfg.llm.qwen.num_hidden_layers, cfg.flow.dit.depth, cfg.flow.n_timesteps
    req_a, req_b = batch_requests_spec()
    out = {}
    for key, name, req, mode in (("a_bf16", "(a) in bf16, the unquantized reference", req_a, None),
                                 ("a", "(a) bs16 x 150 tokens, int8 LLM", req_a, "int8"),
                                 ("b", "(b) bs16 prompted, int8 LLM + int4 MLP, int8 DiT", req_b, "int4")):
        int4 = mode == "int4"
        t0 = time.perf_counter()
        tts = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16)
        if mode is not None:
            tts.quantize_llm(int4_mlp=int4)
        if int4:
            tts.quantize_flow()
        torch.cuda.synchronize()
        log(f"request {name}: random_init and quantization at full width: {time.perf_counter() - t0:.2f} s")
        stage = {}
        steps = counted_steps(tts)
        made = []
        tts._batch_tokens = clocked(stage, "llm", tts._batch_tokens, lambda a, k, o: made.append(o))
        tts._batch_token2mel = clocked(stage, "flow", tts._batch_token2mel)
        tts.vocode_batch = clocked(stage, "vocoder", tts.vocode_batch)
        for run in (1, 2):
            stage.clear()
            steps.reset()
            _zero_launches()
            with kernel_shapes(results, f"request {name}, run {run}"):
                t = time.perf_counter()
                wavs = tts.batch_synthesize(**req)
                wall = time.perf_counter() - t
            counts = _launches(BF16_ROUTES + ("adaln",) + LLM_ROUTES)
            _count(results, counts)
            toks, n = made[-1]
            n_tok = [len(suppress_silent_runs(toks[i, : n[i]])) for i in range(len(n))]
            # adaln: two norms a DiT block and the final one, every DiT call
            want = {"decode_attention": nl * steps.value, "chunk_flash_attention": depth * nt,
                    "int4_matmul": 2 * nl * (1 + steps.value) if int4 else 0, "adaln": (2 * depth + 1) * nt,
                    **llm_want(nl, 1 + steps.value)}
            audio_s = sum(len(w) for w in wavs) / cfg.sample_rate
            ok = (len(wavs) == 16 and steps.value > 0 and counts == want
                  and all(np.isfinite(w).all() and np.abs(w).max() <= 0.99 and len(w) == k * 2 * 480
                          for w, k in zip(wavs, n_tok)))
            log(f"request {name}, run {run}: {sum(n_tok)} tokens ({min(n_tok)}-{max(n_tok)} a row) in {steps} "
                f"decode steps, {audio_s:.2f} s audio; LLM {stage['llm']:.3f} s "
                f"({stage['llm'] / steps.value * 1e3:.2f} ms/step, {sum(n_tok) / stage['llm']:.1f} tok/s), "
                f"flow {stage['flow']:.3f} s, vocoder {stage['vocoder']:.3f} s, wall {wall:.3f} s, "
                f"batch RTF {wall / audio_s:.5f}; launches {counts} (derived {want}) [{card}] "
                f"{'OK' if ok else 'FAIL'}")
            results.setdefault("batch_requests", []).append(dict(
                name=name, run=run, tokens=sum(n_tok), steps=steps.value, audio_s=audio_s, llm_s=stage["llm"],
                flow_s=stage["flow"], vocoder_s=stage["vocoder"], wall_s=wall, rtf=wall / audio_s, launches=counts))
            if not ok:
                raise AssertionError(f"request {name} failed its checks")
        out[key] = (tts, req)
    return out


def graph_inputs(cfg, b: int, lens: tuple, seed: int) -> dict:
    """B rows of text lengths spread over `lens`, GRAPH_RATIO speech tokens a
    text token (min = max), in batch_synthesize's buckets (infer/tts.batch_buckets)."""
    import torch

    from fangyan_tts_torch.data.lm_plan import pad_plans_left
    from fangyan_tts_torch.infer.tts import batch_buckets

    rng = np.random.default_rng(seed)
    texts = [rng.integers(0, 5000, size=int(n), dtype=np.int32) for n in np.linspace(*lens, b).round()]
    none = np.zeros(0, np.int32)
    plans, tp, max_new, cache_len = batch_buckets(cfg.llm, texts, none, none, GRAPH_RATIO)
    batch = pad_plans_left(plans, length=tp)
    lengths = torch.tensor([int(len(t) * GRAPH_RATIO) for t in texts], dtype=torch.int32)
    dev = torch.device("cuda")
    args = (*(torch.from_numpy(batch[k]).to(dev) for k in ("src", "ids", "lengths")), lengths, lengths)
    return dict(args=args, b=b, max_new=max_new, cache_len=cache_len, steps=int(lengths.max()))


def graph_check(results: dict, card: str, model) -> None:
    """The batched decode's CUDA graphs (models/decode_graphs) held to the
    same loop run eagerly: llm._generate with the bucket that
    generate_speech_tokens takes, and without one (the same step body,
    issued step by step), under inference mode as batch_synthesize runs it.
    (a) B = 16 greedy in three buckets, each decoded from its graph twice
    (the first call captures, the second replays every step), once more
    under the benchmark's device trace (benchmark/harness.Trace), and once
    eagerly: tokens, counts and the last logits bit-equal; (b) B = 4 at
    top_k 25 from one seeded generator, on a sampler whose picks follow its
    draws (sampled_draws): tokens bit-equal, the generator left in one
    state, and another seed gives other tokens; (c) a parameter updated in
    place, as GRPO's optimizer step does: the next call captures anew,
    equal to the eager loop on the updated model; (d) a new bucket captured
    under the device trace and then replayed there. In each run the
    wrapper's launch count is layers x steps, in a traced run so is the
    trace's count of decode-attention kernels (replayed launches are the
    tally of the graph's capture: this checks it once a bucket), and the
    graphs' captures and replays (the tracer's llm.graph_captures /
    llm.graph_steps) are what the steps imply."""
    import torch
    from dataclasses import replace

    from benchmark.harness import Trace
    from fangyan_tts_torch.models import decode_graphs, llm
    from fangyan_tts_torch.ops import device
    from fangyan_tts_torch.utils import profiling

    cfg = full_config()
    nl = cfg.llm.qwen.num_hidden_layers
    dev = torch.device("cuda")
    base = model.cfg
    total = {"captures": 0, "replays": 0}  # over the check's runs

    def run(inp: dict, graphed: bool, seed: int | None = None, traced: bool = False) -> dict:
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        before = device.launches["decode_attention"]
        profiling.reset()
        tr = Trace() if traced else None
        if traced:
            tr.start()
        t = time.perf_counter()
        with profiling.recording(), torch.inference_mode():
            held = llm._bucket(model, inp["b"], inp["max_new"], inp["cache_len"], dev) if graphed \
                else contextlib.nullcontext()
            with held as bucket:
                if graphed and bucket is None:
                    raise AssertionError("graph_check: the decode took no bucket on the card")
                res, logits = llm._generate(model, *inp["args"], gen, inp["max_new"], inp["cache_len"], bucket)
            out = dict(tokens=res.tokens.cpu(), counts=res.num_tokens.cpu(), logits=logits.cpu(),
                       generator=gen.get_state() if gen is not None else None)
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        if traced:
            tr.stop()
        tc = profiling.counters()
        profiling.reset()
        out.update(s=s, launches=device.launches["decode_attention"] - before,
                   kernels=len(tr.kernel_times_s("decode_attention_kernel")) if traced else None,
                   traced=(tc.get("llm.graph_captures"), tc.get("llm.graph_steps"), tc.get("llm.decode_steps")))
        total["captures"] += out["traced"][0]
        total["replays"] += out["traced"][1]
        return out

    def held(label: str, inp: dict, runs: dict, captures: dict, logits: bool = True) -> bool:
        """runs[name] against runs["eager"]; captures[name]: the graphs it should capture."""
        steps, eager = inp["steps"], runs["eager"]
        ok = True
        for name, r in runs.items():
            cap = captures.get(name, 0)
            rep = steps - cap if name != "eager" else 0
            same = all(torch.equal(r[k], eager[k]) for k in (("tokens", "counts", "logits") if logits else
                                                            ("tokens", "counts")))
            good = (same and r["launches"] == nl * steps and r["kernels"] in (None, nl * steps)
                    and r["traced"] == (cap, rep, steps))
            kernels = "" if r["kernels"] is None else f", {r['kernels']} decode-attention kernels traced"
            log(f"graph check {label}, {name}: {steps} steps in {r['s']:.3f} s ({r['s'] / steps * 1e3:.2f} ms a "
                f"step), tracer (captures, replays, steps) {r['traced']}, launches "
                f"{r['launches']}{kernels} (derived {nl * steps}); "
                f"{'bit-equal to the eager loop' if same else 'DIFFERS'} [{card}] {'OK' if good else 'FAIL'}")
            ok &= good
        return ok

    ok = True
    try:
        model.cfg = replace(base, top_k=1)  # greedy: the nucleus is the argmax
        for k, lens in enumerate(GRAPH_GREEDY_LENS):
            inp = graph_inputs(cfg, 16, lens, seed=k)
            runs = {"graph, first call": run(inp, True), "graph, bucket reused": run(inp, True),
                    "graph under the profiler, bucket reused": run(inp, True, traced=True), "eager": run(inp, False)}
            ok &= held(f"(a) B 16 greedy, max_new {inp['max_new']}, cache {inp['cache_len']}", inp, runs,
                       {"graph, first call": 1})
        with sampled_draws():
            model.cfg = replace(base, top_k=25)
            inp = graph_inputs(cfg, 4, GRAPH_SAMPLED_LENS, seed=7)
            runs = {"graph, first call": run(inp, True, 1234), "graph, bucket reused": run(inp, True, 1234),
                    "graph under the profiler, bucket reused": run(inp, True, 1234, traced=True),
                    "eager": run(inp, False, 1234)}
            ok &= held(f"(b) B 4 top_k 25, max_new {inp['max_new']}", inp, runs, {"graph, first call": 1},
                       logits=False)
            same = len({tuple(r["generator"].tolist()) for r in runs.values()}) == 1
            other = run(inp, True, 4321)["tokens"]
            moved = not torch.equal(other, runs["eager"]["tokens"])
            log(f"graph check (b): the generator's state after each run equal (the same draws taken): {same}; "
                f"another seed gives other tokens ({int((other != runs['eager']['tokens']).sum())} of "
                f"{other.numel()} differ): {moved} [{card}] {'OK' if same and moved else 'FAIL'}")
            ok &= same and moved
            with torch.no_grad():
                model.llm.norm.weight.mul_(1.01)  # an optimizer step's in-place update
            runs = {"graph after the update": run(inp, True, 1234), "eager": run(inp, False, 1234)}
            ok &= held("(c) after a parameter update", inp, runs, {"graph after the update": 1}, logits=False)
        model.cfg = replace(base, top_k=1)
        inp = graph_inputs(cfg, 16, GRAPH_TRACED_LENS, seed=9)
        runs = {"graph under the profiler, first call": run(inp, True, traced=True),
                "graph under the profiler, bucket reused": run(inp, True, traced=True), "eager": run(inp, False)}
        ok &= held(f"(d) B 16 greedy under the profiler, max_new {inp['max_new']}", inp, runs,
                   {"graph under the profiler, first call": 1})
    finally:
        model.cfg = base
        decode_graphs._stores.pop(model, None)  # no graph of sampled_draws' sampler outlives the check
    log(f"graph check: {total['captures']} captures, {total['replays']} replays in its runs [{card}] "
        f"{'OK' if ok else 'FAIL'}")
    results["graph_check"] = dict(ok=bool(ok), **total)
    if not ok:
        raise AssertionError("graph_check failed")


@contextlib.contextmanager
def sampled_draws():
    """ops/sampling._categorical with Gumbel noise -log(-log(u)), so that a
    sampled pick depends on its uniforms. The package's own noise is NaN
    (the minus binds after the clamp: log(-1e-20)), which makes every pick
    the first candidate whatever the draws; graph_check's sampled case would
    then hold even if a replay read stale uniforms."""
    import torch

    from fangyan_tts_torch.ops import sampling

    inner = sampling._categorical

    def categorical(logits, generator, u=None):
        if u is None:
            u = sampling._uniform(logits.shape, generator, logits.device)
        gumbel = -torch.log((-torch.log(u.clamp_min(1e-20))).clamp_min(1e-20))
        return torch.argmax(logits.float() + gumbel, dim=-1)

    sampling._categorical = categorical
    try:
        yield
    finally:
        sampling._categorical = inner


def _profile(stages: dict, card: str, label: str) -> dict:
    """Each stage under torch.profiler: wall time, device kernel time (sum
    of CUDA events), idle share, kernel count, the largest kernels, and the
    port's own kernels (their time, launches and time a launch in place,
    whether or not they are among the largest). The profiler's own host cost
    is in the wall time. Only device activity is recorded: reading back the
    host events of a 150-step decode took over a minute per stage."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name, fn in stages.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        by_name: dict = {}
        calls: dict = {}
        n = 0
        for e in prof.events():
            if e.device_type == cuda:
                n += 1
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
                calls[e.name] = calls.get(e.name, 0) + 1
        busy = sum(by_name.values()) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        ours = {k: (v, calls[k]) for k, v in by_name.items() if any(p in k for p in PORT_KERNELS)}
        out[name] = dict(wall_s=wall, device_s=busy, idle_share=1 - busy / wall, device_ops=n,
                         top=[[k[:60], v / 1e3] for k, v in top],
                         port_kernels=[[k[:60], v / 1e3, c] for k, (v, c) in sorted(ours.items())])
        log(f"profile {label} {name}: wall {wall:.3f} s, device busy {busy:.4f} s, idle share "
            f"{1 - busy / wall:.3f}, {n} device ops [{card}]")
        for k, v in top:
            log(f"    {v / 1e3:9.3f} ms  {k[:90]}")
        for k, (v, c) in sorted(ours.items()):
            log(f"    port kernel {k[:60]}: {v / 1e3:.3f} ms over {c} launches, {v / c:.2f} us a launch in place")
    return out


def profile_stages(tts, req: dict, results: dict, card: str) -> None:
    """The flow and vocoder stages of the single 150-token request, bf16. Its
    LLM stage is not profiled (phase 15 needs the time: reading back its
    150,000 device events took 22-29 s); phase 10 still profiles the v2
    LLM stage of the same workload."""
    text = req["text"]
    tokens = tts.generate_tokens(text, min_token_text_ratio=5, max_token_text_ratio=5)
    no_prompt = (np.zeros(0, np.int32), np.zeros((0, 80), np.float32))
    mel = tts.token2mel(tokens, *no_prompt, req["flow_embedding"])
    results["profile"] = _profile({
        "flow": lambda: tts.token2mel(tokens, *no_prompt, req["flow_embedding"]),
        "vocoder": lambda: tts.vocode(mel),
    }, card, "150 tokens, bf16")


def profile_batch(tts, req: dict, card: str, label: str) -> dict:
    """The flow and vocoder stages of one batch_synthesize request."""
    args = (req["texts"], req.get("prompt_text", np.zeros(0, np.int32)),
            req.get("llm_prompt_speech_token", np.zeros(0, np.int32)),
            req["min_token_text_ratio"], req["max_token_text_ratio"])
    toks, n = tts._batch_tokens(*args)
    fp = np.asarray(req.get("flow_prompt_speech_token", np.zeros(0, np.int32)), np.int32)
    pf = np.asarray(req.get("prompt_speech_feat", np.zeros((0, 80), np.float32)), np.float32)
    mel, _ = tts._batch_token2mel(toks, n, fp, pf, req["flow_embedding"])
    # the LLM stage is not profiled here (25-35 s each, most of it reading back 150,000-217,000 device events;
    # phases 14 and 15 need the time), nor in profile_stages
    return _profile({"flow": lambda: tts._batch_token2mel(toks, n, fp, pf, req["flow_embedding"]),
                     "vocoder": lambda: tts.vocode_batch(mel)}, card, label)


# ---------------------------------------------------------------- phase 8


def stream_plan(n_tokens: int, n_prompt: int, cfg) -> tuple[int, int]:
    """(hops, flow window calls) of a stream of n_tokens target tokens after
    a prompt of n_prompt tokens, as infer/stream.Token2WavSession runs it:
    a hop when hop (+ prompt_pad on the first) + lookahead tokens are in,
    on the window past stream_window_tokens, and a finalize that runs on
    the window when any frame is left and the stream reached the window."""
    hop, la = cfg.chunk_size, cfg.flow.pre_lookahead_len
    pad = -n_prompt % hop
    hops = offset = windows = 0
    while n_tokens - offset >= (hop + pad if offset == 0 else hop) + la:
        offset += hop + pad if offset == 0 else hop
        hops += 1
        windows += hop * hops + pad >= STREAM_WINDOW
    if n_tokens * cfg.token_mel_ratio > hops * hop * cfg.token_mel_ratio and n_tokens >= STREAM_WINDOW:
        windows += 1
    return hops, windows


def stream_run(tts, run, keep: bool = False) -> dict:
    """One stream: `run()` returns the chunk generator. Wall time, time to
    the first chunk, chunks, samples, and the per-hop budget from the
    tracer's `stream.*` spans (ms); with `keep`, the chunks themselves
    under "wav"."""
    from fangyan_tts_torch.utils import profiling

    profiling.reset()
    first = None
    chunks, n, ok, kept = 0, 0, True, []
    with profiling.recording():
        t0 = time.perf_counter()
        for out in run():
            if first is None:
                first = time.perf_counter() - t0
            wav = out["tts_speech"]
            ok &= bool(np.isfinite(wav).all()) and (len(wav) == 0 or float(np.abs(wav).max()) <= 0.99)
            chunks += 1
            n += len(wav)
            if keep:
                kept.append(wav)
        wall = time.perf_counter() - t0
    stats: dict[str, list[float]] = {}
    for s in profiling.spans():
        if s["name"].startswith("stream.") and s["t1_ns"] is not None:
            stats.setdefault(s["name"][len("stream."):], []).append((s["t1_ns"] - s["t0_ns"]) / 1e6)
    profiling.reset()
    budget = {k: (float(np.mean(v)), float(np.max(v))) for k, v in stats.items()}
    r = dict(wall_s=wall, first_ms=first * 1e3, chunks=chunks, samples=n, audio_s=n / 24000, rtf=wall / (n / 24000),
             finite=ok, budget=budget, pushes=len(stats.get("t2w_dispatch", [])))
    return dict(r, wav=kept) if keep else r


def _budget(b: dict) -> str:
    return ", ".join(f"{k} {m:.2f} / {x:.2f}" for k, (m, x) in sorted(b.items())) + " ms (mean / max)"


def streaming_phase(results: dict, card: str, tts, api_model, prompt_wav: str, api: dict) -> None:
    """Phase 8 on the full-width bf16 model `tts` and the API model: the
    streaming requests S1-S5, each run's launches counted and its kernel
    shapes held to phase 3's checks."""
    import torch

    from fangyan_tts_torch.infer import bistream
    from fangyan_tts_torch.infer.stream import Token2WavSession

    cfg = tts.cfg
    nl, per_window = cfg.llm.qwen.num_hidden_layers, cfg.flow.dit.depth * cfg.flow.n_timesteps
    reqs, text_chunks = stream_requests_spec()
    steps = counted_steps(tts)
    api_steps = counted_steps(api_model.model)
    one_token = [0]
    inner_append = bistream.bistream_append
    eos = cfg.llm.eos

    def append(model, cache, seq_pos, src, ids, cache_len):
        one_token[0] += ids.shape[1] == 1  # a one-token segment is a decode step
        cache, logits, seq_pos = inner_append(model, cache, seq_pos, src, ids, cache_len)
        if one_token[0] >= S5_TOKENS + 2:  # S5's stop, once [sos], its tokens and the task id went in
            logits = logits.clone()
            logits[:, eos] = logits.max() + 1e4
        return cache, logits, seq_pos

    bistream.bistream_append = append
    out = results.setdefault("streaming", {})
    spec = {"speculate_first": 0, "commit_first": 0}  # the first hop dispatched on the device tokens / held
    session_methods = {name: getattr(Token2WavSession, name) for name in spec}

    def spec_counted(name: str):
        def inner(self, *a, **k):
            spec[name] += 1
            return session_methods[name](self, *a, **k)
        return inner

    for name in spec:
        setattr(Token2WavSession, name, spec_counted(name))

    def counted(label: str, model, run, n_prompt: int, decode_calls, keep: bool = False):
        steps.reset()
        api_steps.reset()
        one_token[0] = 0
        _zero_launches()
        spec.update(speculate_first=0, commit_first=0)
        with kernel_shapes(results, label):
            r = stream_run(model, run, keep)
        counts = _launches(ATTENTION_ROUTES)
        _count(results, counts)
        n_tok, rem = divmod(r["samples"], cfg.token_mel_ratio * 480)
        hops, windows = stream_plan(n_tok, n_prompt, cfg)
        want = {"decode_attention": nl * decode_calls(), "chunk_flash_attention": per_window * windows}
        r.update(tokens=n_tok, launches=counts, hops=hops, window_calls=windows, decode_calls=decode_calls(),
                 spec=dict(spec))
        ok = r["finite"] and rem == 0 and counts == want and r["chunks"] == hops + 1 and decode_calls() > 0
        if not ok:
            raise AssertionError(f"{label}: {r} (derived launches {want}, hops {hops})")
        return r

    t0 = time.perf_counter()
    _zero_launches()
    with kernel_shapes(results, "warmup_streaming"):
        tts.warmup_streaming()
    torch.cuda.synchronize()
    warm = dict(s=time.perf_counter() - t0, flash=_launches()["chunk_flash_attention"])
    _count(results, {"chunk_flash_attention": warm["flash"]})
    log(f"warmup_streaming(): {warm['s']:.3f} s ({STREAM_WINDOW + 3 * cfg.chunk_size} silent tokens, vc route; "
        f"flash launches {warm['flash']}) [{card}]")
    out["warmup_s"] = warm["s"]

    run = lambda req: (lambda: tts.tts(stream=True, **req))
    # S1: bench.py's first chunk: a warm-up, then one timed stream (to leave phases 9-12 their time)
    firsts = [counted(f"S1 first chunk, run {i + 1}", tts, run(reqs["S1"]), 0, lambda: steps.value) for i in range(2)]
    ms = [r["first_ms"] for r in firsts[1:]]
    out["S1"] = dict(first_ms_min=min(ms), first_ms_median=float(np.median(ms)), first_ms=ms,
                     warmup_first_ms=[r["first_ms"] for r in firsts[:1]], tokens=firsts[-1]["tokens"],
                     rtf=[r["rtf"] for r in firsts[1:]])
    log(f"S1 first chunk (10 text tokens, {firsts[-1]['tokens']} tokens, no prompt): min {min(ms):.1f} ms, median "
        f"{np.median(ms):.1f} ms of {', '.join(f'{m:.1f}' for m in ms)} (warm-up "
        f"{', '.join(f'{r['first_ms']:.1f}' for r in firsts[:1])}); RTF {firsts[-1]['rtf']:.4f} [{card}]")

    # S2 and S3: one run each, after warmup_streaming and S1 (to leave phases 9-12 their time)
    for name, n_prompt in (("S2", 0), ("S3", 60)):
        r = out[name] = counted(f"{name} run", tts, run(reqs[name]), n_prompt, lambda: steps.value)
        log(f"{name} stream ({r['tokens']} tokens, prompt {n_prompt}): wall {r['wall_s']:.3f} s for "
            f"{r['audio_s']:.2f} s audio, RTF {r['rtf']:.4f}, first chunk {r['first_ms']:.1f} ms, "
            f"{r['decode_calls']} decode steps, {r['pushes']} token chunks pushed, {r['hops']} hops and a finalize "
            f"({r['window_calls']} flow calls on the window), {r['chunks']} audio chunks; budget "
            f"{_budget(r['budget'])}; launches {r['launches']} [{card}]")

    # S4: the public API, streamed once (its first call pays the API model's first-use costs); the sampled
    # decode decides the length
    r = out["S4"] = counted("S4 API stream", api_model.model,
                            lambda: api_model.inference_zero_shot(API_TEXT, API_PROMPT_TEXT, prompt_wav, stream=True),
                            api["prompt_tokens"], lambda: api_steps.value)
    log(f"S4 API stream: {r['tokens']} tokens, {r['chunks']} chunks, first chunk {r['first_ms']:.1f} ms, wall "
        f"{r['wall_s']:.3f} s, RTF {r['rtf']:.4f} (first-use costs included); budget {_budget(r['budget'])}; "
        f"launches {r['launches']} [{card}]")

    # S5: a text generator of 4 chunks of 5 tokens, stopped at S5_TOKENS
    r = counted("S5 bistream", tts, lambda: tts.tts(text=iter(text_chunks), flow_embedding=reqs["S1"]["flow_embedding"],
                                                     stream=True), 0, lambda: one_token[0])
    out["S5"] = r
    log(f"S5 bistream (4 text chunks of 5 tokens, eos forced after {S5_TOKENS} tokens): {r['tokens']} tokens, "
        f"{r['chunks']} chunks, first chunk {r['first_ms']:.1f} ms, wall {r['wall_s']:.3f} s, RTF {r['rtf']:.4f}; "
        f"launches {r['launches']} [{card}]")
    bistream.bistream_append = inner_append
    if not 60 < r["tokens"] <= S5_TOKENS:  # past the text phase's 60, and stopped
        raise AssertionError(f"S5 gave {r['tokens']} tokens; its stop is forced after {S5_TOKENS}")

    # S1 (its first hop speculated) and S3 (prompt_pad 15: not speculated) with
    # speculation and the prefetch thread off, then on, from one generator seed
    for name, n_prompt in (("S1", 0), ("S3", 60)):
        runs = {}
        for off in (True, False):
            tts.stream_no_speculation = tts.stream_no_prefetch = off
            tts.generator.manual_seed(1)
            runs[off] = counted(f"{name}, speculation and prefetch {'off' if off else 'on'}", tts, run(reqs[name]),
                                n_prompt, lambda: steps.value, keep=True)
        tts.stream_no_speculation = tts.stream_no_prefetch = False
        got, want = runs[False]["wav"], runs[True]["wav"]
        lens_ok = [len(c) for c in got] == [len(c) for c in want]
        err = float(np.abs(np.concatenate(got) - np.concatenate(want)).max()) if lens_ok else float("inf")
        speculated = runs[False]["spec"]["speculate_first"] == (name == "S1")
        ok = lens_ok and err <= SPEC_ATOL and speculated and runs[True]["spec"]["speculate_first"] == 0
        out.setdefault("spec_check", {})[name] = dict(lens_equal=lens_ok, max_abs_err=err, bit_equal=err == 0.0,
                                                      spec_on=runs[False]["spec"], chunks=runs[False]["chunks"])
        log(f"{name} speculation and prefetch on vs off: {runs[False]['chunks']} chunks, lengths equal={lens_ok}, max "
            f"|diff| {err:.3e} (limit {SPEC_ATOL}), first hop {runs[False]['spec']} with both on "
            f"{'OK' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise AssertionError(f"{name}: the stream with speculation and prefetch on disagrees with both off")
    for name, method in session_methods.items():
        setattr(Token2WavSession, name, method)
    launch_probe(results, "phase 8, before its profiled hops")
    out["hop_profile"] = profile_hops(tts, reqs["S2"]["flow_embedding"], card)
    launch_probe(results, "phase 8, after its profiled hops")


def profile_hops(tts, xvec: np.ndarray, card: str) -> dict:
    """One young KV hop (hop 2) and one window hop (hop 12, the first past the
    window) of an S2-shaped stream (no prompt), flow and vocoder, each under
    torch.profiler. The token values are random: a hop's work does not
    depend on them."""
    from fangyan_tts_torch.infer.stream import Token2WavSession

    tokens = np.random.default_rng(9).integers(0, 6561, 320).astype(np.int32)
    sess = Token2WavSession(tts, np.zeros(0, np.int32), np.zeros((0, 80), np.float32), xvec)
    sess.push_dev(tokens[:28])[0].numpy()
    young = _profile({"young KV hop (hop 2)": lambda: sess.push_dev(tokens[28:53])[0].numpy()}, card, "S2")
    kv_cap = sess.fs._kv_cap
    for a in sess.push_dev(tokens[53:278]):
        a.numpy()
    window = _profile({"window hop (hop 12)": lambda: sess.push_dev(tokens[278:303])[0].numpy()}, card, "S2")
    log(f"profiled hops: KV cache capacity {kv_cap} slots at hop 2; the window hop's flow runs L = "
        f"{STREAM_WINDOW * tts.cfg.token_mel_ratio} frames [{card}]")
    return {**young, **window}


def small_stream_check() -> None:
    """A small bf16 model's vc stream (no sampling) across the window boundary
    (window 50 tokens, a 7-token prompt, prompt_pad 18): on the card against
    the same weights on the CPU. Its window runs the flash kernel at L = 114."""
    import torch

    from fangyan_tts_torch.config import CosyVoiceConfig, DiTConfig, FlowConfig, HiFTConfig, LLMConfig, QwenConfig
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    qwen = QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, vocab_size=300)
    llm = LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=50, extra_tokens=8, qwen=qwen)
    dit = DiTConfig(dim=128, depth=2, heads=2, dim_head=64, static_chunk_size=50)
    cfg = CosyVoiceConfig(llm=llm, flow=FlowConfig(vocab_size=50, dit=dit, n_timesteps=4, pre_lookahead_channels=64),
                          hift=HiFTConfig(base_channels=64, f0_cond_channels=32))
    ref = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16, device="cpu", seed=4)
    sd = lambda m: {k: v.clone() for k, v in m.state_dict().items()}
    gpu = CosyVoice3TTS(cfg, sd(ref.llm), sd(ref.flow), sd(ref.hift), dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(1)
    req = dict(source_speech_token=rng.integers(0, 50, 130).astype(np.int32),
               flow_prompt_speech_token=rng.integers(0, 50, 7).astype(np.int32),
               prompt_speech_feat=(rng.standard_normal((14, 80)) * 0.5).astype(np.float32),
               flow_embedding=rng.standard_normal(192).astype(np.float32))
    outs = []
    for t in (gpu, ref):
        t.stream_window_tokens = 50
        outs.append([c["tts_speech"] for c in t.tts(stream=True, **req)])
    got, want = outs
    lens_ok = [len(c) for c in got] == [len(c) for c in want]
    g, w = np.concatenate(got), np.concatenate(want)
    rel = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12)) if lens_ok else float("inf")
    ok = lens_ok and rel <= SMALL_REL_TOL and np.isfinite(g).all() and len(got) >= 4
    log(f"small model stream card vs CPU (vc route, window 50 tokens, prompt_pad 18): {len(got)} chunks, lengths "
        f"equal={lens_ok}, wav rel {rel:.3e} (limit {SMALL_REL_TOL}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the streaming path on the card disagrees with its CPU path on a small model")


# ---------------------------------------------------------------- phase 9


def _group_counts(sched) -> tuple[int, int]:
    """(flow calls, hops) of every group of a StreamScheduler so far."""
    groups = [g for gs in sched.groups.values() for g in gs]
    return sum(g.flow_calls for g in groups), sum(g.hops for g in groups)


def serving_counted(results: dict, label: str, cfg, lsched, sched, run):
    """`run()` with the kernel launch counts set to 0 just before it and read
    just after, its kernel shapes held to phase 3's checks. The decode
    launches must be one a layer and step of the LLMScheduler's chunks,
    the flash launches depth x n_timesteps a flow call of the
    StreamScheduler's groups. Returns
    (run's result, the run's counts)."""
    zero = {"steps": 0, "rows": 0}
    l0 = dict(lsched.stats) if lsched is not None else zero
    s0 = dict(sched.stats) if sched is not None else zero
    f0, h0 = _group_counts(sched) if sched is not None else (0, 0)
    _zero_launches()
    with kernel_shapes(results, label):
        out = run()
    counts = _launches(ATTENTION_ROUTES)
    _count(results, counts)
    llm = {k: (lsched.stats[k] if lsched is not None else 0) - l0[k] for k in zero}
    t2w = {k: (sched.stats[k] if sched is not None else 0) - s0[k] for k in zero}
    f1, h1 = _group_counts(sched) if sched is not None else (0, 0)
    chunk_steps = lsched.chunk_steps if lsched is not None else 0
    want = {"decode_attention": cfg.llm.qwen.num_hidden_layers * chunk_steps * llm["steps"],
            "chunk_flash_attention": cfg.flow.dit.depth * cfg.flow.n_timesteps * (f1 - f0)}
    run_counts = dict(launches=counts, llm=llm, t2w=t2w, flow_calls=f1 - f0, hops=h1 - h0)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, derived from the steps and flow calls {want} ({run_counts})")
    return out, run_counts


def _gaps(arrivals: list, hop_s: float) -> dict:
    """Arrival gaps between a stream's chunks, over every stream: p99, max and
    underruns (gaps longer than one hop of audio), as bench.py counts them."""
    gaps = sorted(b - a for ts in arrivals for a, b in zip(ts, ts[1:]))
    ms = [g * 1e3 for g in gaps]
    return dict(n=len(ms), p99_ms=ms[min(len(ms) - 1, int(0.99 * len(ms)))] if ms else 0.0,
                max_ms=ms[-1] if ms else 0.0, underruns=sum(g > hop_s for g in gaps))


def _threads(n: int, client, timeout: float = 600.0) -> None:
    """Run client(i) on n threads; raise the first client's exception."""
    import threading

    errs: list = []

    def guarded(i):
        try:
            client(i)
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)

    ts = [threading.Thread(target=guarded, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in ts):
        raise AssertionError("a client thread did not finish")


@contextlib.contextmanager
def stage_times(lsched=None):
    """Wall ms of each LLMScheduler chunk (lsched._run_chunk, which ends in
    its fetch) and of each BatchedStreamGroup step and finalize, by name,
    over the block (the stages run on the client threads, concurrently)."""
    from fangyan_tts_torch.infer.batch_stream import BatchedStreamGroup

    times: dict = {}

    def timed(name, fn):
        def inner(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
        return inner

    saved = [(BatchedStreamGroup, n, getattr(BatchedStreamGroup, n)) for n in ("step", "finish", "finish_many")]
    for cls, name, fn in saved:
        setattr(cls, name, timed(f"t2w {name}", fn))
    if lsched is not None:
        lsched._run_chunk = timed("llm chunk", lsched._run_chunk)
    try:
        yield times
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
        if lsched is not None:
            del lsched._run_chunk


def _stage_line(times: dict) -> str:
    return "; ".join(f"{k} {len(v)} x {np.mean(v):.1f} / {np.max(v):.1f} ms" for k, v in sorted(times.items())) + \
        " (count x mean / max)"


def async_round(lsched, sched, texts: list, embs: list) -> dict:
    """bench.py's async clients: each opens its decode in the LLMScheduler and
    its session in the StreamScheduler, feeds each token chunk as it comes
    and closes; every audio chunk's arrival time is kept."""
    n = len(texts)
    arrivals, samples, tokens, ok = [[] for _ in range(n)], [0] * n, [0] * n, [True] * n
    t0 = time.perf_counter()

    def got(i, chunk):
        arrivals[i].append(time.perf_counter() - t0)
        samples[i] += len(chunk)
        ok[i] &= bool(np.isfinite(chunk).all()) and (len(chunk) == 0 or float(np.abs(chunk).max()) <= 0.99)

    def client(i):
        lh = lsched.open(texts[i], min_token_text_ratio=SERVE_RATIO, max_token_text_ratio=SERVE_RATIO)
        h = sched.open(np.zeros(0, np.int32), np.zeros((0, 80), np.float32), embs[i])
        for arr in lsched.stream(lh):
            tokens[i] += len(arr)
            for chunk in sched.feed(h, arr):
                got(i, chunk)
        got(i, sched.close(h))

    _threads(n, client)
    return dict(wall_s=time.perf_counter() - t0, arrivals=arrivals, samples=samples, tokens=tokens, ok=ok)


def serving_async(results: dict, card: str, tts, c: int) -> dict:
    """(a) c async clients through an LLMScheduler and a StreamScheduler of
    width c: one measured round (it pays the groups' first calls too)."""
    from fangyan_tts_torch.infer.batch_stream import StreamScheduler
    from fangyan_tts_torch.infer.llm_batch import LLMScheduler

    cfg = tts.cfg
    lsched, sched = LLMScheduler(tts, width=c), StreamScheduler(tts, width=c)
    rng = np.random.default_rng(20 + c)
    texts = [rng.integers(0, 50000, SERVE_TEXT_TOKENS).astype(np.int32) for _ in range(c)]
    embs = [rng.standard_normal(192).astype(np.float32) for _ in range(c)]
    hop_s = cfg.chunk_size / cfg.token_frame_rate
    out = {}
    for name in ("measured",):
        with stage_times(lsched) as times:
            r, counts = serving_counted(results, f"(a) async c={c} {name}", cfg, lsched, sched,
                                        lambda: async_round(lsched, sched, texts, embs))
        want_hops = sum(stream_plan(n, 0, cfg)[0] for n in r["tokens"])
        audio_s = sum(r["samples"]) / cfg.sample_rate
        gaps = _gaps(r["arrivals"], hop_s)
        first_ms = [a[0] * 1e3 for a in r["arrivals"]]
        ok = (all(r["ok"]) and counts["hops"] == want_hops and all(0 < n <= SERVE_TEXT_TOKENS * SERVE_RATIO
                                                                   for n in r["tokens"])
              and r["samples"] == [n * cfg.token_mel_ratio * 480 for n in r["tokens"]])
        ratio = lambda st: st["rows"] / max(st["steps"], 1)
        step_ms = float(np.mean(times["llm chunk"])) / lsched.chunk_steps
        out[name] = dict(wall_s=r["wall_s"], audio_s=audio_s, rtf=r["wall_s"] / audio_s, first_ms=first_ms,
                         tokens=r["tokens"], gaps=gaps, llm_batch=ratio(counts["llm"]), t2w_batch=ratio(counts["t2w"]),
                         decode_step_ms=step_ms, stages={k: (float(np.mean(v)), float(np.max(v)), len(v))
                                                         for k, v in times.items()}, **counts)
        log(f"(a) async streaming c={c} {name}: {r['wall_s']:.3f} s wall for {audio_s:.2f} s audio, aggregate RTF "
            f"{r['wall_s'] / audio_s:.4f}; tokens {r['tokens']}; first chunk ms "
            f"{', '.join(f'{m:.1f}' for m in first_ms)}; batching LLM {counts['llm']['rows']}/{counts['llm']['steps']}"
            f" = {ratio(counts['llm']):.2f}, token2wav {counts['t2w']['rows']}/{counts['t2w']['steps']} = "
            f"{ratio(counts['t2w']):.2f}; {gaps['n']} arrival gaps, p99 {gaps['p99_ms']:.1f} ms, max "
            f"{gaps['max_ms']:.1f} ms, underruns (> {hop_s:.1f} s) {gaps['underruns']}; {counts['flow_calls']} flow "
            f"calls, {counts['hops']} hops (derived {want_hops}); decode {step_ms:.2f} ms a step at B={c}; "
            f"{_stage_line(times)}; launches {counts['launches']} [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"(a) async c={c} {name} failed its checks")
    return out


def serving_stream_vs_solo(results: dict, card: str, tts) -> dict:
    """(c) four fixed-token sessions of BATCH_TOKENS through a width-4
    StreamScheduler, fed 32 tokens at a time from four threads, against the
    same sessions streamed solo (the full-prefix young hops the groups run):
    chunk lengths equal (close() returns the chunks a session had not yet
    taken with its tail, so those are summed) and the audio within
    BATCH_REL_TOL of max |solo|."""
    import threading

    from fangyan_tts_torch.infer.batch_stream import StreamScheduler

    cfg = tts.cfg
    rng = np.random.default_rng(30)
    sessions = [(rng.integers(0, 6561, BATCH_TOKENS).astype(np.int32), rng.standard_normal(192).astype(np.float32))
                for _ in range(4)]
    tts.flow_kv_stream = False
    _zero_launches()
    try:
        with kernel_shapes(results, "(c) solo streams"):
            solo = [[c["tts_speech"] for c in tts.tts(source_speech_token=t, flow_embedding=e, stream=True)]
                    for t, e in sessions]
    finally:
        tts.flow_kv_stream = True
    # every hop of a solo stream without the KV cache is a flow call, and so is a finalize with frames left
    hops = stream_plan(BATCH_TOKENS, 0, cfg)[0]
    solo_calls = len(sessions) * (hops + (BATCH_TOKENS > hops * cfg.chunk_size))
    flash = _launches()["chunk_flash_attention"]
    _count(results, {"chunk_flash_attention": flash})
    if flash != cfg.flow.dit.depth * cfg.flow.n_timesteps * solo_calls:
        raise AssertionError(f"(c) solo streams: {flash} flash launches for {solo_calls} flow calls")
    sched = StreamScheduler(tts, width=4)
    chunks, tails = [[] for _ in sessions], [None] * 4
    barrier = threading.Barrier(4)

    def client(i):
        toks, emb = sessions[i]
        h = sched.open(np.zeros(0, np.int32), np.zeros((0, 80), np.float32), emb)
        barrier.wait(timeout=300)
        for p in range(0, len(toks), 32):
            chunks[i] += sched.feed(h, toks[p : p + 32])
        tails[i] = sched.close(h)

    _, counts = serving_counted(results, "(c) StreamScheduler against solo", cfg, None, sched, lambda: _threads(4, client))
    rows = []
    for i in range(4):
        n = len(chunks[i])
        lens_ok = ([len(c) for c in chunks[i]] == [len(c) for c in solo[i][:n]]
                   and len(tails[i]) == sum(len(c) for c in solo[i][n:]))
        g, w = np.concatenate(chunks[i] + [tails[i]]), np.concatenate(solo[i])
        rel = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12)) if g.shape == w.shape else float("inf")
        rows.append(dict(chunks=n, solo_chunks=len(solo[i]), lens_equal=lens_ok, rel=rel))
    want_hops = 4 * stream_plan(BATCH_TOKENS, 0, cfg)[0]
    ok = all(r["lens_equal"] and r["rel"] <= BATCH_REL_TOL for r in rows) and counts["hops"] == want_hops
    ratio = counts["t2w"]["rows"] / max(counts["t2w"]["steps"], 1)
    log(f"(c) StreamScheduler against solo, {len(sessions)} sessions of {BATCH_TOKENS} tokens: rel |batched - solo| "
        f"{', '.join(f'{r['rel']:.3e}' for r in rows)} (limit {BATCH_REL_TOL}), chunk lengths equal "
        f"{[r['lens_equal'] for r in rows]} ({[r['chunks'] for r in rows]} fed chunks + the close; solo "
        f"{[r['solo_chunks'] for r in rows]}); token2wav batching {ratio:.2f}; {counts['flow_calls']} flow calls, "
        f"{counts['hops']} hops (derived {want_hops}); launches {counts['launches']} [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(c) the StreamScheduler's streams disagree with the solo streams")
    return dict(rows=rows, t2w_batch=ratio, **counts)


def serving_llm_vs_solo(results: dict, card: str, tts, cfg=None, label: str = "(c)") -> dict:
    """(c) four greedy decodes (top_k 1, the RAS fallback off) through a
    width-4 LLMScheduler, two opened a chunk after the others (rows at
    different depths and write slots), against each one's solo decode:
    tokens equal up to the first step whose two best logits lie within
    GREEDY_TIE in the solo decode (there M = 1 and M = 4 may round a tie
    differently); the agreeing prefix lengths are printed. `cfg` (tts.cfg
    by default) gives the LLM's configuration; a TTS with `_plan` (the v2
    family) plans its solo decodes through it, as its scheduler does."""
    from dataclasses import replace

    import torch

    from fangyan_tts_torch.data.lm_plan import pad_plans_left
    from fangyan_tts_torch.infer.llm_batch import LLMScheduler
    from fangyan_tts_torch.infer.tts import stream_buckets
    from fangyan_tts_torch.models.llm import decode_chunk, decode_prefill

    cfg, dev = tts.cfg if cfg is None else cfg, tts.device
    inner = tts.llm.cfg
    tts.llm.cfg = replace(inner, top_k=1, tau_r=1.1)
    try:
        rng = np.random.default_rng(40)
        texts = [rng.integers(0, 50000, SERVE_TEXT_TOKENS).astype(np.int32) for _ in range(4)]
        lsched = LLMScheduler(tts, width=4, silent_tokens=())
        ratio = dict(min_token_text_ratio=GREEDY_RATIO, max_token_text_ratio=GREEDY_RATIO)

        def run():
            got = [[] for _ in texts]
            streams = {i: lsched.stream(lsched.open(texts[i], **ratio)) for i in (0, 1)}
            late = [2, 3]
            while streams or late:
                for i in list(streams):
                    try:
                        got[i].append(next(streams[i]))
                    except StopIteration:
                        del streams[i]
                while late:  # after the first chunk: the others join at depth 0
                    i = late.pop(0)
                    streams[i] = lsched.stream(lsched.open(texts[i], **ratio))
            return [np.concatenate(g) for g in got]

        got, counts = serving_counted(results, f"{label} LLMScheduler against solo (greedy)", cfg, lsched, None, run)
        zeros = np.zeros(0, np.int32)
        rows, solo_steps = [], 0
        with kernel_shapes(results, f"{label} solo greedy decodes"), torch.inference_mode():
            _zero_launches()
            for i, text in enumerate(texts):
                plan, tp, cache_len, lo, hi = stream_buckets(cfg.llm, text, zeros, zeros, GREEDY_RATIO, GREEDY_RATIO)
                if hasattr(tts, "_plan"):
                    plan = tts._plan(text, zeros)
                b = pad_plans_left([plan], length=tp)
                st = decode_prefill(tts.llm, *(torch.from_numpy(b[k]).to(dev) for k in ("src", "ids", "lengths")),
                                    torch.tensor([lo]), torch.tensor([hi]), cache_len)
                toks, ties = [], []
                while not bool(st.done.all()) and st.i < hi:
                    top2 = torch.topk(st.logits.float()[0, : cfg.llm.speech_token_size], 2).values
                    st, chunk = decode_chunk(tts.llm, st, 1, tp, None)
                    solo_steps += 1
                    if int(chunk[0, 0]) >= 0:
                        toks.append(int(chunk[0, 0]))
                        ties.append(float(top2[0] - top2[1]))
                g = got[i].tolist()
                agree = next((j for j, (a, w) in enumerate(zip(g, toks)) if a != w), min(len(g), len(toks)))
                ok = (agree == len(g) == len(toks)) or (agree < len(toks) and ties[agree] <= GREEDY_TIE)
                rows.append(dict(tokens=len(toks), batched_tokens=len(g), agree=agree,
                                 gap_at_split=ties[agree] if agree < len(toks) else None, ok=ok))
            solo_launches = _launches()["decode_attention"]
        _count(results, {"decode_attention": solo_launches})
    finally:
        tts.llm.cfg = inner
    ok = all(r["ok"] for r in rows) and solo_launches == cfg.llm.qwen.num_hidden_layers * solo_steps
    log(f"{label} LLMScheduler against solo, greedy, 4 rows (two joined a chunk later): agreeing prefix "
        f"{[r['agree'] for r in rows]} of {[r['tokens'] for r in rows]} tokens; best-two logit gap where they part "
        f"{[r['gap_at_split'] for r in rows]} (a tie within {GREEDY_TIE} may fall either way); LLM batching "
        f"{counts['llm']['rows']}/{counts['llm']['steps']}; launches {counts['launches']}, solo decodes "
        f"{solo_launches} [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} a batched greedy decode parts from its solo decode away from a near-tie")
    return dict(rows=rows, **counts)


def serving_http(results: dict, card: str, model_dir, api: dict, serving: dict) -> dict:
    """(b) the port's HTTP server in this process on 127.0.0.1 (a free port),
    phase 4's model directory loaded with --batched_streams HTTP_WIDTH, and
    four concurrent /inference_zero_shot clients (runtime/http_client.
    stream_request) sharing the prompt wav, each with its own sentence.
    Each response must be well-formed int16 PCM of whole mel frames."""
    import threading

    import torch

    from fangyan_tts_torch.runtime import http_server
    from fangyan_tts_torch.runtime.http_client import stream_request

    t0 = time.perf_counter()
    model = http_server.load_model(str(model_dir), batched_streams=HTTP_WIDTH)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    srv = http_server.serve(model, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/inference_zero_shot"
    wav = (model_dir / "prompt.wav").read_bytes()
    n = len(HTTP_TEXTS)
    pcm, arrivals = [], []

    def run():
        t1 = time.perf_counter()

        def client(i):
            for chunk in stream_request(url, {"tts_text": HTTP_TEXTS[i], "prompt_text": API_PROMPT_TEXT},
                                        {"prompt_wav": wav}, timeout=600):
                arrivals[i].append(time.perf_counter() - t1)
                pcm[i] += chunk

        _threads(n, client)
        return time.perf_counter() - t1

    out = {"load_s": load_s}
    try:
        tts = model.model
        for name in ("measured",):  # one round: it pays the groups' first calls at the prompt's shapes too
            pcm, arrivals = [b""] * n, [[] for _ in range(n)]
            wall, counts = serving_counted(results, f"(b) HTTP server {name}", tts.cfg, tts.llm_scheduler,
                                           tts.stream_scheduler, run)
            samples = [len(p) // 2 for p in pcm]
            peaks = [int(np.abs(np.frombuffer(p, "<i2")).max()) if p else 0 for p in pcm]
            ok = all(len(p) > 0 and len(p) % (480 * 2) == 0 for p in pcm) and all(peaks)
            audio_s = sum(samples) / 24000
            ratio = lambda st: st["rows"] / max(st["steps"], 1)
            first_ms = [a[0] * 1e3 if a else None for a in arrivals]
            log(f"(b) HTTP server {name} (--batched_streams {HTTP_WIDTH}, load {load_s:.2f} s): {n} concurrent "
                f"/inference_zero_shot clients, text ids {serving['http_ids']}: {samples} samples of int16 PCM (peaks "
                f"{peaks}), wall {wall:.3f} s for {audio_s:.2f} s audio, aggregate RTF {wall / max(audio_s, 1e-9):.4f}, "
                f"first chunk ms {', '.join(f'{m:.1f}' for m in first_ms if m is not None)}; batching LLM "
                f"{ratio(counts['llm']):.2f}, token2wav {ratio(counts['t2w']):.2f}; {counts['flow_calls']} flow calls; "
                f"launches {counts['launches']} [{card}] {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"(b) HTTP {name}: a response was empty or not whole int16 mel frames")
            out[name] = dict(samples=samples, wall_s=wall, rtf=wall / audio_s, first_ms=first_ms,
                             llm_batch=ratio(counts["llm"]), t2w_batch=ratio(counts["t2w"]), **counts)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    del model
    torch.cuda.empty_cache()
    return out


def serving_phase(results: dict, card: str, model_dir, api: dict, serving: dict) -> None:
    """Phase 9 at full width, random bf16 weights: (a) the async workload at
    each of SERVE_WIDTHS, (c) batched against solo, (b) the HTTP server."""
    import torch

    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    t0 = time.perf_counter()
    tts = CosyVoice3TTS.random_init(full_config(), dtype=torch.bfloat16, seed=9)
    log(f"phase 9 model: random_init in {time.perf_counter() - t0:.2f} s")
    out = results.setdefault("serving", {})
    for c in SERVE_WIDTHS:
        out[f"async_c{c}"] = serving_async(results, card, tts, c)
    out["stream_vs_solo"] = serving_stream_vs_solo(results, card, tts)
    out["llm_vs_solo"] = serving_llm_vs_solo(results, card, tts)
    del tts
    torch.cuda.empty_cache()
    out["http"] = serving_http(results, card, model_dir, api, serving)


# ---------------------------------------------------------------- phase 10


def v12_spec(api: dict) -> dict:
    """The decode shapes of phase 10's v2 runs, from infer/tts_v12's own
    formulas (v2_decode_buckets) and the v2 plans (remap_plan_v2): each B = 1
    decode's cache with the last slot it writes and its first valid slot,
    and the width-4 scheduler's (B, S, tp). The offline decode (150 steps)
    writes its last token at tp + max_len - 1; a stream runs whole 32-step
    chunks, past max_len; the API request's decode runs to its max_len
    (random weights sample no stop id)."""
    from fangyan_tts_torch.data.lm_plan import build_prompt_plan, remap_plan_v2
    from fangyan_tts_torch.infer.tts_v12 import v2_decode_buckets, v2_llm_config

    cfg = v2_llm_config()
    up = lambda n, m: -(-n // m) * m

    def plan_len(n_text: int, n_prompt_text: int = 0, n_prompt_speech: int = 0) -> int:
        plan = build_prompt_plan(cfg, [0] * (n_prompt_text + n_text), [0] * n_prompt_speech)
        return len(remap_plan_v2(cfg, plan).ids)

    decode = []
    n = plan_len(V2_TEXT_TOKENS)
    tp, _, s, _, hi = v2_decode_buckets(V2_TEXT_TOKENS, n, False, V2_RATIO, V2_RATIO)
    decode.append(("v2 offline", 1, s, [tp + hi - 1], [tp - n]))
    n = plan_len(V2_STREAM_TEXT_TOKENS)
    tp, _, s, _, hi = v2_decode_buckets(V2_STREAM_TEXT_TOKENS, n, True, V2_STREAM_RATIO, V2_STREAM_RATIO)
    decode.append(("v2 stream", 1, s, [tp + up(hi, 32) - 1], [tp - n]))
    n = plan_len(api["text_ids"], api["prompt_text_ids"], api["prompt_tokens"])
    tp, _, s, _, hi = v2_decode_buckets(api["text_ids"], n, False)
    decode.append(("v2 API", 1, s, [tp + hi - 1], [tp - n]))
    n = plan_len(SERVE_TEXT_TOKENS)
    tp, _, s, _, hi = v2_decode_buckets(SERVE_TEXT_TOKENS, n, True, GREEDY_RATIO, GREEDY_RATIO)
    decode.append(("v2 solo greedy", 1, s, [tp + up(hi, 32) - 1], [tp - n]))
    return dict(decode=decode, sched=[(4, s, tp)])


def v2_stream_chunks(n_tokens: int, n_prompt: int, hop: int = 25, la: int = 3) -> int:
    """The chunks CosyVoice2TTS.tts(stream=True) yields for n_tokens after a
    prompt of n_prompt tokens: a hop (the first one absorbing the prompt's
    padding to a hop boundary) whenever hop + lookahead tokens are in, then
    the final chunk."""
    pad = -n_prompt % hop
    offset = chunks = 0
    while n_tokens - offset >= (hop + pad if offset == 0 else hop) + la:
        offset += hop + pad if offset == 0 else hop
        chunks += 1
    return chunks + 1


BF16_ROUTES = ("decode_attention", "chunk_flash_attention", "int4_matmul")  # the CUDA kernels' bf16 routes
F32_ROUTES = tuple(f"{r}_f32" for r in BF16_ROUTES)
ATTENTION_ROUTES = BF16_ROUTES[:2]
LLM_ROUTES = ("rms_norm", "qkv_rope")  # the LM backbone's Triton kernels, one route for both dtypes


def llm_want(nl: int, forwards: int) -> dict:
    """The LM kernels' launches over `forwards` forwards of an nl-layer Qwen2
    backbone (a prefill and each decode step): two norms a layer and the
    final one, one qkv epilogue a layer."""
    return {"rms_norm": (2 * nl + 1) * forwards, "qkv_rope": nl * forwards}


def _launches(routes: tuple = BF16_ROUTES) -> dict:
    """The launches of `routes` since the last _zero_launches(), zeros
    included (ops/device.launches)."""
    from fangyan_tts_torch.ops import device

    return {r: device.launches[r] for r in routes}


def _zero_launches() -> None:
    """Every route's count to 0."""
    from fangyan_tts_torch.ops import device

    device.launches.clear()


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def v12_small_check() -> None:
    """Small v1 and v2 models on the card against the same weights on the
    CPU: v2 in bf16 (head dim 64, as decode attention takes) within
    SMALL_REL_TOL, v2 in float32 within F32_REL_TOL (its logits on a float32
    KV cache), v1 in float32 within V1_REL_TOL; prefill + teacher-forced
    decode logits, the flow's mel and a vc request's wav (both sides on the
    same CFM noise)."""
    import torch

    from fangyan_tts_torch.config import HiFTConfig, LLMConfig, QwenConfig
    from fangyan_tts_torch.infer.tts_v12 import V1_HIFT, CosyVoice2TTS, CosyVoiceV1TTS
    from fangyan_tts_torch.models.qwen2 import init_cache

    sd = lambda m: {k: v.clone() for k, v in m.state_dict().items()}
    rng = np.random.default_rng(2)
    # v2
    qwen = QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, vocab_size=300)
    llm = LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=50, extra_tokens=3, qwen=qwen,
                    top_k=1, tau_r=1.1)
    flow_kw = dict(vocab_size=50, input_size=64, decoder_channels=(32,), num_mid_blocks=2, n_blocks=1, num_heads=2,
                   attention_head_dim=64, enc_heads=2, enc_ffn=128, enc_blocks=2, enc_up_blocks=1, n_timesteps=4)
    hift = HiFTConfig(base_channels=64, f0_cond_channels=32)
    ref = CosyVoice2TTS.random_init(llm, flow_kw, hift, dtype=torch.bfloat16, device="cpu", seed=3)
    gpu = CosyVoice2TTS(llm, sd(ref.llm), flow_kw, sd(ref.flow), hift, sd(ref.hift), device="cuda")

    def logits(t, cache_dtype=torch.bfloat16) -> np.ndarray:
        dev = t.device
        with torch.inference_mode():
            ids = torch.tensor([[0] + list(range(3, 15)) + [1]], device=dev)
            src = torch.tensor([[2] + [0] * 12 + [2]], device=dev)
            cache = init_cache(qwen, 1, 64, dtype=cache_dtype, device=dev)
            out = [t.llm.decode_logits(t.llm.prefill_leftpad(src, ids, torch.tensor([14], device=dev), cache))]
            start = torch.zeros(1, dtype=torch.int32, device=dev)
            for i, tok in enumerate([5, 9, 17, 33]):
                out.append(t.llm.decode_step(torch.tensor([tok], device=dev), torch.tensor([[14 + i]], device=dev),
                                             start, 14 + i + 1, cache))
            return torch.stack(out).float().cpu().numpy()

    req = dict(source_speech_token=rng.integers(0, 50, 37).astype(np.int32),
               flow_prompt_speech_token=rng.integers(0, 50, 6).astype(np.int32),
               prompt_speech_feat=(rng.standard_normal((12, 80)) * 0.5).astype(np.float32),
               flow_embedding=rng.standard_normal(192).astype(np.float32))
    lg_g, lg_c = logits(gpu), logits(ref)
    mel_g, mel_c = (t.token2mel(req["source_speech_token"], req["flow_prompt_speech_token"], req["prompt_speech_feat"],
                                req["flow_embedding"], 0, False, True) for t in (gpu, ref))
    wav_g, wav_c = (next(t.tts(**req))["tts_speech"] for t in (gpu, ref))
    r = (_rel(lg_g, lg_c), _rel(mel_g, mel_c), _rel(wav_g, wav_c))
    ok = max(r) <= SMALL_REL_TOL and wav_g.shape == wav_c.shape and np.isfinite(wav_g).all()
    log(f"small v2 model card vs CPU (bf16): logits rel {r[0]:.3e} (argmax agreement "
        f"{float((lg_g.argmax(-1) == lg_c.argmax(-1)).mean()):.2f}), mel rel {r[1]:.3e}, wav rel {r[2]:.3e} "
        f"(limit {SMALL_REL_TOL}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the v2 port on the card disagrees with its CPU path on a small model")
    # v2 in float32: the logits on a float32 KV cache (decode attention's float32 route), the mel and the wav
    from fangyan_tts_torch.ops import device

    ref = CosyVoice2TTS.random_init(llm, flow_kw, hift, dtype=torch.float32, device="cpu", seed=3)
    gpu = CosyVoice2TTS(llm, sd(ref.llm), flow_kw, sd(ref.flow), hift, sd(ref.hift), dtype=torch.float32,
                        device="cuda")
    f0 = device.launches["decode_attention_f32"]
    lg_g, lg_c = logits(gpu, torch.float32), logits(ref, torch.float32)
    launched = device.launches["decode_attention_f32"] - f0
    mel_g, mel_c = (t.token2mel(req["source_speech_token"], req["flow_prompt_speech_token"], req["prompt_speech_feat"],
                                req["flow_embedding"], 0, False, True) for t in (gpu, ref))
    wav_g, wav_c = (next(t.tts(**req))["tts_speech"] for t in (gpu, ref))
    r = (_rel(lg_g, lg_c), _rel(mel_g, mel_c), _rel(wav_g, wav_c))
    ok = (max(r) <= F32_REL_TOL and wav_g.shape == wav_c.shape and np.isfinite(wav_g).all()
          and launched == qwen.num_hidden_layers * 4)
    log(f"small v2 model card vs CPU (float32, the logits on a float32 KV cache): logits rel {r[0]:.3e}, mel rel "
        f"{r[1]:.3e}, wav rel {r[2]:.3e} (limit {F32_REL_TOL}); decode attention's float32 route launched "
        f"{launched} times (2 layers x 4 steps) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the float32 v2 port on the card disagrees with its CPU path on a small model")
    # v1
    llm_kw = dict(text_token_size=300, speech_token_size=50, text_encoder_input_size=64, llm_input_size=128,
                  llm_output_size=128, text_enc_blocks=2, llm_blocks=2, heads=2, ffn=256)
    flow1 = dict(vocab_size=50, input_size=64, decoder_channels=(32, 32), num_mid_blocks=2, n_blocks=1, num_heads=2,
                 attention_head_dim=64, enc_heads=2, enc_ffn=128, enc_blocks=2, n_timesteps=4)
    hift1 = HiFTConfig(**{**V1_HIFT.__dict__, "base_channels": 64, "f0_cond_channels": 32})
    ref = CosyVoiceV1TTS.random_init(llm_kw, flow1, hift1, device="cpu", seed=4)
    gpu = CosyVoiceV1TTS(llm_kw, sd(ref.llm), flow1, sd(ref.flow), hift1, sd(ref.hift), device="cuda")
    for t in (gpu, ref):  # the same CFM noise on both sides
        t._flow_noise = (lambda out_len, _d=t.device: torch.from_numpy(
            np.random.default_rng(out_len).standard_normal((1, out_len, 80)).astype(np.float32)).to(_d))
    text = rng.integers(0, 300, (1, 9)).astype(np.int32)
    speech = rng.integers(0, 50, (1, 12)).astype(np.int32)
    emb = rng.standard_normal((1, 192)).astype(np.float32)
    with torch.inference_mode():
        lg1 = [t.llm.logits(*(torch.from_numpy(x).to(t.device) for x in (text, np.asarray([9]), speech,
                                                                          np.asarray([12]), emb))).cpu().numpy()
               for t in (gpu, ref)]
    req1 = dict(source_speech_token=rng.integers(0, 50, 70).astype(np.int32),
                flow_prompt_speech_token=rng.integers(0, 50, 10).astype(np.int32),
                prompt_speech_feat=(rng.standard_normal((17, 80)) * 0.5).astype(np.float32),
                flow_embedding=emb[0])
    wav1 = [next(t.tts(**req1))["tts_speech"] for t in (gpu, ref)]
    r1 = (_rel(*lg1), _rel(*wav1))
    ok = max(r1) <= V1_REL_TOL and wav1[0].shape == wav1[1].shape and np.isfinite(wav1[0]).all()
    log(f"small v1 model card vs CPU (float32, TF32 off): logits rel {r1[0]:.3e}, vc wav rel {r1[1]:.3e} "
        f"(limit {V1_REL_TOL}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the v1 port on the card disagrees with its CPU path on a small model")


def v2_offline(results: dict, card: str, tts) -> dict:
    """The bench workload through CosyVoice2TTS.tts(stream=False): 30 text
    tokens, exactly 150 speech tokens (min = max ratio 5), no prompt; a
    warm-up run, then the timed one. Launches held to one a layer and decode
    step, no other kernel."""
    rng = np.random.default_rng(10)
    req = dict(text=rng.integers(0, 50000, V2_TEXT_TOKENS).astype(np.int32),
               flow_embedding=rng.standard_normal(192).astype(np.float32),
               min_token_text_ratio=V2_RATIO, max_token_text_ratio=V2_RATIO)
    stage: dict = {}
    steps = counted_steps(tts)
    n_tokens, mel_frames = [], []
    inner = (tts.generate_tokens, tts.token2mel, tts.vocode)
    tts.generate_tokens = clocked(stage, "llm", tts.generate_tokens, lambda a, k, out: n_tokens.append(len(out)))
    tts.token2mel = clocked(stage, "flow", tts.token2mel)
    tts.vocode = clocked(stage, "vocoder", tts.vocode, lambda a, k, out: mel_frames.append(a[0].shape[0]))
    out = {}
    try:
        run = "one run, first calls included"
        _zero_launches()
        with kernel_shapes(results, f"v2 offline ({run})"):
            t = time.perf_counter()
            wav = next(tts.tts(**req))["tts_speech"]
            wall = time.perf_counter() - t
        counts = _launches()
        _count(results, counts)
        audio_s = len(wav) / 24000
        ok = (np.isfinite(wav).all() and np.abs(wav).max() <= 0.99 and len(wav) == mel_frames[-1] * 480
              and n_tokens[-1] == int(V2_TEXT_TOKENS * V2_RATIO) and steps.value > 0
              and counts == {"decode_attention": FULL_LLM_LAYERS * steps.value, "chunk_flash_attention": 0,
                              "int4_matmul": 0})
        out = dict(tokens=n_tokens[-1], steps=steps.value, mel_frames=mel_frames[-1], audio_s=audio_s,
                   llm_s=stage["llm"], ms_per_step=stage["llm"] / steps.value * 1e3, flow_s=stage["flow"],
                   vocoder_s=stage["vocoder"], wall_s=wall, rtf=wall / audio_s, launches=counts)
        log(f"v2 offline ({run}): {n_tokens[-1]} tokens in {steps} decode steps, {mel_frames[-1]} mel frames, "
            f"{audio_s:.2f} s audio; decode {stage['llm']:.3f} s ({out['ms_per_step']:.2f} ms/step), flow "
            f"{stage['flow']:.3f} s, vocoder {stage['vocoder']:.3f} s, wall {wall:.3f} s, RTF {wall / audio_s:.4f}; "
            f"launches {counts} [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"v2 offline ({run}) failed its checks")
    finally:
        tts.generate_tokens, tts.token2mel, tts.vocode = inner
        del tts.llm.decode_step  # counted_steps' wrapper is an instance attribute
    text, emb = req["text"], req["flow_embedding"]
    ratio = dict(min_token_text_ratio=V2_RATIO, max_token_text_ratio=V2_RATIO)
    tokens = tts.generate_tokens(text, **ratio)
    no_prompt = (np.zeros(0, np.int32), np.zeros((0, 80), np.float32))
    mel = tts.token2mel(tokens, *no_prompt, emb, 0, False, True)
    out["profile"] = _profile({
        "llm": lambda: tts.generate_tokens(text, **ratio),
        "flow": lambda: tts.token2mel(tokens, *no_prompt, emb, 0, False, True),
        "vocoder": lambda: tts.vocode(mel, np.zeros((0, 1), np.float32), pad_to=-(-mel.shape[0] // 32) * 32),
    }, card, "v2 150 tokens, bf16")
    return out


def v2_stream(results: dict, card: str, tts) -> dict:
    """A stream of 200 tokens (10 text tokens, min = max ratio 20, no
    prompt) through CosyVoice2TTS.tts(stream=True): one stream, its first
    calls included (no warm-up stream: phase 13 needs the time); first-chunk
    ms, RTF and the chunk count (v2_stream_chunks)."""
    rng = np.random.default_rng(11)
    req = dict(text=rng.integers(0, 50000, V2_STREAM_TEXT_TOKENS).astype(np.int32),
               flow_embedding=rng.standard_normal(192).astype(np.float32), stream=True,
               min_token_text_ratio=V2_STREAM_RATIO, max_token_text_ratio=V2_STREAM_RATIO)
    n_tok = int(V2_STREAM_TEXT_TOKENS * V2_STREAM_RATIO)
    want_chunks = v2_stream_chunks(n_tok, 0, tts.token_hop, tts.flow.pre_lookahead_len)
    steps = counted_steps(tts)
    stage: dict = {}
    inner = (tts.token2mel, tts.vocode)
    tts.token2mel = clocked(stage, "flow", tts.token2mel)
    tts.vocode = clocked(stage, "vocoder", tts.vocode)
    out = {}
    try:
        run = "one run, first calls included"
        _zero_launches()
        with kernel_shapes(results, f"v2 stream ({run})"):
            t0 = time.perf_counter()
            first, chunks, n, finite = None, 0, 0, True
            for o in tts.tts(**req):
                first = time.perf_counter() - t0 if first is None else first
                chunks += 1
                n += len(o["tts_speech"])
                finite &= bool(np.isfinite(o["tts_speech"]).all())
            wall = time.perf_counter() - t0
        counts = _launches()
        _count(results, counts)
        audio_s = n / 24000
        ok = (finite and chunks == want_chunks and n == n_tok * 2 * 480 and steps.value > 0
              and counts == {"decode_attention": FULL_LLM_LAYERS * steps.value, "chunk_flash_attention": 0,
                              "int4_matmul": 0})
        rest = wall - stage["flow"] - stage["vocoder"]
        out = dict(tokens=n_tok, chunks=chunks, steps=steps.value, first_ms=first * 1e3, wall_s=wall,
                   audio_s=audio_s, rtf=wall / audio_s, flow_s=stage["flow"], vocoder_s=stage["vocoder"],
                   llm_s=rest, launches=counts)
        log(f"v2 stream ({run}): {n_tok} tokens, {chunks} chunks (derived {want_chunks}), first chunk "
            f"{first * 1e3:.1f} ms, {audio_s:.2f} s audio in {wall:.3f} s, RTF {wall / audio_s:.4f}; flow "
            f"{stage['flow']:.3f} s over {chunks} calls (the whole prefix each hop), vocoder "
            f"{stage['vocoder']:.3f} s, the rest (decode) {rest:.3f} s for {steps} decode steps; launches "
            f"{counts} [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"v2 stream ({run}) failed its checks")
    finally:
        tts.token2mel, tts.vocode = inner
        del tts.llm.decode_step
    return out


def v2_api_request(results: dict, card: str, d, api: dict) -> dict:
    """AutoModel(d) on the v2 model directory, one inference_zero_shot of the
    API request's sentence and 5 s prompt (phase 4's), launches counted."""
    import torch

    from fangyan_tts_torch.api import AutoModel, CosyVoice2

    t0 = time.perf_counter()
    model = AutoModel(str(d))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    steps = counted_steps(model.model)
    _zero_launches()
    with kernel_shapes(results, "v2 API request"):
        t = time.perf_counter()
        outs = list(model.inference_zero_shot(API_TEXT, API_PROMPT_TEXT, str(d / "prompt.wav")))
        wall = time.perf_counter() - t
    counts = _launches()
    _count(results, counts)
    wav = outs[0]["tts_speech"]
    audio_s = len(wav) / 24000
    ok = (isinstance(model, CosyVoice2) and model.model.dtype == torch.bfloat16 and len(outs) == 1
          and np.isfinite(wav).all() and np.abs(wav).max() <= 0.99 and len(wav) % 960 == 0 and steps.value > 0
          and counts == {"decode_attention": FULL_LLM_LAYERS * steps.value, "chunk_flash_attention": 0,
                          "int4_matmul": 0})
    log(f"v2 API request: AutoModel load {load_s:.2f} s ({type(model).__name__}, {model.model.dtype}); "
        f"inference_zero_shot: {steps} decode steps, {audio_s:.2f} s audio, wall {wall:.3f} s, "
        f"RTF {wall / audio_s:.4f}; launches {counts} [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the v2 API request failed its checks")
    del model
    torch.cuda.empty_cache()
    return dict(load_s=load_s, steps=steps.value, audio_s=audio_s, wall_s=wall, rtf=wall / audio_s, launches=counts)


def v1_runs(results: dict, card: str) -> dict:
    """CosyVoice-300M (CosyVoiceV1TTS, float32, random weights): one offline
    request and one stream of V1_TEXT through the byte tokenizer, exactly
    300 speech tokens (min = max ratio 20), an x-vector, no prompt. No
    kernel may launch."""
    import torch

    from fangyan_tts_torch.infer.tts_v12 import V1_HIFT, CosyVoiceV1TTS
    from fangyan_tts_torch.tokenizer import get_tokenizer

    t0 = time.perf_counter()
    tts = CosyVoiceV1TTS.random_init({}, {}, V1_HIFT, device="cuda", seed=12)
    torch.cuda.synchronize()
    log(f"v1 random_init at full width (float32, cuda): {time.perf_counter() - t0:.2f} s")
    text = np.asarray(get_tokenizer(True, None).encode(V1_TEXT), np.int32)
    rng = np.random.default_rng(13)
    xvec = rng.standard_normal(192).astype(np.float32)
    n_tok = int(len(text) * V1_RATIO)
    req = dict(text=text, flow_embedding=xvec, llm_embedding=xvec, min_token_text_ratio=V1_RATIO,
               max_token_text_ratio=V1_RATIO)
    stage: dict = {}
    toks = []
    tts.token2mel = clocked(stage, "flow", tts.token2mel, lambda a, k, out: toks.append(len(a[0])))
    tts.vocode = clocked(stage, "vocoder", tts.vocode)
    out = {}
    for name, stream in (("offline", False), ("stream", True)):
        stage.clear()
        toks.clear()
        _zero_launches()
        with kernel_shapes(results, f"v1 {name}"):
            t0 = time.perf_counter()
            first, chunks, n, finite = None, 0, 0, True
            for o in tts.tts(stream=stream, **req):
                first = time.perf_counter() - t0 if first is None else first
                chunks += 1
                n += len(o["tts_speech"])
                finite &= bool(np.isfinite(o["tts_speech"]).all())
            wall = time.perf_counter() - t0
        counts = _launches()
        audio_s = n / 22050
        # the stream's chunks overlap by 20 tokens; its tokens are the first chunk's and every later hop's
        n_stream_tok = toks[0] + sum(t - tts.token_overlap for t in toks[1:])
        want_chunks = 1 if not stream else 1 + max(0, (n_tok - tts.token_overlap) // tts.token_min_hop)
        ok = (finite and counts == {"decode_attention": 0, "chunk_flash_attention": 0, "int4_matmul": 0}
              and (n_stream_tok if stream else toks[0]) == n_tok and chunks == want_chunks
              and (stream or n == int(n_tok / 50 * 22050 / 256) * 256))
        llm_s = wall - stage["flow"] - stage["vocoder"]
        out[name] = dict(tokens=n_tok, chunks=chunks, first_ms=first * 1e3, wall_s=wall, audio_s=audio_s,
                         rtf=wall / audio_s, llm_s=llm_s, flow_s=stage["flow"], vocoder_s=stage["vocoder"],
                         launches=counts)
        log(f"v1 {name}: {n_tok} tokens ({len(text)} byte-tokenizer text ids), {chunks} chunks (derived "
            f"{want_chunks}), first chunk {first * 1e3:.1f} ms, {audio_s:.2f} s audio in {wall:.3f} s, RTF "
            f"{wall / audio_s:.4f}; LLM {llm_s:.3f} s ({llm_s / n_tok * 1e3:.2f} ms a token), flow "
            f"{stage['flow']:.3f} s, vocoder {stage['vocoder']:.3f} s; launches {counts} [{card}] "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"v1 {name} failed its checks")
    del tts
    torch.cuda.empty_cache()
    return out


def v12_phase(results: dict, card: str, states: tuple[dict, dict], api: dict) -> None:
    """Phase 10 at full width, random weights: the small-model checks, then
    CosyVoice2-0.5B's widths, its LM at FULL_LLM_LAYERS layers, in bf16
    (offline, streamed, through the API, through a width-4 LLMScheduler)
    and CosyVoice-300M in float32 (offline, streamed)."""
    from dataclasses import replace

    import torch

    from fangyan_tts_torch.config import cosyvoice2_config
    from fangyan_tts_torch.infer.tts_v12 import CosyVoice2TTS, v2_llm_config

    v12_small_check()
    out = results.setdefault("v12", {})
    cfg = cosyvoice2_config()
    cfg = replace(cfg, llm=replace(cfg.llm, qwen=replace(cfg.llm.qwen, num_hidden_layers=FULL_LLM_LAYERS)))
    t0 = time.perf_counter()
    tts = CosyVoice2TTS.random_init(v2_llm_config(cfg.llm.qwen), {}, cfg.hift, dtype=torch.bfloat16, seed=11)
    torch.cuda.synchronize()
    log(f"v2 random_init at full width (bf16, cuda): {time.perf_counter() - t0:.2f} s")
    out["v2_offline"] = v2_offline(results, card, tts)
    out["v2_stream"] = v2_stream(results, card, tts)
    out["v2_sched"] = serving_llm_vs_solo(results, card, tts, cfg=replace(cfg, llm=tts.llm_cfg), label="v2")
    with api_model_dir(tts, states, cfg=cfg) as d:
        out["v2_api"] = v2_api_request(results, card, d, api)
    del tts
    torch.cuda.empty_cache()
    out["v1"] = v1_runs(results, card)


# ---------------------------------------------------------------- phase 11


def dp_models(states: tuple[dict, dict]) -> tuple:
    """The CAM++ and S3 functions of `states` for data/extract, bf16 on the
    card as the extraction CLIs build them."""
    import torch

    from fangyan_tts_torch.infer.frontend import make_campplus_fn, make_s3_fn
    from fangyan_tts_torch.models.campplus import CAMPPlus
    from fangyan_tts_torch.models.from_jax import to_jax_tree
    from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3

    with torch.device("meta"):
        skels = CAMPPlus(), S3TokenizerV3()
    camp, s3 = (make(to_jax_tree(sd, skel)) for make, sd, skel in zip((make_campplus_fn, make_s3_fn), states, skels))
    return (lambda f, fl: camp(f)), s3


def dp_corpus(root, seed: int = 17) -> tuple[dict, dict, float]:
    """bench.py's data-prep corpus (bench_data_prep), written before any
    timer: utterance i lasts DP_SECONDS[i % 8] s, a sine at 80 + 10 (i % 12)
    Hz under a 3.1 Hz envelope plus N(0, 0.02) noise, as 16 kHz 16-bit wavs
    under root/raw. Returns (wav paths, texts, seconds of audio)."""
    from fangyan_tts_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    raw = root / "raw"
    raw.mkdir()
    wavs, texts, total = {}, {}, 0.0
    for i in range(DP_UTTS):
        dur = DP_SECONDS[i % len(DP_SECONDS)]
        t = np.arange(16000 * dur) / 16000
        f0 = 80.0 + 10.0 * (i % 12)
        audio = 0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
        audio += 0.02 * rng.standard_normal(t.size)
        u = f"utt{i:04d}"
        write_wav(raw / f"{u}.wav", audio.astype(np.float32), 16000)
        wavs[u], texts[u] = str(raw / f"{u}.wav"), f"这是第{i}句合成测试文本。"
        total += dur
    return wavs, texts, total


def dp_stage0(d, wavs: dict, texts: dict) -> dict:
    """Stage 0: the Kaldi directory with instruct lines (data/kaldi_io
    write_kaldi_dir), validated (validate_dir: the required files present,
    one line an utterance, one a speaker in spk2utt). Returns utt2spk."""
    from fangyan_tts_torch.data.kaldi_io import validate_dir, write_kaldi_dir

    per = DP_UTTS // DP_SPEAKERS
    utt2spk = {u: f"spk{i // per}" for i, u in enumerate(wavs)}
    write_kaldi_dir(d, wavs, texts, utt2spk, {u: "请用普通话说。<|endofprompt|>" for u in wavs})
    v = validate_dir(d)
    lines = v["line_counts"]
    if not v["valid"] or {lines[f] for f in ("wav.scp", "text", "utt2spk")} != {DP_UTTS} or \
            lines["spk2utt"] != DP_SPEAKERS or not v["instruct"]:
        raise AssertionError(f"stage 0 validation failed: {v}")
    return utt2spk


class _Bytes:
    """Stage 4's tokenizer: UTF-8 bytes (bench.py's byte stand-in)."""

    def encode(self, s, **kw):
        return list(s.encode("utf-8"))


def dp_stage4(list_path) -> int:
    """Stage 4: the training pipeline (data/dataset.build_pipeline, llm mode)
    yields a collated LLM batch from the shards; returns its rows."""
    from fangyan_tts_torch.data.dataset import build_pipeline

    it = build_pipeline(str(list_path), _Bytes(), None, mode="llm", llm_cfg=full_config().llm,
                        shuffle_size=64, sort_size=32)
    batch = next(iter(it))
    ids = batch["ids"]
    if ids.ndim != 2 or ids.shape[0] < 1 or ids.shape[1] % 64 or not (batch["lengths"] > 0).all():
        raise AssertionError(f"stage 4 yielded a malformed batch: {({k: np.shape(v) for k, v in batch.items()})}")
    return int(ids.shape[0])


def dp_artifacts(d, utt2spk: dict, shards: bool) -> None:
    """Every artifact is written and reads back with the keys of wav.scp
    (the speakers of utt2spk for spk2embedding): finite 192-d float32
    x-vectors, non-empty int32 token rows; with `shards`, the two parquet
    shards, their json sidecars and the three lists, whose utt columns hold
    every utterance once."""
    import torch

    from fangyan_tts_torch.data.kaldi_io import read_scp

    keys = set(read_scp(d / "wav.scp"))
    for name, want in (("utt2embedding.pt", keys), ("spk2embedding.pt", set(utt2spk.values())),
                       ("utt2speech_token.pt", keys)):
        got = torch.load(d / name, weights_only=False)
        if set(got) != want:
            raise AssertionError(f"{name}: keys differ from wav.scp's ({len(got)} against {len(want)})")
        for k, v in got.items():
            ok = (v.dtype == torch.int32 and v.dim() == 1 and v.numel() > 0) if "token" in name else \
                (v.dtype == torch.float32 and tuple(v.shape) == (192,) and bool(torch.isfinite(v).all()))
            if not ok:
                raise AssertionError(f"{name}[{k}]: {v.dtype} {tuple(v.shape)}")
    if not shards:
        return
    import pyarrow.parquet as pq

    pq_dir = d / "pq"
    lists = {n: (pq_dir / n).read_text().splitlines() for n in ("data.list", "utt2data.list", "spk2data.list")}
    n_shards = -(-DP_UTTS // DP_SHARD)
    if any(len(v) != n_shards for v in lists.values()):
        raise AssertionError(f"shard lists: {lists}")
    utts = []
    for pf, uf in zip(lists["data.list"], lists["utt2data.list"]):
        cols = pq.read_table(pf, columns=["utt", "sample_rate", "num_samples", "instruct"]).to_pydict()
        utts += cols["utt"]
        if set(json.loads(Path(uf).read_text())) != set(cols["utt"]) or set(cols["sample_rate"]) != {16000}:
            raise AssertionError(f"shard {pf} and its sidecar disagree")
    if sorted(utts) != sorted(keys):
        raise AssertionError("the shards' utt columns do not hold every utterance once")


def dp_pass(root, tag: str, wavs: dict, texts: dict, total_s: float, emb, tok, full: bool) -> dict:
    """One pass on a fresh directory: stages 1+2 (`extract_all`, stage 0
    before the clock) or, with `full`, stages 0-4 (stage 0, `prepare_corpus`
    with the shards packed between drains, then `build_pipeline`'s first
    batch) on the clock; each stage's wall, and the artifacts checked after."""
    import torch

    from fangyan_tts_torch.data.extract import extract_all, prepare_corpus

    d = root / tag
    out: dict = {}
    t0 = time.perf_counter()
    utt2spk = dp_stage0(d, wavs, texts)
    t1 = time.perf_counter()
    if full:
        prepare_corpus(d, d / "pq", emb, tok, batch_size=DP_BATCH, num_utts_per_parquet=DP_SHARD, instruct=True)
        t2 = time.perf_counter()
        out["stage4_rows"] = dp_stage4(d / "pq" / "data.list")
        t3 = time.perf_counter()
        out.update(stage0_s=t1 - t0, stages123_s=t2 - t1, stage4_s=t3 - t2, wall_s=t3 - t0)
    else:
        out["maps"] = extract_all(d, emb, tok, batch_size=DP_BATCH)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t1
    out.update(utt_per_s=DP_UTTS / out["wall_s"], audio_s_per_s=total_s / out["wall_s"])
    dp_artifacts(d, utt2spk, shards=full)
    return out


def _route_check(label: str, got: tuple[dict, dict], want: tuple[dict, dict]) -> tuple[float, bool]:
    """x-vectors within DP_ROUTE_ATOL and codes equal, utterance by utterance."""
    (ge, gt), (we, wt) = got, want
    err = max(float(np.abs(ge[u] - we[u]).max()) for u in we)
    same = sorted(gt) == sorted(wt) and all(np.array_equal(gt[u], wt[u]) for u in wt)
    ok = sorted(ge) == sorted(we) and err <= DP_ROUTE_ATOL and same
    log(f"data prep {label}: x-vectors max|diff| {err:.3e} (limit {DP_ROUTE_ATOL}), codes "
        f"{'equal' if same else 'DIFFER'} {'OK' if ok else 'FAIL'}")
    return err, ok


def dp_checks(card: str, utts: list, states: tuple[dict, dict], emb16, tok16) -> dict:
    """Float32 on the card against float32 on the CPU (the same weights and
    audio, one utterance of each of DP_CHECK_SECONDS' buckets through the
    fused route), gated by phase 7's limits; then the bf16 route against
    float32 on the card, recorded."""
    import torch

    from fangyan_tts_torch.data.extract import _batched_buckets, fused
    from fangyan_tts_torch.infer.tts import _load
    from fangyan_tts_torch.models.campplus import CAMPPlus
    from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3

    picks = [utts[DP_SECONDS.index(s)] for s in DP_CHECK_SECONDS]

    def run(dev: str, emb, tok) -> dict:
        out = {}
        for names, pad, lens in _batched_buckets(picks, 16000, DP_BATCH):
            e, c, n = (x.cpu().numpy() for x in fused(emb, tok)(torch.from_numpy(pad).to(dev),
                                                                 torch.from_numpy(lens).to(dev)))
            for i, u in enumerate(names):
                out[u] = (e[i].astype(np.float32), c[i, : n[i]], int(n[i]))
        return out

    camp_sd, s3_sd = states
    f32 = {}
    for dev in ("cuda", "cpu"):
        cm, sm = _load(CAMPPlus, camp_sd, torch.device(dev)), _load(S3TokenizerV3, s3_sd, torch.device(dev))
        f32[dev] = run(dev, lambda f, fl: cm(f), lambda m, ml: sm(m, ml))
        del cm, sm
    b16 = run("cuda", emb16, tok16)
    rows, ok = [], True
    for (u, _), sec in zip(picks, DP_CHECK_SECONDS):
        (xg, cg, lg), (xc, cc, lc), (xb, cb, lb) = f32["cuda"][u], f32["cpu"][u], b16[u]
        xerr = float(np.abs(xg - xc).max())
        x_ok = bool(np.allclose(xg, xc, atol=XVEC_ATOL, rtol=XVEC_RTOL))
        same = float((cg == cc).mean()) if lg == lc else 0.0
        cos = float(np.dot(xb, xg) / (np.linalg.norm(xb) * np.linalg.norm(xg)))
        same16 = float((cb == cg).mean()) if lb == lg else float("nan")
        row_ok = x_ok and lg == lc and same >= S3_CODES_EQUAL and np.isfinite(xb).all() and lb == lg
        ok &= row_ok
        rows.append(dict(seconds=sec, xvec_max_abs_err=xerr, code_len=(lg, lc), codes_equal=same,
                         unique_codes=int(len(np.unique(cg))), bf16_xvec_cos=cos, bf16_codes_equal=same16))
        log(f"data prep {sec} s utterance, fused route: CAM++ card vs CPU float32 max|diff| {xerr:.3e} (atol "
            f"{XVEC_ATOL}, rtol {XVEC_RTOL}), S3 code lengths {lg} / {lc}, codes equal on {same:.4f} (limit "
            f"{S3_CODES_EQUAL}; {rows[-1]['unique_codes']} distinct); bf16 vs float32 on the card: x-vector cosine "
            f"{cos:.6f}, codes equal {same16:.4f} (recorded) [{card}] {'OK' if row_ok else 'FAIL'}")
    if not ok:
        raise AssertionError("data prep: float32 card against CPU failed its limits")
    return {"card_vs_cpu": rows}


def dataprep_phase(results: dict, card: str, states: tuple[dict, dict]) -> None:
    """Phase 11, data prep stages 0-4 at bench.py's full width (128
    utterances of 5-30 s, batch 64, 64 a shard), full-size CAM++ and S3
    with random weights from `states` in bf16 as the CLIs run them: a
    warm-up pass, two timed passes of the fused route (stages 1+2, and
    stages 0-4 when pyarrow imports), the fused route and the two
    extraction CLIs against the separate stages' library calls on the card,
    the fbank's own time and peak memory, the peak memory of each bucket's batch and of a 64-row 30 s batch,
    one 30 s batch under torch.profiler, and the float32 / bf16 checks."""
    import tempfile
    import torch

    from fangyan_tts_torch.cli import extract_embedding, extract_speech_token
    from fangyan_tts_torch.data import native
    from fangyan_tts_torch.data.extract import (_batched_buckets, embed_features, extract_embeddings,
                                                extract_speech_tokens, fused, load_utts)
    from fangyan_tts_torch.models.campplus import CAMPPlus
    from fangyan_tts_torch.models.from_jax import to_jax_tree
    from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3
    from fangyan_tts_torch.train.checkpoint import save_params

    try:
        import pyarrow
        full, why = True, f"pyarrow {pyarrow.__version__} imports"
    except ImportError as e:
        full, why = False, f"pyarrow does not import ({e})"
    log(f"data prep: stages {'0-4' if full else '1+2 only'} run: {why}; audio loader: {native.loader()}")
    out: dict = {"stages": "0-4" if full else "1+2", "pyarrow": why, "loader": native.loader()}
    with torch.device("meta"):
        skels = CAMPPlus(), S3TokenizerV3()
    emb, tok = dp_models(states)
    step = fused(emb, tok)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="dataprep_") as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        wavs, texts, total_s = dp_corpus(root)
        log(f"data prep corpus: {DP_UTTS} wavs, {total_s:.0f} s of audio ({total_s / DP_UTTS:.2f} s mean), "
            f"{DP_SPEAKERS} speakers, written in {time.perf_counter() - t:.2f} s (not timed)")
        t = time.perf_counter()
        dp_pass(root, "warm", wavs, texts, total_s, emb, tok, full)
        log(f"data prep warm-up pass (stages {'0-4' if full else '1+2'}): {time.perf_counter() - t:.2f} s")
        _zero_launches()
        passes = [("1+2", False), ("1+2", False)] + ([("0-4", True), ("0-4", True)] if full else [])
        timed = []
        for i, (label, f) in enumerate(passes):
            r = dp_pass(root, f"pass{i}", wavs, texts, total_s, emb, tok, f)
            timed.append((label, r))
            parts = (f" (stage 0 {r['stage0_s']:.3f} s, stages 1-3 {r['stages123_s']:.3f} s, stage 4 "
                     f"{r['stage4_s']:.3f} s, a batch of {r['stage4_rows']} rows)") if f else ""
            log(f"data prep stages {label}, fused route, pass {i + 1}: {r['wall_s']:.3f} s{parts}, "
                f"{r['utt_per_s']:.2f} utt/s, {r['audio_s_per_s']:.1f} s of audio a second [{card}]")
        launches = _launches()
        log(f"data prep: kernel launches of the timed passes {launches} (this path has no kernel of the port)")
        out["passes"] = [dict(stages=label, **{k: v for k, v in r.items() if k != "maps"}) for label, r in timed]
        out["launches"] = launches
        # the separate stages (extract_embeddings, then extract_speech_tokens: two loads and two uploads of
        # the corpus), then the two stage CLIs, against the fused route's last stages 1+2 pass
        sep_dir = root / "separate"
        sep_spk = dp_stage0(sep_dir, wavs, texts)
        t = time.perf_counter()
        sep = (extract_embeddings(sep_dir, emb, batch_size=DP_BATCH),
               extract_speech_tokens(sep_dir, tok, batch_size=DP_BATCH))
        sep_s = time.perf_counter() - t
        dp_artifacts(sep_dir, sep_spk, shards=False)
        route_err, route_ok = _route_check(f"fused route against the separate stages ({sep_s:.3f} s for both)",
                                           timed[1][1]["maps"], sep)
        ckpt = root / "ckpt"
        bf16 = lambda sd: {k: v.to(torch.bfloat16) if v.dim() >= 2 else v for k, v in sd.items()}
        for name, sd, skel in zip(("campplus", "s3tokenizer"), states, skels):
            save_params(ckpt / f"{name}.msgpack", to_jax_tree(bf16(sd), skel))
        cli_dir = root / "cli"
        dp_stage0(cli_dir, wavs, texts)
        t = time.perf_counter()
        extract_embedding.main(["--dir", str(cli_dir), "--checkpoint", str(ckpt / "campplus.msgpack"),
                                "--batch-size", str(DP_BATCH)])
        extract_speech_token.main(["--dir", str(cli_dir), "--checkpoint", str(ckpt / "s3tokenizer.msgpack"),
                                   "--batch-size", str(DP_BATCH)])
        cli_s = time.perf_counter() - t
        cli_maps = tuple({k: v.numpy() for k, v in torch.load(cli_dir / n, weights_only=False).items()}
                         for n in ("utt2embedding.pt", "utt2speech_token.pt"))
        cli_err, cli_ok = _route_check(f"stage CLIs (--checkpoint, {cli_s:.2f} s for both) against the separate "
                                       "stages", cli_maps, sep)
        out.update(route_err=route_err, cli_err=cli_err, cli_s=cli_s, separate_s=sep_s)
        if not (route_ok and cli_ok):
            raise AssertionError("data prep: a route disagrees with the separate stages")

        # peak memory and time of each bucket's batch, and of a batch of DP_BATCH rows at 30 s
        utts = load_utts(wavs, progress=False)
        mem = []
        batches = list(_batched_buckets(utts, 16000, DP_BATCH))
        pad30, lens30 = next((p, n) for _, p, n in batches if p.shape[1] == 30 * 16000)
        rep = -(-DP_BATCH // len(lens30))
        batches.append(([], np.concatenate([pad30] * rep)[:DP_BATCH], np.concatenate([lens30] * rep)[:DP_BATCH]))
        for _, pad, lens in batches:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            outs = [o.cpu() for o in step(torch.from_numpy(pad).cuda(), torch.from_numpy(lens).cuda())]
            ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated()
            del outs
            mem.append(dict(bucket_s=pad.shape[1] // 16000, rows=pad.shape[0], peak_gib=peak / 2**30,
                            above_resident_gib=(peak - base) / 2**30, ms=ms))
            log(f"data prep memory: {pad.shape[0]} rows of the {pad.shape[1] // 16000} s bucket: peak "
                f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the resident "
                f"{base / 2**30:.2f}), {ms:.1f} ms for the batch (upload, fused step, read back) [{card}]")
        out["memory"] = mem
        # the fbank alone (kaldi_fbank frames and takes its DFT in float64): its own peak on the 64-row 30 s
        # batch, its wall time there and on one 30 s row (the prompt frontend's largest bucket), and the one
        # row under the profiler (under it the 64-row call showed 11 of its device operations, so that call
        # is timed by its wall alone, which its device work fills)
        pad64, lens64 = (torch.from_numpy(a).cuda() for a in batches[-1][1:])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        embed_features(pad64, lens64)
        torch.cuda.synchronize()
        fb_above = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"data prep fbank alone (embed_features) on {DP_BATCH} rows of the 30 s bucket: peak {fb_above:.2f} GiB "
            f"above the resident, against {mem[-1]['above_resident_gib']:.2f} GiB for the fused step [{card}]")
        fb_ms = {rows: eager_ms(lambda: embed_features(pad64[:rows], lens64[:rows]), iters=iters)
                 for rows, iters in ((DP_BATCH, 5), (1, 20))}
        log(f"data prep fbank alone (embed_features), warm wall a call: {fb_ms[DP_BATCH]:.3f} ms for {DP_BATCH} "
            f"rows of the 30 s bucket, {fb_ms[1]:.3f} ms for one row [{card}]")
        out["fbank"] = dict(above_resident_gib=fb_above, ms=fb_ms, profile=_profile(
            {"fbank alone, 1 row at 30 s": lambda: embed_features(pad64[:1], lens64[:1])}, card, "data prep"))
        del pad64, lens64
        d30, n30 = torch.from_numpy(pad30), torch.from_numpy(lens30)
        out["profile"] = _profile({f"fused step, 30 s bucket ({len(lens30)} rows)":
                                   lambda: [o.cpu() for o in step(d30.cuda(), n30.cuda())]},
                                  card, "data prep")
        out.update(dp_checks(card, utts, states, emb, tok))
    results["dataprep"] = out

# ---------------------------------------------------------------- phase 12


def _train_cfgs():
    """The small configuration of the card-vs-CPU train steps (head dim 64,
    as small_reference_check) and the full-width one."""
    from fangyan_tts_torch.config import CosyVoiceConfig, DiTConfig, FlowConfig, LLMConfig, QwenConfig

    qwen = QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, vocab_size=300)
    llm = LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=50, extra_tokens=8, qwen=qwen)
    dit = DiTConfig(dim=128, depth=2, heads=2, dim_head=64, static_chunk_size=10)
    return CosyVoiceConfig(llm=llm, flow=FlowConfig(vocab_size=50, dit=dit, pre_lookahead_channels=64)), \
        full_config()


def llm_train_batch(rng, cfg, b: int, t: int, accum: int) -> dict:
    """bench.py's bench_train batch: random src / ids / targets over the
    speech tokens, every row full, `accum` microbatches stacked."""
    v = cfg.speech_token_size
    return {"src": rng.integers(0, 2, (accum, b, t)).astype(np.int32),
            "ids": rng.integers(0, v, (accum, b, t)).astype(np.int32),
            "lengths": np.full((accum, b), t, np.int32),
            "targets": rng.integers(0, v, (accum, b, t)).astype(np.int32)}


def flow_train_batch(rng, cfg, b: int, lt: int) -> dict:
    return {"token": rng.integers(0, cfg.vocab_size, (b, lt)).astype(np.int32),
            "token_len": np.full((b,), lt, np.int32),
            "feat": rng.standard_normal((b, lt * 2, 80)).astype(np.float32),
            "feat_len": np.full((b,), lt * 2, np.int32),
            "embedding": rng.standard_normal((b, 192)).astype(np.float32)}


def train_small_checks(card: str) -> dict:
    """One LM train step on the card (bf16 compute) against the same step on
    the CPU (float32), and one flow step float32 on both with the same draws,
    from the same weights and batch: loss and grad_norm."""
    import torch

    from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT, flow_train_draws
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import trainer
    from fangyan_tts_torch.train.scheduler import build_optimizer

    small, _ = _train_cfgs()
    rng = np.random.default_rng(12)
    out = {}
    lbatch = {k: v[0] for k, v in llm_train_batch(rng, small.llm, 4, 64, 1).items()}
    lbatch["targets"][:, :8] = -1  # IGNORE_ID, as a plan's text positions
    fbatch = flow_train_batch(rng, small.flow, 3, 24)
    draws = flow_train_draws(3, fbatch["feat"].shape, "cpu", torch.Generator().manual_seed(5))
    for name, dtype, ctor, make_step, batch, limit in (
            ("LM", torch.bfloat16, lambda d: CosyVoice3LM(small.llm, dtype=d), trainer.make_llm_train_step, lbatch,
             SMALL_REL_TOL),
            ("flow", torch.float32, lambda d: CausalMaskedDiffWithDiT(small.flow), trainer.make_flow_train_step,
             fbatch, FLOW_TRAIN_REL_TOL)):
        ref = trainer.random_module(lambda: ctor(torch.float32), 4, "cpu")
        got = {}
        for dev, dt in (("cuda", dtype), ("cpu", torch.float32)):
            model = trainer.random_module(lambda: ctor(dt), 4, dev)
            model.load_state_dict(ref.state_dict())
            tx = build_optimizer(lr=1e-4)
            rng_arg = {k: v.to(dev) for k, v in draws.items()} if name == "flow" else None
            _, m = make_step(model, tx)(trainer.init_state(model, tx), batch, rng_arg)
            got[dev] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        rel = {k: abs(got["cuda"][k] - got["cpu"][k]) / abs(got["cpu"][k]) for k in ("loss", "grad_norm")}
        ok = max(rel.values()) <= limit and all(np.isfinite(v) for v in got["cuda"].values())
        log(f"small {name} train step, card ({str(dtype).split('.')[-1]}) vs CPU (float32): loss {got['cuda']['loss']:.6f}"
            f" / {got['cpu']['loss']:.6f} (rel {rel['loss']:.3e}), grad_norm {got['cuda']['grad_norm']:.6f} / "
            f"{got['cpu']['grad_norm']:.6f} (rel {rel['grad_norm']:.3e}), limit {limit} [{card}] {'OK' if ok else 'FAIL'}")
        out[name] = dict(card=got["cuda"], cpu=got["cpu"], rel=rel, limit=limit)
        if not ok:
            raise AssertionError(f"the {name} train step on the card disagrees with the CPU")
    return out


def _timed_steps(step, state, batch, rng, n: int) -> tuple:
    """A warm-up step, then n timed ones (synchronised around them). Returns
    (state, ms a step, the n losses, peak GiB over the timed steps)."""
    import torch

    state, m = step(state, batch, rng)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, batch, rng)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3 / n
    return state, dt, [float(x) for x in losses], torch.cuda.max_memory_allocated() / 2**30


def train_full_width(card: str) -> dict:
    """bench.py's bench_train at full width: the CosyVoice3-0.5B LM at
    full_config's depth (remat "full", bf16 compute, float32 parameters and
    Adam, accum 2 x (8 x 256)),
    one step of it under the profiler, the same at accum 2 x (64 x 256),
    then one step without remat for its peak memory; the DiT flow (float32)
    on 4 x 200 mel frames, one step under the profiler."""
    import dataclasses

    import torch

    from fangyan_tts_torch.models.flow import CausalMaskedDiffWithDiT
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import trainer
    from fangyan_tts_torch.train.scheduler import build_optimizer

    _, cfg = _train_cfgs()
    rng = np.random.default_rng(13)
    out = {}
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30  # earlier phases' models: the peaks below are above it
    lcfg = dataclasses.replace(cfg.llm, qwen=dataclasses.replace(cfg.llm.qwen, remat="full"))
    t0 = time.perf_counter()
    model = trainer.random_module(lambda: CosyVoice3LM(lcfg, dtype=torch.bfloat16), 0, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    tx = build_optimizer(optim="adam", lr=1e-5, scheduler="constantlr", grad_clip=5.0)
    state = trainer.init_state(model, tx)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: torch.from_numpy(v).cuda() for k, v in llm_train_batch(rng, cfg.llm, TRAIN_B, TRAIN_T,
                                                                         TRAIN_ACCUM).items()}
    step = trainer.make_llm_train_step(model, tx, accum=TRAIN_ACCUM)
    state, ms, losses, peak = _timed_steps(step, state, batch, None, TRAIN_STEPS)
    peak -= resident
    tokens = TRAIN_ACCUM * TRAIN_B * TRAIN_T
    tok_s = tokens / (ms / 1e3)
    mfu = 6.0 * n_params * tok_s / BF16_FLOP_PER_S
    held = [state]

    def one_step():
        held[0], _ = step(held[0], batch)

    prof = _profile({"one LM step (remat full)": one_step}, card, "training")
    # bench.py's max-throughput point: the same step at accum 2 x (64 x 256), a warm-up and three timed steps
    big = {k: torch.from_numpy(v).cuda() for k, v in llm_train_batch(rng, cfg.llm, TRAIN_MAX_B, TRAIN_T,
                                                                       TRAIN_ACCUM).items()}
    state, max_ms, max_losses, max_peak = _timed_steps(step, held[0], big, None, 3)
    max_peak -= resident
    max_tok_s = TRAIN_ACCUM * TRAIN_MAX_B * TRAIN_T / (max_ms / 1e3)
    del big, held
    # the same model and state, one step with remat off (its config is read at every forward)
    model.llm.cfg = dataclasses.replace(model.llm.cfg, remat="")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    off_ms, off_loss = (time.perf_counter() - t0) * 1e3, float(m["loss"])
    off_peak = torch.cuda.max_memory_allocated() / 2**30 - resident
    ok = all(np.isfinite(losses + max_losses + [off_loss]))
    log(f"LM train step at full width (CosyVoice3-0.5B, {FULL_LLM_LAYERS} layers, {n_params / 1e6:.1f}M params, remat "
        f"full, bf16 compute, float32 params and Adam, accum {TRAIN_ACCUM} x {TRAIN_B} x {TRAIN_T}): {ms:.2f} ms a "
        f"step, {tok_s:.0f} "
        f"tokens/s (llm_train_tokens_per_s_per_chip), 6*N*tokens/s {mfu:.3f} of {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; "
        f"peak {peak:.2f} GiB above the resident {resident:.2f}; losses {', '.join(f'{x:.4f}' for x in losses)} "
        f"(warm-up first); at accum "
        f"{TRAIN_ACCUM} x {TRAIN_MAX_B} x {TRAIN_T}: {max_ms:.2f} ms a step, {max_tok_s:.0f} tokens/s, peak "
        f"{max_peak:.2f} GiB, losses {', '.join(f'{x:.4f}' for x in max_losses)}; remat off: one step "
        f"{off_ms:.2f} ms, peak {off_peak:.2f} GiB, loss {off_loss:.4f}; init {init_s:.2f} s [{card}] "
        f"{'OK' if ok else 'FAIL'}")
    out["llm"] = dict(params=n_params, ms=ms, tokens_per_s=tok_s, mfu_6n=mfu, resident_gib=resident,
                      peak_above_resident_gib=peak, losses=losses,
                      max_ms=max_ms, max_tokens_per_s=max_tok_s, max_peak_above_resident_gib=max_peak,
                      max_losses=max_losses, remat_off_ms=off_ms, remat_off_peak_above_resident_gib=off_peak, remat_off_loss=off_loss, init_s=init_s,
                      profile=prof)
    if not ok:
        raise AssertionError("the full-width LM train step gave a non-finite loss")
    del model, state, step, batch, tx
    torch.cuda.empty_cache()

    model = trainer.random_module(lambda: CausalMaskedDiffWithDiT(cfg.flow), 1, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    tx = build_optimizer(optim="adam", lr=1e-4, scheduler="constantlr", grad_clip=5.0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in flow_train_batch(rng, cfg.flow, FLOW_TRAIN_B,
                                                                          FLOW_TRAIN_TOKENS).items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    step = trainer.make_flow_train_step(model, tx)
    state, ms, losses, peak = _timed_steps(step, trainer.init_state(model, tx), batch, gen, FLOW_STEPS)
    peak -= resident
    held = [state]

    def one_step():
        held[0], _ = step(held[0], batch, gen)

    prof = _profile({"one flow step": one_step}, card, "training")
    ok = all(np.isfinite(losses))
    log(f"flow train step at full width (DiT {cfg.flow.dit.dim} x {cfg.flow.dit.depth}, {n_params / 1e6:.1f}M params, "
        f"float32, {FLOW_TRAIN_B} x {2 * FLOW_TRAIN_TOKENS} mel frames, dense attention): {ms:.2f} ms a step, peak "
        f"{peak:.2f} GiB above the resident; losses {', '.join(f'{x:.4f}' for x in losses)} [{card}] {'OK' if ok else 'FAIL'}")
    out["flow"] = dict(params=n_params, ms=ms, peak_above_resident_gib=peak, losses=losses, profile=prof)
    if not ok:
        raise AssertionError("the full-width flow train step gave a non-finite loss")
    del model, tx, batch, state, step, held
    torch.cuda.empty_cache()
    return out


def train_guard(card: str) -> dict:
    """Each kernel wrapper raises on a CUDA input that requires grad (the
    kernels have no backward), before it launches."""
    import torch

    from fangyan_tts_torch.ops.decode_attention import decode_attention
    from fangyan_tts_torch.ops.flash_attention import chunk_flash_attention
    from fangyan_tts_torch.ops.int4_matmul import int4_matmul

    bf = dict(dtype=torch.bfloat16, device="cuda")
    q = torch.zeros((1, 2, 64, 64), requires_grad=True, **bf)
    kv = torch.zeros((1, 2, 64, 64), **bf)
    ck = torch.zeros((2, 1, 128, 2, 64), **bf)
    calls = {
        "chunk_flash_attention": lambda: chunk_flash_attention(q, kv, kv, torch.tensor([64], dtype=torch.int32,
                                                                                     device="cuda"), 0),
        "decode_attention": lambda: decode_attention(torch.zeros((1, 14, 64), requires_grad=True, **bf),
                                                     torch.zeros((1, 2, 64), **bf), torch.zeros((1, 2, 64), **bf), ck,
                                                     ck.clone(), torch.zeros(1, dtype=torch.int32, device="cuda"),
                                                     torch.zeros((1, 128), device="cuda"), 0),
        "int4_matmul": lambda: int4_matmul(torch.zeros((16, 896), requires_grad=True, **bf),
                                           torch.zeros((448, 4864), dtype=torch.int8, device="cuda"),
                                           torch.ones(4864, device="cuda")),
    }
    before = _launches()
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "returned"
        except RuntimeError as e:
            out[name] = "raised" if "no backward" in str(e) else f"raised another error: {e}"
    ok = all(v == "raised" for v in out.values()) and _launches() == before
    log(f"kernel wrappers on CUDA inputs that require grad: {out}, launches unchanged {_launches() == before} "
        f"[{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a kernel wrapper took an input that requires grad")
    return out


def train_clis(results: dict, card: str, states: tuple[dict, dict], model_dir, api: dict) -> dict:
    """The entry points at full width: phase 11's corpus through
    prepare_corpus (shard 0 the train list, shard 1 the CV list), then
    `python -m fangyan_tts_torch.cli.train --config` (full_config) for the
    LM and the flow, one epoch each (the JAX executor's checkpoints and sidecars checked), then
    cli.average_model --val_best --num 2 on the LM, loaded into a copy of
    phase 4's model directory (or a fresh one) for one zero-shot request."""
    import contextlib
    import shutil
    import tempfile

    import torch

    from fangyan_tts_torch.cli import average_model, train
    from fangyan_tts_torch.config import config_to_json
    from fangyan_tts_torch.data.extract import prepare_corpus
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS
    from fangyan_tts_torch.train.checkpoint import load_meta

    emb, tok = dp_models(states)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=build, prefix="train_") as tmp, contextlib.ExitStack() as stack:
        root = Path(tmp)
        wavs, texts, total_s = dp_corpus(root)
        d = root / "kaldi"
        dp_stage0(d, wavs, texts)
        t = time.perf_counter()
        shards = prepare_corpus(d, d / "pq", emb, tok, batch_size=DP_BATCH, num_utts_per_parquet=DP_SHARD,
                                instruct=True)
        log(f"training corpus: {len(wavs)} utterances ({total_s:.0f} s) through prepare_corpus in "
            f"{time.perf_counter() - t:.2f} s, {len(shards)} shards")
        (root / "train.list").write_text(shards[0] + "\n")
        (root / "cv.list").write_text(shards[1] + "\n")
        (root / "config.json").write_text(config_to_json(full_config()))
        for model in ("llm", "flow"):
            exp = root / model
            t = time.perf_counter()
            train.main(["--model", model, "--train_data", str(root / "train.list"), "--cv_data",
                        str(root / "cv.list"), "--model_dir", str(exp), "--config", str(root / "config.json"),
                        "--max_epoch", "1", "--save_per_step", str(TRAIN_SAVE_PER_STEP), "--log_interval", "4"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            metas = {f.name: load_meta(f) for f in sorted(exp.glob("*.msgpack"))}
            last = metas.get("epoch_0_whole.msgpack") or {}
            want = {"init.msgpack", "epoch_0_whole.msgpack"} | {
                f"step_{s}.msgpack" for s in range(TRAIN_SAVE_PER_STEP, last.get("step", 0) + 1, TRAIN_SAVE_PER_STEP)}
            records = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
            ok = (set(metas) == want and len(want) >= 3 and metas["init.msgpack"] == {"epoch": -1, "step": 0}
                  and all(set(m) >= {"epoch", "step", "cv_loss"} and np.isfinite(m["cv_loss"])
                          for n, m in metas.items() if n != "init.msgpack")
                  and {r["tag"] for r in records} == {"train", "cv"}
                  and all(np.isfinite(r["loss"]) for r in records if r["tag"] == "train"))
            gib = sum(f.stat().st_size for f in exp.iterdir()) / 2**30
            log(f"cli.train --model {model}: one epoch, {last.get('step')} steps in {wall:.2f} s (model init, "
                f"{len(metas)} checkpoints of {gib / len(metas):.2f} GiB and CV included); checkpoints "
                f"{sorted(metas)}, cv_loss {[round(m['cv_loss'], 4) for m in metas.values() if 'cv_loss' in m]}; "
                f"metrics.jsonl {len(records)} records [{card}] {'OK' if ok else 'FAIL'}")
            out[model] = dict(wall_s=wall, steps=last.get("step"), checkpoints=sorted(metas),
                              cv_loss={n: m.get("cv_loss") for n, m in metas.items()})
            if not ok:
                raise AssertionError(f"cli.train --model {model} did not write what the JAX executor writes")
            if model == "flow":
                shutil.rmtree(exp)
        avg = root / "llm_avg.msgpack"
        t = time.perf_counter()
        average_model.main(["--dst_model", str(avg), "--src_path", str(root / "llm"), "--num", "2", "--val_best"])
        avg_from = load_meta(avg)["averaged_from"]
        log(f"cli.average_model --val_best --num 2: {[Path(p).name for p in avg_from]} in "
            f"{time.perf_counter() - t:.2f} s")
        out["averaged_from"] = [Path(p).name for p in avg_from]
        if len(avg_from) != 2:
            raise AssertionError("average_model did not average two checkpoints")
        shutil.rmtree(root / "llm")
        launches = _launches()
        log(f"training kernel launches (small checks, full-width steps, both CLI epochs, averaging): {launches} "
            f"(no kernel of the port is on this path)")
        out["launches"] = launches
        if any(launches.values()):
            raise AssertionError("training launched a kernel of the port")
        if model_dir is None:  # phase 4 did not run: a full-width directory of random weights
            tts = CosyVoice3TTS.random_init(full_config(), dtype=torch.bfloat16, seed=11)
            model_dir = stack.enter_context(api_model_dir(tts, states))
            del tts
        d2 = root / "api_model"
        shutil.copytree(model_dir, d2)
        shutil.copy(avg, d2 / "llm.msgpack")
        api_request(results, card, d2, api, key="train_api_request", count=False)
    return out


def train_phase(results: dict, card: str, states: tuple[dict, dict], model_dir, api: dict) -> None:
    """Phase 12, training: the small train steps card against CPU, the
    full-width LM and flow steps, the guard of the kernel wrappers, the CLIs
    (train, average_model) and a zero-shot request from the averaged LM. No
    kernel of the port is on the training path: the counts must stay 0."""
    _zero_launches()
    out = results.setdefault("train", {})
    out["small"] = train_small_checks(card)
    out["full"] = train_full_width(card)
    out["guard"] = train_guard(card)
    out["clis"] = train_clis(results, card, states, model_dir, api)


# ---------------------------------------------------------------- phase 13


def _gan_small():
    """The small vocoder of the card-vs-CPU GAN turns (HiFT base 32) and its
    discriminators (periods 2 and 3, one resolution), as the CPU tests'."""
    from fangyan_tts_torch.config import HiFTConfig

    return HiFTConfig(base_channels=32, f0_cond_channels=16), dict(periods=(2, 3), fft_sizes=(512,),
                                                                   hop_sizes=(128,), win_lengths=(240,))


def _rel_err(a: float, b: float, floor: float = 1e-2) -> float:
    return abs(a - b) / max(abs(b), floor)


def _card_vs_cpu(card: str, label: str, got: dict, limit: float) -> dict:
    """Each metric's card value against the CPU's within `limit` relative
    (of max(|CPU|, 1e-2)), all finite."""
    rel = {k: _rel_err(got["cuda"][k], got["cpu"][k]) for k in got["cpu"]}
    ok = max(rel.values()) <= limit and all(np.isfinite(v) for v in got["cuda"].values())
    log(f"small {label}, card vs CPU: " + ", ".join(f"{k} {got['cuda'][k]:.6f} / {got['cpu'][k]:.6f} (rel "
                                                      f"{rel[k]:.3e})" for k in got["cpu"])
        + f", limit {limit} [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {label} on the card disagrees with the CPU")
    return dict(card=got["cuda"], cpu=got["cpu"], rel=rel, limit=limit)


def rest_small_checks(card: str) -> dict:
    """Small models, card against CPU from the same weights and batch: each
    GAN turn from the same start in float32 on both (GAN_TRAIN_REL_TOL), one
    DPO step in bf16 on the card against float32 on the CPU, and one GRPO
    update likewise (SMALL_REL_TOL, as phase 12's LM step)."""
    import torch

    from fangyan_tts_torch.data.lm_plan import build_prompt_plan
    from fangyan_tts_torch.models.discriminators import MultipleDiscriminator
    from fangyan_tts_torch.models.hift import CausalHiFT
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import dpo, gan, grpo, trainer
    from fangyan_tts_torch.train.scheduler import build_optimizer, plain_adam

    rng = np.random.default_rng(14)
    out = {}
    hcfg, dkw = _gan_small()
    hift_ref = trainer.random_module(lambda: CausalHiFT(hcfg), 4, "cpu")
    with torch.no_grad():
        hift_ref.f0_predictor.classifier.bias.fill_(60.0)  # voiced frames: the sine phases carry gradient
    disc_ref = trainer.random_module(lambda: MultipleDiscriminator(**dkw), 5, "cpu")
    batch = {"speech": (rng.standard_normal((2, 12 * 480)) * 0.1).astype(np.float32),
             "speech_feat": (rng.standard_normal((2, 12, 80)) * 0.3).astype(np.float32),
             "pitch_feat": (np.abs(rng.standard_normal((2, 12))) * 100).astype(np.float32)}
    for turn in (1, 0):  # the discriminator's turn, then the generator's, each from the same start
        got = {}
        for dev in ("cuda", "cpu"):
            h = trainer.random_module(lambda: CausalHiFT(hcfg), 4, dev)
            h.load_state_dict(hift_ref.state_dict())
            d = trainer.random_module(lambda: MultipleDiscriminator(**dkw), 5, dev)
            d.load_state_dict(disc_ref.state_dict())
            state = gan.init_gan_state(h, d, plain_adam(2e-4), plain_adam(2e-4))
            _, m = gan.make_hifigan_steps(h, d, plain_adam(2e-4), plain_adam(2e-4))[turn](state, batch)
            got[dev] = {k: float(v) for k, v in m.items()}
        out["gan_" + ("discriminator" if turn else "generator")] = _card_vs_cpu(
            card, f"GAN {'discriminator' if turn else 'generator'} turn (float32)", got, GAN_TRAIN_REL_TOL)

    small, _ = _train_cfgs()
    lbatch = {k: v[0] for k, v in llm_train_batch(rng, small.llm, 4, 64, 1).items()}
    lbatch["targets"][:, :8] = -1  # IGNORE_ID, as a plan's text positions
    ref = trainer.random_module(lambda: CosyVoice3LM(small.llm), 6, "cpu")
    other = trainer.random_module(lambda: CosyVoice3LM(small.llm), 7, "cpu")
    got = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = trainer.random_module(lambda: CosyVoice3LM(small.llm, dtype=dt), 6, dev)
        model.load_state_dict(ref.state_dict())
        tx = build_optimizer(lr=1e-4)
        _, m = dpo.make_dpo_train_step(model, trainer.frozen_copy(model), tx)(trainer.init_state(model, tx), lbatch)
        got[dev] = {k: float(m[k]) for k in ("loss", "sft_loss", "dpo_loss")}
    out["dpo"] = _card_vs_cpu(card, "DPO step (card bf16, CPU float32)", got, SMALL_REL_TOL)

    # one GRPO update: 2 prompts x group 2, a reference of other weights, old_logps off the policy's
    plans = [build_prompt_plan(small.llm, rng.integers(0, 300, n).tolist(), []) for n in (5, 9)]
    tokens = rng.integers(0, small.llm.speech_token_size, (4, 32)).astype(np.int32)
    lens = np.asarray([32, 20, 27, 9], np.int32)
    rewards = np.asarray([0.9, 0.1, 0.2, 0.7], np.float32)
    with torch.no_grad():
        base = grpo.make_rollout_batch(ref, plans, 2, tokens, lens, rewards)
    noise = torch.from_numpy(rng.normal(0, 0.3, (4, 32)).astype(np.float32))
    got = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = trainer.random_module(lambda: CosyVoice3LM(small.llm, dtype=dt), 6, dev)
        model.load_state_dict(ref.state_dict())
        model.requires_grad_(False)
        refm = trainer.random_module(lambda: CosyVoice3LM(small.llm, dtype=dt), 7, dev)
        refm.load_state_dict(other.state_dict())
        refm.requires_grad_(False)
        batch = {k: v.to(dev) for k, v in base.items()}
        batch["old_logps"] = batch["old_logps"] + noise.to(dev) * (batch["old_logps"] != 0)
        tx = plain_adam(1e-4, weight_decay=1e-4, grad_clip=1.0)
        step = grpo.make_grpo_step(model, refm, tx, grpo.GRPOConfig(group_size=2))
        _, m = step(trainer.init_state(model, tx), batch)
        got[dev] = {k: float(m[k]) for k in ("loss", "pg_loss", "kl")}
    out["grpo"] = _card_vs_cpu(card, "GRPO update (card bf16, CPU float32)", got, SMALL_REL_TOL)
    return out


def gan_full_width(card: str) -> dict:
    """The vocoder's GAN turns at full width: full_config().hift and the
    full MultipleDiscriminator in float32 (TF32 off) on one batch as the
    recipe's pipeline gives it (collate_hifigan: GAN_ROWS crops of 24,960
    samples, max_frames_in_batch 2000, their matcha mels on the card and
    their f0): a warm-up pair, GAN_STEPS timed pairs (ms a turn), the peak
    above what earlier phases leave resident, and one turn of each under
    torch.profiler."""
    import torch

    from fangyan_tts_torch.data.dataset import collate_hifigan, make_mel_fn
    from fangyan_tts_torch.models.discriminators import MultipleDiscriminator
    from fangyan_tts_torch.models.hift import CausalHiFT
    from fangyan_tts_torch.train import gan, trainer
    from fangyan_tts_torch.train.scheduler import plain_adam

    cfg = full_config()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    rng = np.random.default_rng(15)
    t0 = time.perf_counter()
    crops = [{"speech": prompt_audio(GAN_CROP / 24000, 24000, seed=int(s))[:GAN_CROP]}
             for s in rng.integers(0, 2**31, GAN_ROWS)]
    batch = {k: torch.from_numpy(v).cuda() for k, v in collate_hifigan(crops, make_mel_fn("cuda")).items()}
    collate_s = time.perf_counter() - t0
    hift = trainer.random_module(lambda: CausalHiFT(cfg.hift), 0, "cuda")
    disc = trainer.random_module(MultipleDiscriminator, 1, "cuda")
    n_gen, n_disc = (sum(p.numel() for p in m.parameters()) for m in (hift, disc))
    state = gan.init_gan_state(hift, disc, plain_adam(2e-4), plain_adam(2e-4))
    gen_step, disc_step = gan.make_hifigan_steps(hift, disc, plain_adam(2e-4), plain_adam(2e-4))
    state, dm = disc_step(state, batch)
    state, gm = gen_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"discriminator": 0.0, "generator": 0.0}
    losses = []
    for _ in range(GAN_STEPS):
        for name, step in (("discriminator", disc_step), ("generator", gen_step)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t) / GAN_STEPS
            losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2**30 - resident
    held = [state]

    def turn(step):
        def run():
            held[0], _ = step(held[0], batch)
        return run

    prof = _profile({"discriminator turn": turn(disc_step), "generator turn": turn(gen_step)}, card, "GAN")
    ok = all(np.isfinite(losses)) and gm["loss_mel"] > 0
    log(f"GAN turns at full width (CausalHiFT base {cfg.hift.base_channels}, {n_gen / 1e6:.1f}M params; the "
        f"discriminators {n_disc / 1e6:.1f}M; float32, TF32 off; {GAN_ROWS} x {GAN_CROP} samples, collated in "
        f"{collate_s:.2f} s): discriminator turn {times['discriminator'] * 1e3:.2f} ms, generator turn "
        f"{times['generator'] * 1e3:.2f} ms; peak {peak:.2f} GiB above the resident {resident:.2f}; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the full-width GAN turns gave a non-finite loss")
    out = dict(rows=GAN_ROWS, gen_params=n_gen, disc_params=n_disc, disc_ms=times["discriminator"] * 1e3,
               gen_ms=times["generator"] * 1e3, peak_above_resident_gib=peak, losses=losses, profile=prof)
    del hift, disc, state, held, batch
    torch.cuda.empty_cache()
    return out


def dpo_full_width(card: str) -> dict:
    """A DPO step at full width: the CosyVoice3-0.5B LM (full_config,
    remat "full", bf16 compute, float32 parameters and Adam as phase 12's
    LM step), its frozen
    copy as the reference, DPO_PAIRS chosen / rejected pairs of DPO_T tokens:
    a warm-up and DPO_STEPS timed steps, tokens/s (policy tokens), peak."""
    import dataclasses

    import torch

    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import dpo, trainer
    from fangyan_tts_torch.train.scheduler import build_optimizer

    cfg = full_config()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    lcfg = dataclasses.replace(cfg.llm, qwen=dataclasses.replace(cfg.llm.qwen, remat="full"))
    model = trainer.random_module(lambda: CosyVoice3LM(lcfg, dtype=torch.bfloat16), 2, "cuda")
    ref = trainer.frozen_copy(model)
    tx = build_optimizer(optim="adam", lr=1e-5, scheduler="constantlr", grad_clip=5.0)
    rng = np.random.default_rng(16)
    batch = {k: torch.from_numpy(v[0]).cuda() for k, v in llm_train_batch(rng, cfg.llm, 2 * DPO_PAIRS, DPO_T,
                                                                             1).items()}
    batch["targets"][:, :32] = -1  # IGNORE_ID over a prompt's text positions
    step = dpo.make_dpo_train_step(model, ref, tx)
    state, ms, losses, peak = _timed_steps(step, trainer.init_state(model, tx), batch, None, DPO_STEPS)
    peak -= resident
    tokens = 2 * DPO_PAIRS * DPO_T
    ok = all(np.isfinite(losses))
    log(f"DPO step at full width (CosyVoice3-0.5B, {FULL_LLM_LAYERS} layers, remat full, bf16 compute, float32 params "
        f"and Adam, a frozen copy as the reference; {DPO_PAIRS} pairs x {DPO_T} tokens): {ms:.2f} ms a step, "
        f"{tokens / (ms / 1e3):.0f} "
        f"tokens/s; peak {peak:.2f} GiB above the resident {resident:.2f}; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (warm-up first) [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the full-width DPO step gave a non-finite loss")
    out = dict(ms=ms, tokens_per_s=tokens / (ms / 1e3), peak_above_resident_gib=peak, losses=losses)
    del model, ref, state, step, batch, tx
    torch.cuda.empty_cache()
    return out


def grpo_spec() -> dict:
    """The kernel shapes of phase 13's GRPO run, from train/grpo's own
    buckets (rollout_buckets, the function generate_rollouts uses) on
    GRPO_TEXTS through the byte tokenizer (the card's model directories
    have no tokenizer/): the decode at B = prompts x group with its cache
    length and each row's first valid slot, and flash at the CFG pair for
    every length bucket a rollout can reach between its min and max lengths
    (token2mel pads the tokens to a multiple of 32, 2 mel frames a token)."""
    import warnings

    from fangyan_tts_torch.data.lm_plan import build_prompt_plan
    from fangyan_tts_torch.infer.frontend import Frontend
    from fangyan_tts_torch.tokenizer import get_qwen_tokenizer
    from fangyan_tts_torch.train.grpo import rollout_buckets

    cfg = full_config()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fe = Frontend(get_qwen_tokenizer(None, True, "cosyvoice3"), cfg, device="cpu")
    plans = [build_prompt_plan(cfg.llm, fe.extract_text_token(t).tolist(), []) for t in GRPO_TEXTS]
    bk = rollout_buckets(plans, GRPO_GROUP)
    up = lambda n, m: -(-n // m) * m
    flash_l = sorted({up(max(n, 1), 32) * cfg.token_mel_ratio
                      for n in range(int(bk["min_lens"].min()), int(bk["max_lens"].max()) + 1)})
    return dict(b=len(bk["rows"]), tp=bk["tp"], max_new=bk["max_new"], cache_len=bk["cache_len"],
                starts=[bk["tp"] - len(p.ids) for p in bk["rows"]], min_lens=bk["min_lens"].tolist(),
                max_lens=bk["max_lens"].tolist(), flash_l=flash_l)


def _decode_iterations(lens, max_lens, max_new: int) -> int:
    """generate_speech_tokens' loop count from its result: row r is done
    after step n_r (its stop id) or, at its max length, after step n_r - 1;
    the loop runs until every row is done."""
    done = [n - 1 if n >= m else n for n, m in zip(lens, max_lens)]
    return min(max(done) + 1, max_new)


def grpo_cli(results: dict, card: str, model_dir, spec: dict) -> dict:
    """`python -m fangyan_tts_torch.cli.grpo_train` at its defaults (4
    prompts x 8 rollouts, echo reward, clip 1.0 + adamw) for GRPO_ITERS steps
    on `model_dir`: each iteration's wall split into the rollouts, token2wav
    (token2mel + vocode) and the update (make_rollout_batch's old_logps and
    the step); decode launches held to the LM's layers a decode step and
    the steps to what the rollouts' lengths imply, flash launches to
    n_timesteps x depth a token2mel call, none in the update, every shape held to phase 3's checks
    (grpo_spec); metrics.jsonl and the checkpoint read back."""
    import shutil
    import tempfile

    import torch

    from fangyan_tts_torch.cli import grpo_train
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS
    from fangyan_tts_torch.models.from_jax import llm_from_jax
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.train import grpo
    from fangyan_tts_torch.train.checkpoint import load_params

    iters: list = []  # one dict an iteration, opened by its rollouts
    orig = {"rollouts": grpo.generate_rollouts, "batch": grpo.make_rollout_batch, "step": grpo.make_grpo_step,
            "token2mel": CosyVoice3TTS.token2mel, "vocode": CosyVoice3TTS.vocode, "decode": CosyVoice3LM.decode_step}

    def timed(part, fn, note=None):
        def inner(*a, **k):
            torch.cuda.synchronize()
            before, t = sum(_launches().values()), time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            it = iters[-1]
            it[part] = it.get(part, 0.0) + time.perf_counter() - t
            if part == "update":
                it["update_launches"] = it.get("update_launches", 0) + sum(_launches().values()) - before
            if note:
                note(it, res)
            return res
        return inner

    def rollouts(model, plans, group_size, *a, **k):
        bk = grpo.rollout_buckets(plans, group_size)
        iters.append({"steps": StepCount(), "token2mel_calls": 0, "max_lens": bk["max_lens"].tolist(),
                      "max_new": bk["max_new"]})
        graphs = dict(count_graphs())
        res = timed("rollouts", orig["rollouts"], lambda it, res: it.update(lens=res[1].tolist()))(
            model, plans, group_size, *a, **k)
        it = iters[-1]
        it.update(steps=it["steps"].value, **{k: GRAPHS[k] - graphs[k] for k in graphs})
        return res

    def decode_step(self, *a, **k):
        iters[-1]["steps"].bump()
        return orig["decode"](self, *a, **k)

    def count_call(it, _):
        it["token2mel_calls"] += 1

    patches = [(grpo, "generate_rollouts", rollouts), (grpo, "make_rollout_batch", timed("update", orig["batch"])),
               (grpo, "make_grpo_step", lambda *a, **k: timed("update", orig["step"](*a, **k))),
               (CosyVoice3TTS, "token2mel", timed("token2wav", orig["token2mel"], count_call)),
               (CosyVoice3TTS, "vocode", timed("token2wav", orig["vocode"])),
               (CosyVoice3LM, "decode_step", decode_step)]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="grpo_") as tmp:
        root = Path(tmp)
        (root / "train.jsonl").write_text("".join(json.dumps({"text": t}, ensure_ascii=False) + "\n"
                                                  for t in GRPO_TEXTS))
        saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
        for owner, name, fn in patches:
            setattr(owner, name, fn)
        _zero_launches()
        try:
            with kernel_shapes(results, "cli.grpo_train"):
                t0 = time.perf_counter()
                grpo_train.main(["--model_dir", str(model_dir), "--data", str(root / "train.jsonl"), "--out_dir",
                                 str(root / "out"), "--steps", str(GRPO_ITERS)])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
        counts = _launches()
        _count(results, counts)
        records = [json.loads(x) for x in (root / "out" / "metrics.jsonl").read_text().splitlines()]
        ckpt = root / "out" / f"llm_grpo_step{GRPO_ITERS}.msgpack"
        t = time.perf_counter()
        n_leaves = len(llm_from_jax(load_params(ckpt), full_config().llm))
        read_s = time.perf_counter() - t
        ckpt_gib = ckpt.stat().st_size / 2**30
        shutil.rmtree(root / "out")
    steps = sum(it["steps"] for it in iters)
    calls = sum(it["token2mel_calls"] for it in iters)
    b = spec["b"]
    cfg = full_config()
    nl, per_call = cfg.llm.qwen.num_hidden_layers, cfg.flow.dit.depth * cfg.flow.n_timesteps
    derived = [_decode_iterations(it["lens"], it["max_lens"], it["max_new"]) for it in iters]
    ok = (len(iters) == len(records) == GRPO_ITERS and all(len(it["lens"]) == b for it in iters)
          and [it["steps"] for it in iters] == derived and calls == b * GRPO_ITERS
          and counts == {"decode_attention": nl * steps, "chunk_flash_attention": per_call * calls, "int4_matmul": 0}
          and all(it.get("update_launches") == 0 for it in iters)
          and all(np.isfinite(r["loss"]) and r["reward_mean"] == -1.0 for r in records))
    for i, (it, r) in enumerate(zip(iters, records)):
        log(f"cli.grpo_train iteration {i}: {b} rollouts ({GRPO_PROMPTS} prompts x {GRPO_GROUP}), lengths "
            f"{min(it['lens'])}-{max(it['lens'])} (mean {np.mean(it['lens']):.1f}), {it['steps']} decode steps "
            f"(derived {derived[i]}; {it['replays']} replayed, {it['captures']} graph captures); rollouts "
            f"{it['rollouts']:.3f} s, token2wav {it['token2wav']:.3f} s over "
            f"{it['token2mel_calls']} token2mel + vocode calls, update {it['update']:.3f} s (old_logps and the step, "
            f"{it['update_launches']} kernel launches); wall_s {r['wall_s']}; loss {r['loss']:.6f}, kl {r['kl']:.3e}, "
            f"reward_mean {r['reward_mean']}")
    log(f"cli.grpo_train: {GRPO_ITERS} iterations in {wall:.2f} s (model load and the checkpoint included); "
        f"launches {counts} ({nl} x {steps} decode steps, {per_call} x {calls} token2mel calls); checkpoint "
        f"{ckpt_gib:.2f} GiB, {n_leaves} tensors, read back in {read_s:.2f} s [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli.grpo_train failed its checks")
    return dict(wall_s=wall, iterations=iters, derived_steps=derived,
                launches=counts, records=records, checkpoint_gib=ckpt_gib)


def gan_cli(card: str, states: tuple[dict, dict]) -> dict:
    """`python -m fangyan_tts_torch.cli.train_gan` for one epoch on phase
    11's corpus (prepare_corpus, shard 0 the train list), at full width;
    both checkpoints read back, and the generator's loaded as AutoModel
    loads a CausalHiFT (bf16 but the f0 predictor) to vocode one mel."""
    import tempfile

    import torch

    from fangyan_tts_torch.cli import train_gan
    from fangyan_tts_torch.data.extract import prepare_corpus
    from fangyan_tts_torch.infer.tts import _cast_state, _load
    from fangyan_tts_torch.models.from_jax import discriminator_from_jax, hift_from_jax
    from fangyan_tts_torch.models.hift import CausalHiFT
    from fangyan_tts_torch.train.checkpoint import load_meta, load_params

    cfg = full_config()
    emb, tok = dp_models(states)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="gan_") as tmp:
        root = Path(tmp)
        wavs, texts, _ = dp_corpus(root)
        d = root / "kaldi"
        dp_stage0(d, wavs, texts)
        shards = prepare_corpus(d, d / "pq", emb, tok, batch_size=DP_BATCH, num_utts_per_parquet=DP_SHARD,
                                instruct=True)
        (root / "train.list").write_text(shards[0] + "\n")
        t = time.perf_counter()
        train_gan.main(["--train_data", str(root / "train.list"), "--model_dir", str(root / "exp"), "--max_epoch",
                        "1", "--log_interval", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        names = sorted(f.name for f in (root / "exp").iterdir())
        gen, disc = (load_params(root / "exp" / f"epoch_0_{n}.msgpack") for n in ("whole", "disc"))
        metas = [load_meta(root / "exp" / f"epoch_0_{n}.msgpack") for n in ("whole", "disc")]
    discriminator_from_jax(disc)  # the full set's keys and shapes
    hift = _load(lambda: CausalHiFT(cfg.hift), _cast_state(hift_from_jax(gen, cfg.hift), torch.bfloat16,
                                                           ("f0_predictor.",)), torch.device("cuda"))
    mel = torch.from_numpy((np.random.default_rng(17).standard_normal((1, 64, 80)) * 0.5).astype(np.float32))
    with torch.inference_mode():
        audio, _ = hift(mel.cuda().to(torch.bfloat16))
    audio = audio.float().cpu().numpy()
    ok = (names == ["epoch_0_disc.msgpack", "epoch_0_disc.msgpack.json", "epoch_0_whole.msgpack",
                    "epoch_0_whole.msgpack.json"] and metas == [{"epoch": 0}] * 2
          and audio.shape == (1, 64 * 480) and np.isfinite(audio).all())
    log(f"cli.train_gan: one epoch on shard 0 ({DP_SHARD} utterances) in {wall:.2f} s (model init, the "
        f"pipeline's resample, crops, mels and f0, the checkpoints included); wrote {names}; the generator "
        f"vocodes a 64-frame mel as AutoModel loads it: {audio.shape[1]} samples, max |x| "
        f"{np.abs(audio).max():.4f} [{card}] {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli.train_gan did not write what the JAX CLI writes")
    return dict(wall_s=wall, files=names)


def rest_phase(results: dict, card: str, states: tuple[dict, dict], model_dir, grpo: dict) -> None:
    """Phase 13, the rest of training: the small models card against CPU
    (GAN turns, a DPO step, a GRPO update), the GAN turns and a DPO step at
    full width, then the CLIs: cli.grpo_train (its rollouts on the decode
    kernel and its token2wav on the flash kernel, launches counted) and
    cli.train_gan. The GAN, DPO and GRPO-update steps launch no kernel."""
    import contextlib

    import torch

    out = results.setdefault("train_rest", {})
    _zero_launches()
    out["small"] = rest_small_checks(card)
    out["gan"] = gan_full_width(card)
    out["dpo"] = dpo_full_width(card)
    launches = _launches()
    log(f"phase 13 training steps' kernel launches (small checks, GAN turns, DPO steps): {launches} (none expected)")
    if any(launches.values()):
        raise AssertionError("a GAN, DPO or GRPO-update step launched a kernel of the port")
    with contextlib.ExitStack() as stack:
        if model_dir is None:  # phase 4 did not run: a full-width directory of random weights
            from fangyan_tts_torch.infer.tts import CosyVoice3TTS

            tts = CosyVoice3TTS.random_init(full_config(), dtype=torch.bfloat16, seed=11)
            model_dir = stack.enter_context(api_model_dir(tts, states))
            del tts
        out["grpo_cli"] = grpo_cli(results, card, model_dir, grpo)
    _zero_launches()
    out["gan_cli"] = gan_cli(card, states)
    if any(_launches().values()):
        raise AssertionError("cli.train_gan launched a kernel of the port")


# ---------------------------------------------------------------- float32 routes (phases 3, 4 and 10)


def bound_f32(nbytes: float, flops: float) -> tuple[float, str]:
    """bound() for the float32 routes: their products run on the CUDA cores
    (no TF32), so the operations' peak is float32's outside the tensor cores."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def held_f32(name: str, err: float, err_f32: float, limit: float, scale: float) -> str:
    """Check a float32 route's max error `err` against its plain version in
    float64 on the same float32 inputs: within `limit`, which must stay
    under F32_LIMIT_SHARE of the mean |plain f64| `scale`. `err_f32` is the
    plain version's own float32 error (recorded)."""
    if limit > F32_LIMIT_SHARE * scale:
        raise AssertionError(f"{name}: limit {limit:.1e} is over {F32_LIMIT_SHARE} of the mean |output| "
                             f"{scale:.3e}; the check would be too loose for this data")
    msg = (f"max|kernel-plain f64|={err:.3e} (limit {limit:.1e} = {limit / scale:.2e} of mean|plain f64|="
           f"{scale:.3e}; max|plain f32-plain f64|={err_f32:.3e})")
    if not err <= limit:
        raise AssertionError(f"{name} float32 route disagrees with its plain version: {msg}")
    return msg


def f32_batch_request() -> dict:
    """Phase 4's float32 batch at full width: F32_B texts of F32_TEXT_TOKENS
    tokens, no prompt, exactly F32_TEXT_TOKENS x F32_RATIO tokens a row."""
    rng = np.random.default_rng(13)
    return dict(texts=[rng.integers(0, 50000, F32_TEXT_TOKENS).astype(np.int32) for _ in range(F32_B)],
                flow_embedding=rng.standard_normal(192).astype(np.float32),
                min_token_text_ratio=F32_RATIO, max_token_text_ratio=F32_RATIO)


def f32_decode_cases() -> list[tuple[int, int, list[int], list[int]]]:
    """The float32 decode route's checked and timed shapes, as (B, S, write
    slots, first open slots): phase 4's float32 batch (infer/tts.batch_buckets:
    B = F32_B rows at their last step, windows from random starts in the
    prompt bucket), B = 4, S = 256 with a row that has no open slot and a
    write past S, B = 1, S = 4096, and the GRPO rollout bucket's shape in
    float32 (B = 32, S = 384: every row open from slot 0 to its write slot
    at S - 1 or clamped there from past S, so the whole cache layer is read)."""
    bt = batch_shapes(f32_batch_request())
    b, s, tp = bt["b"], bt["cache_len"], bt["tp"]
    last = tp + int(F32_TEXT_TOKENS * F32_RATIO) - 1
    starts = [int(v) for v in np.random.default_rng(9).integers(0, tp, b)]
    return [(b, s, [last] * b, starts), (4, 256, [0, 100, 255, 300], [0, 0, 0, 256]), (1, 4096, [4000], [0]),
            (32, 384, [383 + 5 * (i % 2) for i in range(32)], [0] * 32)]


def f32_decode_inputs(gen, nl: int, b: int, s: int, idx_list: list, first_slots: list) -> tuple:
    """Float32 inputs of one f32_decode_cases() case on the card: q, k_new,
    v_new, caches of nl layers, idx, and a bias of 0 on [first, clamped write
    slot] and -1e10 elsewhere."""
    import torch

    dev, kv, hd, qh = "cuda", 2, 64, 14
    q = torch.randn((b, qh, hd), generator=gen, device=dev) * QK_SCALE
    kn, vn = (torch.randn((b, kv, hd), generator=gen, device=dev) for _ in range(2))
    ck, cv = (torch.randn((nl, b, s, kv, hd), generator=gen, device=dev) for _ in range(2))
    idx = torch.tensor(idx_list, dtype=torch.int32, device=dev)
    slot = torch.arange(s, device=dev)[None, :]
    first = torch.tensor(first_slots, device=dev)[:, None]
    bias = torch.where((slot >= first) & (slot <= torch.clamp(idx, max=s - 1)[:, None]), 0.0, -1e10).float()
    return q, kn, vn, ck, cv, idx, bias


def check_f32_routes(results: dict, api: dict) -> None:
    """Each kernel's float32 route against its plain version run in float64
    on the same float32 inputs, at the float32 paths' shapes worked out from
    the code's own buckets: phase 4's float32 batch (infer/tts.batch_buckets:
    decode attention at B = F32_B and its cache, int4 at its decode M = B
    and its prefill M = B x tp, flash at its 2B rows and flow length) and
    phase 4's float32 API request (flash at every length its decode can give,
    from the API request's buckets; its decode runs on the bf16 KV cache
    that both packages' models keep, the bf16 route); decode attention also
    with a row that has no open slot and a write past S, at S = 4096 and at
    B = 32, S = 384 (f32_decode_cases; each shape timed, each call
    bit-equal to a second one); int4 also at M = 1, 8, 16, 17 and 100 (the
    edges of its decode and prefill tiles; M = 16 timed), each call
    bit-equal to a second one; flash also one row past its 128-row block
    with a row of mel_len 0 (zeros).
    Times against the plain version in float32 and against SDPA and
    F.linear in float32 (TF32 off), with bounds at float32's rates."""
    import torch
    import torch.nn.functional as F

    from fangyan_tts_torch.ops import decode_attention as da
    from fangyan_tts_torch.ops import flash_attention as fa
    from fangyan_tts_torch.ops import int4_matmul as i4
    from fangyan_tts_torch.ops.masks import chunk_attn_mask
    from fangyan_tts_torch.ops.quant import quantize_int4_packed, unpack_int4

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(13)
    bt = batch_shapes(f32_batch_request())
    b = bt["b"]
    nl, kv, hd, qh = FULL_LLM_LAYERS, 2, 64, 14
    errs = []
    for bb, ss, idx_list, first_slots in f32_decode_cases():
        _checked(results, "decode_attention_f32", (bb, ss, kv, qh))
        q, kn, vn, ck, cv, idx, bias = f32_decode_inputs(gen, nl, bb, ss, idx_list, first_slots)
        qkv = torch.cat([q.reshape(bb, -1), kn.reshape(bb, -1), vn.reshape(bb, -1)], dim=1)
        views = (qkv[:, : qh * hd].view(bb, qh, hd), qkv[:, qh * hd: (qh + kv) * hd].view(bb, kv, hd),
                 qkv[:, (qh + kv) * hd:].view(bb, kv, hd))
        c1, c2, c3, c4 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        out_v = da.decode_attention(*views, c1, c2, idx, bias, 0)
        out_c = da.decode_attention(q, kn, vn, c3, c4, idx, bias, 0)
        same = torch.equal(out_v, out_c) and torch.equal(c1, c3) and torch.equal(c2, c4)
        # call to call: the same inputs (the new row already in the caches) give the same bits
        again = torch.equal(out_c, da.decode_attention(q, kn, vn, c3, c4, idx, bias, 0))
        del c1, c2, c3, c4
        for layer in (0, nl - 1):
            c = [t.clone() for t in (ck, cv, ck, cv, ck, cv)]
            out_k = da.decode_attention(q, kn, vn, c[0], c[1], idx, bias, layer)
            out_d = da.decode_attention_plain(q.double(), kn, vn, c[2], c[3], idx, bias, layer)
            out_f = da.decode_attention_plain(q, kn, vn, c[4], c[5], idx, bias, layer)
            torch.cuda.synchronize()
            err = (out_k.double() - out_d).abs().max().item()
            msg = held_f32("decode_attention_f32", err, (out_f.double() - out_d).abs().max().item(), DECODE_F32_ATOL,
                           out_d.abs().mean().item())
            caches = all(torch.equal(x, y) for x, y in ((c[0], c[2]), (c[1], c[3])))
            errs.append(err)
            log(f"decode_attention_f32 B={bb} S={ss} plan {da.plan_f32(bb, ss, kv)} layer={layer} "
                f"idx={idx_list[:4]} starts={first_slots[:4]}: {msg}; caches bit-equal={caches}, strided views "
                f"equal to the contiguous call={same}, bit-equal to a second call={again}")
            if not (caches and same and again and torch.isfinite(out_k).all()):
                raise AssertionError("decode_attention_f32 wrote other cache rows than its plain version, gave a "
                                     "value that is not finite, differs on strided views or from call to call")
            del c
        run_k = lambda: da.decode_attention(q, kn, vn, ck, cv, idx, bias, 0)
        ms_k = time_ms(run_k)
        ms_p = time_ms(lambda: da.decode_attention_plain(q, kn, vn, ck, cv, idx, bias, 0))
        kl, vl = (t[0].permute(0, 2, 1, 3).contiguous() for t in (ck, cv))
        mask = (bias == 0)[:, None, None, :]
        ms_l = time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None, :], kl, vl, attn_mask=mask,
                                                              enable_gqa=True))
        del kl, vl
        open_slots = int((bias > -1e9).sum().item())
        nbytes = 2 * (bb * qh * hd) * 4 + 2 * (bb * kv * hd) * 4 * 2 + 2 * (open_slots * kv * hd) * 4 + bb * ss * 4 + bb * 4
        bms, by = bound_f32(nbytes, 2 * 2 * qh * hd * open_slots)
        results.setdefault("decode_f32_timing", []).append(
            dict(b=bb, s=ss, ms=ms_k, plain_ms=ms_p, library_ms=ms_l, bound_ms=bms, bound_by=by))
        log(f"decode_attention_f32 B={bb} S={ss}: kernel {ms_k * 1e3:.2f} us, plain f32 {ms_p * 1e3:.1f} us, "
            f"sdpa f32 {ms_l * 1e3:.1f} us, bound {bms * 1e3:.3f} us ({by})")
    results["decode_f32_err"] = max(errs)

    # flash attention: the batch's 2B rows (ragged mel_len) timed, contiguous and as the DiT's strided views;
    # the float32 API request's CFG pair at every length its decode can give, untimed
    rag = np.random.default_rng(10)
    runs = [((bt["l_mel"], tuple(int(v) for v in rag.integers(bt["l_mel"] * 5 // 8, bt["l_mel"] + 1, b)) * 2), lay)
            for lay in ("contiguous", "strided")]
    lmax = max(api["flash_l"])
    runs.append(((lmax, (lmax - 6, lmax - 6)), "contiguous"))
    runs += [((l, (l - 6, l - 6)), "untimed") for l in api["flash_l"] if l != lmax]
    runs.append(((129, (129, 0, 77)), "untimed"))  # one row past the route's 128-row block; a row with no key
    errs = []
    for (l, mel), layout in runs:
        bb, h, d = len(mel), 16, 64
        _checked(results, "chunk_flash_attention_f32", (bb, l, h))
        rnd = lambda shape, scale: torch.randn(shape, generator=gen, device=dev) * scale
        if layout == "strided":
            heads = lambda t: t.reshape(bb, l, h, d).transpose(1, 2)
            qkv = rnd((bb, l, 3 * h * d), 1.0)
            q, k, v = heads(rnd((bb, l, h * d), flash_q_scale(l))), heads(rnd((bb, l, h * d), 1.0)), heads(
                qkv[..., 2 * h * d:])
        else:
            q, k, v = rnd((bb, h, l, d), flash_q_scale(l)), rnd((bb, h, l, d), 1.0), rnd((bb, h, l, d), 1.0)
        mel_len = torch.tensor(mel, dtype=torch.int32, device=dev)
        for chunk in (0, 50):
            out_k = fa.chunk_flash_attention(q, k, v, mel_len, chunk)
            out_d = fa.chunk_flash_attention_plain(q.double(), k.double(), v.double(), mel_len, chunk)
            out_f = fa.chunk_flash_attention_plain(q, k, v, mel_len, chunk)
            same = True
            if layout == "strided":
                same = torch.equal(out_k, fa.chunk_flash_attention(*(t.contiguous() for t in (q, k, v)), mel_len, chunk))
            torch.cuda.synchronize()
            valid = lambda t: torch.cat([t[bi, :, :mel[bi]].double().flatten() for bi in range(bb)])
            vk, vd, vf = valid(out_k), valid(out_d), valid(out_f)
            err = (vk - vd).abs().max().item()
            msg = held_f32("chunk_flash_attention_f32", err, (vf - vd).abs().max().item(), FLASH_F32_ATOL,
                           vd.abs().mean().item())
            errs.append(err)
            empty = all(bool((out_k[bi] == 0).all()) for bi in range(bb) if mel[bi] == 0)  # no valid key: zeros
            log(f"chunk_flash_attention_f32 ({bb},{h},{l},{d}) {layout} chunk={chunk} mel_len={mel[:4]}: {msg}"
                + (f" equal to the contiguous call={same}" if layout == "strided" else "")
                + (f" rows of mel_len 0 all zeros={empty}" if 0 in mel else ""))
            if not (same and empty and torch.isfinite(out_k).all()):
                raise AssertionError("chunk_flash_attention_f32 gave a value that is not finite, a strided call "
                                     "that differs from the contiguous one, or a row without keys that is not 0")
            if layout == "untimed":
                continue
            ms_k = time_ms(lambda: fa.chunk_flash_attention(q, k, v, mel_len, chunk), iters=10)
            ms_p = time_ms(lambda: fa.chunk_flash_attention_plain(q, k, v, mel_len, chunk), iters=10)
            mask = chunk_attn_mask(mel_len, l, chunk)[:, None]
            ms_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters=10)
            pairs = int(mask.sum().item()) * h
            nbytes = 2 * bb * h * l * d * 4 + sum(min(m, l) for m in mel) * h * d * 2 * 4 + bb * 4
            bms, by = bound_f32(nbytes, 4 * d * pairs)
            results.setdefault("flash_f32_timing", []).append(
                dict(b=bb, l=l, chunk=chunk, layout=layout, ms=ms_k, plain_ms=ms_p, library_ms=ms_l, bound_ms=bms,
                     bound_by=by))
            log(f"chunk_flash_attention_f32 B={bb} L={l} {layout} chunk={chunk}: kernel {ms_k * 1e3:.2f} us, plain "
                f"f32 {ms_p * 1e3:.1f} us, sdpa f32 {ms_l * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by})")
    results["flash_f32_err"] = max(errs)

    # int4: the batch's decode M = B and prefill M = B x tp, M = 1, 8 and 16 (the decode tile's buckets; 16 its
    # edge, timed), and 17 (the prefill tile's edge) and 100 (no multiple of a tile); every call one launch and
    # bit-equal to a second call on the same inputs
    errs = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, k, n in (("gate_up_proj", 896, 9728), ("down_proj", 4864, 896)):
        copies = [quantize_int4_packed(torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k))
                  for _ in range(24)]
        w, sc = copies[0]
        lib_w = [(unpack_int4(wc).float() * scc).t().contiguous() for wc, scc in copies]
        for m in sorted({1, b, 8, 16, 17, 100, bt["prefill_m"]}):
            _checked(results, "int4_matmul_f32", (m, k, n))
            x = torch.randn((m, k), generator=gen, device=dev)
            out_k = i4.int4_matmul(x, w, sc)
            again = i4.int4_matmul(x, w, sc)
            out_d = i4.int4_matmul_plain(x.double(), w, sc)
            out_f = i4.int4_matmul_plain(x, w, sc)
            torch.cuda.synchronize()
            err = (out_k.double() - out_d).abs().max().item()
            msg = held_f32("int4_matmul_f32", err, (out_f.double() - out_d).abs().max().item(), INT4_F32_ATOL,
                           out_d.abs().mean().item())
            errs.append(err)
            same = torch.equal(out_k, again)
            log(f"int4_matmul_f32 {name} M={m} K={k} N={n} plan {i4.plan_f32(m, k, n, sms)}: {msg} "
                f"finite={bool(torch.isfinite(out_k).all())} bit-equal to a second call={same}")
            if not (same and torch.isfinite(out_k).all()):
                raise AssertionError("int4_matmul_f32 gave a value that is not finite, or differs from run to run")
            if m not in (b, 16, bt["prefill_m"]):
                continue
            ms_k = time_ms(cycling(lambda i: i4.int4_matmul(x, *copies[i]), len(copies)), iters=len(copies))
            ms_p = time_ms(cycling(lambda i: i4.int4_matmul_plain(x, *copies[i]), len(copies)), iters=len(copies))
            ms_l = time_ms(cycling(lambda i: F.linear(x, lib_w[i]), len(copies)), iters=len(copies))
            bms, by = bound_f32(m * k * 4 + k * n // 2 + n * 4 + m * n * 4, 2 * m * k * n)
            results.setdefault("int4_f32_timing", []).append(
                dict(proj=name, m=m, k=k, n=n, ms=ms_k, plain_ms=ms_p, library_ms=ms_l, bound_ms=bms, bound_by=by))
            log(f"int4_matmul_f32 {name} M={m}: kernel {ms_k * 1e3:.2f} us, plain f32 {ms_p * 1e3:.1f} us, F.linear "
                f"f32 on the dequantized weight {ms_l * 1e3:.2f} us, bound {bms * 1e3:.3f} us ({by})")
        del copies, lib_w
    results["int4_f32_err"] = max(errs)


@contextlib.contextmanager
def float32_kv_cache():
    """models/qwen2.init_cache making float32 KV caches, as the port's CPU
    tests give both packages: the decode-attention kernel's float32 route.
    Both packages' models decode on a bf16 cache whatever their dtype, so
    this is the only caller of that route."""
    import torch

    from fangyan_tts_torch.models import qwen2

    inner = qwen2.init_cache
    qwen2.init_cache = lambda cfg, batch, max_len, dtype=None, device=None: inner(cfg, batch, max_len, torch.float32,
                                                                                  device)
    try:
        yield
    finally:
        qwen2.init_cache = inner


@contextlib.contextmanager
def counted_lm_steps():
    """Count the decode steps of every model made inside the block (a CLI
    builds its own): a StepCount."""
    from fangyan_tts_torch.models.llm import CosyVoice3LM

    steps = StepCount()
    inner = CosyVoice3LM.decode_step

    def step(self, *a, **k):
        steps.bump()
        return inner(self, *a, **k)

    CosyVoice3LM.decode_step = step
    try:
        yield steps
    finally:
        CosyVoice3LM.decode_step = inner


def small_float32_check(results: dict) -> None:
    """The small model in float32 on the card against the same weights on
    the CPU, greedy: (1) on the model's own path (both packages keep a bf16
    KV cache, so decode attention runs its bf16 route): the vc route's mel
    and wav within F32_REL_TOL, teacher-forced logits within SMALL_REL_TOL
    (the cache's bf16 rounding); (2) on a float32 KV cache (the decode
    route in float32 too): the LLM route's greedy tokens equal, its mel and
    wav and the teacher-forced logits within F32_REL_TOL; (3) the same in
    the int8 LLM + int4 MLP mode (the int4 kernel's float32 route)."""
    import torch

    from fangyan_tts_torch.infer.tts import CosyVoice3TTS

    cfg = _small_config()
    ref = CosyVoice3TTS.random_init(cfg, dtype=torch.float32, device="cpu", seed=3)
    sd = lambda m: {k: v.clone() for k, v in m.state_dict().items()}
    gpu = CosyVoice3TTS(cfg, sd(ref.llm), sd(ref.flow), sd(ref.hift), dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    vc = dict(source_speech_token=rng.integers(0, 50, 37).astype(np.int32),
              flow_prompt_speech_token=rng.integers(0, 50, 6).astype(np.int32),
              prompt_speech_feat=(rng.standard_normal((12, 80)) * 0.5).astype(np.float32),
              flow_embedding=rng.standard_normal(192).astype(np.float32))
    llm_req = dict(text=rng.integers(0, 300, 10).astype(np.int32), flow_embedding=vc["flow_embedding"])

    def tokens_and_wav(t):
        made = []
        inner = t.token2mel
        t.token2mel = lambda tok, *a, **k: made.append(np.asarray(tok)) or inner(tok, *a, **k)
        try:
            wav = next(t.tts(**llm_req))["tts_speech"]
        finally:
            t.token2mel = inner
        return made[0], wav

    rows = {}
    lg_g, lg_c = _small_logits(gpu, torch.bfloat16), _small_logits(ref, torch.bfloat16)
    mel_g, mel_c = (t.token2mel(vc["source_speech_token"], vc["flow_prompt_speech_token"], vc["prompt_speech_feat"],
                                vc["flow_embedding"]) for t in (gpu, ref))
    wav_g, wav_c = (next(t.tts(**vc))["tts_speech"] for t in (gpu, ref))
    rows["float32, bf16 KV cache"] = dict(logits=_rel(lg_g, lg_c), mel=_rel(mel_g, mel_c), wav=_rel(wav_g, wav_c),
                                          tokens_equal=True, logit_tol=SMALL_REL_TOL)
    for mode in ("float32, float32 KV cache", "float32 int8 LLM + int4 MLP, float32 KV cache"):
        if "int4" in mode:
            for t in (gpu, ref):
                t.quantize_llm(int4_mlp=True)
        f0 = _launches(F32_ROUTES)
        with float32_kv_cache():
            lg_g, lg_c = _small_logits(gpu, torch.float32), _small_logits(ref, torch.float32)
            (tok_g, wav_g), (tok_c, wav_c) = tokens_and_wav(gpu), tokens_and_wav(ref)
        f1 = _launches(F32_ROUTES)
        launched = {k: f1[k] - f0[k] for k in f1}
        mel_g, mel_c = (t.token2mel(tok_c, np.zeros(0, np.int32), np.zeros((0, 80), np.float32),
                                    llm_req["flow_embedding"]) for t in (gpu, ref))
        rows[mode] = dict(logits=_rel(lg_g, lg_c), mel=_rel(mel_g, mel_c),
                          wav=_rel(wav_g, wav_c) if wav_g.shape == wav_c.shape else float("inf"),
                          tokens_equal=bool(np.array_equal(tok_g, tok_c)), tokens=len(tok_c), launched=launched,
                          logit_tol=F32_REL_TOL)
        want_route = {"decode_attention_f32", "chunk_flash_attention_f32"} | ({"int4_matmul_f32"} if "int4" in mode
                                                                            else set())
        if {k for k, v in launched.items() if v} != want_route:
            raise AssertionError(f"small float32 model ({mode}) launched float32 routes {launched}")
    ok = True
    for mode, r in rows.items():
        good = (r["tokens_equal"] and r["logits"] <= r["logit_tol"] and r["mel"] <= F32_REL_TOL
                and r["wav"] <= F32_REL_TOL)
        ok &= good
        log(f"small model card vs CPU ({mode}): logits rel {r['logits']:.3e} (limit {r['logit_tol']}), mel rel "
            f"{r['mel']:.3e}, wav rel {r['wav']:.3e} (limit {F32_REL_TOL})"
            + (f", greedy tokens equal={r['tokens_equal']} ({r['tokens']} tokens), float32 launches {r['launched']}"
               if "launched" in r else "") + f" {'OK' if good else 'FAIL'}")
    results["small_float32"] = rows
    if not ok:
        raise AssertionError("the port's float32 path on the card disagrees with its CPU path on a small model")


def float32_api_request(results: dict, card: str, model_dir, api: dict) -> None:
    """One full-width float32 request as a user makes it: python -m
    fangyan_tts_torch.runtime.offline_inference --no-fp16 on phase 4's model
    directory (its int8 LLM default), one row (the API request's sentence
    and 5 s prompt) through inference_zero_shot. Launches: the flow's flash
    attention on its float32 route, n_timesteps x depth a flow call;
    decode attention one a layer and decode step on the bf16 route (both packages' KV cache is bf16); the
    LM's norms and qkv epilogues (llm_want) each forward; no other. Every shape held to phase 3's checks."""
    import tempfile

    import torch

    from fangyan_tts_torch.config import config_from_dict
    from fangyan_tts_torch.data.audio import read_wav
    from fangyan_tts_torch.runtime import offline_inference

    build = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=build, prefix="f32_request_") as tmp:
        root = Path(tmp)
        row = {"id": "f32", "text": API_TEXT, "prompt_text": API_PROMPT_TEXT, "prompt_wav": str(model_dir / "prompt.wav")}
        (root / "rows.jsonl").write_text(json.dumps(row, ensure_ascii=False) + "\n", encoding="utf-8")
        _zero_launches()
        with counted_lm_steps() as steps, kernel_shapes(results, "float32 request (offline_inference --no-fp16)"):
            t = time.perf_counter()
            offline_inference.main(["--model-dir", str(model_dir), "--dataset", str(root / "rows.jsonl"),
                                    "--output-dir", str(root / "out"), "--no-fp16"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = _launches(BF16_ROUTES + F32_ROUTES + LLM_ROUTES)
        _count(results, counts)
        metrics = json.loads((root / "out" / "metrics.json").read_text())
        wav, sr = read_wav(root / "out" / "f32.wav")
    cfg = config_from_dict(json.loads((model_dir / "config.json").read_text()))  # the directory's model
    want = {"decode_attention": cfg.llm.qwen.num_hidden_layers * steps.value, "chunk_flash_attention": 0,
            "int4_matmul": 0, "decode_attention_f32": 0,
            "chunk_flash_attention_f32": cfg.flow.dit.depth * cfg.flow.n_timesteps, "int4_matmul_f32": 0,
            **llm_want(cfg.llm.qwen.num_hidden_layers, 1 + steps.value)}
    agg = metrics["aggregate"]
    ok = (counts == want and steps.value > 0 and sr == 24000 and len(wav) > 0 and len(wav) % 480 == 0
          and np.isfinite(wav).all() and agg["n_utts"] == 1)
    log(f"float32 request (offline_inference --no-fp16, int8 LLM): {steps} decode steps, {len(wav) / sr:.2f} s "
        f"audio, request RTF {agg['rtf']:.4f} (its own clock), CLI wall {wall:.2f} s with the float32 load; launches "
        f"{counts} (derived {want}) [{card}] {'OK' if ok else 'FAIL'}")
    results["f32_request"] = dict(steps=steps.value, audio_s=len(wav) / sr, rtf=agg["rtf"], cli_wall_s=wall,
                                  launches=counts)
    if not ok:
        raise AssertionError("the float32 request failed its checks")


def float32_batch(results: dict, card: str) -> None:
    """The full-width float32 model in the int8 LLM + int4 MLP mode on a
    float32 KV cache (float32_kv_cache): one batch_synthesize of
    f32_batch_request, the three kernels on their float32 routes. Launches:
    decode one a layer and decode step, int4 2 a layer and forward (the
    prefill and each step; one kernel launch a call on every path), flash
    n_timesteps x depth; the LM's norms and qkv epilogues (llm_want) each
    forward; none on a bf16 route. Every shape held to phase 3's checks."""
    import torch

    from fangyan_tts_torch.infer.tts import CosyVoice3TTS, suppress_silent_runs

    cfg = full_config()
    t0 = time.perf_counter()
    tts = CosyVoice3TTS.random_init(cfg, dtype=torch.float32)
    tts.quantize_llm(int4_mlp=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    steps = counted_steps(tts)
    made = []
    inner = tts._batch_tokens
    tts._batch_tokens = lambda *a, **k: made.append(inner(*a, **k)) or made[-1]
    req = f32_batch_request()
    _zero_launches()
    with float32_kv_cache(), kernel_shapes(results, "float32 batch (int4 MLP, float32 KV cache)"):
        t = time.perf_counter()
        wavs = tts.batch_synthesize(**req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = _launches(BF16_ROUTES + F32_ROUTES + LLM_ROUTES)
    _count(results, counts)
    toks, n = made[-1]
    n_tok = [len(suppress_silent_runs(toks[i, : n[i]])) for i in range(len(n))]
    nl = cfg.llm.qwen.num_hidden_layers
    want = {"decode_attention": 0, "chunk_flash_attention": 0, "int4_matmul": 0,
            "decode_attention_f32": nl * steps.value, "chunk_flash_attention_f32": cfg.flow.dit.depth * cfg.flow.n_timesteps,
            "int4_matmul_f32": 2 * nl * (1 + steps.value), **llm_want(nl, 1 + steps.value)}
    audio_s = sum(len(w) for w in wavs) / cfg.sample_rate
    ok = (counts == want and steps.value > 0 and len(wavs) == F32_B
          and all(np.isfinite(w).all() and len(w) == k * 2 * 480 for w, k in zip(wavs, n_tok)))
    log(f"float32 batch at full width (int8 LLM + int4 MLP, float32 KV cache): {sum(n_tok)} tokens in {steps} "
        f"decode steps, {audio_s:.2f} s audio, wall {wall:.3f} s, batch RTF {wall / audio_s:.4f} (random_init "
        f"and quantization {load_s:.2f} s); launches {counts} (derived {want}) [{card}] {'OK' if ok else 'FAIL'}")
    results["f32_batch"] = dict(steps=steps.value, tokens=sum(n_tok), audio_s=audio_s, wall_s=wall, rtf=wall / audio_s,
                                launches=counts)
    if not ok:
        raise AssertionError("the float32 batch failed its checks")
    del tts
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 14


def datagen_inputs() -> tuple[list[str], list[str]]:
    """Phase 14's input directory: DG_AISHELL_LINES transcript lines (an
    utterance id, then DG_CHARS characters separated by spaces, as aishell's
    transcript writes them) and DG_DIALECT_LINES lines of hunan.txt, from a
    fixed pool of characters and a seed; every text DG_CHARS characters."""
    rng = np.random.default_rng(14)
    line = lambda: "".join(DG_POOL[i] for i in rng.integers(0, len(DG_POOL), DG_CHARS))
    aishell = [f"DG{i:04d} " + " ".join(line()) for i in range(DG_AISHELL_LINES)]
    return aishell, [line() for _ in range(DG_DIALECT_LINES)]


def datagen_spec(api: dict) -> dict:
    """The kernel shapes of phase 14, from the code's own buckets, through the
    byte tokenizer (the card's model directories have no tokenizer/):
    (a) the CLI's batches of 16 (infer/tts.batch_buckets with the hunan
    instruct as prompt text and no LLM prompt speech, as frontend_instruct2
    gives it): decode (16, S) at the last slot a row can write, flash at 32
    rows and every flow length the rows can reach (the prompt's tokens plus
    the longest row's, padded to 64); (b) compare_inference's two sentences
    through inference_instruct2 and (c) run_eval's four through
    inference_zero_shot: decode (1, S) and flash at the CFG pair for every
    length its decode can give (CosyVoice3TTS.generate_tokens' buckets, as
    api_request_spec works them out); (d) the server's stream: its window
    (STREAM_WINDOW tokens, no prompt), which phase 3 checks with the
    streams'."""
    import warnings

    from fangyan_tts_torch.cli.compare_inference import DIALECT_TEXTS
    from fangyan_tts_torch.cli.generate_dialect_dataset import INSTRUCT_BY_DIALECT
    from fangyan_tts_torch.infer.frontend import Frontend
    from fangyan_tts_torch.infer.tts import batch_buckets
    from fangyan_tts_torch.tokenizer import get_qwen_tokenizer

    cfg = full_config()
    up = lambda n, m: -(-n // m) * m
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fe = Frontend(get_qwen_tokenizer(None, True, "cosyvoice3"), cfg, device="cpu")
    n_prompt = api["prompt_tokens"]
    instruct = fe.extract_text_token(INSTRUCT_BY_DIALECT["hunan"])
    aishell, hunan = datagen_inputs()
    texts = [fe.extract_text_token("".join(t.split()[1:])) for t in aishell] + [fe.extract_text_token(t) for t in hunan]
    assert len({len(t) for t in texts}) == 1, "every phase 14 text has the same length"
    plans, tp, max_new, cache_len = batch_buckets(cfg.llm, texts[:16], instruct, np.zeros(0, np.int32), 20.0)
    max_len = int(len(texts[0]) * 20.0)
    min_len = int(len(texts[0]) * 2.0)
    cli = dict(b=16, tp=tp, cache_len=cache_len, last=tp + max_len - 1, starts=[tp - len(p.ids) for p in plans],
               min_len=min_len, max_len=max_len,
               flash_l=sorted({up(n_prompt + n, 64) * cfg.token_mel_ratio for n in range(max_len + 1)}))
    prompt_text = fe.extract_text_token(fe.text_normalize(API_PROMPT_TEXT, split=False))
    single = request_specs(cfg, fe, n_prompt, [("compare " + t, t, instruct, [])
                                               for t in DIALECT_TEXTS["hunan"][:DG_COMPARE_TEXTS]]
                           + [("evaluate " + t, t, prompt_text, [0] * n_prompt) for t in DG_EVAL_TEXTS])
    return dict(cli=cli, single=single)


def request_specs(cfg, fe, n_prompt: int, requests: list) -> list[dict]:
    """The kernel shapes of single requests (label, text, prompt text ids,
    LLM prompt speech tokens) of a model of `cfg` with an n_prompt-token
    flow prompt, through the byte tokenizer: decode (1, S) at the last slot
    its decode can write and its first valid slot, flash at the CFG pair for
    every length its decode can give (CosyVoice3TTS.generate_tokens'
    buckets, as api_request_spec works them out)."""
    from fangyan_tts_torch.data.lm_plan import build_prompt_plan

    up = lambda n, m: -(-n // m) * m
    single = []
    for label, text, ptext, speech in requests:
        segs = fe.text_normalize(text)
        assert len(segs) == 1, segs
        ids = fe.extract_text_token(segs[0])
        plan = build_prompt_plan(cfg.llm, np.concatenate([ptext, ids]).tolist(), speech)
        s_tp = up(len(plan.ids), 64)
        s_max = int(len(ids) * 20.0)
        single.append(dict(label=label, cache_len=up(s_tp + max(up(max(s_max, 1), 64), 64), 128),
                           last=s_tp + s_max - 1, start=s_tp - len(plan.ids),
                           flash_l=sorted({up(n_prompt + n, 32) * cfg.token_mel_ratio for n in range(s_max + 1)})))
    return single


def datagen_phase(results: dict, card: str, model_dir, dg: dict) -> None:
    """Phase 14 at full width (full_config, random weights, bf16 as the
    CLIs load it by default) on phase 4's model directory and 5 s prompt:
    (a) `cli.generate_dialect_dataset --backend cuda --mode hunan` on a
    written input directory (32 utterances: 2 batches of 16); its index read
    back against the wavs on disk; its first batch bit-equal to a direct
    batch_synthesize on a freshly loaded model; a rerun makes no launch;
    (c) `cli.evaluate.run_eval` of four pairs on that model with an ASR stub
    that returns each target text (CER 0 on every row), SS in [-1, 1] and a
    wav against itself at 1; (d) `token2wav_asr_server.serve` in this
    process on 127.0.0.1: a RemoteToken2Wav stream of DG_STREAM_TOKENS
    tokens against the in-process Token2WavSession on the same tokens; (b)
    `cli.compare_inference --dialects hunan --num_texts DG_COMPARE_TEXTS`
    with the directory's own LLM as --finetuned_llm, each fine-tuned wav
    bit-equal to its original. Launches counted for every run (decode one a layer and
    decode step, flash n_timesteps x depth a flow call), every shape held to phase 3's checks; the phase
    must take under DG_PHASE_LIMIT_S."""
    import random
    import shutil
    import tempfile

    import torch

    from fangyan_tts_torch.api import CosyVoice3
    from fangyan_tts_torch.cli import compare_inference, evaluate
    from fangyan_tts_torch.cli import generate_dialect_dataset as gdd
    from fangyan_tts_torch.config import config_from_dict
    from fangyan_tts_torch.data.audio import load_audio, read_wav, write_wav
    from fangyan_tts_torch.infer.stream import Token2WavSession
    from fangyan_tts_torch.runtime import disaggregated, token2wav_asr_server

    t_phase = time.perf_counter()
    cfg = config_from_dict(json.loads((model_dir / "config.json").read_text()))  # the directory's model
    nl, per_flow = cfg.llm.qwen.num_hidden_layers, cfg.flow.dit.depth * cfg.flow.n_timesteps
    build = Path(__file__).resolve().parent / "build"
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=build, prefix="datagen_") as tmp:
        root = Path(tmp)
        inp, prompts, ds = root / "input", root / "prompts", root / "dataset"
        inp.mkdir()
        prompts.mkdir()
        aishell, hunan = datagen_inputs()
        (inp / "aishell_transcript_v0.8.txt").write_text("\n".join(aishell) + "\n", encoding="utf-8")
        (inp / "hunan.txt").write_text("\n".join(hunan) + "\n", encoding="utf-8")
        shutil.copy(model_dir / "prompt.wav", prompts / "hunan.wav")

        # (a) the CLI
        random.seed(0)  # prepare_dataset samples the transcript with random.sample
        _zero_launches()
        with counted_lm_steps() as steps, kernel_shapes(results, "phase 14 (a) generate_dialect_dataset"):
            t = time.perf_counter()
            stats = gdd.main(["--mode", "hunan", "--backend", "cuda", "--input-dir", str(inp), "--output-dir", str(ds),
                              "--model-dir", str(model_dir), "--prompt-wav-dir", str(prompts)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = _launches()
        _count(results, counts)
        want = {"decode_attention": nl * steps.value, "chunk_flash_attention": per_flow * stats["batches"],
                "int4_matmul": 0}
        d = ds / "hunan"
        read = lambda name: [line.split(maxsplit=1) for line in (d / name).read_text(encoding="utf-8").splitlines()]
        scp, text, utt2spk = dict(read("wav.scp")), dict(read("text")), dict(read("utt2spk"))
        spk2utt = dict(read("spk2utt"))
        cache = json.loads((ds / "dataset_cache.json").read_text(encoding="utf-8"))["hunan"]
        n_utt = DG_AISHELL_LINES + DG_DIALECT_LINES
        index_ok = (len(scp) == len(text) == len(utt2spk) == len(cache) == n_utt and set(scp) == set(text)
                    and spk2utt == {"speaker_hunan": " ".join(it["utt_id"] for it in cache)}
                    and all(text[it["utt_id"]] == it["text"] for it in cache))
        wav_ok, lengths = True, []
        for utt, path in scp.items():
            w, sr = read_wav(path)
            lengths.append(len(w))
            wav_ok &= sr == 24000 and len(w) > 0 and len(w) % 480 == 0 and bool(np.isfinite(w).all())
        synth = stats["synth_s"]
        ok = (counts == want and stats["utts"] == n_utt and stats["batches"] == 2 and index_ok and wav_ok)
        out["cli"] = dict(wall_s=wall, load_s=stats["load_s"], synth_s=synth, utts=stats["utts"],
                          audio_s=stats["audio_s"], utt_per_s=stats["utts"] / synth, batch_rtf=synth / stats["audio_s"],
                          steps=steps.value, launches=counts)
        log(f"phase 14 (a) generate_dialect_dataset --backend cuda --mode hunan: {stats['utts']} utterances in "
            f"{stats['batches']} batches of 16, {stats['audio_s']:.2f} s audio ({min(lengths) / 24000:.2f}-"
            f"{max(lengths) / 24000:.2f} s each); CLI wall {wall:.2f} s, load {stats['load_s']:.2f} s "
            f"({stats['load_s'] / wall:.3f} of the wall), synthesis {synth:.2f} s: {stats['utts'] / synth:.3f} utt/s, "
            f"batch RTF {synth / stats['audio_s']:.5f}; {steps} decode steps; index read back (wav.scp, text, "
            f"utt2spk, spk2utt against dataset_cache.json)={index_ok}, every wav 24 kHz, finite, a whole number of "
            f"hops={wav_ok}; launches {counts} (derived {want}) [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 14 (a): the dataset CLI failed its checks")

        # (a) its first batch against a direct batch_synthesize on a freshly loaded model, and a rerun
        t = time.perf_counter()
        model = CosyVoice3(str(model_dir))
        torch.cuda.synchronize()
        fresh_load = time.perf_counter() - t
        items = sorted([gdd.TextItem(**it) for it in cache], key=lambda it: len(it.text))[:16]
        texts = [np.asarray(model.frontend.extract_text_token(it.text), np.int32) for it in items]
        direct = model.model.batch_synthesize(texts, **gdd.dialect_prompt(model, "hunan", str(prompts)))
        same = 0
        for it, wav in zip(items, direct):
            write_wav(root / "direct.wav", wav, model.sample_rate)
            same += (root / "direct.wav").read_bytes() == Path(scp[it.utt_id]).read_bytes()
        _zero_launches()
        again = gdd.synthesize_batch_cuda([gdd.TextItem(**it) for it in cache], str(ds), str(model_dir), str(prompts),
                                          model=model)
        rerun = _launches()
        ok = same == len(items) and again["utts"] == 0 and not any(rerun.values())
        out["cli"].update(first_batch_bit_equal=same, fresh_load_s=fresh_load, rerun_launches=rerun)
        log(f"phase 14 (a) first batch against a direct batch_synthesize on a fresh load ({fresh_load:.2f} s): "
            f"{same}/{len(items)} wav files bit-equal; a rerun synthesized {again['utts']} utterances, launches "
            f"{rerun} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 14 (a): the CLI's batch differs from batch_synthesize, or a rerun launched")

        # (c) run_eval on the loaded model, an ASR stub that returns each target
        pairs = [{"utt": f"e{i}", "prompt_text": API_PROMPT_TEXT, "prompt_wav": str(model_dir / "prompt.wav"),
                  "target_text": t} for i, t in enumerate(DG_EVAL_TEXTS)]
        targets = iter(p["target_text"] for p in pairs)
        _zero_launches()
        with counted_lm_steps() as steps, kernel_shapes(results, "phase 14 (c) run_eval"):
            t = time.perf_counter()
            ev = evaluate.run_eval(str(model_dir), pairs, root / "eval", asr_fn=lambda wav, sr: next(targets),
                                   model=model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = _launches()
        _count(results, counts)
        want = {"decode_attention": nl * steps.value, "chunk_flash_attention": per_flow * len(pairs), "int4_matmul": 0}
        w16, _ = load_audio(root / "eval" / "e0.wav", target_sr=16000)
        self_ss = evaluate.speaker_similarity(model.frontend, w16, w16)
        ok = (counts == want and ev["n"] == len(pairs) and all(r["cer"] == 0.0 for r in ev["per_utt"])
              and all(-1.0 <= r["ss"] <= 1.0 for r in ev["per_utt"]) and abs(self_ss - 1.0) <= 1e-5)
        out["eval"] = dict(wall_s=wall, n=ev["n"], cer=ev["cer"], ss=[r["ss"] for r in ev["per_utt"]],
                           self_ss=self_ss, steps=steps.value, launches=counts)
        log(f"phase 14 (c) run_eval: {ev['n']} pairs in {wall:.2f} s, CER {[r['cer'] for r in ev['per_utt']]}, SS "
            f"{[round(r['ss'], 4) for r in ev['per_utt']]}, a wav against itself {self_ss:.7f}; {steps.value} decode "
            f"steps; launches {counts} (derived {want}) [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 14 (c): run_eval failed its checks")

        # (d) the token2wav server in this process against the in-process session
        rng = np.random.default_rng(15)
        tokens = rng.integers(0, cfg.llm.speech_token_size, DG_STREAM_TOKENS).astype(np.int32)
        emb = rng.standard_normal(192).astype(np.float32)
        no_prompt = (np.zeros(0, np.int32), np.zeros((0, 80), np.float32))
        pushes = lambda: (tokens[i : i + 32] for i in range(0, len(tokens), 32))
        _, windows = stream_plan(DG_STREAM_TOKENS, 0, cfg)
        httpd = token2wav_asr_server.serve(model.model, token2wav_asr_server.make_asr_fn("echo"), port=0,
                                           host="127.0.0.1")
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            _zero_launches()
            with kernel_shapes(results, "phase 14 (d) RemoteToken2Wav stream"):
                t = time.perf_counter()
                remote = list(disaggregated.RemoteToken2Wav(url).stream(pushes(), *no_prompt, emb))
                wall = time.perf_counter() - t
            counts = _launches()
            _count(results, counts)
        finally:
            httpd.shutdown()
            httpd.server_close()
        _zero_launches()
        with torch.inference_mode():
            sess = Token2WavSession(model.model, *no_prompt, emb)
            solo = [c for p in pushes() for c in sess.push(p)] + [sess.finish()]
        solo_counts = _launches()
        scale = max(float(np.abs(c).max()) for c in solo if len(c))
        diff = max(float(np.abs(a - b).max()) for a, b in zip(remote, solo) if len(b)) if len(remote) == len(
            solo) else float("inf")
        audio_s = sum(len(c) for c in remote) / 24000
        want = {"decode_attention": 0, "chunk_flash_attention": per_flow * windows, "int4_matmul": 0}
        ok = ([len(c) for c in remote] == [len(c) for c in solo] and diff <= BATCH_REL_TOL * scale
              and counts == want == solo_counts and windows > 0)
        out["server"] = dict(wall_s=wall, audio_s=audio_s, rtf=wall / audio_s, chunks=len(remote), max_diff=diff,
                             window_calls=windows, launches=counts)
        log(f"phase 14 (d) RemoteToken2Wav stream of {DG_STREAM_TOKENS} tokens through token2wav_asr_server on "
            f"127.0.0.1: {len(remote)} chunks, {audio_s:.2f} s audio in {wall:.2f} s (RTF {wall / audio_s:.4f}); "
            f"max |remote - in-process| {diff:.3e} (limit {BATCH_REL_TOL} x max|solo| {scale:.3f}); launches "
            f"{counts}, the in-process session's {solo_counts} (derived {want}: {windows} flow calls on the window) "
            f"[{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 14 (d): the remote token2wav stream failed its checks")
        del model
        torch.cuda.empty_cache()

        # (b) compare_inference with the directory's own LLM as the fine-tuned one
        _zero_launches()
        with counted_lm_steps() as steps, kernel_shapes(results, "phase 14 (b) compare_inference"):
            t = time.perf_counter()
            compare_inference.main(["--pretrained_dir", str(model_dir), "--finetuned_llm", str(model_dir / "llm.msgpack"),
                                    "--prompt_wav", str(model_dir / "prompt.wav"), "--output_dir", str(root / "cmp"),
                                    "--dialects", "hunan", "--num_texts", str(DG_COMPARE_TEXTS)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = _launches()
        _count(results, counts)
        want = {"decode_attention": nl * steps.value, "chunk_flash_attention": per_flow * 2 * DG_COMPARE_TEXTS,
                "int4_matmul": 0}
        pairs_equal = [(root / "cmp" / f"hunan_{i}_original.wav").read_bytes()
                       == (root / "cmp" / f"hunan_{i}_finetuned.wav").read_bytes()
                       for i in range(1, DG_COMPARE_TEXTS + 1)]
        ok = counts == want and all(pairs_equal)
        out["compare"] = dict(wall_s=wall, steps=steps.value, launches=counts, bit_equal=pairs_equal)
        log(f"phase 14 (b) compare_inference --dialects hunan --num_texts {DG_COMPARE_TEXTS} (the directory's own LLM as the "
            f"fine-tuned one): {wall:.2f} s with two model loads, {steps} decode steps; fine-tuned wavs bit-equal "
            f"to the originals {pairs_equal}; launches {counts} (derived {want}) [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 14 (b): compare_inference failed its checks")
    phase_s = time.perf_counter() - t_phase
    out["phase_s"] = phase_s
    results["datagen"] = out
    log(f"phase 14 took {phase_s:.1f} s (limit {DG_PHASE_LIMIT_S} s) [{card}]")
    if phase_s > DG_PHASE_LIMIT_S:
        raise AssertionError(f"phase 14 took {phase_s:.1f} s, over its limit of {DG_PHASE_LIMIT_S} s")


# ---------------------------------------------------------------- phase 15


def recipe_config():
    """Phase 15 (b)'s model: CosyVoice3's layout at widths the kernels take
    (heads of 64): a Qwen of 2 layers at hidden 128 with 2 query heads and 1
    KV head, a DiT of 2 blocks at dim 128 with 2 heads, a small HiFT; the
    real speech-token vocabulary (S3 emits codes in [0, 6561)) and the byte
    tokenizer's 300 text ids."""
    from fangyan_tts_torch import config as c

    qwen = c.QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
                        num_key_value_heads=1, head_dim=64, vocab_size=300)
    return c.CosyVoiceConfig(
        llm=c.LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=6561, extra_tokens=8, qwen=qwen),
        flow=c.FlowConfig(vocab_size=6561, dit=c.DiTConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2)),
        hift=c.HiFTConfig(base_channels=64, f0_cond_channels=32))


def export_spec(api: dict) -> dict:
    """Phase 15's kernel shapes: (a) the exported flow_solve of the full
    model, its CFG pair at 2 x EXPORT_TOKENS frames (cli.export's shapes),
    n_timesteps x depth launches a call; (b) the recipe's small model
    (recipe_config): stage 7's flow_solve at the same length with its own
    heads, and compare_inference's instruct request (request_specs, with the
    5 s prompt)."""
    import warnings

    from fangyan_tts_torch.cli.compare_inference import DIALECT_TEXTS
    from fangyan_tts_torch.cli.generate_dialect_dataset import INSTRUCT_BY_DIALECT
    from fangyan_tts_torch.infer.frontend import Frontend
    from fangyan_tts_torch.tokenizer import get_qwen_tokenizer

    cfg = recipe_config()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fe = Frontend(get_qwen_tokenizer(None, True, "cosyvoice3"), cfg, device="cpu")
    instruct = fe.extract_text_token(INSTRUCT_BY_DIALECT["hunan"])
    single = request_specs(cfg, fe, api["prompt_tokens"], [("compare " + t, t, instruct, [])
                                                            for t in DIALECT_TEXTS["hunan"][:1]])
    l = 2 * EXPORT_TOKENS
    q = cfg.llm.qwen
    return dict(export=dict(flash_l=l),
                recipe=dict(export_l=[l], flash_l=sorted({x for r in single for x in r["flash_l"]}), single=single,
                            heads=cfg.flow.dit.heads,
                            decode_dims=(q.num_hidden_layers, q.num_key_value_heads, q.num_attention_heads)))


# Runs `-m <module> [args]` with hook_kernels installed and, on exit, appends
# the module's kernel shapes, launches (both routes) and wall time to the
# JSON-lines file $SMOKE_RECORD: phase 15 hands it to the recipe as PY.
RECORDER = """import atexit, os, runpy, sys, time
sys.path.insert(0, os.environ["SMOKE_ROOT"])
import chip_smoke
seen = chip_smoke.hook_kernels()[0]
assert sys.argv[1] == "-m", sys.argv
module = sys.argv[2]
atexit.register(chip_smoke.append_record, os.environ["SMOKE_RECORD"], module, seen, time.perf_counter())
sys.argv = [module] + sys.argv[3:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def append_record(path: str, module: str, seen: dict, t0: float) -> None:
    """RECORDER's exit hook: one JSON line for one process."""
    rec = dict(module=module, wall_s=time.perf_counter() - t0, shapes={k: sorted(v) for k, v in seen.items()},
               launches=_launches(BF16_ROUTES + F32_ROUTES))
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec) + "\n")


def _read_records(path: Path) -> list[dict]:
    return [json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []


# A fresh process that imports torch, numpy and fangyan_tts_torch only: it
# loads the model eagerly, waits for a line on its stdin (the programs are
# written), loads the three programs cli.export wrote, runs them on the card
# in a chain (flow_prepare -> flow_solve -> vocoder) on inputs made from a
# seed, holds each to the eager call, counts the loaded flow_solve's kernel
# launches (set to 0 just before it); then, once a second line arrives,
# times loaded against eager with CUDA events, in turns, and prints one
# RESULT line.
LOADED_CHECK = """import json, sys, time
import numpy as np
import torch
from fangyan_tts_torch.api import CosyVoice3
from fangyan_tts_torch.cli.export import max_diff, programs
from fangyan_tts_torch.ops import device

export_dir, model_dir, nt = sys.argv[1], sys.argv[2], int(sys.argv[3])
torch.cuda.reset_peak_memory_stats()
model = CosyVoice3(model_dir, load_frontend_models=False)
eager = {n: m for n, m, _ in programs(model.model, nt)}
sys.stdin.readline()  # the parent's word that the three programs are written
t = time.perf_counter()
loaded = {n: torch.export.load(f"{export_dir}/{n}.pt2").module() for n in ("flow_prepare", "flow_solve", "vocoder")}
load_s = time.perf_counter() - t
cfg, dt, dev = model.model.cfg, model.model.dtype, model.model.device
g = torch.Generator(device=dev).manual_seed(15)
rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dt)
i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
token = torch.randint(0, cfg.flow.vocab_size, (1, nt), generator=g, device=dev, dtype=torch.int32)
out, errs, ms = {}, {}, {}
with torch.no_grad():
    args = {"flow_prepare": (token, i32(nt), rnd(1, 2 * nt, 80), i32(150), rnd(1, 192))}
    out["flow_prepare"] = loaded["flow_prepare"](*args["flow_prepare"])
    mu, spks, conds, mel_len = out["flow_prepare"]  # flow_solve takes mu, spks and conds in the model dtype
    args["flow_solve"] = (rnd(1, 2 * nt, 80), mu.to(dt), spks.to(dt), conds.to(dt), mel_len)
    device.launches.clear()
    out["flow_solve"] = loaded["flow_solve"](*args["flow_solve"])
    torch.cuda.synchronize()
    launches = dict(bf16=device.launches["chunk_flash_attention"], f32=device.launches["chunk_flash_attention_f32"])
    args["vocoder"] = (out["flow_solve"],)
    out["vocoder"] = loaded["vocoder"](*args["vocoder"])
    for n in loaded:
        errs[n] = max_diff(out[n], eager[n](*args[n]))
    torch.cuda.synchronize()
    sys.stdin.readline()  # the parent's go: the card is no longer shared with its other work
    for n in loaded:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        times = {"eager": [], "loaded": []}
        for which in ("eager", "loaded", "loaded", "eager"):
            ev[0].record()
            (eager if which == "eager" else loaded)[n](*args[n])
            ev[1].record()
            torch.cuda.synchronize()
            times[which].append(ev[0].elapsed_time(ev[1]))
        ms[n] = {k: float(np.mean(v)) for k, v in times.items()}
finite = all(bool(torch.isfinite(o.float()).all()) for o in (*out["flow_prepare"][:3], out["flow_solve"], out["vocoder"]))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "fangyan_tts_tpu")]
print("RESULT " + json.dumps(dict(load_s=load_s, errs=errs, ms=ms, launches=launches, finite=finite, bad_modules=bad,
                                  mel_len=int(mel_len[0]), wav_samples=int(out["vocoder"].shape[-1]),
                                  per_call=cfg.flow.n_timesteps * cfg.flow.dit.depth,
                                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)), flush=True)
"""


def subsampling_check(card: str) -> dict:
    """Phase 15 (c): each subsampling module (models/subsampling.py) at the
    wenet encoder's width (80 mel bins in, 256 out; a 300-frame batch of 2),
    float32 on the card against the CPU on the same weights and inputs
    (TF32 off), within SUB_REL_TOL of the CPU output's max |.|."""
    import torch

    from fangyan_tts_torch.models import subsampling as sub

    gen = torch.Generator().manual_seed(15)
    x = torch.randn((2, 300, 80), generator=gen)
    mask = torch.ones((2, 1, 300), dtype=torch.bool)
    mask[1, :, 250:] = False
    ids = torch.randint(0, 6561, (2, 300), generator=gen)
    out = {}
    for name, kind in (("Conv2dSubsampling4", "abs"), ("Conv2dSubsampling6", "rel"), ("Conv2dSubsampling8", "abs"),
                       ("Conv1dSubsampling2", "whisper"), ("EmbeddingNoSubsampling", "learnable")):
        m = getattr(sub, name)(6561 if name.startswith("Embedding") else 80, 256, kind).eval()
        with torch.no_grad():
            for t in m.parameters():
                t.copy_(torch.randn(t.shape, generator=gen) / math.sqrt(max(math.prod(t.shape[1:]), 1)))
            inp = ids if name.startswith("Embedding") else x
            want = m(inp, mask, 2)
            got = m.cuda()(inp.cuda(), mask.cuda(), 2)
        torch.cuda.synchronize()
        errs = [_rel(g.detach().float().cpu().numpy(), w.detach().float().numpy()) for g, w in zip(got[:2], want[:2])]
        same_mask = torch.equal(got[2].cpu(), want[2])
        ok = max(errs) <= SUB_REL_TOL and same_mask and got[0].shape == want[0].shape
        out[name] = dict(kind=kind, shape=list(got[0].shape), rel_err=max(errs), mask_equal=same_mask)
        log(f"phase 15 (c) {name} ({kind}) float32 card against CPU: out {tuple(got[0].shape)}, max |diff| / max |cpu| "
            f"{max(errs):.2e} (limit {SUB_REL_TOL:.0e}), masks equal {same_mask} [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 15 (c): {name} on the card differs from the CPU")
    return out


def recipe_run(results: dict, card: str, states: tuple[dict, dict], ex: dict, build: Path) -> dict:
    """Phase 15 (b): `bash fangyan_tts_torch/recipes/dialect/run.sh 0 7` with
    DEVICE=cuda on a RECIPE_UTTS-utterance corpus written here (speech-like
    audio, two speakers, the hunan instruct) and a PRETRAIN_DIR of the small
    recipe_config model (random weights) with phase 11's full-size CAM++ and
    S3 states, MAX_EPOCH RECIPE_EPOCHS; each stage a process under RECORDER
    (its shapes held to phase 3's checks, its launches counted: none, as
    stage 7 exports without --check, as the JAX recipe does, and tracing
    launches nothing); each stage's artifacts checked; stage 7's flow_solve
    loaded and run on the card (n_timesteps x depth flash launches); then
    `cli.compare_inference` in this process on the chain's fine-tuned LLM,
    launches held to the layers x decode steps and n_timesteps x depth a
    flow call."""
    import tempfile

    import torch

    from fangyan_tts_torch.cli import compare_inference
    from fangyan_tts_torch.data import kaldi_io
    from fangyan_tts_torch.data.audio import write_wav
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS
    from fangyan_tts_torch.train.checkpoint import load_params

    cfg = recipe_config()
    per_flow, nl = cfg.flow.n_timesteps * cfg.flow.dit.depth, cfg.llm.qwen.num_hidden_layers
    small = CosyVoice3TTS.random_init(cfg, dtype=torch.float32, seed=15)
    root_dir = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=build, prefix="recipe_") as tmp, api_model_dir(small, states) as pretrain:
        root = Path(tmp)
        data_dir = root / "dataset" / "combined"
        (data_dir / "wavs").mkdir(parents=True)
        wav_scp, text, utt2spk, instruct = {}, {}, {}, {}
        for i in range(RECIPE_UTTS):
            utt = f"u{i:03d}"
            write_wav(data_dir / "wavs" / f"{utt}.wav", prompt_audio(1.5 + 0.1 * i, 24000, seed=150 + i), 24000)
            wav_scp[utt], text[utt], utt2spk[utt] = str(data_dir / "wavs" / f"{utt}.wav"), f"今天天气真不错第{i}句。", f"s{i % 2}"
            instruct[utt] = "请用湖南话说。<|endofprompt|>"
        kaldi_io.write_kaldi_dir(data_dir, wav_scp, text, utt2spk, instruct)
        (root / "recorder.py").write_text(RECORDER)
        record = root / "record.jsonl"
        exp_dir = root / "exp" / "llm"
        env = dict(os.environ, DATA_DIR=str(data_dir), EXP_DIR=str(exp_dir), PRETRAIN_DIR=str(pretrain),
                   CONFIG=str(pretrain / "config.json"), MAX_EPOCH=str(RECIPE_EPOCHS), MAX_FRAMES="400",
                   NUM_UTTS_PER_PARQUET="5", DEVICE="cuda", PY=f"{sys.executable} {root / 'recorder.py'}",
                   SMOKE_ROOT=str(root_dir), SMOKE_RECORD=str(record))
        t = time.perf_counter()
        r = subprocess.run(["bash", "fangyan_tts_torch/recipes/dialect/run.sh", "0", "7"], cwd=root_dir, env=env,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        recs = _read_records(record)
        for rec in recs:
            log(f"phase 15 (b) stage {rec['module']}: {rec['wall_s']:.2f} s in its process, launches "
                f"{ {k: v for k, v in rec['launches'].items() if v} }")
        if r.returncode != 0:
            log(r.stdout[-3000:] + "\n" + r.stderr[-3000:])
            raise AssertionError(f"phase 15 (b): the dialect recipe exited {r.returncode}")
        for rec in recs:
            hold_shapes(results, f"phase 15 (b) stage {rec['module']}", rec["shapes"])
        export_launches = {k: v for rec in recs if rec["module"].endswith(".export") for k, v in rec["launches"].items()}
        other = sum(v for rec in recs if not rec["module"].endswith(".export") for v in rec["launches"].values())
        # the artifacts of each stage (tests/test_torch_recipe_chain.py checks the same on the CPU)
        utt2emb = torch.load(data_dir / "utt2embedding.pt", weights_only=False)
        utt2tok = torch.load(data_dir / "utt2speech_token.pt", weights_only=False)
        toks = np.concatenate([np.asarray(v).ravel() for v in utt2tok.values()])
        shards = (data_dir / "parquet" / "data.list").read_text().splitlines()
        cv = (data_dir / "parquet" / "cv.data.list").read_text().splitlines()
        ckpts = sorted(exp_dir.glob("epoch_*_whole.msgpack"))
        cv_loss = [json.loads(Path(str(c) + ".json").read_text())["cv_loss"] for c in ckpts]
        avg = load_params(exp_dir / "llm.msgpack")
        exported = sorted(p.name for p in (exp_dir / "export").iterdir())
        art = dict(utts=len(utt2emb), emb_dim=int(np.asarray(next(iter(utt2emb.values()))).shape[0]),
                   token_range=[int(toks.min()), int(toks.max())], shards=len(shards), cv_shards=len(cv),
                   checkpoints=len(ckpts), cv_loss=cv_loss, exported=exported)
        ok = (len(recs) == 7 and art["utts"] == RECIPE_UTTS and art["emb_dim"] == 192 and 0 <= toks.min()
              and toks.max() < 6561 and len(utt2tok) == RECIPE_UTTS and len(shards) == 3 and len(cv) == 1
              and len(ckpts) == RECIPE_EPOCHS and all(np.isfinite(cv_loss))
              and tuple(np.asarray(avg["llm_decoder"]["kernel"]).shape) == (128, 6561 + 8)
              and {"flow_prepare.pt2", "flow_solve.pt2", "vocoder.pt2", "llm.msgpack", "flow.msgpack",
                   "hift.msgpack"} <= set(exported)
              and sum(export_launches.values()) == 0 and other == 0)
        # stage 7 only traces (fake tensors: no launch); its flow_solve, loaded here, runs on the card
        nt = EXPORT_TOKENS
        gen = torch.Generator(device="cuda").manual_seed(16)
        bf = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)  # the CLI loads bf16
        solve = torch.export.load(exp_dir / "export" / "flow_solve.pt2").module()
        _zero_launches()
        with torch.no_grad():
            mel = solve(bf(1, 2 * nt, 80), bf(1, 2 * nt, 80), bf(1, 80), bf(1, 2 * nt, 80),
                        torch.tensor([2 * nt - 6], dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        loaded = _launches()
        _count(results, loaded)
        ok = ok and loaded == {"decode_attention": 0, "chunk_flash_attention": per_flow, "int4_matmul": 0} and bool(
            torch.isfinite(mel.float()).all()) and tuple(mel.shape) == (1, 2 * nt, 80)
        log(f"phase 15 (b) dialect recipe stages 0-7 (DEVICE=cuda): {wall:.2f} s, {len(recs)} stage processes; "
            f"artifacts {art}; launches of stage 7 {export_launches} (none: it traces), of the others {other}; "
            f"stage 7's flow_solve loaded here and run on the card: launches {loaded} (derived flash {per_flow} at "
            f"(2, {cfg.flow.dit.heads}, {2 * nt}, 64)) [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 15 (b): the dialect recipe failed its checks")

        _zero_launches()
        with counted_lm_steps() as steps, kernel_shapes(results, "phase 15 (b) compare_inference"):
            t = time.perf_counter()
            compare_inference.main(["--pretrained_dir", str(pretrain), "--finetuned_llm", str(exp_dir / "llm.msgpack"),
                                    "--prompt_wav", str(pretrain / "prompt.wav"), "--output_dir", str(root / "cmp"),
                                    "--dialects", "hunan", "--num_texts", "1", "--device", "cuda"])
            torch.cuda.synchronize()
            cmp_wall = time.perf_counter() - t
        counts = _launches()
        _count(results, counts)
        want = {"decode_attention": nl * steps.value, "chunk_flash_attention": 2 * per_flow, "int4_matmul": 0}
        wavs = [root / "cmp" / f"hunan_1_{k}.wav" for k in ("original", "finetuned")]
        ok = counts == want and steps.value > 0 and all(w.exists() and w.stat().st_size > 44 for w in wavs)
        log(f"phase 15 (b) compare_inference on the recipe's fine-tuned LLM: {cmp_wall:.2f} s with two loads, "
            f"{steps} decode steps; launches {counts} (derived {want}) [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 15 (b): compare_inference on the recipe's outputs failed its checks")
    return dict(wall_s=wall, stages={rec["module"]: rec["wall_s"] for rec in recs}, artifacts=art,
                export_launches=export_launches, compare=dict(wall_s=cmp_wall, steps=steps.value, launches=counts))


def export_phase(results: dict, card: str, model_dir, states: tuple[dict, dict], ex: dict) -> None:
    """Phase 15: (a) `python -m fangyan_tts_torch.cli.export --check` on the
    full-width model directory (under RECORDER: its shapes and launches),
    and LOADED_CHECK in a fresh process, which loads the programs once the
    CLI has written them (against eager, bit-equal expected, limit the
    CLI's 1e-3; the loaded flow_solve's flash launches n_timesteps x depth
    on the bf16 route; peak memory; device times once the card is its
    alone). Both run beside (c) subsampling_check and (b) recipe_run, which
    leave them the host's other cores. Every process it starts has ended
    when it returns."""
    import tempfile
    import threading

    import torch

    from fangyan_tts_torch.cli.export import CHECK_ATOL
    from fangyan_tts_torch.config import config_from_dict

    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent
    build = here / "build"
    build.mkdir(exist_ok=True)
    cfg = config_from_dict(json.loads((model_dir / "config.json").read_text()))  # the directory's model
    per_call = cfg.flow.n_timesteps * cfg.flow.dit.depth
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=build, prefix="export_") as tmp:
        root = Path(tmp)
        (root / "recorder.py").write_text(RECORDER)
        env = dict(os.environ, SMOKE_ROOT=str(here), SMOKE_RECORD=str(root / "record.jsonl"))
        cli_log, fresh_log = root / "export.log", root / "fresh.log"
        procs: dict = {}
        t = time.perf_counter()
        with open(cli_log, "w", encoding="utf-8") as f, open(fresh_log, "w", encoding="utf-8") as g:
            procs["cli"] = subprocess.Popen(
                [sys.executable, str(root / "recorder.py"), "-m", "fangyan_tts_torch.cli.export", "--model_dir",
                 str(model_dir), "--output_dir", str(root / "out"), "--check", "--n_tokens", str(EXPORT_TOKENS)],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=here)
            procs["fresh"] = subprocess.Popen(
                [sys.executable, "-c", LOADED_CHECK, str(root / "out"), str(model_dir), str(EXPORT_TOKENS)],
                stdin=subprocess.PIPE, stdout=g, stderr=subprocess.STDOUT, text=True, cwd=here)

        def written():  # tell the fresh process once the CLI has written the three programs (before its check)
            while procs["cli"].poll() is None and "exported vocoder" not in cli_log.read_text():
                time.sleep(1.0)
            if "exported vocoder" in cli_log.read_text():
                try:
                    procs["fresh"].stdin.write("written\n")
                    procs["fresh"].stdin.flush()
                    procs["written_s"] = time.perf_counter() - t
                except BrokenPipeError:  # it has ended already: its log says why
                    pass

        watcher = threading.Thread(target=written, daemon=True)
        watcher.start()
        try:
            out["subsampling"] = subsampling_check(card)
            out["recipe"] = recipe_run(results, card, states, ex, build)
            torch.cuda.empty_cache()
            rc = procs["cli"].wait(timeout=900)
            cli_s = time.perf_counter() - t
            watcher.join()
            text = cli_log.read_text()
            log(f"phase 15 (a) cli.export --check output:\n{text[-3000:]}", stamp=False)
            progs = {m.group(1): dict(mb=float(m.group(2)), export_s=float(m.group(3))) for m in re.finditer(
                r"exported (\w+) -> \S+ \(([\d.]+) MB\) in ([\d.]+) s", text)}
            checks = [float(x) for x in re.findall(r"parity check OK \(max \|diff\| ([^)]+)\)", text)]
            recs = _read_records(root / "record.jsonl")
            cli_launches = recs[0]["launches"] if recs else {}
            ok = (rc == 0 and len(recs) == 1 and set(progs) == {"flow_prepare", "flow_solve", "vocoder"}
                  and len(checks) == 3 and max(checks) <= CHECK_ATOL and "written_s" in procs
                  and cli_launches.get("chunk_flash_attention") == 2 * per_call
                  and sum(cli_launches.values()) == 2 * per_call)
            log(f"phase 15 (a) cli.export --check --n_tokens {EXPORT_TOKENS} on the full-width model directory: "
                f"{cli_s:.1f} s in its process (beside (c) and (b)); programs {progs}; --check max |diff| {checks}; "
                f"its launches {cli_launches} (derived flash {2 * per_call}: the eager call and the loaded program) "
                f"[{card}] {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("phase 15 (a): cli.export failed its checks")
            hold_shapes(results, "phase 15 (a) cli.export", recs[0]["shapes"])
            _count(results, {k: cli_launches.get(k, 0) for k in _launches()})

            fresh = procs["fresh"]
            try:
                fresh.stdin.write("go\n")
                fresh.stdin.close()
            except BrokenPipeError:  # it has ended already: its log says why
                pass
            rc = fresh.wait(timeout=900)
            fresh_s = time.perf_counter() - t
        finally:
            for name in ("cli", "fresh"):
                if name == "fresh":
                    watcher.join()
                if procs[name].poll() is None:
                    procs[name].kill()
                    procs[name].wait()
        text = fresh_log.read_text()
        line = next((x for x in text.splitlines() if x.startswith("RESULT ")), None)
        if rc != 0 or line is None:
            log(text[-3000:])
            raise AssertionError(f"phase 15 (a): the fresh process exited {rc}")
        res = json.loads(line[len("RESULT "):])
        ok = (res["finite"] and not res["bad_modules"] and max(res["errs"].values()) <= CHECK_ATOL
              and res["launches"] == {"bf16": per_call, "f32": 0} and res["per_call"] == per_call
              and res["mel_len"] == 2 * EXPORT_TOKENS and res["wav_samples"] == 2 * EXPORT_TOKENS * 480)
        log(f"phase 15 (a) the three programs loaded in a fresh process (torch, numpy, fangyan_tts_torch only) once "
            f"the CLI had written them ({procs['written_s']:.1f} s into the phase): load {res['load_s']:.1f} s, the "
            f"process {fresh_s:.1f} s; max |loaded - "
            f"eager| {res['errs']} (limit {CHECK_ATOL}); the loaded flow_solve launched the flash kernel "
            f"{res['launches']} (derived {per_call} bf16 at (2, {cfg.flow.dit.heads}, {2 * EXPORT_TOKENS}, 64)); ms a "
            f"call, CUDA events, with the card to itself, eager / loaded: "
            + ", ".join(f"{n} {v['eager']:.3f} / {v['loaded']:.3f}" for n, v in res["ms"].items())
            + f"; peak {res['peak_gib']:.2f} GiB [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("phase 15 (a): the loaded programs failed their checks")
        _count(results, {"chunk_flash_attention": res["launches"]["bf16"]})
        out["export"] = dict(cli_s=cli_s, programs=progs, check_errs=checks, cli_launches=cli_launches,
                             fresh_s=fresh_s, **res)
    out["phase_s"] = time.perf_counter() - t_phase
    results["export"] = out
    log(f"phase 15 took {out['phase_s']:.1f} s [{card}]")


# ---------------------------------------------------------------- phase 16


def mp_spec() -> dict:
    """Phase 16's kernel shapes, fixed before any model runs: the TP=2
    decode of the 150-token request (CosyVoice3TTS.generate_tokens's
    buckets: B = 1, its cache, KV and query heads halved, its last write
    slot and first valid slot; with the int4 MLP each rank's gate_up_proj
    columns and down_proj rows halved, at the prefill's M (the prompt
    bucket) and the steps' M = 1) and the sharded flow's window hop (the
    CFG pair at (P + MP_WINDOW) x 2 frames, P = 0, heads halved)."""
    from fangyan_tts_torch.data.lm_plan import build_prompt_plan

    cfg = full_config()
    up = lambda n, m: -(-n // m) * m
    plan = build_prompt_plan(cfg.llm, list(range(1, MP_TEXT_TOKENS + 1)), [])
    tp = up(len(plan.ids), 64)
    max_len = int(MP_TEXT_TOKENS * MP_RATIO)
    cache_len = up(tp + max(up(max_len, 64), 64), 128)
    q = cfg.llm.qwen
    hidden = q.intermediate_size // MP_RANKS
    return dict(cache_len=cache_len, last=tp + max_len - 1, start=tp - len(plan.ids), max_len=max_len,
                kv=q.num_key_value_heads // MP_RANKS, qh=q.num_attention_heads // MP_RANKS,
                int4=[("gate_up_proj", q.hidden_size, 2 * hidden), ("down_proj", hidden, q.hidden_size)],
                int4_m={1, tp},
                flash_l=MP_WINDOW * cfg.token_mel_ratio, heads=cfg.flow.dit.heads // MP_RANKS)


def _mp_decode(tts, text: np.ndarray, force: np.ndarray | None = None) -> dict:
    """Greedy generate_tokens of the 150-token request, with every logits
    row the model gave (the prefill's, then each decode step's). `force`:
    teacher forcing, the sampler's pick at row i made force[i] (the row is
    recorded as the model gave it). Every step runs eagerly, as the TP
    decode's do: a step replayed from a CUDA graph runs no Python, so this
    hook would see none of its rows."""
    import torch

    from fangyan_tts_torch.models import decode_graphs

    rows = []
    inner = tts.llm.decode_logits

    def logits(h):
        out = inner(h)
        rows.append(out.float())
        if force is not None:
            out = out.clone()
            out[:, int(force[len(rows) - 1])] = out.max() + 1e3
        return out

    tts.llm.decode_logits = logits
    eligible = decode_graphs.eligible
    decode_graphs.eligible = lambda model, device: False
    try:
        tokens = tts.generate_tokens(text, min_token_text_ratio=MP_RATIO, max_token_text_ratio=MP_RATIO)
    finally:
        del tts.llm.decode_logits
        decode_graphs.eligible = eligible
    torch.cuda.synchronize()
    return {"tokens": tokens, "logits": torch.cat(rows).cpu().numpy()}


def mp_rank(rank: int, world: int) -> dict:
    """One of phase 16's two processes on card 0 (gloo): (a) the 150-token
    request's greedy decode through a TP=2 LM, float32 weights (decode in
    the bf16 cache), free and then teacher-forced on process 0's
    one-process picks; (a') the same request teacher-forced through a TP=2
    LM with request (b)'s int8 LLM and int4 MLP, bf16; (b) two streaming
    hops of a TP=2 sharded token2wav, bf16, (c) a dp=2 LM train step on one
    global batch; process 0 also runs each one unsharded first. Returns its
    results, its kernel shapes and its launches (counts set to 0 before
    each sharded run)."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from fangyan_tts_torch.infer.stream import FlowStream
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS
    from fangyan_tts_torch.models.llm import CosyVoice3LM
    from fangyan_tts_torch.ops.device import exact_fp32
    from fangyan_tts_torch.parallel import make_mesh, shard_module
    from fangyan_tts_torch.train import trainer
    from fangyan_tts_torch.train.scheduler import build_optimizer

    torch.cuda.set_device(0)
    exact_fp32()
    base = full_config()
    cfg = replace(base, llm=replace(base.llm, top_k=1, tau_r=1.1))  # greedy: the nucleus is the argmax
    n_speech = cfg.llm.speech_token_size
    out: dict = {"times": {}, "launches": {}, "seen": {}, "steps": {}}
    text = np.random.default_rng(0).integers(0, 50000, MP_TEXT_TOKENS).astype(np.int32)
    tp_mesh = make_mesh(tp=MP_RANKS, device="cuda", backend="gloo")

    def sharded(label: str, fn):
        """fn() with the counts set to 0 before and read after, its kernel shapes recorded, timed."""
        _zero_launches()
        seen, restore = hook_kernels()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            restore()
        out["times"][label] = time.perf_counter() - t
        out["launches"][label] = _launches(BF16_ROUTES + F32_ROUTES)
        out["seen"][label] = {k: sorted(v) for k, v in seen.items()}
        return res

    def one_process(key: str, tts) -> np.ndarray:
        """Process 0's unsharded decode (kept under `key`); its greedy picks on every process: the argmax over
        the speech tokens of each row (stop ids are masked until min_len = max_len)."""
        picks = [None]
        if rank == 0:
            t = time.perf_counter()
            out[key] = _mp_decode(tts, text)
            out["times"][f"{key} one process"] = time.perf_counter() - t
            picks = [out[key]["logits"][:, :n_speech].argmax(-1)]
        dist.broadcast_object_list(picks, src=0)
        return picks[0]

    def decode(label: str, tts, force=None) -> dict:
        steps = counted_steps(tts)
        res = sharded(label, lambda: _mp_decode(tts, text, force))
        out["steps"][label] = steps.value
        return res

    # (a) TP=2 decode, float32 weights: free, then teacher-forced
    t = time.perf_counter()
    tts = CosyVoice3TTS.random_init(cfg, dtype=torch.float32, seed=MP_SEED)
    out["times"]["init float32"] = time.perf_counter() - t
    picks = one_process("decode_ref", tts)
    shard_module(tts.llm, tp_mesh)
    out["decode"] = decode("decode", tts)
    out["forced"] = decode("decode forced", tts, picks)
    del tts

    # (a') TP=2 decode with the int4 MLP (int8 LLM, bf16), teacher-forced; then
    # (b) TP=2 shard_token2wav on the same model, bf16, two hops (hop 2 a window hop: the flash kernel)
    tts = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16, seed=MP_SEED)
    tts.quantize_llm(int4_mlp=True)
    picks = one_process("int4_ref", tts)
    shard_module(tts.llm, tp_mesh)
    out["int4"] = decode("int4 forced", tts, picks)
    tts.stream_window_tokens = MP_WINDOW
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 6561, MP_STREAM_TOKENS).astype(np.int32)
    emb = rng.standard_normal(192).astype(np.float32)

    def hops():
        fs = FlowStream(tts, np.zeros(0, np.int32), np.zeros((0, 80), np.float32), emb, prompt_pad=0)
        return [fs.step(tokens).float().cpu().numpy() for _ in range(2)]

    if rank == 0:
        t = time.perf_counter()
        out["hops_ref"] = hops()
        out["times"]["hops one process"] = time.perf_counter() - t
    tts.shard_token2wav(tp_mesh)
    out["hops"] = sharded("hops", hops)
    del tts
    torch.cuda.empty_cache()

    # (c) dp=2 LM train step on one global batch (bf16 compute, float32 parameters and Adam, remat "full")
    dp_mesh = make_mesh(dp=MP_RANKS, device="cuda", backend="gloo")
    lcfg = replace(cfg.llm, qwen=replace(cfg.llm.qwen, remat="full"))
    batch = {k: v[0] for k, v in llm_train_batch(np.random.default_rng(16), lcfg, MP_TRAIN_B, MP_TRAIN_T, 1).items()}

    def step(mesh):
        model = trainer.random_module(lambda: CosyVoice3LM(lcfg, dtype=torch.bfloat16), MP_SEED, "cuda")
        tx = build_optimizer(lr=1e-4)
        state = trainer.init_state(model, tx)
        if mesh is not None:
            state = trainer.shard_state(state, mesh, tx)
        _, m = trainer.make_llm_train_step(model, tx, mesh)(state, batch)
        return {k: float(v) for k, v in m.items()}

    if rank == 0:
        t = time.perf_counter()
        out["train_ref"] = step(None)
        out["times"]["train step one process"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    out["train"] = sharded("train", lambda: step(dp_mesh))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def mp_phase(results: dict, card: str, mp: dict) -> None:
    """Phase 16: two processes on card 0 over gloo (parallel/launch.spawn)
    run the tensor- and data-parallel paths at full_config's widths
    (mp_rank); every sharded run's launches and kernel shapes are held
    here, the shapes to phase 3's checks."""
    from fangyan_tts_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    res = spawn(mp_rank, MP_RANKS, backend="gloo", timeout=3 * MP_PHASE_LIMIT_S, threads=2)
    cfg = full_config()
    layers = cfg.llm.qwen.num_hidden_layers
    ref = res[0]
    kernels = ("decode_attention", "chunk_flash_attention", "int4_matmul")
    for r, got in enumerate(res):
        for label, seen in got["seen"].items():
            hold_shapes(results, f"phase 16 rank {r} {label}", seen)
        cnt, steps = got["launches"], got["steps"]
        # a decode: one decode launch a layer and step, with the int4 MLP two int4 launches a layer and forward
        # (the prefill's and each step's); the hops: one window hop's flow call; no float32 route, none in training
        ok_launch = (all(cnt[lab]["decode_attention"] == layers * steps[lab] > 0 for lab in steps)
                     and cnt["int4 forced"]["int4_matmul"] == 2 * layers * (steps["int4 forced"] + 1)
                     and cnt["decode"]["int4_matmul"] == cnt["decode forced"]["int4_matmul"] == 0
                     and cnt["hops"]["chunk_flash_attention"] == cfg.flow.dit.depth * cfg.flow.n_timesteps
                     and not any(cnt["train"][k] for k in kernels)
                     and not any(c for lab in cnt.values() for k, c in lab.items() if k.endswith("_f32")))
        _count(results, {k: sum(cnt[lab][k] for lab in ("decode", "decode forced", "int4 forced", "hops"))
                         for k in kernels})
        # (a) the free greedy picks equal the one process's, or part at a near-tie (both margins printed)
        want, have = ref["decode_ref"], got["decode"]
        v = cfg.llm.speech_token_size
        pick_w, pick_h = (x["logits"][:-1, :v].argmax(-1) for x in (want, have))
        n = min(len(pick_w), len(pick_h))
        n_same = next((i for i in range(n) if pick_w[i] != pick_h[i]), n)
        equal = n_same == len(pick_w) == len(pick_h) and np.array_equal(want["tokens"], have["tokens"])
        top2 = lambda row: float(np.diff(np.sort(row[:v])[-2:])[0])
        tie, near_tie = "", False
        if n_same < n:
            mw, mh = top2(want["logits"][n_same]), top2(have["logits"][n_same])
            tie = f"; step {n_same} differs: margins {mw:.4f} one process / {mh:.4f} TP (near-tie limit {GREEDY_TIE})"
            near_tie = min(mw, mh) <= GREEDY_TIE
        # (a), (a') teacher-forced on the one process's picks: the same tokens, and every logits row (the
        # prefill's and each step's, the same inputs) within the limit
        forced = {}
        for key, label, ref_key in (("forced", "float32", "decode_ref"), ("int4", "int8 + int4 MLP", "int4_ref")):
            w, h = ref[ref_key], got[key]
            same = w["logits"].shape == h["logits"].shape and np.array_equal(w["tokens"], h["tokens"])
            rel = _rel(h["logits"], w["logits"]) if same else float("inf")
            forced[label] = dict(rows=len(h["logits"]), tokens_equal=same, logits_rel=rel)
        mrel = max(_rel(a, b) for a, b in zip(got["hops"], ref["hops_ref"]))
        train_rel = {m: abs(got["train"][m] - ref["train_ref"][m]) / abs(ref["train_ref"][m]) for m in ("loss", "grad_norm")}
        ok = (ok_launch and (equal or near_tie) and mrel <= MP_MEL_TOL
              and all(f["tokens_equal"] and f["logits_rel"] <= MP_LOGIT_TOL for f in forced.values())
              and max(train_rel.values()) <= SMALL_REL_TOL
              and all(np.isfinite(h).all() for h in got["hops"]))
        log(f"phase 16 rank {r}: (a) TP=2 greedy decode {len(have['tokens'])} tokens in {steps['decode']} steps, "
            f"equal to one process={equal} (first {n_same} equal{tie}); teacher-forced on the one process's picks "
            + "; ".join(f"{label}: {f['rows']} logits rows rel {f['logits_rel']:.3e}, tokens equal {f['tokens_equal']}"
                        for label, f in forced.items())
            + f" (limit {MP_LOGIT_TOL}); (b) shard_token2wav 2 hops bf16 mel rel {mrel:.3e} (limit {MP_MEL_TOL}); "
            f"(c) dp=2 train step loss {got['train']['loss']:.6f} / {ref['train_ref']['loss']:.6f}, grad_norm "
            f"{got['train']['grad_norm']:.6f} / {ref['train_ref']['grad_norm']:.6f} (rel {train_rel['loss']:.2e}, "
            f"{train_rel['grad_norm']:.2e}, limit {SMALL_REL_TOL}); launches {cnt}; peak {got['peak_gib']:.2f} GiB "
            f"[{card}] {'OK' if ok else 'FAIL'}")
        results.setdefault("mp", {})[f"rank {r}"] = dict(
            tokens=len(have["tokens"]), equal=equal, first_equal=n_same, forced=forced, mel_rel=mrel,
            train=got["train"], train_rel=train_rel, launches=cnt, times=got["times"], peak_gib=got["peak_gib"])
        if not ok:
            raise AssertionError(f"phase 16 rank {r} failed its checks")
    took = time.perf_counter() - t0
    log(f"phase 16 times (rank 0, s): {json.dumps({k: round(v, 3) for k, v in ref['times'].items()})}; rank 1: "
        f"{json.dumps({k: round(v, 3) for k, v in res[1]['times'].items()})}. Two processes share one card and gloo "
        f"goes through the host: these times do not measure multi-GPU speed [{card}]")
    log(f"phase 16 took {took:.1f} s (limit {MP_PHASE_LIMIT_S} s) [{card}]")
    results["mp"]["phase_s"] = took
    if took > MP_PHASE_LIMIT_S:
        raise AssertionError(f"phase 16 took {took:.1f} s, over its limit of {MP_PHASE_LIMIT_S} s")


def moon_config(seed: int = 0):
    """CosyVoice3 with the MLA-MoE speech LM at Moonlight-16B-A3B's sizes
    (MLAMoEConfig's defaults), greedy, and full_config's flow and vocoder."""
    from dataclasses import replace

    from fangyan_tts_torch.config import MLAMoEConfig

    cfg = full_config()
    llm = replace(cfg.llm, llm_input_size=2048, llm_output_size=2048, top_k=1, tau_r=1.1, qwen=MLAMoEConfig())
    return replace(cfg, llm=llm)


def graph_ms(fn, reps: int = MOON_REPS) -> float:
    """Device ms of one call of fn, from a CUDA graph of `reps` calls
    (captured after one eager call on the capture stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def moon_kernels(results: dict, model) -> None:
    """Phase 17 (a): the expert and MLA decode kernels at the datagen cell's shapes."""
    import torch

    from fangyan_tts_torch.ops import mla_decode as mla
    from fangyan_tts_torch.ops import moe

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    layer = model.llm.layers[1].mlp
    out = []
    for n in (16, 1536):  # a decode call, a 1.5 k-row prefill
        x = (torch.randn(n, 2048, device=dev, generator=g) * 0.5).bfloat16()
        with torch.inference_mode():
            chosen, w = layer.route(x)
            got = moe.moe_experts(x, chosen, w, layer.experts.gate_up, layer.experts.down)
            want = moe.moe_experts_plain(x, chosen, w, layer.experts.gate_up, layer.experts.down)
            err = float((got.float() - want.float()).norm() / want.float().norm())
            ms = graph_ms(lambda: moe.moe_experts(x, chosen, w, layer.experts.gate_up, layer.experts.down))
            plain_ms = eager_ms(lambda: moe.moe_experts_plain(x, chosen, w, layer.experts.gate_up, layer.experts.down),
                                iters=3)
        active = int((torch.bincount(chosen.flatten(), minlength=64) > 0).sum())
        nbytes = active * 3 * 2048 * 1408 * 2 + n * 6 * 2048 * 4
        bound = max(nbytes / HBM_BYTES_PER_S, n * 6 * 2 * 3 * 2048 * 1408 / BF16_FLOP_PER_S) * 1e3
        out.append(dict(kernel="moe_experts", rows=n, active=active, rel_err=err, ms=ms, bound_ms=bound,
                        roofline_pct=100 * bound / ms, plain_ms=plain_ms))
        if err > MOON_KERNEL_TOL:
            raise AssertionError(f"moe_experts at {n} rows: rel err {err:.3g} over {MOON_KERNEL_TOL}")
    scale = 192 ** -0.5
    for s in (128, 256, 512):
        b = 16
        cache = (torch.randn(27, b, s, 576, device=dev, generator=g)).bfloat16()
        q = torch.randn(b, 16, 576, device=dev, generator=g).bfloat16()
        new = torch.randn(b, 576, device=dev, generator=g).bfloat16()
        end = torch.randint(s // 2, s, (b,), device=dev, generator=g)
        start = torch.randint(0, s // 4, (b,), device=dev, generator=g)
        slot = torch.arange(s, device=dev)
        bias = torch.where((slot[None] >= start[:, None]) & (slot[None] <= end[:, None]), 0.0, -1e10).float()
        idx = end.to(torch.int32)
        ref_cache = cache.clone()
        got = mla.mla_decode(q, new, cache, idx, bias, 7, scale, 512)
        want = mla.mla_decode_plain(q, new, ref_cache, idx, bias, 7, scale, 512)
        err = float((got.float() - want.float()).norm() / want.float().norm())
        if err > MOON_KERNEL_TOL or not torch.equal(cache, ref_cache):
            raise AssertionError(f"mla_decode at S = {s}: rel err {err:.3g}, cache equal {torch.equal(cache, ref_cache)}")
        ms = graph_ms(lambda: mla.mla_decode(q, new, cache, idx, bias, 7, scale, 512))
        plain_ms = graph_ms(lambda: mla.mla_decode_plain(q, new, ref_cache, idx, bias, 7, scale, 512))
        open_slots = int((bias > -1).sum())
        nbytes = open_slots * 1152 + b * 16 * (576 + 512) * 2 + b * s * 4
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * 16 * 1088 * open_slots / BF16_FLOP_PER_S) * 1e3
        out.append(dict(kernel="mla_decode", b=b, s=s, plan=list(mla.plan(b, s)), rel_err=err, ms=ms,
                        bound_ms=bound, roofline_pct=100 * bound / ms, plain_ms=plain_ms))
    for r in out:
        log("phase 17 kernel: " + json.dumps(r))
    results["moon_kernels"] = out


def moon_decode(model, texts, dev, graphed: bool, keep_logits: bool = False) -> dict:
    """The batch's greedy decode through llm._generate (as batch_synthesize
    buckets it), from its bucket's graph or eagerly; with keep_logits the
    loop is run here step by step to keep each step's logits."""
    import torch

    from fangyan_tts_torch.data.lm_plan import pad_plans_left
    from fangyan_tts_torch.infer.tts import batch_buckets
    from fangyan_tts_torch.models import llm
    from fangyan_tts_torch.ops.sampling import ras_uniforms

    c = model.cfg
    plans, tp, max_new, cache_len = batch_buckets(c, texts, np.zeros(0, np.int32), np.zeros(0, np.int32), 6.0)
    batch = pad_plans_left(plans, length=tp)
    lens = np.asarray([6 * len(t) for t in texts], np.int32)
    args = (torch.from_numpy(batch["src"]).to(dev), torch.from_numpy(batch["ids"]).to(dev),
            torch.from_numpy(batch["lengths"]).to(dev), torch.from_numpy(lens), torch.from_numpy(lens))
    with torch.inference_mode():
        held = llm._bucket(model, len(texts), max_new, cache_len, dev) if graphed else contextlib.nullcontext()
        with held as bucket:
            if graphed and bucket is None:
                raise AssertionError("phase 17: the decode took no bucket on the card")
            if not keep_logits:
                res, logits = llm._generate(model, *args, None, max_new, cache_len, bucket)
                return dict(tokens=res.tokens.cpu(), counts=res.num_tokens.cpu(), logits=logits.float().cpu(),
                            plans=plans)
            s = bucket.state
            s.start(args[2].to(torch.int32), args[3].to(dev), args[4].to(dev), tp)
            s.logits.copy_(model.decode_logits(model.prefill_leftpad(args[0], args[1], s.prompt_lens, s.cache)))
            steps = [s.logits.float().clone()]
            for _ in range(max_new):
                if bool(s.done.all()):
                    break
                ras_uniforms(s.uniforms, None)
                if bucket.graph is None:
                    bucket.capture(lambda: llm._batch_step(model, s))
                else:
                    bucket.replay()
                steps.append(s.logits.float().clone())
            return dict(tokens=s.out.clone().cpu(), counts=s.counts.clone().cpu(), steps=steps, plans=plans)


def moon_phase(results: dict, card: str) -> None:
    """Phase 17: the MLA-MoE speech LM at full width (see the module's
    docstring); within DG_PHASE_LIMIT_S."""
    import torch

    from benchmark.harness import Trace
    from benchmark.reference import moonlight_lm
    from fangyan_tts_torch.infer.tts import CosyVoice3TTS
    from fangyan_tts_torch.ops import device
    from fangyan_tts_torch.utils import profiling

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = moon_config()
    tts = CosyVoice3TTS.random_init(cfg, dtype=torch.bfloat16, seed=17)
    gen = torch.Generator(device=dev).manual_seed(1717)
    with torch.no_grad():
        for name, p in tts.llm.named_parameters():
            if name.endswith("e_score_correction_bias"):
                p.normal_(0.0, 0.05, generator=gen)
    torch.cuda.synchronize()
    log(f"phase 17: the MLA-MoE model built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in tts.llm.parameters()) / 1e9:.3f} B LM parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    moon_kernels(results, tts.llm)
    rng = np.random.default_rng(17)
    texts = [rng.integers(0, 163840, n).astype(np.int32) for n in MOON_TEXT_TOKENS for _ in range(2)]
    prompt = dict(flow_embedding=rng.standard_normal(192).astype(np.float32),
                  flow_prompt_speech_token=rng.integers(0, 6561, 125).astype(np.int32),
                  prompt_speech_feat=rng.standard_normal((250, 80)).astype(np.float32),
                  min_token_text_ratio=6, max_token_text_ratio=6)
    runs = []
    for traced in (False, True):  # the first call captures its bucket, the second replays every step
        before = device.launches.copy()
        profiling.reset()
        tr = Trace() if traced else None
        if traced:
            tr.start()
        t = time.perf_counter()
        with profiling.recording():
            wavs = tts.batch_synthesize(texts, **prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if traced:
            tr.stop()
        tc = profiling.counters()
        profiling.reset()
        steps = tc["llm.decode_steps"]
        run = dict(traced=traced, s=wall, steps=steps, graph_steps=tc["llm.graph_steps"],
                   moe_launches=device.launches["moe_experts"] - before["moe_experts"],
                   mla_launches=device.launches["mla_decode"] - before["mla_decode"],
                   captures=tc["llm.graph_captures"],
                   counters={k: v for k, v in tc.items() if k.startswith("moe.")},
                   audio_s=sum(len(w) for w in wavs) / 24000)
        moe_layers = cfg.llm.qwen.num_hidden_layers - cfg.llm.qwen.first_k_dense_replace
        want = dict(moe_launches=2 * moe_layers * (steps + 1), mla_launches=2 * cfg.llm.qwen.num_hidden_layers * steps)
        if traced:
            run.update(traced_moe=len(tr.kernel_times_s("fangyan_moe_")),
                       traced_mla=len(tr.kernel_times_s("fangyan_mla_decode")),
                       moe_ms=1e3 * sum(tr.kernel_times_s("fangyan_moe_")),
                       mla_ms=1e3 * sum(tr.kernel_times_s("fangyan_mla_decode")), busy_s=tr.busy_s(),
                       window_s=tr.window_s)
            want.update(traced_moe=want["moe_launches"], traced_mla=want["mla_launches"])
        log("phase 17 batch: " + json.dumps(run))
        bad = {k: (run[k], v) for k, v in want.items() if run[k] != v}
        if bad or run["counters"].get("moe.calls.decode") != moe_layers * steps:
            raise AssertionError(f"phase 17: launches (got, want) {bad}, counters {run['counters']}")
        if traced and run["graph_steps"] < 0.97 * steps:
            raise AssertionError(f"phase 17: {run['graph_steps']} of {steps} steps replayed")
        runs.append(run)
    # one offline request through tts(stream=False): generate_tokens' B = 1 decode from its own bucket's graph
    profiling.reset()
    with profiling.recording():
        wav = next(tts.tts(text=texts[4], flow_embedding=prompt["flow_embedding"],
                           flow_prompt_speech_token=prompt["flow_prompt_speech_token"],
                           prompt_speech_feat=prompt["prompt_speech_feat"], min_token_text_ratio=6,
                           max_token_text_ratio=6))["tts_speech"]
    tc = profiling.counters()
    profiling.reset()
    offline = dict(samples=len(wav), want=6 * len(texts[4]) * 2 * 480, steps=tc.get("llm.decode_steps"),
                   graph_steps=tc.get("llm.graph_steps"), finite=bool(np.isfinite(wav).all()))
    log("phase 17 tts(stream=False): " + json.dumps(offline))
    # its tokens' audio, 960 samples a token (silent runs past 5 tokens are dropped before the flow)
    if not 0 < offline["samples"] <= offline["want"] or offline["samples"] % 960 or not offline["finite"] \
            or not offline["graph_steps"]:
        raise AssertionError(f"phase 17: the offline request {offline}")
    graphed = moon_decode(tts.llm, texts, dev, graphed=True)
    eager = moon_decode(tts.llm, texts, dev, graphed=False)
    equal = all(torch.equal(graphed[k], eager[k]) for k in ("tokens", "counts", "logits"))
    log(f"phase 17: graph against eager bit-equal: {equal}")
    if not equal:
        raise AssertionError("phase 17: the graphed decode differs from the eager one")
    kept = moon_decode(tts.llm, texts, dev, graphed=True, keep_logits=True)
    from benchmark.reference import exact_float32

    exact_float32()
    ref_cfg = dict(vars(cfg.llm.qwen), **{k: getattr(cfg.llm, k) for k in (
        "llm_input_size", "llm_output_size", "speech_token_size", "extra_tokens")})
    with torch.device("meta"):  # the program's bf16 weights, shared: the reference upcasts them as it uses them
        ref = moonlight_lm.SpeechLM(ref_cfg)
    ref.load_state_dict(tts.llm.state_dict(), strict=True, assign=True)
    ref.eval()
    checks = []
    n_speech = cfg.llm.speech_token_size
    limits = json.loads(MOON_CELL.read_text())["limits"]
    for r in (len(texts) - 1, 0)[:MOON_CHECK_ROWS]:
        n = int(kept["counts"][r])
        served = kept["tokens"][r, :n].numpy()
        want = ref.served_logits(texts[r], np.zeros(0, np.int64), served).float()
        got = torch.stack([kept["steps"][i][r] for i in range(n)]).to(want.device)
        rel = ((got - want).norm(dim=1) / want.norm(dim=1)).cpu()
        gaps = (want[:, :n_speech].max(1).values - want[:, :n_speech].gather(
            1, torch.as_tensor(served, device=want.device).long()[:, None])[:, 0]).cpu()
        checks.append(dict(row=r, tokens=n, prefill_rel=float(rel[0]), rel_median=float(rel.median()),
                           rel_max=float(rel.max()), gap=float(gaps.max()), gap_mean=float(gaps.mean()),
                           argmax_share=float((gaps == 0).float().mean())))
        log("phase 17 reference: " + json.dumps(checks[-1]) + f" (limits {limits['lm_gap']}, {limits['lm_gap_mean']})")
        if checks[-1]["gap"] > limits["lm_gap"] or checks[-1]["gap_mean"] > limits["lm_gap_mean"]:
            raise AssertionError(f"phase 17: row {r} off the reference: {checks[-1]}")
    phase_s = time.perf_counter() - t0
    results["moon"] = dict(runs=runs, checks=checks, phase_s=phase_s)
    log(f"phase 17 took {phase_s:.1f} s (limit {DG_PHASE_LIMIT_S} s) [{card}]")
    del tts, ref
    torch.cuda.empty_cache()
    if phase_s > DG_PHASE_LIMIT_S:
        raise AssertionError(f"phase 17 took {phase_s:.1f} s, over its limit of {DG_PHASE_LIMIT_S} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17",
                    help="comma-separated phases to run (see above)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2
    from fangyan_tts_torch.ops import _build
    from fangyan_tts_torch.ops.device import exact_fp32

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    exact_fp32()
    results: dict = {}

    if 2 in phases:
        t = time.perf_counter()
        _build.build_all()
        log(f"kernel build: {time.perf_counter() - t:.2f} s for {', '.join(_build.SOURCES)}")
        for name, text in _build.build_logs.items():
            for line in text.splitlines():
                if any(w in line.lower() for w in ("registers", "spill", "error", "warning")):
                    log(f"  nvcc {name}: {line.strip()}")
    launch_probe(results, "start")
    api = api_request_spec()
    stream = stream_shapes(api)
    serving = serving_spec(api)
    v12 = v12_spec(api)
    grpo = grpo_spec()
    dg = datagen_spec(api)
    ex = export_spec(api)
    mp = mp_spec()
    states = frontend_states() if phases & {4, 7, 8, 9, 10, 11, 12, 13, 14, 15} else None
    if 3 in phases:
        batches = [batch_shapes(r) for r in batch_requests_spec()]
        log(f"batched requests' shapes (a), (b): {batches}; the API request's: {api}; the streams': {stream}; "
            f"the serving runs' decode (B, S, tp) {serving['decode']} and flow calls (rows, L): kind "
            f"{dict(sorted(serving['flash'].items()))}; phase 10's v2 decodes (label, B, S, last slot, first "
            f"slot) {v12['decode']} and scheduler (B, S, tp) {v12['sched']}; phase 13's GRPO rollouts: decode B "
            f"{grpo['b']} S {grpo['cache_len']} (tp {grpo['tp']}, max_new {grpo['max_new']}), flash L {grpo['flash_l']}; "
            f"phase 14's CLI batches {dg['cli']} and single requests {[(r['label'], r['cache_len']) for r in dg['single']]}; "
            f"phase 15's export flash L {ex['export']['flash_l']} and recipe {ex['recipe']}; phase 16's TP=2 decode and "
            f"window hop {mp}")
        check_decode(results, batches, api, stream, serving, v12, grpo, dg, ex, mp)
        check_decode_rows(results, serving)
        check_flash(results, batches, api, stream, serving, grpo, dg, ex, mp)
        check_int4(results, batches[1], mp)
        check_adaln(results)
        check_rms_norm_qkv_rope(results)
        t = time.perf_counter()
        check_f32_routes(results, api)
        log(f"the float32 routes' checks took {time.perf_counter() - t:.1f} s")
    with contextlib.ExitStack() as stack:
        if 4 in phases:
            small_reference_check()
            small_float32_check(results)
            tts, req = full_path(results, card)
        elif phases & {8, 9, 14, 15}:
            from fangyan_tts_torch.infer.tts import CosyVoice3TTS

            tts = CosyVoice3TTS.random_init(full_config(), dtype=torch.bfloat16)
        model_dir = stack.enter_context(api_model_dir(tts, states)) if phases & {4, 8, 9, 14, 15} else None
        if 4 in phases:
            api_request(results, card, model_dir, api)
            batched = batched_requests(results, card)
            graph_check(results, card, batched["a_bf16"][0].llm)
            t = time.perf_counter()
            float32_api_request(results, card, model_dir, api)
            float32_batch(results, card)
            log(f"phase 4's float32 requests took {time.perf_counter() - t:.1f} s")
        if 8 in phases:
            # before the profiler passes of phases 5 and 7: the probes around phase 8's own
            # profiled hops show what a profiler session leaves behind in the host's launch cost
            from fangyan_tts_torch.api import AutoModel
            from fangyan_tts_torch.infer.tts import CosyVoice3TTS

            small_stream_check()
            t = time.perf_counter()
            stream_tts = CosyVoice3TTS.random_init(full_config(), dtype=torch.bfloat16)  # fresh: no clocks
            api_model = AutoModel(str(model_dir))
            torch.cuda.synchronize()
            log(f"phase 8 models: random_init and AutoModel load in {time.perf_counter() - t:.2f} s")
            launch_probe(results, "before phase 8")
            streaming_phase(results, card, stream_tts, api_model, str(model_dir / "prompt.wav"), api)
            del stream_tts, api_model
            torch.cuda.empty_cache()
        if 9 in phases:  # after phase 8, before the profiler passes
            launch_probe(results, "before phase 9")
            t = time.perf_counter()
            serving_phase(results, card, model_dir, api, serving)
            log(f"phase 9 took {time.perf_counter() - t:.1f} s")
            launch_probe(results, "after phase 9")
        if 10 in phases:  # after phase 9, before the profiler passes of phases 5 and 7
            t = time.perf_counter()
            v12_phase(results, card, states, api)
            log(f"phase 10 took {time.perf_counter() - t:.1f} s")
            launch_probe(results, "after phase 10")
        if 11 in phases:  # after phase 10, before the profiler passes of phases 5 and 7
            t = time.perf_counter()
            dataprep_phase(results, card, states)
            log(f"phase 11 took {time.perf_counter() - t:.1f} s")
            launch_probe(results, "after phase 11")
        if 12 in phases:  # after phase 11, before the profiler passes of phases 5 and 7
            t = time.perf_counter()
            train_phase(results, card, states, model_dir, api)
            log(f"phase 12 took {time.perf_counter() - t:.1f} s")
            launch_probe(results, "after phase 12")
        if 13 in phases:  # after phase 12, before the profiler passes of phases 5 and 7
            t = time.perf_counter()
            rest_phase(results, card, states, model_dir, grpo)
            log(f"phase 13 took {time.perf_counter() - t:.1f} s")
            launch_probe(results, "after phase 13")
        if 14 in phases:  # after phase 13, before the profiler passes of phases 5 and 7
            datagen_phase(results, card, model_dir, dg)
            launch_probe(results, "after phase 14")
        if 15 in phases:  # after phase 14, before the profiler passes of phases 5 and 7
            export_phase(results, card, model_dir, states, ex)
            launch_probe(results, "after phase 15")
        if 16 in phases:  # after phase 15, before the profiler passes of phases 5 and 7
            if 2 not in phases:
                _build.build_all()  # built once here: two processes must not build at once
            mp_phase(results, card, mp)
            launch_probe(results, "after phase 16")
        if 17 in phases:  # after phase 16, before the profiler passes of phases 5 and 7
            moon_phase(results, card)
            launch_probe(results, "after phase 17")
        if 4 in phases and 5 in phases:
            profile_stages(tts, req, results, card)
            (tts_a, req_a), (tts_b, req_b) = batched["a"], batched["b"]
            results["profile_batch"] = {
                "a_int8": profile_batch(tts_a, req_a, card, "(a) int8 LLM"),
                "b_int4": profile_batch(tts_b, req_b, card, "(b) int8 LLM + int4 MLP, int8 DiT"),
            }
        if 7 in phases:
            frontend_phase(results, card, states)
    if 6 in phases and 3 in phases and 4 in phases:
        # the zero-shot request's shapes: its 600-token decode holds most of the
        # main path's decode launches, and its flow the longest attention
        dt = next(r for r in results["decode_timing"] if r["s"] == 768)
        ft = next(r for r in results["flash_timing"]
                  if r["l"] == 1344 and r["chunk"] == 0 and r["layout"] == "strided")  # the DiT's own views
        # gate_up_proj at decode M = 16: every decode step of request (b) makes
        # one such launch a layer (and one of down_proj), the prefill only two
        it = next(r for r in results["int4_timing"] if r["proj"] == "gate_up_proj" and r["m"] == 16)
        # the float32 routes: decode at phase 4's float32 batch (its only main-path caller), flash at the
        # float32 API request's longest flow, int4 gate_up_proj at the float32 batch's decode M
        dt32 = results["decode_f32_timing"][0]
        ft32 = next(r for r in results["flash_f32_timing"] if r["b"] == 2 and r["chunk"] == 0)
        it32 = next(r for r in results["int4_f32_timing"] if r["proj"] == "gate_up_proj" and r["m"] == F32_B)
        kernels = [
            dict(name="decode_attention", route="cuda", source="fangyan_tts_torch/csrc/decode_attention.cu",
                 replaces="fangyan_tts_tpu/ops/decode_attention.py:124",
                 launches=results["launches"]["decode_attention"], max_abs_err=results["decode_err"],
                 ms=dt["ms"], plain_ms=dt["plain_ms"], bound_ms=dt["bound_ms"], bound_by=dt["bound_by"],
                 library_ms=dt["library_ms"]),
            dict(name="chunk_flash_attention", route="cuda", source="fangyan_tts_torch/csrc/flash_attention.cu",
                 replaces="fangyan_tts_tpu/ops/flash_attention.py:78",
                 launches=results["launches"]["chunk_flash_attention"], max_abs_err=results["flash_err"],
                 ms=ft["ms"], plain_ms=ft["plain_ms"], bound_ms=ft["bound_ms"], bound_by=ft["bound_by"],
                 library_ms=ft["library_ms"]),
            dict(name="int4_matmul", route="cuda", source="fangyan_tts_torch/csrc/int4_matmul.cu",
                 replaces="fangyan_tts_tpu/ops/int4_matmul.py:39",
                 launches=results["launches"]["int4_matmul"], max_abs_err=results["int4_err"],
                 ms=it["ms"], plain_ms=it["plain_ms"], bound_ms=it["bound_ms"], bound_by=it["bound_by"],
                 library_ms=it["library_ms"]),
        ]
        at = next(r for r in results["adaln_timing"] if r["l"] == ADALN_GATE_FRAMES and r["residual"])
        kernels.append(dict(name="adaln", route="triton", source="fangyan_tts_torch/csrc/adaln_triton.py",
                            replaces=None, launches=results["launches"].get("adaln", 0),
                            max_abs_err=results["adaln_err"], ms=at["ms"], plain_ms=at["plain_ms"],
                            bound_ms=at["bound_ms"], bound_by=at["bound_by"], library_ms=None))
        for name, kind in (("rms_norm", "residual"), ("qkv_rope", "bias")):  # a Qwen2 decode step's rows
            lt = next(r for r in results["llm_fused_timing"] if r["kernel"] == name and r["t"] == 1
                      and r["d"] in (896, 1152) and r["kind"] == kind)
            kernels.append(dict(name=name, route="triton", source=f"fangyan_tts_torch/csrc/{name}_triton.py",
                                replaces=None, launches=results["launches"].get(name, 0),
                                max_abs_err=results[f"{name}_err"], ms=lt["ms"], plain_ms=lt["plain_ms"],
                                bound_ms=lt["bound_ms"], bound_by=lt["bound_by"], library_ms=None))
        for name, key, src, line, timing in (
                ("decode_attention_f32", "decode_f32_err", "decode_attention.cu", "decode_attention.py:124", dt32),
                ("chunk_flash_attention_f32", "flash_f32_err", "flash_attention.cu", "flash_attention.py:78", ft32),
                ("int4_matmul_f32", "int4_f32_err", "int4_matmul.cu", "int4_matmul.py:39", it32)):
            kernels.append(dict(name=name, route="cuda", source=f"fangyan_tts_torch/csrc/{src}",
                                replaces=f"fangyan_tts_tpu/ops/{line}", launches=results["launches"].get(name, 0),
                                max_abs_err=results[key], ms=timing["ms"], plain_ms=timing["plain_ms"],
                                bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
                                library_ms=timing["library_ms"]))
        log("detail: " + json.dumps({k: results[k] for k in ("decode_timing", "flash_timing", "int4_timing", "requests",
                                                             "api_request", "batch_requests", "profile",
                                                             "profile_batch", "frontend", "streaming",
                                                             "serving", "v12", "dataprep", "train",
                                                             "train_api_request", "decode_rows_bit_equal",
                                                             "launch_probe_us", "decode_f32_timing",
                                                             "flash_f32_timing", "int4_f32_timing", "small_float32",
                                                             "adaln_timing", "llm_fused_timing",
                                                             "f32_request", "f32_batch", "datagen", "mp")
                                     if k in results}))
        log(json.dumps({"kernels": kernels}), stamp=False)
    launch_probe(results, "end")
    log(f"chip_smoke: phases {sorted(phases)} ran in {time.perf_counter() - _START:.1f} s of script time [{card}]")
    log(card, stamp=False)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": CARDS_USED}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failure is a failed run: report it and exit non-zero
        traceback.print_exc()
        sys.exit(1)
