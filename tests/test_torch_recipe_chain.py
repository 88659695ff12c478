"""The port's dialect recipe end to end on the CPU:
`bash fangyan_tts_torch/recipes/dialect/run.sh 0 7` with DEVICE=cpu on a
12-utterance kaldi corpus and a tiny PRETRAIN_DIR written by the port (a
Qwen of 2 layers at hidden 128 with heads of 64, a DiT of 2 blocks at dim
128 with heads of 64: the widths the CUDA kernels take; full-size CAM++ and
S3 with random weights, since the API builds its frontend at full size),
each stage checked by its artifacts as tests/test_recipe_chain.py checks the
JAX recipe's (embeddings, speech tokens in the FSQ id space, parquet
shards and the train / cv split, epoch checkpoints with their CV loss, the
val-best average, the exported programs and msgpack files), then
`cli.compare_inference` on the chain's own fine-tuned LLM. Every CLI runs
as a subprocess through the script. Besides, `bash -n` on every ported
recipe, and every `-m fangyan_tts_torch.<module>` they name is importable.
"""

import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fangyan_tts_torch import config as tcfg
from fangyan_tts_torch.data import kaldi_io
from fangyan_tts_torch.data.audio import write_wav
from fangyan_tts_torch.infer.tts import CosyVoice3TTS, _random_state
from fangyan_tts_torch.models.campplus import CAMPPlus
from fangyan_tts_torch.models.from_jax import to_jax_tree
from fangyan_tts_torch.models.s3tokenizer import S3TokenizerV3
from fangyan_tts_torch.train.checkpoint import load_params, save_params

REPO = Path(__file__).resolve().parent.parent
RECIPES = REPO / "fangyan_tts_torch" / "recipes"
N_UTT = 12
MAX_EPOCH = 5  # stage 6 averages --num 5 val-best checkpoints
NT = 16  # stage 7's --n_tokens is the CLI default (256); the check below reads the programs' input shapes

# heads of 64, real speech-token vocab (stage 2's S3 emits codes in [0, 6561))
TINY = tcfg.CosyVoiceConfig(
    llm=tcfg.LLMConfig(llm_input_size=128, llm_output_size=128, speech_token_size=6561, extra_tokens=8,
                       qwen=tcfg.QwenConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                                            num_attention_heads=2, num_key_value_heads=1, head_dim=64,
                                            vocab_size=300)),
    flow=tcfg.FlowConfig(vocab_size=6561, n_timesteps=2,
                         dit=tcfg.DiTConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, static_chunk_size=10)),
    hift=tcfg.HiFTConfig(base_channels=64, f0_cond_channels=32),
    chunk_size=5,
)


def write_chain_inputs(root: Path, cfg, seed: int = 11) -> tuple[Path, Path, Path]:
    """The corpus (dataset/combined, N_UTT utterances of 1.5-2.6 s at 24
    kHz, two speakers, the hunan instruct), PRETRAIN_DIR (config.json, the
    three msgpacks of `cfg` at random weights, full-size CAM++ and S3) and a
    2 s prompt wav."""
    data_dir = root / "dataset" / "combined"
    (data_dir / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    wav_scp, text, utt2spk, instruct = {}, {}, {}, {}
    for i in range(N_UTT):
        utt = f"u{i:03d}"
        wav = data_dir / "wavs" / f"{utt}.wav"
        write_wav(wav, (rng.standard_normal(int(24000 * (1.5 + 0.1 * i))) * 0.1).astype(np.float32), 24000)
        wav_scp[utt], text[utt], utt2spk[utt] = str(wav), f"今天天气真不错第{i}句。", f"s{i % 2}"
        instruct[utt] = "请用湖南话说。<|endofprompt|>"
    kaldi_io.write_kaldi_dir(data_dir, wav_scp, text, utt2spk, instruct)

    pretrain = root / "pretrained"
    pretrain.mkdir()
    (pretrain / "config.json").write_text(tcfg.config_to_json(cfg))
    tts = CosyVoice3TTS.random_init(cfg, dtype=torch.float32, device="cpu", seed=seed)
    for name, m in (("llm", tts.llm), ("flow", tts.flow), ("hift", tts.hift)):
        save_params(pretrain / f"{name}.msgpack", to_jax_tree(m.state_dict(), m))
    gen = torch.Generator().manual_seed(seed)
    for name, ctor in (("campplus", CAMPPlus), ("s3tokenizer", S3TokenizerV3)):
        with torch.device("meta"):
            skel = ctor()
        save_params(pretrain / f"{name}.msgpack", to_jax_tree(_random_state(ctor, torch.float32, gen, "cpu"), skel))
    prompt = root / "prompt.wav"
    write_wav(prompt, (rng.standard_normal(24000 * 2) * 0.1).astype(np.float32), 24000)
    return data_dir, pretrain, prompt


def recipe_env(root: Path, data_dir: Path, pretrain: Path, device: str) -> dict:
    env = dict(os.environ)
    env.update(DATA_DIR=str(data_dir), EXP_DIR=str(root / "exp" / "llm"), PRETRAIN_DIR=str(pretrain),
               CONFIG=str(pretrain / "config.json"), MAX_EPOCH=str(MAX_EPOCH), MAX_FRAMES="400",
               NUM_UTTS_PER_PARQUET="5",  # 12 utterances -> 3 shards -> a real train / cv split
               DEVICE=device, PY=sys.executable)
    return env


def check_chain_artifacts(data_dir: Path, exp_dir: Path, cfg) -> None:
    """Each stage's files, as tests/test_recipe_chain.py checks the JAX recipe's."""
    utt2emb = torch.load(data_dir / "utt2embedding.pt", weights_only=False)
    spk2emb = torch.load(data_dir / "spk2embedding.pt", weights_only=False)
    assert set(utt2emb) == {f"u{i:03d}" for i in range(N_UTT)} and set(spk2emb) == {"s0", "s1"}
    assert np.asarray(utt2emb["u000"]).shape == (192,)
    utt2tok = torch.load(data_dir / "utt2speech_token.pt", weights_only=False)
    assert set(utt2tok) == set(utt2emb)
    toks = np.concatenate([np.asarray(v).ravel() for v in utt2tok.values()])
    assert toks.min() >= 0 and toks.max() < 6561
    parquet = data_dir / "parquet"
    shards = (parquet / "data.list").read_text().splitlines()
    assert len(shards) == 3 and all(Path(s).exists() for s in shards)
    train_list = (parquet / "train.data.list").read_text().splitlines()
    cv_list = (parquet / "cv.data.list").read_text().splitlines()
    assert len(train_list) == 2 and len(cv_list) == 1 and set(train_list) | set(cv_list) == set(shards)
    ckpts = sorted(exp_dir.glob("epoch_*_whole.msgpack"))
    assert len(ckpts) == MAX_EPOCH, [p.name for p in exp_dir.iterdir()]
    for ck in ckpts:
        assert np.isfinite(json.loads(Path(str(ck) + ".json").read_text())["cv_loss"])
    avg = load_params(exp_dir / "llm.msgpack")
    assert tuple(avg["llm_decoder"]["kernel"].shape) == (cfg.llm.llm_output_size, 6561 + 8)
    export_dir = exp_dir / "export"
    names = {p.name for p in export_dir.iterdir()}
    assert {"flow_prepare.pt2", "flow_solve.pt2", "vocoder.pt2", "llm.msgpack", "flow.msgpack",
            "hift.msgpack"} <= names
    assert all((export_dir / n).stat().st_size > 0 for n in names)


def run_compare(pretrain: Path, finetuned: Path, prompt: Path, out_dir: Path, env: dict, device: str) -> None:
    r = subprocess.run(
        [sys.executable, "-m", "fangyan_tts_torch.cli.compare_inference", "--pretrained_dir", str(pretrain),
         "--finetuned_llm", str(finetuned), "--prompt_wav", str(prompt), "--output_dir", str(out_dir),
         "--dialects", "hunan", "--num_texts", "1", "--device", device],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"compare_inference failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    for name in ("hunan_1_original.wav", "hunan_1_finetuned.wav"):
        assert (out_dir / name).exists() and (out_dir / name).stat().st_size > 44, name


def test_dialect_recipe_stages_0_to_7_and_compare(tmp_path):
    data_dir, pretrain, prompt = write_chain_inputs(tmp_path, TINY)
    env = recipe_env(tmp_path, data_dir, pretrain, "cpu")
    r = subprocess.run(["bash", str(RECIPES / "dialect" / "run.sh"), "0", "7"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, f"run.sh failed:\nSTDOUT:\n{r.stdout[-4000:]}\nSTDERR:\n{r.stderr[-4000:]}"
    exp_dir = Path(env["EXP_DIR"])
    check_chain_artifacts(data_dir, exp_dir, TINY)
    ep = torch.export.load(exp_dir / "export" / "flow_solve.pt2")
    z = next(n for n in ep.graph.nodes if n.op == "placeholder" and n.name == "z")
    assert tuple(z.meta["val"].shape) == (1, 2 * 256, 80)  # the CLI's default --n_tokens 256
    run_compare(pretrain, exp_dir / "llm.msgpack", prompt, tmp_path / "comparison", env, "cpu")


@pytest.mark.parametrize("recipe", ["dialect", "libritts", "grpo", "magicdata-read"])
def test_recipe_scripts_parse_and_name_port_modules(recipe):
    script = RECIPES / recipe / "run.sh"
    r = subprocess.run(["bash", "-n", str(script)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    text = script.read_text()
    assert "fangyan_tts_tpu" not in text
    for mod in re.findall(r"-m (fangyan_tts_torch\.[\w.]+)", text) + re.findall(r"from (fangyan_tts_torch\.[\w.]+)", text):
        importlib.import_module(mod)
    assert "DEVICE" in text
