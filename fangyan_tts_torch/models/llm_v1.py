"""The CosyVoice1 AR speech-token LM (fangyan_tts_tpu/models/llm_v1.py,
`TransformerLM` with its prefix-recompute decode `v1_generate` /
`v1_generate_stream`).

A conformer text encoder (no macaron, no convolution) with an affine to
the LM width, then a transformer LM (ReLU feed-forward, the legacy linear
input layer with its ReLU) over [sos, spk_emb, text, task, speech], token-
causal, and a linear head over speech_token_size + 1 (the last id is eos).
`forward` is the training loss: label-smoothed CE over the speech tokens
and eos, teacher-forced, with autograd. The recompute decode runs the
whole prefix for every token, under no_grad; it is the reference the
KV-cached decode of models/llm_v1_decode.py is held to.
Sampling draws from a `torch.Generator` (the JAX package's PRNG key) with
the reference's RAS parameters (V1_SAMPLING).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.sampling import ras_sample
from .conformer import ConformerEncoder
from .llm import IGNORE_ID, label_smoothed_ce
from .qwen2 import flax_dense

# the reference's RAS sampling (cosyvoice.yaml: top_p 0.8, top_k 25, win 10, tau_r 0.1)
V1_SAMPLING = dict(top_p=0.8, top_k=25, win_size=10, tau_r=0.1)


class TransformerLM(nn.Module):
    """Defaults are CosyVoice-300M's (text encoder 1024 / 16 heads x 6, LM
    1024 / 16 heads x 14, 4096 speech tokens)."""

    def __init__(self, text_token_size: int = 51866, speech_token_size: int = 4096, text_encoder_input_size: int = 512,
                 llm_input_size: int = 1024, llm_output_size: int = 1024, spk_embed_dim: int = 192,
                 text_enc_blocks: int = 6, llm_blocks: int = 14, heads: int = 16, ffn: int = 4096,
                 lsm_weight: float = 0.0, length_normalized_loss: bool = True):
        super().__init__()
        self.text_token_size, self.speech_token_size = text_token_size, speech_token_size
        self.llm_input_size, self.llm_output_size, self.heads = llm_input_size, llm_output_size, heads
        self.lsm_weight, self.length_normalized_loss = lsm_weight, length_normalized_loss
        self.text_embedding = nn.Embedding(text_token_size, text_encoder_input_size)
        self.text_encoder = ConformerEncoder(dim=llm_input_size, heads=heads, ffn_hidden=ffn,
                                             num_blocks=text_enc_blocks, macaron=False, use_cnn=False,
                                             input_dim=text_encoder_input_size)
        self.text_encoder_affine_layer = nn.Linear(llm_input_size, llm_input_size)
        self.llm_embedding = nn.Embedding(2, llm_input_size)  # sos 0, task 1
        self.spk_embed_affine_layer = nn.Linear(spk_embed_dim, llm_input_size)
        self.speech_embedding = nn.Embedding(speech_token_size, llm_input_size)
        self.llm = ConformerEncoder(dim=llm_output_size, heads=heads, ffn_hidden=ffn, num_blocks=llm_blocks,
                                    macaron=False, use_cnn=False, ffn_act="relu", legacy_embed=True,
                                    input_dim=llm_input_size)
        self.llm_decoder = nn.Linear(llm_output_size, speech_token_size + 1)

    def encode_text(self, text_tokens, text_len):
        h = self.text_embedding(text_tokens.clamp(0, self.text_token_size - 1))
        h, _ = self.text_encoder(h, text_len, streaming=True, static_chunk_size=1)
        return flax_dense(h, self.text_encoder_affine_layer)

    def build_lm_input(self, text_enc, text_len, speech_tokens, speech_len, embedding):
        """[sos, spk, text, task, speech] as a padded (B, 2+Lt+1+Ls, D)
        sequence; returns (lm_input, lm_len = 3 + text_len + speech_len)."""
        b, lt = text_enc.shape[:2]
        ls = speech_tokens.shape[1]
        d = self.llm_input_size
        dev = text_enc.device
        emb = embedding / torch.clamp(torch.linalg.norm(embedding, dim=1, keepdim=True), min=1e-12)
        spk = flax_dense(emb, self.spk_embed_affine_layer)[:, None, :]
        sos = self.llm_embedding.weight[0].expand(b, 1, d)
        task = self.llm_embedding.weight[1].expand(b, 1, d)
        sp_emb = self.speech_embedding(speech_tokens.clamp(0, self.speech_token_size - 1))

        total = 2 + lt + 1 + ls
        out = torch.zeros((b, total, d), dtype=text_enc.dtype, device=dev)
        out[:, 0:1] = sos.to(out.dtype)
        out[:, 1:2] = spk.to(out.dtype)
        pos = torch.arange(total, device=dev)[None, :]
        text_pos = pos - 2
        text_part = torch.gather(text_enc, 1, text_pos.clamp(0, lt - 1).expand(b, total)[..., None].expand(b, total, d))
        out = torch.where(((text_pos >= 0) & (text_pos < text_len[:, None]))[..., None], text_part, out)
        out = torch.where((pos == (2 + text_len)[:, None])[..., None], task.to(out.dtype), out)
        sp_pos = pos - 3 - text_len[:, None]
        sp_part = torch.gather(sp_emb, 1, sp_pos.clamp(0, ls - 1)[..., None].expand(b, total, d))
        out = torch.where(((sp_pos >= 0) & (sp_pos < speech_len[:, None]))[..., None], sp_part.to(out.dtype), out)
        return out, 3 + text_len + speech_len

    def logits(self, text_tokens, text_len, speech_tokens, speech_len, embedding) -> torch.Tensor:
        """Teacher-forced logits (B, 2+Lt+1+Ls, speech_token_size + 1) over
        the whole sequence, token-causal (the training forward's)."""
        text_enc = self.encode_text(text_tokens, text_len)
        lm_input, lm_len = self.build_lm_input(text_enc, text_len, speech_tokens, speech_len, embedding)
        h, _ = self.llm(lm_input, lm_len, streaming=True, static_chunk_size=1)
        return flax_dense(h, self.llm_decoder)

    def forward(self, text_tokens, text_len, speech_tokens, speech_len, embedding) -> tuple[torch.Tensor, torch.Tensor]:
        """Training loss on the token-causal logits: the target of position
        p is speech token p - (2 + text_len) over the speech span, eos
        (speech_token_size) after it, IGNORE_ID elsewhere (the 2 + text_len
        prefix and the padding). Returns (loss, acc) (models/llm
        label_smoothed_ce)."""
        logits = self.logits(text_tokens, text_len, speech_tokens, speech_len, embedding)
        b, total = logits.shape[:2]
        pos = torch.arange(total, device=logits.device)[None, :]
        sp_idx = pos - 2 - text_len[:, None]
        ls = speech_tokens.shape[1]
        sp_t = speech_tokens.gather(1, sp_idx.clamp(0, ls - 1).expand(b, total).long()).long()
        tgt = torch.where((sp_idx >= 0) & (sp_idx < speech_len[:, None]), sp_t, IGNORE_ID)
        tgt = torch.where(pos == (2 + text_len + speech_len)[:, None], self.speech_token_size, tgt)
        return label_smoothed_ce(logits, tgt, self.lsm_weight, self.length_normalized_loss)


@torch.no_grad()
def _v1_step_logp(model: TransformerLM, text, tlen, speech, slen, emb) -> torch.Tensor:
    logits = model.logits(text, tlen, speech, slen, emb)
    lm_len = 3 + tlen + slen
    last = torch.gather(logits, 1, (lm_len - 1).long()[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
    return torch.log_softmax(last.float(), dim=-1)


def v1_generate(model: TransformerLM, text_tokens: np.ndarray, embedding: np.ndarray,
                prompt_speech: np.ndarray = np.zeros(0, np.int32), generator: torch.Generator | None = None,
                min_token_text_ratio: float = 2.0, max_token_text_ratio: float = 20.0, chunk: int = 32,
                prompt_text_len: int = 0) -> np.ndarray:
    """The whole recompute decode: (N,) int32 speech tokens."""
    return np.asarray(list(v1_generate_stream(model, text_tokens, embedding, prompt_speech, generator,
                                              min_token_text_ratio, max_token_text_ratio, chunk, prompt_text_len)),
                      np.int32)


def v1_generate_stream(model: TransformerLM, text_tokens: np.ndarray, embedding: np.ndarray,
                       prompt_speech: np.ndarray = np.zeros(0, np.int32), generator: torch.Generator | None = None,
                       min_token_text_ratio: float = 2.0, max_token_text_ratio: float = 20.0, chunk: int = 32,
                       prompt_text_len: int = 0):
    """Yields speech tokens one by one, each from a forward over the whole
    prefix (padded to a multiple of `chunk` speech slots). min / max
    lengths count the new text only (prompt_text_len excluded); the RAS
    window covers generated tokens only."""
    sp = V1_SAMPLING
    dev = model.llm_decoder.weight.device
    lt = len(text_tokens)
    new_text = lt - prompt_text_len
    min_len, max_len = int(new_text * min_token_text_ratio), int(new_text * max_token_text_ratio)
    text = torch.as_tensor(np.asarray(text_tokens, np.int32), device=dev)[None]
    tlen = torch.tensor([lt], dtype=torch.int32, device=dev)
    emb = torch.as_tensor(np.asarray(embedding, np.float32), device=dev).reshape(1, -1)
    out = list(np.asarray(prompt_speech, np.int32).tolist())
    n_prompt = len(out)
    win = sp["win_size"]
    eos = model.speech_token_size
    while len(out) - n_prompt < max_len:
        ls = max((len(out) + chunk - 1) // chunk * chunk, chunk)
        speech = np.zeros((1, ls), np.int32)
        speech[0, : len(out)] = out
        logp = _v1_step_logp(model, text, tlen, torch.from_numpy(speech).to(dev),
                             torch.tensor([len(out)], dtype=torch.int32, device=dev), emb)
        i = len(out) - n_prompt
        allowed = torch.ones((1, eos + 1), dtype=torch.bool, device=dev)
        if i < min_len:
            allowed[0, eos] = False
        recent = np.full(win, -1, np.int32)
        tail = out[n_prompt:][-win:]
        recent[win - len(tail):] = tail
        rec = torch.from_numpy(recent[None]).to(dev)
        tok = int(ras_sample(logp, rec, rec >= 0, allowed, generator, **sp)[0])
        if tok == eos:
            break
        out.append(tok)
        yield tok
