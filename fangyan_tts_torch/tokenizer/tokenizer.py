"""Text tokenizers of the three model generations
(fangyan_tts_tpu/tokenizer/tokenizer.py).

- `QwenTTSTokenizer`: the HF AutoTokenizer of a local tokenizer directory
  plus the paralinguistic specials; v3 adds <|endofsystem|> and the ARPABET
  and pinyin phoneme tokens. `transformers` is imported only when one is
  built.
- `WhisperStyleTokenizer` (CosyVoice1): tiktoken BPE from a `.tiktoken`
  base64 rank file, plus the language, audio-event, emotion and TTS
  specials and 1501 timestamps. `tiktoken` is imported only when one is
  built; `get_tokenizer` without a rank file gives the byte tokenizer.
- `ByteFallbackTokenizer`: a UTF-8 byte tokenizer with the same
  special-token interface, so the pipeline runs without tokenizer files.
  Its ids are not those of a Qwen checkpoint.
"""

from __future__ import annotations

import base64
import re
from functools import lru_cache

# -- special token sets ------------------------------------------------------

_PARALINGUISTIC = [
    "<|im_start|>", "<|im_end|>", "<|endofprompt|>",
    "[breath]", "<strong>", "</strong>", "[noise]",
    "[laughter]", "[cough]", "[clucking]", "[accent]",
    "[quick_breath]", "<laughter>", "</laughter>",
    "[hissing]", "[sigh]", "[vocalized-noise]", "[lipsmack]", "[mn]",
]

# alphabetical phoneme order with vowels carrying 0/1/2 stress variants —
# must match the reference list token-for-token (tokenizer.py:288-294):
# HF assigns special-token ids sequentially in list order, so a different
# ordering silently shifts every phoneme token id
_ARPA_VOWELS = set("AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW".split())
_ARPA_ORDER = (
    "AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG "
    "OW OY P R S SH T TH UH UW V W Y Z ZH"
).split()
_ARPABET_TOKENS = [
    f"[{p}{s}]" for p in _ARPA_ORDER
    for s in (("", "0", "1", "2") if p in _ARPA_VOWELS else ("",))
]

# pinyin initials/finals with tone-marked vowels (tokenizer.py:286-305)
_PINYIN_TOKENS = [f"[{s}]" for s in (
    "a ai an ang ao b c ch d e ei en eng f g h i ian in ing iu "
    "ià iàn iàng iào iá ián iáng iáo iè ié iòng ióng iù iú iā iān iāng iāo "
    "iē iě iōng iū iǎ iǎn iǎng iǎo iǒng iǔ j k l m n o ong ou p q r s sh t u uang ue "
    "un uo uà uài uàn uàng uá uái uán uáng uè ué uì uí uò uó uā uāi uān uāng uē uě uī uō uǎ uǎi "
    "uǎn uǎng uǐ uǒ vè w x y z zh à ài àn àng ào á ái án áng áo è èi èn èng èr é éi én "
    "éng ér ì ìn ìng í ín íng ò òng òu ó óng óu ù ùn ú ún ā āi ān āng āo ē ēi ēn ēng ě "
    "ěi ěn ěng ěr ī īn īng ō ōng ōu ū ūn ǎ ǎi ǎn ǎng ǎo ǐ ǐn ǐng ǒ ǒng ǒu ǔ ǔn ǘ ǚ ǜ"
).split()]

CV2_SPECIAL_TOKENS = {
    "eos_token": "<|endoftext|>",
    "pad_token": "<|endoftext|>",
    "additional_special_tokens": list(_PARALINGUISTIC),
}
CV3_SPECIAL_TOKENS = {
    "eos_token": "<|endoftext|>",
    "pad_token": "<|endoftext|>",
    "additional_special_tokens": list(_PARALINGUISTIC) + ["<|endofsystem|>"] + _ARPABET_TOKENS + _PINYIN_TOKENS,
}

# dialect-extended whisper language codes (tokenizer.py:111-117)
EXTRA_LANGUAGES = ["yue", "minnan", "wuyu", "dialect", "zh/en", "en/zh"]


class QwenTTSTokenizer:
    """HF AutoTokenizer wrapper (CosyVoice2Tokenizer/CosyVoice3Tokenizer,
    tokenizer.py:241-313)."""

    def __init__(self, token_path: str, skip_special_tokens: bool = True, version: str = "cosyvoice3"):
        from transformers import AutoTokenizer

        self.special_tokens = CV3_SPECIAL_TOKENS if version == "cosyvoice3" else CV2_SPECIAL_TOKENS
        self.tokenizer = AutoTokenizer.from_pretrained(token_path)
        self.tokenizer.add_special_tokens(self.special_tokens)
        self.skip_special_tokens = skip_special_tokens

    def encode(self, text: str, **kwargs) -> list[int]:
        return self.tokenizer([text])["input_ids"][0]

    def decode(self, tokens: list[int]) -> str:
        return self.tokenizer.batch_decode([list(tokens)], skip_special_tokens=self.skip_special_tokens)[0]

    @property
    def vocab_size(self) -> int:
        return len(self.tokenizer)


class ByteFallbackTokenizer:
    """UTF-8 byte tokenizer with special-token passthrough.

    ids: [0, 256) raw bytes; specials get stable ids from 256 upward in the
    CV3 special order. Deterministic, asset-free; for tests/benchmarks only.
    """

    def __init__(self, skip_special_tokens: bool = True, version: str = "cosyvoice3"):
        import warnings

        warnings.warn(
            "ByteFallbackTokenizer produces a DIFFERENT id space than the Qwen "
            "tokenizer — fine for tests/benchmarks, but NOT id-compatible with "
            "real CosyVoice2/3 checkpoints (provide the HF tokenizer assets)",
            stacklevel=2,
        )
        spec = CV3_SPECIAL_TOKENS if version == "cosyvoice3" else CV2_SPECIAL_TOKENS
        specials = [spec["eos_token"]] + spec["additional_special_tokens"]
        self.special_to_id = {s: 256 + i for i, s in enumerate(dict.fromkeys(specials))}
        self.id_to_special = {v: k for k, v in self.special_to_id.items()}
        self.skip_special_tokens = skip_special_tokens
        pattern = "|".join(re.escape(s) for s in sorted(self.special_to_id, key=len, reverse=True))
        self._split = re.compile(f"({pattern})")

    def encode(self, text: str, **kwargs) -> list[int]:
        out: list[int] = []
        for part in self._split.split(text):
            if not part:
                continue
            if part in self.special_to_id:
                out.append(self.special_to_id[part])
            else:
                out.extend(part.encode("utf-8"))
        return out

    def decode(self, tokens: list[int]) -> str:
        buf, out = bytearray(), []
        for t in tokens:
            t = int(t)
            if t < 256:
                buf.append(t)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not self.skip_special_tokens:
                    out.append(self.id_to_special.get(t, ""))
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.special_to_id)


@lru_cache(maxsize=None)
def get_qwen_tokenizer(token_path: str | None, skip_special_tokens: bool = True, version: str = "cosyvoice3"):
    """Factory mirroring tokenizer.py:316-327; falls back to bytes when no
    tokenizer assets are available (token_path None/missing)."""
    if token_path:
        try:
            return QwenTTSTokenizer(token_path, skip_special_tokens, version)
        except (OSError, ValueError) as e:
            print(f"⚠️ could not load Qwen tokenizer from {token_path} ({e}); using byte fallback")
    return ByteFallbackTokenizer(skip_special_tokens, version)


class WhisperStyleTokenizer:
    """The CosyVoice1 tiktoken tokenizer: a base64-rank BPE vocabulary
    (`vocab_path`, the format of the reference's
    multilingual_zh_ja_yue_char_del.tiktoken) with the language /
    audio-event / emotion / TTS specials and 1501 timestamps after it."""

    def __init__(self, vocab_path: str, num_languages: int = 99):
        import tiktoken

        with open(vocab_path) as f:
            ranks = {base64.b64decode(token): int(rank) for token, rank in (line.split() for line in f if line.strip())}
        n_vocab = len(ranks)
        specials = [
            "<|endoftext|>",
            "<|startoftranscript|>",
            *[f"<|{lang}|>" for lang in self._language_codes()[:num_languages]],
            *[f"<|{e}|>" for e in ("ASR", "AED", "SER", "Speech", "/Speech", "BGM", "/BGM", "Laughter", "/Laughter",
                                   "Applause", "/Applause")],
            *[f"<|{e}|>" for e in ("HAPPY", "SAD", "ANGRY", "NEUTRAL")],
            "<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>",
            *[f"<|SPECIAL_TOKEN_{i}|>" for i in range(1, 31)],
            *[f"<|{t}|>" for t in ("TTS/B", "TTS/O", "TTS/Q", "TTS/A", "TTS/CO", "TTS/CL", "TTS/H")],
            *[f"<|TTS/SP{i:02d}|>" for i in range(1, 14)],
            *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
        ]
        special_tokens = {}
        for tok in specials:
            special_tokens[tok] = n_vocab
            n_vocab += 1
        self.encoding = tiktoken.Encoding(
            name="cosyvoice1",
            explicit_n_vocab=n_vocab,
            pat_str=r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""",
            mergeable_ranks=ranks,
            special_tokens=special_tokens,
        )

    @staticmethod
    def _language_codes() -> list[str]:
        # whisper's language codes and the dialect extensions
        base = (
            "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no th ur hr bg lt la "
            "mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
            "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha ba jw su"
        ).split()
        return base + EXTRA_LANGUAGES

    def encode(self, text: str, allowed_special="all", **kwargs) -> list[int]:
        return self.encoding.encode(text, allowed_special=allowed_special)

    def decode(self, tokens: list[int]) -> str:
        return self.encoding.decode([int(t) for t in tokens])

    @property
    def vocab_size(self) -> int:
        return self.encoding.n_vocab


@lru_cache(maxsize=None)
def get_tokenizer(multilingual: bool = True, vocab_path: str | None = None, num_languages: int = 99):
    """The CosyVoice1 factory: the whisper-style tokenizer on a rank file,
    else the byte tokenizer."""
    if vocab_path:
        return WhisperStyleTokenizer(vocab_path, num_languages)
    return ByteFallbackTokenizer(version="cosyvoice2")
