"""Text tokenizers of CosyVoice2/3 (fangyan_tts_tpu/tokenizer/tokenizer.py,
without the CosyVoice1 whisper-style tokenizer).

- `QwenTTSTokenizer`: the HF AutoTokenizer of a local tokenizer directory
  plus the paralinguistic specials; v3 adds <|endofsystem|> and the ARPABET
  and pinyin phoneme tokens. `transformers` is imported only when one is
  built.
- `ByteFallbackTokenizer`: a UTF-8 byte tokenizer with the same
  special-token interface, so the pipeline runs without tokenizer files.
  Its ids are not those of a Qwen checkpoint.
"""

from __future__ import annotations

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
