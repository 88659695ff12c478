"""The port's copies of infer/textnorm.py + infer/tn.py and of the byte
tokenizer against the JAX package's: text_normalize gives the same string
(split=False) and the same segments (split=True) on every case of
tests/test_textnorm_categories.py, faults kept; is_only_punctuation agrees
on every assigned BMP code point; the byte tokenizer's ids are equal.

is_only_punctuation: the JAX package uses the third-party `regex` package
(\\p{P}\\p{S}), the port `unicodedata.category`. The two read Unicode tables of
their own, so a code point that Python's table leaves unassigned (Cn) may be
punctuation or a symbol to `regex`: those code points are excluded here."""

import unicodedata
import warnings

import pytest

import test_textnorm_categories as cases
import torch_port_util  # noqa: F401  (one torch CPU thread per worker)
from fangyan_tts_torch.infer import textnorm as ttn
from fangyan_tts_torch.tokenizer import ByteFallbackTokenizer as TorchBytes
from fangyan_tts_torch.tokenizer import get_qwen_tokenizer as torch_get_tokenizer
from fangyan_tts_tpu.infer import textnorm as jtn
from fangyan_tts_tpu.tokenizer import ByteFallbackTokenizer as JaxBytes

EXTRA = [
    "请用四川话说。<|endofprompt|>今天3.5%。",
    "你好世界",
    "hello world",
    "",
    "。”好的。",
    "他说：“吃饭了。”然后走了。" * 12,
    "Read pages 3-4% of it. It costs $1,234.50!",
    "第一句话，很长很长。" * 20 + "最后一句",
]
TEXTS = [inp for inp, _ in cases.ZH_CASES + cases.EN_CASES] + EXTRA


@pytest.mark.parametrize("text", TEXTS)
def test_text_normalize_equal(text):
    tok = list
    assert ttn.text_normalize(text, tok, split=False) == jtn.text_normalize(text, tok, split=False)
    assert ttn.text_normalize(text, tok, split=True) == jtn.text_normalize(text, tok, split=True)


@pytest.mark.parametrize("inp, want", cases.ZH_CASES[:3] + cases.EN_CASES[:3])
def test_text_normalize_gives_the_golden_reading(inp, want):
    assert ttn.text_normalize(inp, list, split=False) == want


def test_is_only_punctuation_on_every_assigned_bmp_code_point():
    assigned = [chr(c) for c in range(0x10000) if unicodedata.category(chr(c)) != "Cn"]
    assert len(assigned) > 60000
    diff = [c for c in assigned if ttn.is_only_punctuation(c) != jtn.is_only_punctuation(c)]
    assert not diff, [hex(ord(c)) for c in diff[:20]]
    assert sum(ttn.is_only_punctuation(c) for c in assigned) > 1000
    for s in ("", "。！？", "!?\n", "\n", "a。", "——…", "《》", "。a"):
        assert ttn.is_only_punctuation(s) == jtn.is_only_punctuation(s), repr(s)


def test_byte_tokenizer_ids_equal():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pairs = [(TorchBytes(version=v), JaxBytes(version=v)) for v in ("cosyvoice3", "cosyvoice2")]
        pairs.append((torch_get_tokenizer(None, True, "cosyvoice3"), JaxBytes(True, "cosyvoice3")))
    texts = TEXTS + ["<|im_start|>[breath]你好<|endofprompt|>[AA1][ǚ]<|endofsystem|>"]
    for t, j in pairs:
        assert t.vocab_size == j.vocab_size and t.special_to_id == j.special_to_id
        for text in texts:
            ids = t.encode(text)
            assert ids == j.encode(text)
            assert t.decode(ids) == j.decode(ids)
