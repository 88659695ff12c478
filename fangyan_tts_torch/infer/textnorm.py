"""Text normalization + paragraph splitting.

The port's copy of fangyan_tts_tpu/infer/textnorm.py. It needs no third-party
`regex` package: `is_only_punctuation` tests Unicode categories P* and S*
with `unicodedata`.

Behavioral reference: cosyvoice/utils/frontend_utils.py:21-136 and the
wetext/ttsfrd fallback chain in cli/frontend.py:56-75. The category
normalization itself lives in infer/tn.py — a native tagger→verbalizer
engine mirroring wetext's two-WFST architecture (ordered semiotic-class
rules, longest-match scan) covering: dates (CJK/ISO/ranges/lunar/decades),
times (+ranges), percent (+ranges, per-mille), fractions, currency
(+万/亿 scales), measure units, telephone (mobile/landline/hotline),
serial/ID codes, sport scores, license plates, math operators, dotted
versions/IPs, thousands separators, generic ranges, negatives, and
cardinal/decimal readings with the 二/两 distinction — for zh, and the en
equivalents (percent/currency/time/fraction/ordinals/ranges). `<|...|>`
markup always bypasses normalization, matching frontend.py:131-134.
Category vectors: tests/test_textnorm_categories.py.

Deliberate pass-throughs (shapes the tagger does NOT claim; they fall to
the generic cardinal reading, same as wetext's untagged fallback):
- 1-3 digit years without a full date (202年 reads 二百零二年 — genuinely
  ambiguous with durations: 住了202年);
- hotlines WITHOUT a dial context (110 alone reads 一百一十 — only
  拨打110/热线12345 style contexts disambiguate);
- roman numerals, fraction slashes in zh running text (wetext leaves both
  to the upstream tagger too);
- erhua 儿 stays lexical (no 儿-insertion/deletion — the reference's
  ttsfrd binary did dialect-aware erhua, wetext does not);
- URLs/emails pass through untouched (wetext has no web tagger either).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable

from . import tn
from .tn import (  # noqa: F401 — public re-exports
    digits_zh as _digits_zh_impl,
    number_to_words_en,
    number_to_words_zh,
    ordinal_words_en,
)

_CHINESE_CHAR = re.compile(r"[一-鿿]")

_DIGITS_ZH = tn._DIGITS_ZH
_ONES_EN = tn._ONES_EN


def _digits_zh(s: str, phone: bool = False) -> str:
    """Digit-by-digit reading; phone style reads 1 as 幺 (telephony)."""
    return _digits_zh_impl(s, phone=phone)


def contains_chinese(text: str) -> bool:
    return bool(_CHINESE_CHAR.search(text))


def replace_corner_mark(text: str) -> str:
    return text.replace("²", "平方").replace("³", "立方")


def remove_bracket(text: str) -> str:
    for ch in ("（", "）", "【", "】", "`"):
        text = text.replace(ch, "")
    return text.replace("——", " ")


def replace_blank(text: str) -> str:
    """Drop spaces unless both neighbors are non-space ascii
    (frontend_utils.py:119-130)."""
    out = []
    for i, c in enumerate(text):
        if c == " ":
            prev_ok = i > 0 and text[i - 1].isascii() and text[i - 1] != " "
            next_ok = i + 1 < len(text) and text[i + 1].isascii() and text[i + 1] != " "
            if prev_ok and next_ok:
                out.append(c)
        else:
            out.append(c)
    return "".join(out)


def is_only_punctuation(text: str) -> bool:
    """True when every character is punctuation (P*) or a symbol (S*); the
    empty string is. `regex`'s [\\p{P}\\p{S}] reads the same categories from
    its own Unicode tables, which may class a code point that Python's
    table leaves unassigned."""
    return all(unicodedata.category(c)[0] in "PS" for c in text)


def normalize_categories_zh(text: str) -> str:
    """wetext-category readings for zh via the tagger→verbalizer engine
    (infer/tn.py). Reference: the wetext WFST chain behind
    cli/frontend.py:63-75."""
    text = tn.normalize_zh(text)
    # leftover range tildes between already-normalized spans
    return text.replace("~", "到").replace("～", "到")


def normalize_categories_en(text: str) -> str:
    """en equivalents via the tagger→verbalizer engine (infer/tn.py)."""
    return tn.normalize_en(text)


def spell_out_number(text: str, lang: str = "en") -> str:
    """Replace digit runs with words (frontend_utils.py:42-58 analogue;
    zh mode also reads decimals). After normalize_categories_* this is a
    safety net — the tagger's cardinal catch-all already claims digits."""
    fn = number_to_words_zh if lang == "zh" else number_to_words_en

    def repl(m: re.Match) -> str:
        s = m.group(0)
        if "." in s:
            int_part, frac = s.split(".", 1)
            if lang == "zh":
                return fn(int_part or "0") + "点" + "".join(_DIGITS_ZH[int(c)] for c in frac)
            return fn(int_part or "0") + " point " + " ".join(_ONES_EN[int(c)] for c in frac)
        return fn(s)

    return re.sub(r"\d+(?:\.\d+)?", repl, text)


def split_paragraph(
    text: str,
    tokenize: Callable[[str], list],
    lang: str = "zh",
    token_max_n: int = 80,
    token_min_n: int = 60,
    merge_len: int = 20,
    comma_split: bool = False,
) -> list[str]:
    """Sentence splitting with token-count-aware merging
    (frontend_utils.py:65-116)."""

    def utt_length(t: str) -> int:
        return len(t) if lang == "zh" else len(tokenize(t))

    if lang == "zh":
        pounc = ["。", "？", "！", "；", "：", "、", ".", "?", "!", ";"]
    else:
        pounc = [".", "?", "!", ";", ":"]
    if comma_split:
        pounc.extend(["，", ","])

    if not text:
        return []
    if text[-1] not in pounc:
        text += "。" if lang == "zh" else "."

    st, utts = 0, []
    for i, c in enumerate(text):
        if c in pounc:
            if len(text[st:i]) > 0:
                utts.append(text[st:i] + c)
            if i + 1 < len(text) and text[i + 1] in ['"', "”"]:
                # closing quote rides with the sentence it ends
                # (frontend_utils.py:96-99; pop+append keeps earlier utts)
                utts.append((utts.pop() if utts else "") + text[i + 1])
                st = i + 2
            else:
                st = i + 1

    final, cur = [], ""
    for utt in utts:
        if utt_length(cur + utt) > token_max_n and utt_length(cur) > token_min_n:
            final.append(cur)
            cur = ""
        cur += utt
    if cur:
        if utt_length(cur) < merge_len and final:
            final[-1] += cur
        else:
            final.append(cur)
    return final


def text_normalize(
    text: str,
    tokenize: Callable[[str], list],
    split: bool = True,
    use_frontend: bool = True,
):
    """Normalize + split (cli/frontend.py:127-158 flow)."""
    if "<|" in text and "|>" in text:
        use_frontend = False
    if not use_frontend or text == "":
        return [text] if split else text
    text = text.strip()
    if contains_chinese(text):
        text = text.replace("\n", "")
        text = replace_blank(text)
        text = normalize_categories_zh(text)
        text = replace_corner_mark(text)
        text = spell_out_number(text, "zh")
        text = text.replace(".", "。").replace(" - ", "，")
        text = remove_bracket(text)
        text = re.sub(r"[，,、]+$", "。", text)
        texts = split_paragraph(text, tokenize, "zh", token_max_n=80, token_min_n=60, merge_len=20)
    else:
        text = normalize_categories_en(text)
        text = spell_out_number(text, "en")
        texts = split_paragraph(text, tokenize, "en", token_max_n=80, token_min_n=60, merge_len=20)
    texts = [t for t in texts if not is_only_punctuation(t)]
    return texts if split else text
