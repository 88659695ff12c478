"""Tagger→verbalizer text-normalization engine (wetext replacement).

The port's copy of fangyan_tts_tpu/infer/tn.py, rule for rule, its known
faults kept (the en range rule reads '3-4%' without "percent"; money with
thousands separators misreads), so that both packages normalize alike.

The reference normalizes text through wetext's two WFST stages — a tagger
that marks typed semiotic spans (date, time, money, measure, telephone, …)
and a verbalizer that rewrites each tagged span into characters
(cosyvoice/cli/frontend.py:56-75; wetext zh tagger.fst/verbalizer.fst).
This module re-implements that architecture natively: an ordered rule table
per language, scanned left-to-right with longest-match semantics (ties fall
to table order, the WFST path-weight analogue), each rule pairing a tagger
pattern with a verbalizer function. Compared to a chain of global
re.sub passes, the scanner matches wetext's behavior where categories
overlap: the longest tagged span wins at each position, and every
verbalizer sees the ORIGINAL text context (lookbehind/lookahead), not the
half-rewritten output of earlier passes.

Semiotic classes covered for zh — the wetext tagger inventory plus the
long-tail shapes rounds 3-5 added: telephone (mobile/landline/dial-context
hotline), serial (10+ digit IDs, leading-zero codes), date (CJK, ISO,
year ranges, lunar 初N, decades NN年代 / N零后), time (clock, with-seconds,
time ranges), sport scores, percent (+ranges, per-mille), fraction,
money (+万/亿 scales), measure units, license plates, math operators
(+ × ÷ = ±), dotted sequences (versions/IPs), thousands separators,
generic ranges, negatives, and cardinal/decimal with the 二/两
distinction (wetext char.fst). For en: percent, currency (+cents), clock
times (+ranges), fractions, ordinal suffixes (1st/2nd/…), thousands
separators, ranges, negatives, cardinals/decimals.

Deliberate pass-throughs are documented in infer/textnorm.py (the public
entry point, which re-exports this engine's normalize_zh/normalize_en).
Golden vectors: tests/test_textnorm_categories.py.
"""

from __future__ import annotations

import re
from typing import Callable

# ---------------------------------------------------------------------------
# number readings (shared verbalizer primitives)

_DIGITS_ZH = "零一二三四五六七八九"
_UNITS_ZH = ["", "十", "百", "千"]
_GROUPS_ZH = ["", "万", "亿", "万亿"]

_ONES_EN = (
    "zero one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen".split()
)
_TENS_EN = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()


def number_to_words_en(num_str: str) -> str:
    """Integer -> English words (replaces the inflect dependency)."""
    n = int(num_str)
    if n == 0:
        return "zero"
    if n >= 10**15:  # beyond the scales table: read digit-by-digit
        return " ".join("zero" if c == "0" else _ONES_EN[int(c)] for c in num_str)
    parts = []

    def three(x: int) -> str:
        s = []
        if x >= 100:
            s.append(_ONES_EN[x // 100] + " hundred")
            x %= 100
        if x >= 20:
            t = _TENS_EN[x // 10]
            if x % 10:
                t += "-" + _ONES_EN[x % 10]
            s.append(t)
        elif x > 0:
            s.append(_ONES_EN[x])
        return " ".join(s)

    scales = ["", " thousand", " million", " billion", " trillion"]
    chunks = []
    while n:
        chunks.append(n % 1000)
        n //= 1000
    for i in range(len(chunks) - 1, -1, -1):
        if chunks[i]:
            parts.append(three(chunks[i]) + scales[i])
    return " ".join(parts)


_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def ordinal_words_en(num_str: str) -> str:
    """Integer -> English ordinal words (21 -> twenty-first)."""
    words = number_to_words_en(num_str)
    head, _, last = words.rpartition(" ")
    hhead, _, hlast = last.rpartition("-")
    if hlast in _ORDINAL_IRREGULAR:
        hlast = _ORDINAL_IRREGULAR[hlast]
    elif hlast.endswith("y"):
        hlast = hlast[:-1] + "ieth"
    else:
        hlast += "th"
    last = (hhead + "-" + hlast) if hhead else hlast
    return (head + " " + last) if head else last


def number_to_words_zh(num_str: str) -> str:
    """Integer -> Chinese reading (wetext-subset replacement)."""
    n = int(num_str)
    if n == 0:
        return "零"
    if n >= 10**16:  # beyond 万亿: read digit-by-digit
        return digits_zh(num_str)
    out = []
    group_idx = 0
    while n > 0:
        g = n % 10000
        n //= 10000
        if g:
            s = _group_zh(g)
            out.append(s + _GROUPS_ZH[group_idx])
        elif out and not out[-1].startswith("零"):
            out.append("零")
        group_idx += 1
    text = "".join(reversed(out))
    text = re.sub("零+", "零", text).strip("零")
    # 一十X -> 十X
    if text.startswith("一十"):
        text = text[1:]
    return text or "零"


def _group_zh(g: int) -> str:
    s = []
    digits = [(g // 1000) % 10, (g // 100) % 10, (g // 10) % 10, g % 10]
    started = False
    for d, u in zip(digits, ["千", "百", "十", ""]):
        if d:
            s.append(_DIGITS_ZH[d] + u)
            started = True
        elif started:
            s.append("零")
    return re.sub("零+", "零", "".join(s)).rstrip("零")


def digits_zh(s: str, phone: bool = False) -> str:
    """Digit-by-digit reading; phone style reads 1 as 幺 (telephony usage)."""
    return "".join(
        "零" if c == "0" else ("幺" if c == "1" and phone else _DIGITS_ZH[int(c)])
        for c in s
    )


def num_zh(s: str) -> str:
    """Integer-or-decimal string -> Chinese reading."""
    if "." in s:
        i, f = s.split(".", 1)
        return number_to_words_zh(i or "0") + "点" + digits_zh(f)
    return number_to_words_zh(s)


def num_en(s: str) -> str:
    """Integer-or-decimal string -> English reading."""
    if "." in s:
        i, f = s.split(".", 1)
        return number_to_words_en(i or "0") + " point " + " ".join(_ONES_EN[int(c)] for c in f)
    return number_to_words_en(s)


# ---------------------------------------------------------------------------
# the scanner engine


class Rule:
    """One semiotic class: tagger pattern + verbalizer.

    `triggers` lists the characters the match can start with — the scanner
    only attempts the pattern at those positions (the tagger's input
    alphabet restriction). The verbalizer receives (match, full_text) so it
    can consult ORIGINAL left/right context, e.g. the 二/两 decision."""

    __slots__ = ("name", "rx", "fn", "triggers")

    def __init__(self, name: str, pattern: str, fn: Callable, triggers: str):
        self.name = name
        self.rx = re.compile(pattern)
        self.fn = fn
        self.triggers = triggers


def _build(rules: list[Rule]) -> dict[str, list[Rule]]:
    tmap: dict[str, list[Rule]] = {}
    for r in rules:
        for c in r.triggers:
            tmap.setdefault(c, []).append(r)  # table order = priority
    return tmap


def _scan(text: str, tmap: dict[str, list[Rule]]) -> str:
    out = []
    i, n = 0, len(text)
    while i < n:
        cand = tmap.get(text[i])
        if not cand:
            out.append(text[i])
            i += 1
            continue
        best_r, best_m = None, None
        for r in cand:
            m = r.rx.match(text, i)
            # strict > keeps the FIRST rule on ties: table order is priority
            if m and m.end() > i and (best_m is None or m.end() > best_m.end()):
                best_r, best_m = r, m
        if best_m is None:
            out.append(text[i])
            i += 1
            continue
        out.append(best_r.fn(best_m, text))
        i = best_m.end()
    return "".join(out)


# ---------------------------------------------------------------------------
# zh rule table

_D = "0123456789"

# characters after which a standalone 2 reads 两 (measure words, clock 点,
# scale words 万/亿/千/百); 月/日/号 deliberately absent (2月 = 二月)
_LIANG_FOLLOWERS = (
    "个只本条张次位名件台辆架间家场篇首座颗棵粒艘顶杯瓶碗盘块枚匹头罐桶袋箱层栋排"
    "对双份节段句行页幅卷册部集支把口亩级倍人天年周岁点分秒小站轮届门道笔锅组队幢"
    "万亿千百"
)

_CURRENCY_ZH = {"￥": "元", "¥": "元", "$": "美元", "€": "欧元", "£": "英镑"}

# zh measure units appended directly after a number (wetext measure.fst
# set), longest-first so km² beats km beats m
_UNITS_ZH_TABLE = [
    ("km/h", "千米每小时"), ("m/s", "米每秒"), ("kWh", "千瓦时"), ("kW", "千瓦"),
    ("km²", "平方千米"), ("m²", "平方米"), ("cm²", "平方厘米"), ("m³", "立方米"),
    ("mm", "毫米"), ("cm", "厘米"), ("km", "千米"), ("mg", "毫克"), ("kg", "千克"),
    ("ml", "毫升"), ("℃", "摄氏度"), ("℉", "华氏度"), ("GB", "吉字节"),
    ("MB", "兆字节"), ("KB", "千字节"), ("Hz", "赫兹"), ("h", "小时"),
    ("g", "克"), ("L", "升"), ("m", "米"), ("s", "秒"),
]
_UNITS_ALT = "|".join(re.escape(u) for u, _ in _UNITS_ZH_TABLE)
_UNITS_READ = dict(_UNITS_ZH_TABLE)

_PLATE_PROVINCES = "京津沪渝冀豫云辽黑湘皖鲁新苏浙赣鄂桂甘晋蒙陕吉闽贵粤青藏川宁琼使领"

_MATH_ZH = {"+": "加", "×": "乘", "÷": "除以", "=": "等于", "＝": "等于",
            "≈": "约等于", "≥": "大于等于", "≤": "小于等于"}


def _v_phone(m, _t):
    return digits_zh(m.group(0), phone=True)


def _v_landline(m, _t):
    return digits_zh(m.group(1), phone=True) + digits_zh(m.group(2), phone=True)


def _v_serial(m, _t):
    return digits_zh(m.group(0))


def _v_year_range(m, _t):
    return digits_zh(m.group(1)) + "到" + digits_zh(m.group(2))


def _v_date_cjk(m, _t):
    out = digits_zh(m.group(1)) + "年"
    if m.group(2):
        out += number_to_words_zh(m.group(2)) + "月"
    if m.group(3):
        out += number_to_words_zh(m.group(3)) + "日"
    return out


def _v_date_iso(m, _t):
    return (digits_zh(m.group(1)) + "年" + number_to_words_zh(m.group(2)) + "月"
            + number_to_words_zh(m.group(3)) + "日")


def _v_date_md(m, _t):
    return number_to_words_zh(m.group(1)) + "月" + number_to_words_zh(m.group(2)) + "日"


def _read_time_zh(h: str, mi: str, se: str | None) -> str:
    out = ("两" if int(h) == 2 else number_to_words_zh(h)) + "点"
    if int(mi):
        out += ("零" if mi[0] == "0" and int(mi) else "") + number_to_words_zh(mi) + "分"
    if se is not None and int(se):
        out += number_to_words_zh(se) + "秒"
    return out


def _v_time(m, _t):
    return _read_time_zh(m.group(1), m.group(2), m.group(3))


_TIME_PART = re.compile(r"(\d{1,2}):(\d{2})(?::(\d{2}))?")


def _v_time_range(m, _t):
    a, b = _TIME_PART.fullmatch(m.group(1)), _TIME_PART.fullmatch(m.group(2))
    return (_read_time_zh(a.group(1), a.group(2), a.group(3)) + "到"
            + _read_time_zh(b.group(1), b.group(2), b.group(3)))


def _v_score(m, _t):
    return number_to_words_zh(m.group(1)) + "比" + number_to_words_zh(m.group(2))


def _v_percent_range(m, _t):
    return ("百分之" + num_zh(m.group(1).lstrip("-")) + "到百分之"
            + num_zh(m.group(2).lstrip("-")))


def _v_percent(m, _t):
    s = m.group(0)
    return ("负" if s.startswith("-") else "") + "百分之" + num_zh(s.lstrip("-")[:-1])


def _v_permille(m, _t):
    s = m.group(0)
    return ("负" if s.startswith("-") else "") + "千分之" + num_zh(s.lstrip("-")[:-1])


def _v_lunar(m, _t):
    return "初" + number_to_words_zh(m.group(1))


def _v_fraction(m, _t):
    return number_to_words_zh(m.group(2)) + "分之" + number_to_words_zh(m.group(1))


def _v_currency(m, _t):
    scale = m.group(3) or ""
    amt = m.group(2)
    # standalone 2 before a 万/亿 scale reads 两 ($2万 -> 两万美元)
    num = "两" if (amt == "2" and scale) else num_zh(amt)
    return num + scale + _CURRENCY_ZH[m.group(1)]


def _v_decade(m, _t):
    return digits_zh(m.group(1))


def _v_dotted(m, _t):
    """Multi-dot sequences (versions, IPs): first group cardinal, later
    groups digit-by-digit (2.5.1 -> 二点五点一, 192.168.1.1 ->
    一百九十二点一六八点一点一)."""
    groups = m.group(0).split(".")
    return "点".join([number_to_words_zh(groups[0])] + [digits_zh(g) for g in groups[1:]])


def _v_range(m, _t):
    return num_zh(m.group(1)) + "到" + num_zh(m.group(2))


def _v_measure(m, _t):
    num, reading = m.group(1), _UNITS_READ[m.group(2)]
    # standalone 2 before a 千/百-initial reading keeps the 两 reading the
    # char.fst would produce after unit expansion (2kg -> 两千克)
    if num == "2" and reading[0] in "千百万亿":
        return "两" + reading
    return num_zh(num) + reading


def _v_range_measure(m, _t):
    return num_zh(m.group(1)) + "到" + num_zh(m.group(2)) + _UNITS_READ[m.group(3)]


def _v_plate(m, _t):
    tail = "".join(digits_zh(c, phone=True) if c.isdigit() else c for c in m.group(3))
    return m.group(1) + m.group(2) + tail


def _v_math(m, _t):
    return _MATH_ZH[m.group(0)]


def _v_plusminus(m, _t):
    return "正负"


def _v_thousands(m, _t):
    return number_to_words_zh(m.group(0).replace(",", ""))


def _v_negative(m, _t):
    return "负"


def _v_cardinal_zh(m, text):
    s = m.group(0)
    if "." not in s and s == "2":
        j = m.end()
        prev = text[m.start() - 1] if m.start() else ""
        # standalone 2 + measure word / 点(clock) / scale word reads 两
        # (wetext char.fst); ordinals (第2次) and calendar 月/日/号 keep 二
        if j < len(text) and text[j] in _LIANG_FOLLOWERS and prev != "第":
            return "两"
    return num_zh(s)


_ZH_RULES = [
    # telephony first: these digit runs must never read as cardinals
    Rule("telephone", r"(?<!\d)1[3-9]\d{9}(?!\d)", _v_phone, "1"),
    Rule("landline", r"(?<!\d)(0\d{2,3})-(\d{7,8})(?!\d)", _v_landline, "0"),
    Rule("serial", r"(?<!\d)\d{10,}(?!\d)", _v_serial, _D),
    Rule("hotline", r"(?<=[打线])1\d{2,4}(?!\d)", _v_phone, "1"),
    # dates (longest shapes first; the scanner prefers longer matches
    # anyway — order here settles equal-length ties)
    Rule("year_range", r"(?<!\d)(\d{4})\s*[-~～]\s*(\d{4})(?=年)", _v_year_range, _D),
    Rule("date_cjk", r"(\d{4})年(?:(\d{1,2})月)?(?:(\d{1,2})[日号])?", _v_date_cjk, _D),
    Rule("date_iso", r"(?<!\d)(\d{4})[-/](\d{1,2})[-/](\d{1,2})(?!\d)", _v_date_iso, _D),
    Rule("date_md", r"(?<!\d)(\d{1,2})月(\d{1,2})[日号]", _v_date_md, _D),
    Rule("decade", r"(?<!\d)(\d{2})(?=年代)", _v_decade, _D),
    Rule("decade_hou", r"(?<!\d)(\d0)(?=后)", _v_decade, _D),
    Rule("lunar_day", r"初(\d{1,2})(?!\d)", _v_lunar, "初"),
    # times, then what X:Y shapes remain are scores
    Rule("time_range",
         r"(?<!\d)(\d{1,2}:\d{2}(?::\d{2})?)\s*[-~～]\s*(\d{1,2}:\d{2}(?::\d{2})?)(?!\d)",
         _v_time_range, _D),
    Rule("time", r"(?<!\d)(\d{1,2}):(\d{2})(?::(\d{2}))?(?!\d)", _v_time, _D),
    Rule("score", r"(?<!\d)(\d{1,3}):(\d{1,3})(?!\d)", _v_score, _D),
    # leading-zero codes are never cardinals (after dates/times claimed
    # their zero-led fields)
    Rule("zero_code", r"(?<![\d.])0\d+(?![\d.])", _v_serial, "0"),
    # percent family
    Rule("percent_range",
         r"(-?\d+(?:\.\d+)?)%\s*[-~～]\s*(-?\d+(?:\.\d+)?)%", _v_percent_range, _D + "-"),
    Rule("percent", r"-?\d+(?:\.\d+)?%", _v_percent, _D + "-"),
    Rule("permille", r"-?\d+(?:\.\d+)?‰", _v_permille, _D + "-"),
    # fractions / money / measures
    Rule("fraction", r"(?<![\d/])(\d{1,3})/(\d{1,3})(?![\d/])", _v_fraction, _D),
    Rule("money", r"([￥¥$€£])\s*(\d+(?:\.\d+)?)(万亿|万|亿)?", _v_currency, "￥¥$€£"),
    Rule("measure", r"(\d+(?:\.\d+)?)(" + _UNITS_ALT + r")(?![A-Za-z0-9²³])",
         _v_measure, _D),
    # ranges whose unit rides on the right end: 400-500km -> 四百到五百千米
    Rule("range_measure",
         r"(?<!\d)(\d+(?:\.\d+)?)[~～-](\d+(?:\.\d+)?)(" + _UNITS_ALT + r")(?![A-Za-z0-9²³])",
         _v_range_measure, _D),
    # dotted sequences (versions, IPs) before the generic decimal
    Rule("dotted", r"(?<![\d.])\d+(?:\.\d+){2,}(?![\d.])", _v_dotted, _D),
    # thousands separators before the generic cardinal (a trailing . only
    # blocks the match when it starts a decimal fraction)
    Rule("thousands", r"(?<![\d,])\d{1,3}(?:,\d{3})+(?![\d,]|\.\d)", _v_thousands, _D),
    # generic ranges (the % lookahead keeps 3-2% on the old percent path)
    Rule("range", r"(?<!\d)(\d+(?:\.\d+)?)[~～-](\d+(?:\.\d+)?)(?![\d%])", _v_range, _D),
    # license plates: province + letter + 4-6 alnum with at least a digit
    Rule("plate",
         r"([" + _PLATE_PROVINCES + r"])([A-Z])·?((?=[A-Z0-9]*\d)[A-Z0-9]{4,6})(?![A-Z0-9])",
         _v_plate, _PLATE_PROVINCES),
    # math operators between digits; ± before a digit
    Rule("math", r"(?<=\d)[+×÷=＝≈≥≤](?=\d)", _v_math, "+×÷=＝≈≥≤"),
    Rule("plus_minus", r"±(?=\d)", _v_plusminus, "±"),
    # negatives, then the cardinal/decimal catch-all
    Rule("negative", r"(?<![\dA-Za-z)])-(?=\d)", _v_negative, "-"),
    Rule("cardinal", r"\d+(?:\.\d+)?", _v_cardinal_zh, _D),
]
_ZH_MAP = _build(_ZH_RULES)


# ---------------------------------------------------------------------------
# en rule table

_CURRENCY_EN = {"$": ("dollar", "dollars"), "€": ("euro", "euros"), "£": ("pound", "pounds")}
_FRAC_EN = {"1/2": "one half", "1/3": "one third", "2/3": "two thirds",
            "1/4": "one quarter", "3/4": "three quarters"}


def _v_percent_en(m, _t):
    return num_en(m.group(1)) + " percent"


def _v_currency_en(m, _t):
    sym, amt = m.group(1), m.group(2)
    one, many = _CURRENCY_EN[sym]
    if "." in amt:
        i, f = amt.split(".", 1)
        cents = int(f.ljust(2, "0")[:2])
        out = number_to_words_en(i or "0") + " " + (one if i == "1" else many)
        if cents:
            out += " " + number_to_words_en(str(cents)) + (" cent" if cents == 1 else " cents")
        return out
    return number_to_words_en(amt) + " " + (one if amt == "1" else many)


def _read_time_en(h: str, mi: str) -> str:
    out = number_to_words_en(str(int(h)))
    if int(mi) == 0:
        out += " o'clock"
    elif int(mi) < 10:
        out += " oh " + number_to_words_en(str(int(mi)))
    else:
        out += " " + number_to_words_en(mi)
    return out


def _v_time_en(m, _t):
    return _read_time_en(m.group(1), m.group(2))


_TIME_PART_EN = re.compile(r"(\d{1,2}):(\d{2})")


def _v_time_range_en(m, _t):
    a, b = _TIME_PART_EN.fullmatch(m.group(1)), _TIME_PART_EN.fullmatch(m.group(2))
    return _read_time_en(a.group(1), a.group(2)) + " to " + _read_time_en(b.group(1), b.group(2))


def _v_fraction_en(m, _t):
    return _FRAC_EN.get(
        m.group(0),
        number_to_words_en(m.group(1)) + " over " + number_to_words_en(m.group(2)),
    )


def _v_ordinal_en(m, _t):
    return ordinal_words_en(m.group(1))


def _v_thousands_en(m, _t):
    return number_to_words_en(m.group(0).replace(",", ""))


def _v_range_en(m, _t):
    return num_en(m.group(1)) + " to " + num_en(m.group(2))


def _v_negative_en(m, _t):
    return "minus "


def _v_cardinal_en(m, _t):
    return num_en(m.group(0))


_EN_RULES = [
    Rule("percent", r"(\d+(?:\.\d+)?)%", _v_percent_en, _D),
    Rule("currency", r"([$€£])\s*(\d+(?:\.\d+)?)", _v_currency_en, "$€£"),
    Rule("time_range", r"(?<!\d)(\d{1,2}:\d{2})\s*[-–]\s*(\d{1,2}:\d{2})(?!\d)",
         _v_time_range_en, _D),
    Rule("time", r"(?<!\d)(\d{1,2}):(\d{2})(?!\d)", _v_time_en, _D),
    Rule("fraction", r"(?<![\d/])(\d{1,3})/(\d{1,3})(?![\d/])", _v_fraction_en, _D),
    Rule("ordinal", r"(\d+)(?:st|nd|rd|th)(?![A-Za-z])", _v_ordinal_en, _D),
    Rule("thousands", r"(?<![\d,])\d{1,3}(?:,\d{3})+(?![\d,]|\.\d)", _v_thousands_en, _D),
    Rule("range", r"(?<!\d)(\d+(?:\.\d+)?)[-–](\d+(?:\.\d+)?)(?!\d)", _v_range_en, _D),
    Rule("negative", r"(?<![\w)])-(?=\d)", _v_negative_en, "-"),
    Rule("cardinal", r"\d+(?:\.\d+)?", _v_cardinal_en, _D),
]
_EN_MAP = _build(_EN_RULES)


def normalize_zh(text: str) -> str:
    """zh tagger+verbalizer pass: every digit-bearing span is rewritten to
    its character reading in ONE scan (wetext tagger.fst ∘ verbalizer.fst
    behind cli/frontend.py:63-75)."""
    return _scan(text, _ZH_MAP)


def normalize_en(text: str) -> str:
    """en tagger+verbalizer pass (the EnNormalizer in cli/frontend.py:68)."""
    return _scan(text, _EN_MAP)
