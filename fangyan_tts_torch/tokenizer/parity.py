"""Real-vocab tokenizer parity evidence (the port's copy of
fangyan_tts_tpu/tokenizer/parity.py).

The reference tokenizes with the actual Qwen vocab plus its added specials
(cosyvoice/tokenizer/tokenizer.py). This module, pointed at real Qwen
tokenizer assets, proves id compatibility two ways:

1. **Self-check (always runs)** — structural invariants that hold for any
   correct asset + special-list combination: every added special encodes to
   exactly ONE id; the added ids are assigned sequentially in list order
   starting at the base vocab size (the HF `add_special_tokens` contract the
   id layout depends on); specials survive an encode/decode roundtrip.

2. **Reference byte-equality (runs when a reference source tree is given)**
   — imports the ACTUAL CosyVoice2Tokenizer/CosyVoice3Tokenizer classes
   from a reference checkout (--reference_root, or the COSYVOICE_REF
   environment variable) and asserts byte-for-byte id equality over a
   corpus containing every special token plus mixed zh/en/digit/punctuation
   text.

cli/prepare_model_dir.py runs this when the model dir holds tokenizer
assets. `transformers` is imported only inside the check.
"""

from __future__ import annotations

import os
import sys
from typing import Any

from .tokenizer import QwenTTSTokenizer


def parity_corpus(tokenizer: QwenTTSTokenizer) -> list[str]:
    """Texts covering every special token (alone, adjacent, and embedded in
    zh/en text) plus ordinary-language samples."""
    specials = list(tokenizer.special_tokens["additional_special_tokens"])
    corpus = list(specials)  # every special standalone
    # adjacent specials without separators (longest-match boundary cases)
    corpus += ["".join(specials[i : i + 6]) for i in range(0, len(specials), 6)]
    corpus += [
        f"你好{s}世界 hello {s} world 123。" for s in specials[:8]
    ]
    corpus += [
        "今天天气不错,温度23.5℃。",
        "The quick brown fox jumps over 13 lazy dogs!",
        "混合 mixed 文本 with <strong>强调</strong> and [laughter] marks.",
        "<|im_start|>user<|im_end|><|endofprompt|>",
        "",
        " ",
        "…—«»“”‘’",
    ]
    return corpus


def _import_reference_tokenizer(reference_root: str) -> Any:
    """Import the reference cosyvoice.tokenizer.tokenizer module from a
    checkout, stubbing the whisper dependency if absent (the Qwen classes
    never touch it)."""
    if reference_root not in sys.path:
        sys.path.insert(0, reference_root)
    if "whisper" not in sys.modules:
        try:
            import whisper  # noqa: F401
        except ImportError:
            import types

            w = types.ModuleType("whisper")
            wt = types.ModuleType("whisper.tokenizer")

            class _Tok:
                def __init__(self, encoding, **kw):
                    self.encoding = encoding

            wt.Tokenizer = _Tok
            w.tokenizer = wt
            sys.modules["whisper"] = w
            sys.modules["whisper.tokenizer"] = wt
    import importlib

    return importlib.import_module("cosyvoice.tokenizer.tokenizer")


def default_reference_root() -> str | None:
    """$COSYVOICE_REF when it names a directory, else None."""
    root = os.environ.get("COSYVOICE_REF")
    if root and os.path.isdir(root):
        return root
    return None


def check_tokenizer_parity(
    tok_dir: str,
    version: str = "cosyvoice3",
    reference_root: str | None = None,
) -> dict:
    """Run the self-check (and reference byte-equality when available).

    Returns {"version", "vocab_size", "n_specials", "base_vocab",
    "self_check": "ok", "reference": "ok"|"unavailable",
    "corpus_texts", "corpus_ids"}; raises AssertionError with a precise
    message on any violation."""
    ours = QwenTTSTokenizer(tok_dir, skip_special_tokens=True, version=version)
    specials = list(ours.special_tokens["additional_special_tokens"])
    hf = ours.tokenizer

    # -- self-check: one id per special, sequential in list order ------------
    ids = []
    for s in specials:
        enc = hf.convert_tokens_to_ids(s)
        assert isinstance(enc, int) and enc >= 0, f"special {s!r} missing an id"
        one = ours.encode(s)
        assert list(one) == [enc], f"special {s!r} must encode to ONE id, got {one}"
        ids.append(enc)
    # specials NOT already in the pristine asset must get ids assigned
    # sequentially in LIST order starting at the base vocab size — the HF
    # add_special_tokens contract converted checkpoints' embedding rows
    # rely on (a reordered list silently shifts every new special id)
    from transformers import AutoTokenizer

    base_len = len(AutoTokenizer.from_pretrained(tok_dir))
    new_ids = [i for i in ids if i >= base_len]
    assert new_ids == list(range(base_len, base_len + len(new_ids))), (
        f"newly-added special ids are not sequential in list order from "
        f"base vocab size {base_len}: {new_ids[:8]}..."
    )
    for s in (specials[0], specials[-1]):
        rt = hf.batch_decode([[hf.convert_tokens_to_ids(s)]], skip_special_tokens=False)[0]
        assert s in rt, f"special {s!r} does not survive decode (got {rt!r})"

    corpus = parity_corpus(ours)
    corpus_ids = [list(ours.encode(t)) for t in corpus]

    result = {
        "version": version,
        "vocab_size": len(hf),
        "n_specials": len(specials),
        "self_check": "ok",
        "reference": "unavailable",
        "corpus_texts": len(corpus),
        "corpus_ids": sum(len(x) for x in corpus_ids),
    }

    # -- reference byte-equality ---------------------------------------------
    reference_root = reference_root or default_reference_root()
    if reference_root:
        ref_mod = _import_reference_tokenizer(reference_root)
        ref_cls = ref_mod.CosyVoice3Tokenizer if version == "cosyvoice3" else ref_mod.CosyVoice2Tokenizer
        theirs = ref_cls(tok_dir, skip_special_tokens=True)
        ref_specials = list(theirs.special_tokens["additional_special_tokens"])
        assert specials == ref_specials, (
            "special-token LIST diverges from the reference class: first delta at index "
            f"{next(i for i, (a, b) in enumerate(zip(specials, ref_specials)) if a != b)}"
        )
        assert len(hf) == len(theirs.tokenizer), "vocab size diverges from reference"
        for s in specials:
            a, b = hf.convert_tokens_to_ids(s), theirs.tokenizer.convert_tokens_to_ids(s)
            assert a == b, f"special {s!r} id diverges: ours {a} vs reference {b}"
        for text, ours_ids in zip(corpus, corpus_ids):
            ref_ids = list(theirs.encode(text))
            assert ours_ids == ref_ids, (
                f"encoding diverges from reference on {text[:60]!r}: "
                f"ours {ours_ids[:12]}... vs reference {ref_ids[:12]}..."
            )
        result["reference"] = "ok"
    return result


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tokenizer_dir", required=True, help="dir with real Qwen tokenizer assets")
    ap.add_argument("--version", default="cosyvoice3", choices=["cosyvoice2", "cosyvoice3"])
    ap.add_argument("--reference_root", default=None,
                    help="CosyVoice reference checkout for byte-equality (default: $COSYVOICE_REF)")
    args = ap.parse_args(argv)
    res = check_tokenizer_parity(args.tokenizer_dir, args.version, args.reference_root)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
