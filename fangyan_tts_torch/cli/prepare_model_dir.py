"""One-shot model-dir conversion (the port's copy of
fangyan_tts_tpu/cli/prepare_model_dir.py): a reference CosyVoice download
becomes a directory that the port's api.AutoModel loads.

Converts whatever is present:
  llm.pt / flow.pt / hift.pt     -> llm/flow/hift.msgpack (family-aware)
  campplus.onnx                  -> campplus.msgpack
  speech_tokenizer_v*.onnx       -> s3tokenizer.msgpack
  cosyvoice*.yaml                -> config.json (family version + scalars)
Tokenizer assets (tokenizer/, CosyVoice-BlankEN/, *.tiktoken) are used in
place — nothing to convert. Runs on the host only (no model is loaded).

Run: python -m fangyan_tts_torch.cli.prepare_model_dir --model_dir <dir>
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def detect_version(d: Path) -> int:
    if (d / "config.json").exists():
        return json.loads((d / "config.json").read_text()).get("version", 3)
    for v, name in ((3, "cosyvoice3.yaml"), (2, "cosyvoice2.yaml"), (1, "cosyvoice.yaml")):
        if (d / name).exists():
            return v
    return 3


def prepare_model_dir(model_dir: str, force: bool = False) -> dict:
    """Convert everything convertible in `model_dir`; returns a report dict."""
    from ..config import _to_jsonable, load_reference_yaml
    from ..models import convert as C
    from ..train.checkpoint import save_params

    d = Path(model_dir)
    version = detect_version(d)
    report: dict = {"version": version, "converted": [], "skipped": []}

    def _save(name: str, params) -> None:
        save_params(d / f"{name}.msgpack", params)
        report["converted"].append(f"{name}.msgpack")

    def _want(name: str) -> bool:
        if (d / f"{name}.msgpack").exists() and not force:
            report["skipped"].append(f"{name}.msgpack (exists)")
            return False
        return True

    # torch checkpoints (family-aware converters)
    conv = {
        3: {"llm": C.llm_params_from_reference, "flow": C.flow_params_from_reference,
            "hift": C.hift_params_from_reference},
        2: {"llm": C.llm_v2_params_from_reference, "flow": C.flow_v2_params_from_reference,
            "hift": lambda sd: C.hift_nc_params_from_reference(sd)},
        1: {"llm": C.llm_v1_params_from_reference, "flow": C.flow_v1_params_from_reference,
            "hift": lambda sd: C.hift_nc_params_from_reference(sd, upsample_rates=(8, 8))},
    }[version]
    for name, fn in conv.items():
        pt = d / f"{name}.pt"
        if pt.exists() and _want(name):
            import torch

            sd = C.filter_training_meta(torch.load(pt, map_location="cpu", weights_only=False))
            _save(name, fn(sd))

    # ONNX frontends
    if (d / "campplus.onnx").exists() and _want("campplus"):
        _save("campplus", C.campplus_params_from_onnx(str(d / "campplus.onnx")))
    for onnx in sorted(d.glob("speech_tokenizer_v*.onnx"), reverse=True):
        if _want("s3tokenizer"):
            params, hyper = C.s3_params_from_onnx(str(onnx))
            _save("s3tokenizer", params)
            report["s3_hyperparams"] = hyper
        break

    # config.json from the family yaml scalars
    if not (d / "config.json").exists():
        yamls = [d / n for n in ("cosyvoice3.yaml", "cosyvoice2.yaml", "cosyvoice.yaml") if (d / n).exists()]
        if yamls:
            try:
                cfg = load_reference_yaml(str(yamls[0]))
                (d / "config.json").write_text(json.dumps({**_to_jsonable(cfg), "version": version}))
                report["converted"].append("config.json")
            except Exception as e:  # noqa: BLE001 — yaml optional; family presets cover defaults
                report["skipped"].append(f"config.json ({e})")
        else:
            report["skipped"].append("config.json (no family yaml; presets apply)")

    # real-vocab tokenizer parity evidence (tokenizer/parity.py): when the
    # download ships HF tokenizer assets, prove our CosyVoice2/3 special-id
    # layout on THOSE assets (and byte-equality vs the reference class when
    # a reference checkout is importable)
    if version >= 2:
        tok_dir = d / ("CosyVoice-BlankEN" if version == 2 and (d / "CosyVoice-BlankEN").exists()
                       else "tokenizer")
        if (tok_dir / "tokenizer.json").exists() or (tok_dir / "tokenizer_config.json").exists():
            from ..tokenizer.parity import check_tokenizer_parity

            try:
                report["tokenizer_parity"] = check_tokenizer_parity(
                    str(tok_dir), version=f"cosyvoice{version}")
            except AssertionError as e:
                report["tokenizer_parity"] = {"error": str(e)}
                raise
        else:
            report["skipped"].append("tokenizer_parity (no HF tokenizer assets)")
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--force", action="store_true", help="re-convert over existing msgpacks")
    args = ap.parse_args(argv)
    report = prepare_model_dir(args.model_dir, force=args.force)
    print(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
