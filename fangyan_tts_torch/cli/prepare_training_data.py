"""Training-data preparer: instruct generation, MP3→WAV conversion, dialect
merging, and integrity validation.

Flag-compatible with the reference's prepare_training_data.py (modes
all/instruct/combine/convert/validate; --dataset-dir/--dialects/
--combined-name/--workers/--no-convert/--extra-dirs/--force-instruct/
--output-dir). Output files are byte-compatible Kaldi dirs.

Difference from the reference: paths are resolved relative to CWD (not the
script's directory) so the CLI works installed as a module. The port's copy
of fangyan_tts_tpu/cli/prepare_training_data.py (host only):

python -m fangyan_tts_torch.cli.prepare_training_data --mode all --dataset-dir dataset
"""

from __future__ import annotations

import argparse
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

from ..data.audio import ffmpeg_to_wav16k
from ..data.kaldi_io import list_dialect_dirs, read_spk2utt, validate_dir

SAMPLE_RATE = 16000
COMBINED_DIR = "combined"

# Per-dialect Chinese instructions (prepare_training_data.py:37-68)
INSTRUCT_TEMPLATES = {
    "dongbei": "请用东北话说。<|endofprompt|>",
    "tianjin": "请用天津话说。<|endofprompt|>",
    "xian": "请用西安话说。<|endofprompt|>",
    "henan": "请用河南话说。<|endofprompt|>",
    "zhengzhou": "请用郑州话说。<|endofprompt|>",
    "sichuan": "请用四川话说。<|endofprompt|>",
    "chuanyu": "请用川渝方言说。<|endofprompt|>",
    "chongqing": "请用重庆话说。<|endofprompt|>",
    "hunan": "请用湖南话说。<|endofprompt|>",
    "changsha": "请用长沙话说。<|endofprompt|>",
    "hunan_pu": "请用湖南普通话说。<|endofprompt|>",
    "cantonese": "请用粤语说。<|endofprompt|>",
    "yueyu": "请用粤语说。<|endofprompt|>",
    "guangxi": "请用广西话说。<|endofprompt|>",
    "shanghai": "请用上海话说。<|endofprompt|>",
    "emotion": "请用普通话说。<|endofprompt|>",
    "default": "请用方言说。<|endofprompt|>",
}

DIALECT_NAMES = {
    "dongbei": "东北话", "tianjin": "天津话", "xian": "西安话", "henan": "河南话",
    "zhengzhou": "郑州话", "sichuan": "四川话", "hunan": "湖南话", "hunan_pu": "湖南普通话",
    "cantonese": "粤语", "guangxi": "广西话", "shanghai": "上海话", "emotion": "情感",
}


def generate_instruct_file(data_dir: Path, dialect: str, force: bool = False) -> int:
    text_file = data_dir / "text"
    instruct_file = data_dir / "instruct"
    instruct_txt = data_dir / "instruct.txt"
    if not text_file.exists():
        print(f"  ❌ 错误: {text_file} 不存在")
        return 0
    if not force:
        if instruct_file.exists():
            count = sum(1 for _ in open(instruct_file, encoding="utf-8"))
            print(f"  ⏭️ 跳过: instruct 已存在 ({count} 条)")
            return count
        if instruct_txt.exists():
            shutil.copy(instruct_txt, instruct_file)
            count = sum(1 for _ in open(instruct_file, encoding="utf-8"))
            print(f"  ✅ 复制 instruct.txt -> instruct ({count} 条)")
            return count
    template = INSTRUCT_TEMPLATES.get(dialect, INSTRUCT_TEMPLATES["default"])
    count = 0
    with open(text_file, encoding="utf-8") as fin, open(instruct_file, "w", encoding="utf-8") as fout:
        for line in fin:
            parts = line.strip().split(maxsplit=1)
            if parts:
                fout.write(f"{parts[0]} {template}\n")
                count += 1
    print(f"  ✅ 生成 instruct: {count} 条 (指令: {template[:20]}...)")
    return count


def convert_audio_files(data_dir: Path, num_workers: int = 4) -> tuple[int, int]:
    """MP3→WAV with wav.scp rewrite + .bak (prepare_training_data.py:361-420)."""
    wav_scp = data_dir / "wav.scp"
    if not wav_scp.exists():
        print(f"  ❌ 错误: {wav_scp} 不存在")
        return 0, 0
    jobs = []
    with open(wav_scp, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2 and parts[1].endswith(".mp3"):
                jobs.append((parts[1], parts[1].replace(".mp3", ".wav")))
    if not jobs:
        print("  ⚠️ 没有需要转换的 MP3 文件")
        return 0, 0
    ok = bad = 0
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        futures = [ex.submit(ffmpeg_to_wav16k, s, d, SAMPLE_RATE) for s, d in jobs]
        for fut in as_completed(futures):
            success, _ = fut.result()
            ok += success
            bad += not success
    print(f"  ✅ 转换完成: 成功 {ok}, 失败 {bad}")
    if ok:
        new = data_dir / "wav.scp.new"
        with open(wav_scp, encoding="utf-8") as fin, open(new, "w", encoding="utf-8") as fout:
            for line in fin:
                parts = line.strip().split()
                if len(parts) >= 2:
                    fout.write(f"{parts[0]} {parts[1].replace('.mp3', '.wav')}\n")
        bak = data_dir / "wav.scp.bak"
        if not bak.exists():
            shutil.copy(wav_scp, bak)
        shutil.move(new, wav_scp)
        print("  ✅ 更新 wav.scp 指向 WAV 文件")
    return ok, bad


def combine_dialect_data(dataset_dir: Path, dialects: list[str], combined_dir: Path, extra_dirs=None) -> dict:
    """Merge per-dialect Kaldi dirs (+extra dirs) into combined/
    (prepare_training_data.py:174-358)."""
    print(f"\n📦 合并方言数据到: {combined_dir}")
    combined_dir.mkdir(parents=True, exist_ok=True)
    files_to_merge = ["wav.scp", "text", "utt2spk", "instruct"]
    merged: dict[str, list[str]] = {f: [] for f in files_to_merge}
    spk2utt: dict[str, list[str]] = {}
    stats = {"total_utts": 0, "total_speakers": 0, "dialects_processed": 0}

    def absorb(d: Path, allow_txt_suffix: bool = False) -> None:
        count = 0
        for fname in files_to_merge:
            p = d / fname
            if allow_txt_suffix and not p.exists():
                p = d / f"{fname}.txt"
            if p.exists():
                for line in open(p, encoding="utf-8"):
                    line = line.strip()
                    if line:
                        merged[fname].append(line)
                        if fname == "text":
                            count += 1
        s2u = d / "spk2utt"
        if s2u.exists():
            for spk, utts in read_spk2utt(s2u).items():
                spk2utt.setdefault(spk, []).extend(utts)
        stats["total_utts"] += count
        stats["dialects_processed"] += 1
        print(f"     语音数: {count}")

    for dialect in dialects:
        d = dataset_dir / dialect
        if dialect in (COMBINED_DIR, "combined"):
            print("  ⏭️ 跳过 combined 目录")
            continue
        if not d.exists():
            print(f"  ⚠️ 跳过不存在的目录: {dialect}")
            continue
        if not (d / "text").exists():
            print(f"  ⚠️ 跳过 {dialect}: 缺少 text 文件")
            continue
        print(f"  📂 处理 {dialect}...")
        absorb(d)

    for extra in extra_dirs or []:
        p = Path(extra)
        if not p.exists():
            print(f"  ⚠️ 跳过不存在的目录: {extra}")
            continue
        if p.name in (COMBINED_DIR, "combined"):
            continue
        if not (p / "text").exists():
            print(f"  ⚠️ 跳过 {p.name}: 缺少 text 文件")
            continue
        print(f"  📂 处理 {p.name}...")
        absorb(p, allow_txt_suffix=True)

    print("\n  📝 写入合并文件...")
    for fname, lines in merged.items():
        if lines:
            with open(combined_dir / fname, "w", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
            print(f"     {fname}: {len(lines)} 行")
    if spk2utt:
        with open(combined_dir / "spk2utt", "w", encoding="utf-8") as f:
            for spk in sorted(spk2utt):
                f.write(f"{spk} {' '.join(spk2utt[spk])}\n")
        stats["total_speakers"] = len(spk2utt)
        print(f"     spk2utt: {len(spk2utt)} 个说话人")
    print(f"\n  ✅ 合并完成!\n     方言数: {stats['dialects_processed']}\n     语音总数: {stats['total_utts']}\n     说话人数: {stats['total_speakers']}")
    return stats


def print_validation(data_dir: Path, name: str = "") -> dict:
    r = validate_dir(data_dir)
    print(f"\n  📁 {name or data_dir.name}")
    print("  必需文件:")
    for f in ("wav.scp", "text", "utt2spk", "spk2utt"):
        status = "✅" if r[f] else "❌"
        lc = r["line_counts"].get(f)
        print(f"    {status} {f}" + (f" ({lc} 行)" if lc is not None else ""))
    print("  可选文件:")
    for f in ("instruct", "utt2embedding.pt", "spk2embedding.pt", "utt2speech_token.pt"):
        print(f"    {'✅' if r[f] else '⚪'} {f}")
    return r


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="方言训练数据准备脚本")
    parser.add_argument("--mode", choices=["all", "instruct", "combine", "convert", "validate"], default="all")
    parser.add_argument("--dataset-dir", default="dataset")
    parser.add_argument("--dialects", nargs="*", default=None)
    parser.add_argument("--combined-name", default=COMBINED_DIR)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--no-convert", action="store_true")
    parser.add_argument("--extra-dirs", nargs="*", default=[])
    parser.add_argument("--force-instruct", action="store_true")
    parser.add_argument("--output-dir", default=None)
    args = parser.parse_args(argv)

    dataset_dir = Path(args.dataset_dir)
    combined_dir = Path(args.output_dir) if args.output_dir else dataset_dir / args.combined_name
    dialects = args.dialects if args.dialects else list_dialect_dirs(dataset_dir, exclude=(args.combined_name, COMBINED_DIR))

    print("=" * 60)
    print("🗣️  方言训练数据准备脚本 (PyTorch port)")
    print("=" * 60)
    print(f"模式: {args.mode}\n数据集目录: {dataset_dir}\n检测到方言: {len(dialects)} 个")
    for d in dialects:
        print(f"  - {d} ({DIALECT_NAMES.get(d, d)})")
    print(f"合并目录: {combined_dir}")
    print("=" * 60)
    if not dialects and not (args.mode == "validate" and combined_dir.exists()):
        # validate-mode runs on a combined-only tree (recipe stage 0 checks
        # the merged dir after per-dialect prep happened elsewhere)
        print("❌ 没有找到任何方言数据目录")
        sys.exit(1)

    if args.mode in ("all", "instruct"):
        print("\n📝 生成 instruct 文件（中文指令）")
        for dialect in dialects:
            d = dataset_dir / dialect
            if d.exists():
                print(f"\n处理 {dialect} ({DIALECT_NAMES.get(dialect, dialect)}):")
                generate_instruct_file(d, dialect, force=args.force_instruct)
        for extra in args.extra_dirs:
            p = Path(extra)
            if p.exists():
                print(f"\n处理额外目录 {p.name}:")
                generate_instruct_file(p, p.name, force=args.force_instruct)

    if args.mode in ("all", "convert") and not args.no_convert:
        print("\n🎵 转换音频文件 (MP3 -> WAV)")
        if not shutil.which("ffmpeg"):
            print("\n⚠️ 未找到 ffmpeg，跳过音频转换")
        else:
            for dialect in dialects:
                d = dataset_dir / dialect
                if d.exists():
                    print(f"\n处理 {dialect}:")
                    convert_audio_files(d, args.workers)

    if args.mode in ("all", "combine"):
        print("\n📦 合并所有方言数据")
        extra_paths = [Path(e) for e in args.extra_dirs if Path(e).exists()]
        combine_dialect_data(dataset_dir, dialects, combined_dir, extra_dirs=extra_paths)

    if args.mode in ("all", "validate"):
        print("\n🔍 验证数据完整性")
        for dialect in dialects:
            d = dataset_dir / dialect
            if d.exists():
                print_validation(d, DIALECT_NAMES.get(dialect, dialect))
        if combined_dir.exists():
            print_validation(combined_dir, "合并数据 (combined)")

    print("\n✅ 准备完成!")


if __name__ == "__main__":
    main()
