"""Per-dialect audio duration statistics.

Flag- and output-compatible with the reference's stats_duration.py
(table or --json; scans <dataset-dir>/<dialect>/wavs/*.{mp3,wav};
backend chain mutagen -> pydub -> ffprobe, plus a native stdlib WAV reader).
The port's copy of fangyan_tts_tpu/cli/stats_duration.py (host only).
Run: python -m fangyan_tts_torch.cli.stats_duration --dataset-dir dataset [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

from ..data.audio import audio_duration


@dataclass
class AudioStats:
    dialect: str
    file_count: int = 0
    total_duration_seconds: float = 0.0
    average_duration_seconds: float = 0.0
    min_duration_seconds: float = 0.0
    max_duration_seconds: float = 0.0
    failed_files: list[str] = field(default_factory=list)


def format_duration(seconds: float) -> str:
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    s = int(seconds % 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


def scan_dialect_directory(dialect_dir: Path, detailed: bool = False) -> AudioStats:
    name = dialect_dir.name
    wavs_dir = dialect_dir / "wavs"
    if not wavs_dir.exists():
        return AudioStats(dialect=name)
    audio_files = sorted(wavs_dir.glob("*.mp3")) + sorted(wavs_dir.glob("*.wav"))
    durations, failed = [], []
    for i, f in enumerate(audio_files):
        d = audio_duration(f)
        if d > 0:
            durations.append(d)
        else:
            failed.append(f.name)
        if detailed and (i + 1) % 100 == 0:
            print(f"  [{name}] 已处理 {i + 1}/{len(audio_files)} 个文件...")
    if not durations:
        return AudioStats(dialect=name, file_count=len(audio_files), failed_files=failed)
    total = sum(durations)
    return AudioStats(
        dialect=name,
        file_count=len(durations),
        total_duration_seconds=total,
        average_duration_seconds=total / len(durations),
        min_duration_seconds=min(durations),
        max_duration_seconds=max(durations),
        failed_files=failed,
    )


def print_stats_table(stats_list: list[AudioStats]) -> None:
    print("\n" + "=" * 80)
    print("📊 方言数据集时长统计")
    print("=" * 80)
    print(f"{'方言':<10} {'文件数':>10} {'总时长':>15} {'平均时长':>12} {'最短':>10} {'最长':>10}")
    print("-" * 80)
    total_files, total_seconds = 0, 0.0
    for s in stats_list:
        if s.file_count > 0:
            print(
                f"{s.dialect:<10} {s.file_count:>10} {format_duration(s.total_duration_seconds):>15} "
                f"{s.average_duration_seconds:>10.2f}s {s.min_duration_seconds:>9.2f}s {s.max_duration_seconds:>9.2f}s"
            )
            total_files += s.file_count
            total_seconds += s.total_duration_seconds
        else:
            print(f"{s.dialect:<10} {'无数据':>10}")
    print("-" * 80)
    if total_files:
        print(f"{'合计':<10} {total_files:>10} {format_duration(total_seconds):>15} {total_seconds / total_files:>10.2f}s")
    print("=" * 80)
    for s in stats_list:
        if s.failed_files:
            print(f"\n⚠️  [{s.dialect}] {len(s.failed_files)} 个文件读取失败:")
            for f in s.failed_files[:5]:
                print(f"   - {f}")
            if len(s.failed_files) > 5:
                print(f"   ... 还有 {len(s.failed_files) - 5} 个")


def print_stats_json(stats_list: list[AudioStats]) -> None:
    result = {"dialects": [], "summary": {"total_files": 0, "total_duration_seconds": 0.0, "total_duration_formatted": ""}}
    for s in stats_list:
        result["dialects"].append(
            {
                "name": s.dialect,
                "file_count": s.file_count,
                "total_duration_seconds": round(s.total_duration_seconds, 2),
                "total_duration_formatted": format_duration(s.total_duration_seconds),
                "average_duration_seconds": round(s.average_duration_seconds, 2),
                "min_duration_seconds": round(s.min_duration_seconds, 2),
                "max_duration_seconds": round(s.max_duration_seconds, 2),
                "failed_files_count": len(s.failed_files),
            }
        )
        result["summary"]["total_files"] += s.file_count
        result["summary"]["total_duration_seconds"] += s.total_duration_seconds
    result["summary"]["total_duration_seconds"] = round(result["summary"]["total_duration_seconds"], 2)
    result["summary"]["total_duration_formatted"] = format_duration(result["summary"]["total_duration_seconds"])
    print(json.dumps(result, ensure_ascii=False, indent=2))


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="方言数据集时长统计脚本")
    parser.add_argument("--dataset-dir", default="dataset")
    parser.add_argument("--dialect", type=str, default=None)
    parser.add_argument("--detailed", action="store_true")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    dataset_dir = Path(args.dataset_dir)
    if not dataset_dir.exists():
        print(f"❌ 错误: 数据集目录不存在: {dataset_dir}")
        sys.exit(1)
    if args.dialect:
        dialect_dirs = [dataset_dir / args.dialect]
        if not dialect_dirs[0].exists():
            print(f"❌ 错误: 方言目录不存在: {dialect_dirs[0]}")
            sys.exit(1)
    else:
        dialect_dirs = [d for d in dataset_dir.iterdir() if d.is_dir() and not d.name.startswith(".")]
    if not dialect_dirs:
        print("❌ 没有找到方言目录")
        sys.exit(1)

    stats_list = [scan_dialect_directory(d, detailed=args.detailed) for d in sorted(dialect_dirs)]
    if args.json:
        print_stats_json(stats_list)
    else:
        print_stats_table(stats_list)


if __name__ == "__main__":
    main()
