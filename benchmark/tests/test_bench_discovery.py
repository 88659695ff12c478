"""A configuration, a cell, a traffic kind and a per-layer metric added as
new files, with their entries in BENCHMARK.json, are found by the harness
by name, with no edit to a file that is there."""

import json
import shutil
from pathlib import Path

from benchmark.harness import Cell

BENCH = Path(__file__).resolve().parents[1]


def test_new_files_are_found(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}

    cfg = json.loads((root / "configs" / "cosyvoice3-0.5b.json").read_text())
    cfg["name"] = "cosyvoice3-0.5b-int8"
    (root / "configs" / "cosyvoice3-0.5b-int8.json").write_text(json.dumps(cfg))
    (root / "traffic" / "replay_once.py").write_text(
        "from benchmark.traffic.batch_offline import *  # noqa: F401,F403\n"
        "KIND = 'replay_once'\n")
    cell = json.loads((root / "workloads" / "cv3.datagen_b16.json").read_text())
    cell.update(config="cosyvoice3-0.5b-int8", traffic="replay_once")
    (root / "workloads" / "cv3.replay_b16.json").write_text(json.dumps(cell))
    (root / "metrics" / "rows_per_step.replay.py").write_text("def read(ctx):\n    return 42.0\n")
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="cosyvoice3-0.5b-int8",
                                 file="benchmark/configs/cosyvoice3-0.5b-int8.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="cv3.replay_b16", config="cosyvoice3-0.5b-int8",
                                   traffic="replay_once"))
    bench["per_layer"].append({"name": "rows_per_step.replay", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "LLM scheduler", "moves": "audio_s_per_s",
                               "workloads": ["cv3.replay_b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = Cell("cv3.replay_b16", root=root)
    assert found.config["name"] == "cosyvoice3-0.5b-int8"
    assert found.traffic.KIND == "replay_once" and callable(found.traffic.generate)
    assert found.system.System.__name__ == "System"
    assert [m["name"] for m in found.per_layer()] == ["rows_per_step.replay"]
    assert [m["name"] for m in found.end_to_end()] == ["audio_s_per_s", "setup_s"]
    assert found.reader("rows_per_step.replay")({}) == 42.0
    old = Cell("cv3.datagen_b16", root=root)  # the cells that were there keep their metrics
    assert "rows_per_step.replay" not in [m["name"] for m in old.per_layer()]
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed
