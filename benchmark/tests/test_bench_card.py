"""The control of each cell of BENCHMARK.json on the card, at the cell's own
size: the program's int8 path (CosyVoice3) or the int8 reference in its
place (CosyVoice2) must come out not correct. Skips without an NVIDIA card.

    python -m pytest benchmark/tests -m card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 4242),
                          "--seconds", "20", "--trace", "0", "--control", "int8"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["check"]
