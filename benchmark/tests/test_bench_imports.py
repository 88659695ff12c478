"""Nothing the benchmark runs imports JAX or the JAX package, top-level names
compared whole; the references import nothing of the system under test."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_sources_import_no_jax():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & set(FORBIDDEN), p


def test_references_import_nothing_of_the_system():
    for p in (BENCH / "reference").rglob("*.py"):
        mods = _imports(p)
        assert not {m for m in mods if m.split(".")[0] == "fangyan_tts_torch"}, p
        assert not {m for m in mods if m.startswith("benchmark.") and not m.startswith("benchmark.reference")}, p


def test_forbidden_names_are_compared_whole():
    fake = ["fangyan_tts_tpu_extra", "jaxtyping", "jax.numpy"]
    try:
        for name in fake:
            sys.modules.setdefault(name, type(sys)(name))
        found = forbidden_modules()
        assert "jax" in found
        assert "fangyan_tts_tpu_extra" not in found and "jaxtyping" not in found
        assert "fangyan_tts_torch" not in found
    finally:
        for name in fake:
            sys.modules.pop(name, None)


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(BENCH.parent)!r}); sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "import benchmark.run\n"
        "from benchmark.harness import Cell, forbidden_modules\n"
        "from conftest import tiny_config\n"
        "cell = Cell('cv3.datagen_b16')\n"
        "s = cell.system.System(tiny_config(cell.config), 5, torch.device('cpu'))\n"
        "s.build()\n"
        "s.batch([torch.arange(3).numpy()], {'xvec': torch.ones(192).numpy(), 'instruct': torch.arange(2).numpy(),"
        " 'flow_tokens': torch.arange(4).numpy(), 'feat': torch.zeros(8, 80).numpy()}, 2.0)\n"
        "s.free(); s.references()\n"
        "print(forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
