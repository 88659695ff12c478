"""Run one benchmark cell once on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (import, CUDA, weights made from the seed, the models, the cell's
warm-up) counts in `setup_s`; then the traffic runs for `--seconds`; then,
with the program freed, a sample of its outputs is held against the
float32 references. The last line of standard output is one JSON object;
earlier lines and the numbers compared go to standard error. `--control
int8` runs the program's int8 path in place of the served one (the check
must then fail); a run never takes it by itself.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout; no library pulls in JAX
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"

from benchmark.harness import Cell, Trace, forbidden_modules, note  # noqa: E402


def card_lines(torch) -> None:
    """The card's name and power limit, and the host's cost of one eager launch."""
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        note(f"card: {q.stdout.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        note(f"card: nvidia-smi unavailable ({e})")
    x = torch.zeros(1, device="cuda")
    for _ in range(50):
        x.add_(1.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    torch.cuda.synchronize()
    note(f"host launch probe: {(time.perf_counter() - t) / 2000 * 1e6:.2f} us an eager launch")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: str | None = None, after_build=None) -> dict | None:
    """One run of `cell`; the result object, or None where the process
    loaded a module it must not (named on standard error)."""
    import torch

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    note(f"set-up: {time.perf_counter() - t_start:.3f} s to torch and the device")
    system = cell.system.System(cell.config, seed, device, cell.spec["params"])
    system.build()
    if control:
        system.control(control)
    if after_build is not None:
        after_build(system)
    sync()
    t_built = time.perf_counter()
    inputs = cell.traffic.generate(cell.spec["params"], seed)
    cell.traffic.warm(system, inputs)
    sync()
    note(f"set-up: {t_built - t_start:.3f} s to the built models, {time.perf_counter() - t_built:.3f} s of warm-up")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    tr = Trace() if trace else None
    if tr is not None:
        tr.start()
    window = cell.traffic.drive(system, inputs, seconds, sync, on_close=tr.stop if tr is not None else None)
    window_s = window["t1"] - window["t0"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = cell.traffic.end_to_end(window, system.sample_rate)
    note(f"window: {window_s:.3f} s, {cell.traffic.counts(window)}")

    result_metrics: dict = {}
    breakdown = None
    if trace:
        spans = [dict(s, device_ms=system.spans.device_ms(s)) for s in system.spans.items
                 if window["t0"] <= s["t0"] <= window["t1"]]
        ctx = {"cell": cell.name, "spans": spans, "work": cell.traffic.work(system, inputs, window),
               "trace": tr, "window_s": window_s}
        for m in cell.per_layer():
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        for line in ctx.get("notes", []):
            note(line)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps(system.spans)}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end():
            if m["name"] in values:
                result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    for k, v in e2e.items():
        note(f"{k}: {v}")

    attempted, failed, numbers = cell.traffic.check(system, inputs, window)
    limits = cell.spec["limits"]
    check = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and attempted > 0 and all(v <= limits[k] for k, v in numbers.items())
    if cuda:
        card_lines(torch)
    bad = forbidden_modules()
    if bad:
        note(f"refused: the process loaded {', '.join(bad)}")
        return None

    dev = {"platform": "gpu" if cuda else device.type, "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": result_metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    note(f"attempted {attempted}, failed {failed}, correct {correct}")
    for k, c in check.items():
        note(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("int8",), default=None)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    chips = next(w["chips"] for w in cell.bench["workloads"] if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        note(f"refused: this cell needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), T_START,
                      control=args.control)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
