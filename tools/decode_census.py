"""Census of one replayed decode step of a benchmark cell on the card.

    python3 tools/decode_census.py --workload cv3.datagen_b16 [--root DIR] [--label NAME] [--seed N]

Builds the cell's system from the seed as `benchmark/run.py` does, warms
it (which captures the CUDA graphs of its longest and shortest batches'
decode buckets, models/decode_graphs), then runs its longest batch once
more, so that every decode step is a graph replay. One replay (`--step`)
runs under torch.profiler (device activity only): every device operation
of the step by name, with its count and device µs. Every other
replay is timed by CUDA events around it, which gives the step's untraced
device time. `--root` names the checkout whose program and benchmark build
the cell (default: this one), so that another commit, unpacked into a
directory, is counted by the same tool. Writes
chiprun_out/census/<cell>.<label>.json and prints a summary.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def profile_step(fn) -> dict:
    """fn() under torch.profiler, device activity only: its device ops, their
    summed device ms, and [name, us, count] for each kernel name, the
    longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    us, calls = collections.Counter(), collections.Counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
    return dict(device_ops=sum(calls.values()), device_ms=sum(us.values()) / 1e3,
                kernels=[dict(name=k, us=v, count=calls[k]) for k, v in us.most_common()])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--root", default=str(HERE), help="the checkout whose program and benchmark run")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=2147483701)
    ap.add_argument("--step", type=int, default=40, help="the replay of the batch that is profiled")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / sub)
    import torch

    from benchmark.harness import Cell
    from fangyan_tts_torch.models import decode_graphs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    cell = Cell(args.workload, root=root / "benchmark")
    params = cell.spec["params"]
    t0 = time.perf_counter()
    system = cell.system.System(cell.config, args.seed, torch.device("cuda"), params)
    system.build()
    inputs = cell.traffic.generate(params, args.seed)
    cell.traffic.warm(system, inputs)
    torch.cuda.synchronize()
    print(f"{args.workload} ({args.label}): built and warmed in {time.perf_counter() - t0:.1f} s [{card}]")

    longest = max(inputs["batches"], key=lambda b: max(len(t) for t in b))
    seen = {"n": 0, "events": [], "profile": None}
    replay = decode_graphs.Bucket.replay

    def counted(bucket):
        seen["n"] += 1
        if seen["n"] == args.step:
            seen["profile"] = profile_step(lambda: replay(bucket))
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        replay(bucket)
        end.record()
        seen["events"].append((start, end))

    decode_graphs.Bucket.replay = counted
    try:
        system.batch(longest, inputs["prompt"], inputs["ratio"])
    finally:
        decode_graphs.Bucket.replay = replay
    torch.cuda.synchronize()
    if seen["profile"] is None:
        raise RuntimeError(f"the batch replayed {seen['n']} decode steps, fewer than --step {args.step}")
    ms = [s.elapsed_time(e) for s, e in seen["events"]]
    prof = seen["profile"]
    out = dict(workload=args.workload, label=args.label, card=card, seed=args.seed, replays=seen["n"],
               step_device_ms_untraced=dict(median=statistics.median(ms), mean=statistics.fmean(ms), min=min(ms),
                                            max=max(ms), n=len(ms)),
               traced_step=prof)
    dest = HERE / "chiprun_out" / "census"
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.workload}.{args.label}.json").write_text(json.dumps(out, indent=1))
    print(f"{args.workload} ({args.label}): {seen['n']} replays; untraced step device ms median "
          f"{out['step_device_ms_untraced']['median']:.4f} (min {min(ms):.4f}, max {max(ms):.4f}); traced step "
          f"{prof['device_ops']} device ops, {prof['device_ms']:.4f} ms busy [{card}]")
    for k in out["traced_step"]["kernels"]:
        print(f"    {k['count']:5d} x {k['us'] / k['count']:8.2f} us = {k['us']:9.2f} us  {k['name'][:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
