"""Where the decode-attention kernel's time goes, on one CUDA card.

    python3 tools/decode_attention_sweep.py

Builds csrc/decode_attention.cu as it is and in variants with parts
compiled out (text edits of a copy, built with the same nvcc flags into
build/sweep/), and times each with CUDA-graph replay (chip_smoke.time_ms)
at the decode loop's shapes. Whole kernels, under every launch plan of 1 to
8 blocks a cluster, each checked against the plain version in float32:
  full      the kernel
  cpasync   K and V by 16-byte cp.async from every thread instead of TMA
  w4        at most 4 warps a block instead of 8
Parts compiled out, under the plan `plan` picks (outputs not right):
  noop      every thread returns at entry (the launch of the grid alone)
  loads     returns once its copies have landed (launch, loads, the wait)
  nomath    no scores or P.V (the partials, the pushes, the merges)
  nocombine rank 0 returns once the partials have arrived (no final merge)
Prints one line per (shape, plan, variant) and the card's name and power
limit.

    python3 tools/decode_attention_sweep.py --f32 [--root DIR]

The float32 route instead, at chip_smoke.py's float32 decode shapes
(`f32_decode_cases`): the route as the wrapper plans it, then, where the
checkout has `plan_f32`, every launch plan of 1 to 16 blocks a cluster
(runs of a multiple of 32 slots) through the C entry, each held to the
plain version in float64 within chip_smoke's DECODE_F32_ATOL. With
`--root DIR` the kernels and wrappers are those of the checkout at DIR
(`git archive` of a parent commit unpacked there), built under DIR.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (DECODE_F32_ATOL, FULL_LLM_LAYERS, card_line, f32_decode_cases,  # noqa: E402
                        f32_decode_inputs, time_ms)

if "--root" in sys.argv:  # the package of another checkout (chip_smoke above stays this one's)
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--root") + 1]).resolve()))

from fangyan_tts_torch.ops import _build  # noqa: E402
from fangyan_tts_torch.ops import decode_attention as da  # noqa: E402

SRC = _build.CSRC / "decode_attention.cu"
OUT = ROOT / "build" / "sweep"
EDITS = {
    "full": [],
    "noop": [("uint8_t smem_raw[];\n", "uint8_t smem_raw[];\n  if (p.S > 0) return;\n")],
    "loads": [("    cp_async_wait_all();\n", "    cp_async_wait_all();\n    if (p.S > 0) return;\n")],
    "nomath": [("grp < groups;", "grp < 0;")],
    "nocombine": [("  // rank 0: out =", "  if (p.S > 0) return;\n  // rank 0: out =")],
    # alternatives, each a whole kernel: K/V by 16-byte cp.async from every
    # thread (zeros past S) instead of TMA, the new row written over the old
    # once every thread's copies have landed; at most 4 warps a block
    "cpasync": [
        ("__device__ __forceinline__ void cp_async_wait_all()",
         "__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int n) {\n"
         "  asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n\" ::\"r\"(smem_u32(dst)), "
         "\"l\"(reinterpret_cast<uint64_t>(src)), \"r\"(n) : \"memory\");\n}\n"
         "__device__ __forceinline__ void cp_async_wait_all()"),
        ("    mbar_arrive_expect_tx(&bars[bi], 2 * lo.tile);\n",
         "    mbar_arrive(&bars[bi]);\n    if (p.S > 0) return;\n"),
        ("      else bs[r] = kNeg;\n    }\n",
         "      else bs[r] = kNeg;\n    }\n"
         "    const size_t rows0 = ((size_t)p.layer * p.B + b) * (size_t)S * p.KV * kHd + (size_t)kvh * kHd;\n"
         "    for (int j = tid; j < padded * 16; j += nthreads) {\n"
         "      const int row = j >> 4, v = (j >> 3) & 1, c16 = j & 7, in = r0 + row < S;\n"
         "      cp_async_16((v ? v_tile(c % lo.nbuf) : k_tile(c % lo.nbuf)) + swz(row, c16),"
         " (v ? p.cache_v : p.cache_k) + rows0 + (size_t)(in ? r0 + row : 0) * p.KV * kHd + c16 * 8,"
         " in ? 16 : 0);\n    }\n"),
        ("    mbar_wait(&bars[bi], (c / lo.nbuf) & 1);\n",
         "    cp_async_wait_all();\n    __syncthreads();\n    mbar_wait(&bars[bi], (c / lo.nbuf) & 1);\n"),
    ],
    "w4": [("constexpr int kMaxWarps = 8;", "constexpr int kMaxWarps = 4;")],
}
# the float32 route's parts compiled out (timed at the plan; outputs not right but in the whole kernels)
F32_EDITS = {
    "full": [],
    "noop": [("  const LayoutF32 lo = layout_f32(n, p.per, G);\n",
              "  if (p.S > 0) return;\n  const LayoutF32 lo = layout_f32(n, p.per, G);\n")],
    # launch, barriers, q, idx and the new row, no tile or bias copies
    # launch, barriers, the new row and idx, no tile, q or bias copies
    "init": [("    mbar_arrive_expect_tx(&bars[bi], 4 * lo.half);\n",
              "    if (p.S > 0) return;\n    mbar_arrive_expect_tx(&bars[bi], 4 * lo.half);\n"),
             ("    for (int r = tid; r < count; r += kF32Threads) cp_async_4(bs + r, src + r);\n", ""),
             ("  if (tid < kMaxG * 16) {\n", "  if (tid < 0) {\n"),
             ("  __syncthreads();  // the mbarriers are initialised\n",
              "  __syncthreads();  // the mbarriers are initialised\n  if (p.S > 0) return;\n")],
    # returns once the first chunk's tiles, q and bias have landed
    "wait": [("    if (owner && tid < 32 && slot >= r0 && slot < r0 + count) {  // the new row",
              "    if (p.S > 0) return;\n"
              "    if (owner && tid < 32 && slot >= r0 && slot < r0 + count) {  // the new row")],
    "loads": [("\n    // slot js's scores", "\n    if (p.S > 0) return;\n    // slot js's scores")],
    "scores": [("    __syncthreads();  // the warps' maxima are visible\n",
                "    if (p.S > 0) return;\n    __syncthreads();  // the warps' maxima are visible\n")],
    "probs": [("    __syncthreads();  // the probabilities are visible\n",
               "    if (p.S > 0) return;\n    __syncthreads();  // the probabilities are visible\n")],
    "nomath": [("    if (js < count) {\n#pragma unroll\n      for (int h = 0;",
                "    if (js < 0) {\n#pragma unroll\n      for (int h = 0;"),
               ("    for (int j = sub; j < count; j += 16) {", "    for (int j = sub; j < 0; j += 16) {")],
    "nopartial": [("  // the block's partial, in registers: a reduce-scatter",
                   "  if (p.S > 0) return;\n  // the block's partial, in registers: a reduce-scatter")],
    "nocombine": [("  // rank 0: out = sum_r w_r o_r / sum_r w_r l_r, w_r = 2^(m_r",
                   "  if (p.S > 0) return;\n  // rank 0: out = sum_r w_r o_r / sum_r w_r l_r, w_r = 2^(m_r")],
    # a whole kernel: at most 85 registers a thread, three blocks of 256 threads an SM
    "regs3": [("__global__ void __launch_bounds__(kF32Threads)\n",
               "__global__ void __launch_bounds__(kF32Threads, 3)\n")],
}
ALTERNATIVES = ("full", "cpasync", "w4")  # timed under every plan and checked; the rest only at the plan
SHAPES = [(1, 256), (4, 256), (1, 768), (16, 256), (16, 320), (1, 4096)]
PLAN_CLUSTERS = (1, 2, 3, 4, 5, 6, 7, 8)


def build(variant: str, edits: dict = EDITS, entry: str = "decode_attention"):
    text = SRC.read_text()
    for old, new in edits[variant]:
        if old not in text:
            raise RuntimeError(f"variant {variant}: anchor {old!r} not in {SRC}")
        text = text.replace(old, new, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{entry}_{variant}.cu"
    src.write_text(text)
    so = OUT / f"lib{entry}_{variant}.so"
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def main_f32() -> int:
    """The float32 route at chip_smoke's float32 decode shapes (see the
    module docstring)."""
    print(f"card: {card_line()}")
    print(f"package: {Path(da.__file__).resolve().parent.parent}")
    entry = _build.load("decode_attention_f32")
    fn = entry if hasattr(da, "plan_f32") else None  # a checkout whose float32 entry takes the plan
    variants = {}
    if fn is not None and SRC == ROOT / "fangyan_tts_torch" / "csrc" / "decode_attention.cu":
        jobs = {v: build(v, F32_EDITS, "decode_attention_f32") for v in F32_EDITS}
        for v, (proc, so) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for float32 variant {v}:\n{log}")
            if v == "regs3":
                print("\n".join(line.strip() for line in log.splitlines() if "registers" in line or "spill" in line))
            variants[v] = getattr(ctypes.CDLL(str(so)), "fangyan_decode_attention_f32")
            variants[v].argtypes, variants[v].restype = _build._SIGNATURES["decode_attention_f32"][2], ctypes.c_int
    for line in _build.build_logs.get("decode_attention", "").splitlines():  # ptxas: registers, spills
        if "f32" in line or "registers" in line or "spill" in line:
            print(line.strip())
    nl, kv, hd = FULL_LLM_LAYERS, 2, 64
    gen = torch.Generator(device="cuda").manual_seed(13)
    failed = False
    for b, s, idx_list, first_slots in f32_decode_cases():
        q, kn, vn, ck, cv, idx, bias = f32_decode_inputs(gen, nl, b, s, idx_list, first_slots)
        qh = q.shape[1]
        ref = da.decode_attention_plain(q.double(), kn, vn, ck.clone(), cv.clone(), idx, bias, 0)
        out = torch.empty_like(q)

        def entry(n, per, fn=fn):
            code = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), ck.data_ptr(), cv.data_ptr(), idx.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), q.stride(0), kn.stride(0), vn.stride(0), nl, b, s, kv,
                      qh // kv, hd, 0, n, per, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"cudaError_t {code}")
            return out

        runs = [("wrapper", lambda: da.decode_attention(q, kn, vn, ck, cv, idx, bias, 0))]
        if fn is not None:
            pers = sorted({-(-(-(-s // n)) // da.GROUP_F32) * da.GROUP_F32 for n in range(1, 17)}, reverse=True)
            runs += [(f"n={-(-s // per)} per={per}", lambda n=-(-s // per), per=per: entry(n, per)) for per in pers]
            runs += [(f"variant {v}", lambda f=f: entry(*da.plan_f32(b, s, kv), fn=f)) for v, f in variants.items()]
        plan = da.plan_f32(b, s, kv) if fn is not None else "one block a (KV head, row)"
        for label, call in runs:
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError as e:  # a plan the card refuses (a non-portable cluster it cannot place)
                print(f"decode_attention_f32 B={b} S={s} {label}: refused ({e})", flush=True)
                continue
            err = (got.double() - ref).abs().max().item()
            bad = not err <= DECODE_F32_ATOL and label.removeprefix("variant ") not in F32_EDITS.keys() - {"full", "regs3"}
            failed |= bad
            ms = time_ms(call, iters=50, reps=10)
            print(f"decode_attention_f32 B={b} S={s} {label} (plan {plan}): {ms * 1e3:.2f} us, "
                  f"max|err vs plain f64|={err:.2e}" + (" OVER THE LIMIT" if bad else ""), flush=True)
        del q, kn, vn, ck, cv, ref
    print(card_line())
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f32", action="store_true", help="the float32 route at chip_smoke's float32 shapes")
    ap.add_argument("--root", help="with --f32: the checkout whose kernels and wrappers are timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_attention_sweep: no CUDA device")
        return 2
    if args.f32:
        return main_f32()
    jobs = {v: build(v) for v in EDITS}
    fns = {}
    for v, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), "fangyan_decode_attention")
        fn.argtypes, fn.restype = _build._SIGNATURES["decode_attention"][2], ctypes.c_int
        fns[v] = fn
    card = card_line()
    print(f"card: {card}")
    nl, kv, hd, qh = 24, 2, 64, 14
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s in SHAPES:
        q = (torch.randn((b, qh, hd), generator=gen, device="cuda") * 2).to(torch.bfloat16)
        kn = torch.randn((b, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        vn = torch.randn((b, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        ck = torch.randn((nl, b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        cv = torch.randn((nl, b, s, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        idx = torch.full((b,), s - 20, dtype=torch.int32, device="cuda")
        bias = torch.where(torch.arange(s, device="cuda")[None, :] <= idx[:, None], 0.0, -1e10).float().expand(b, s)
        bias = bias.contiguous()
        out = torch.empty_like(q)
        ref = da.decode_attention_plain(q.float(), kn, vn, ck.clone(), cv.clone(), idx, bias, 0)
        plans = sorted({(-(-s // per), per) for per in
                        (-(-(-(-s // n)) // da.GROUP) * da.GROUP for n in PLAN_CLUSTERS)})
        for n, per in plans:
            for v, fn in fns.items():
                if v not in ALTERNATIVES and (n, per) != da.plan(b, s, kv):
                    continue

                def call(fn=fn, n=n, per=per):
                    code = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                              idx.data_ptr(), bias.data_ptr(), out.data_ptr(), q.stride(0), kn.stride(0),
                              vn.stride(0), nl, b, s, kv, qh // kv, hd, 0, n, per,
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"variant {v} plan ({n}, {per}): cudaError_t {code}")
                call()
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item() if v in ALTERNATIVES else float("nan")
                ms = time_ms(call, iters=50, reps=10)
                mark = " (plan)" if (n, per) == da.plan(b, s, kv) else ""
                print(f"B={b} S={s} n={n} per={per}{mark} {v}: {ms * 1e3:.2f} us"
                      + (f" max|err|={err:.2e}" if err == err else ""), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
