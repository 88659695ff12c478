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
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import card_line, time_ms  # noqa: E402
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
ALTERNATIVES = ("full", "cpasync", "w4")  # timed under every plan and checked; the rest only at the plan
SHAPES = [(1, 256), (4, 256), (1, 768), (16, 256), (16, 320), (1, 4096)]
PLAN_CLUSTERS = (1, 2, 3, 4, 5, 6, 7, 8)


def build(variant: str):
    text = SRC.read_text()
    for old, new in EDITS[variant]:
        if old not in text:
            raise RuntimeError(f"variant {variant}: anchor {old!r} not in {SRC}")
        text = text.replace(old, new, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"decode_attention_{variant}.cu"
    src.write_text(text)
    so = OUT / f"lib{variant}.so"
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_attention_sweep: no CUDA device")
        return 2
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
