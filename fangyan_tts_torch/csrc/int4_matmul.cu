// Fused int4-dequant matmul: out = (x @ dequant(w)) * scale, bf16 out.
//
// Replaces the Pallas kernel fangyan_tts_tpu/ops/int4_matmul.py
// (`int4_matmul`, body `_kernel`). Same function: x (M, K) bf16; w (K/2, N)
// int8 holding two int4 values a byte (packed row i: input row 2i in the low
// nibble, 2i+1 in the high nibble, two's complement in [-7, 7]); scale (N,)
// float32 applied to the float32 sum before the cast to bf16.
//
// Bound on the H100: at decode (M = 1-16) bytes, since the packed weight
// (K*N/2 bytes) is read once and used by only M rows; at prefill (M in the
// hundreds) operations, 2*M*K*N. Design:
//   - a block owns 128 output columns and 16 (M <= 16) or 64 rows; its four
//     warps own 32 columns each. K goes in steps of 64 through a ring of
//     shared-memory stages filled by cp.async (16 bytes a thread, coalesced
//     along N for w and along K for x), so the next steps' bytes are in
//     flight while the tensor cores work on this one;
//   - the product runs on mma.sync m16n8k16 (bf16 in, float32 accumulate).
//     A thread's B fragment holds, for one column, the two consecutive K
//     values 2i and 2i+1: exactly the two nibbles of packed byte i. So each
//     fragment register is one byte read from shared memory and sign-extended
//     into two bf16 (values in [-7, 7] are exact): the weight is dequantized
//     in registers and never written out, and no even/odd split of x is
//     needed (the Pallas kernel's split was a TPU relayout workaround);
//   - the packed rows sit 144 bytes apart in shared memory, so the 8 bytes a
//     warp reads from each of 4 rows fall in distinct banks;
//   - where the output tiles number fewer than the SMs (down_proj: 896
//     columns, 7 tiles), the caller splits K over blocks (grid z). Each split
//     writes float32 partials, and a second pass sums them in split order,
//     scales and casts: the result is the same from run to run (no atomics).
// wgmma, TMA and a persistent schedule are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBn = 128;            // output columns per block
constexpr int kBk = 64;             // K rows per pipeline step
constexpr int kPk = kBk / 2;        // packed rows per step
constexpr int kWStride = kBn + 16;  // bytes per packed shared row
constexpr int kXStride = kBk + 8;   // bf16 per activation shared row (144 bytes)
constexpr int kThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one packed byte -> bf16 pair (low nibble in the low half: the smaller K)
__device__ __forceinline__ uint32_t dequant2(int8_t byte) {
  const int v = byte;
  const int lo = static_cast<int>(static_cast<uint32_t>(v) << 28) >> 28;
  const int hi = v >> 4;
  __nv_bfloat162 r = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// grid (N / kBn, ceil(M / BM), splits); block z sums K steps
// [z * per, min((z + 1) * per, K / kBk)). With one split it writes
// bf16(sum * scale) to out, else the float32 sums to part[z] (M, N).
template <int BM>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(
    const __nv_bfloat16* __restrict__ x,  // (M, K)
    const int8_t* __restrict__ w,         // (K/2, N)
    const float* __restrict__ scale,      // (N,)
    __nv_bfloat16* __restrict__ out,      // (M, N)
    float* __restrict__ part,             // (splits, M, N) or null
    int M, int K, int N, int per) {
  constexpr int kMt = BM / 16;            // 16-row fragments per warp
  constexpr int kStages = BM == 16 ? 4 : 3;
  __shared__ __align__(16) __nv_bfloat16 xs[kStages][BM][kXStride];
  __shared__ __align__(16) int8_t wsm[kStages][kPk][kWStride];

  const int n0 = blockIdx.x * kBn;
  const int m0 = blockIdx.y * BM;
  const int step0 = blockIdx.z * per;
  const int nsteps = min(per, K / kBk - step0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row / column group
  const int tg = lane & 3;  // thread in group

  auto load = [&](int step, int stage) {
    const int k0 = (step0 + step) * kBk;
    // packed w: kPk rows x 128 bytes, 8 chunks of 16 bytes a row
    for (int i = tid; i < kPk * (kBn / 16); i += kThreads) {
      const int r = i / (kBn / 16), c = (i % (kBn / 16)) * 16;
      cp_async16(&wsm[stage][r][c], w + (size_t)(k0 / 2 + r) * N + n0 + c, true);
    }
    // x: BM rows x 64 bf16, 8 chunks a row; rows past M read as zeros
    for (int i = tid; i < BM * (kBk / 8); i += kThreads) {
      const int r = i / (kBk / 8), c = (i % (kBk / 8)) * 8;
      const bool ok = m0 + r < M;
      cp_async16(&xs[stage][r][c], x + (ok ? (size_t)(m0 + r) * K + k0 + c : 0), ok);
    }
  };

  float acc[kMt][4][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }

  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step t has landed for every thread; step t-1's stage is free
    if (t + kStages - 1 < nsteps) load(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();

    const int st = t % kStages;
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t a[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        const int r = mt * 16 + g;
        a[mt][0] = ld32(&xs[st][r][kk * 16 + tg * 2]);
        a[mt][1] = ld32(&xs[st][r + 8][kk * 16 + tg * 2]);
        a[mt][2] = ld32(&xs[st][r][kk * 16 + 8 + tg * 2]);
        a[mt][3] = ld32(&xs[st][r + 8][kk * 16 + 8 + tg * 2]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = warp * 32 + j * 8 + g;
        const uint32_t b0 = dequant2(wsm[st][kk * 8 + tg][col]);      // K = kk*16 + 2tg, +1
        const uint32_t b1 = dequant2(wsm[st][kk * 8 + 4 + tg][col]);  // K = kk*16 + 8 + 2tg, +1
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) mma_bf16(acc[mt][j], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + warp * 32 + j * 8 + tg * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mt * 16 + g + h * 8;
        if (row >= M) continue;
        const float v0 = acc[mt][j][2 * h], v1 = acc[mt][j][2 * h + 1];
        if (part == nullptr) {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(v0 * scale[col], v1 * scale[col + 1]);
        } else {
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + row) * N + col) = make_float2(v0, v1);
        }
      }
    }
  }
}

// out = bf16(sum over z in order of part[z] * scale), two columns a thread
__global__ void int4_matmul_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                          __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const size_t pairs = (size_t)M * N / 2;
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < pairs; i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = 2 * i;
    const int col = (int)(e % N);
    float s0 = 0.f, s1 = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float2 p = *reinterpret_cast<const float2*>(part + z * mn + e);
      s0 += p.x;
      s1 += p.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + e) = __floats2bfloat162_rn(s0 * scale[col], s1 * scale[col + 1]);
  }
}

}  // namespace

extern "C" int fangyan_int4_matmul(const void* x, const void* w, const void* scale, void* out, void* ws,
                                   int M, int K, int N, int bm, int splits, int per, void* stream) {
  const int steps = K / kBk;
  if (M < 1 || K < kBk || K % kBk || N < kBn || N % kBn || (bm != 16 && bm != 64) || splits < 1 || per < 1 ||
      (long long)(splits - 1) * per >= steps || (long long)splits * per < steps || (M + bm - 1) / bm > 65535 ||
      splits > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(N / kBn, (M + bm - 1) / bm, splits);
  float* part = splits > 1 ? (float*)ws : nullptr;
  if (bm == 16)
    int4_matmul_kernel<16><<<grid, kThreads, 0, s>>>((const __nv_bfloat16*)x, (const int8_t*)w,
                                                     (const float*)scale, (__nv_bfloat16*)out, part, M, K, N, per);
  else
    int4_matmul_kernel<64><<<grid, kThreads, 0, s>>>((const __nv_bfloat16*)x, (const int8_t*)w,
                                                     (const float*)scale, (__nv_bfloat16*)out, part, M, K, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  // a grid-stride loop: at most 8 blocks an SM
  const long long pairs = (long long)M * N / 2;
  const int blocks = (int)(pairs / 256 + 1 < sms * 8LL ? pairs / 256 + 1 : sms * 8LL);
  int4_matmul_reduce_kernel<<<blocks, 256, 0, s>>>(part, (const float*)scale, (__nv_bfloat16*)out, M, N, splits);
  return (int)cudaGetLastError();
}
