// Length-masked, optionally chunk-causal flash attention for the DiT.
//
// Replaces the Pallas kernel fangyan_tts_tpu/ops/flash_attention.py
// (`chunk_flash_attention`, body `_kernel`). Same function on (B, H, L, 64)
// bf16: out = softmax(q.k^T / 8 + mask) . v with float32 accumulation, where
// key j is valid for query i iff j < mel_len[b] and, when chunk > 0,
// j / chunk <= i / chunk. The masks are computed in the kernel from
// mel_len and chunk; no (L, L) bias is read.
//
// Bound on the H100: 4*B*H*L^2*64 FLOPs (fewer where the masks cut pairs)
// against 4*B*H*L*64*2 bytes, so L/2 FLOPs a byte against the card's ridge
// of about 295: bytes for L below about 590 (a 6 s request has L = 320),
// operations above it. Design: FlashAttention-2's structure on the tensor
// cores through mma.sync m16n8k16 (bf16 in, float32 accumulate):
// one block of 4 warps per (b*h, 64-query tile), each warp owning 16 query
// rows; K and V tiles of 64 keys go through shared memory (V stored
// transposed so the P.V operand loads are 32-bit); the running max, sum and
// the output accumulator stay in float32 registers, and P goes from the
// score accumulators to the P.V operand without leaving registers. Key tiles
// that lie wholly past mel_len[b], or wholly after the last query's chunk,
// are skipped. A row with no valid key comes out as zeros (finite). wgmma
// and TMA are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;      // head dim
constexpr int kBq = 64;     // query rows per block
constexpr int kBk = 64;     // keys per tile
constexpr int kPad = 72;    // shared row stride (bf16): conflict-free fragment loads
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) chunk_flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B*H, L, D)
    const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const int32_t* __restrict__ mel_len,   // (B,)
    __nv_bfloat16* __restrict__ out,       // (B*H, L, D)
    int H, int L, int chunk, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBq][kPad];
  __shared__ __align__(16) __nv_bfloat16 ks[kBk][kPad];
  __shared__ __align__(16) __nv_bfloat16 vt[kD][kPad];  // V transposed: [dim][key]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBq;
  const size_t base = (size_t)bh * L * kD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group

  for (int i = tid; i < kBq * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < L) val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * kD + c);
    *reinterpret_cast<uint4*>(&qs[r][c]) = val;
  }

  int len = mel_len[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  int kend = len;
  if (chunk > 0) {
    const int qlast = min(q0 + kBq, L) - 1;
    kend = min(kend, (qlast / chunk + 1) * chunk);
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = ld32(&qs[r0][kk * 16 + tg * 2]);
    qa[kk][1] = ld32(&qs[r0 + 8][kk * 16 + tg * 2]);
    qa[kk][2] = ld32(&qs[r0][kk * 16 + 8 + tg * 2]);
    qa[kk][3] = ld32(&qs[r0 + 8][kk * 16 + 8 + tg * 2]);
  }
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const int qchunk[2] = {chunk > 0 ? qrow[0] / chunk : 0, chunk > 0 ? qrow[1] / chunk : 0};

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < kend; k0 += kBk) {
    __syncthreads();  // the previous tile's ks / vt reads are done
    for (int i = tid; i < kBk * kD / 8; i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < L) {
        kv = *reinterpret_cast<const uint4*>(k + base + (size_t)(k0 + r) * kD + c);
        vv = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * kD + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[c + e][r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys (8 blocks of 8 keys)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_bf16(s[j], qa[kk], ld32(&ks[j * 8 + g][kk * 16 + tg * 2]),
                 ld32(&ks[j * 8 + g][kk * 16 + 8 + tg * 2]));
    }

    // mask, scale, running max
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const int key = k0 + j * 8 + tg * 2 + (e & 1);
        const bool ok = key < len && (chunk <= 0 || key / chunk <= qchunk[ri]);
        s[j][e] = ok ? s[j][e] * scale : kNeg;
        mx[ri] = fmaxf(mx[ri], s[j][e]);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m[ri], mx[ri]);
      corr[ri] = expf(m[ri] - m_new);
      m[ri] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const float p = s[j][e] <= kNeg ? 0.f : expf(s[j][e] - m[ri]);
        s[j][e] = p;
        rs[ri] += p;
      }
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      rs[ri] += __shfl_xor_sync(0xffffffffu, rs[ri], 1);
      rs[ri] += __shfl_xor_sync(0xffffffffu, rs[ri], 2);
      l[ri] = l[ri] * corr[ri] + rs[ri];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V: the score accumulators of key blocks 2kk, 2kk+1 are the
    // A operand of the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_bf16(o[j], pa, ld32(&vt[j * 8 + g][kk * 16 + tg * 2]), ld32(&vt[j * 8 + g][kk * 16 + 8 + tg * 2]));
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (qrow[ri] >= L) continue;
    const float inv = l[ri] > 0.f ? 1.f / l[ri] : 0.f;
    __nv_bfloat16* orow = out + base + (size_t)qrow[ri] * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(o[j][2 * ri] * inv, o[j][2 * ri + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tg * 2) = val;
    }
  }
}

}  // namespace

extern "C" int fangyan_chunk_flash_attention(
    const void* q, const void* k, const void* v, const void* mel_len, void* out,
    int B, int H, int L, int D, int chunk, void* stream) {
  if (D != kD || B < 1 || H < 1 || L < 1 || (long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kBq - 1) / kBq, B * H);
  chunk_flash_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int32_t*)mel_len, (__nv_bfloat16*)out, H, L, chunk, 0.125f);
  return (int)cudaGetLastError();
}
