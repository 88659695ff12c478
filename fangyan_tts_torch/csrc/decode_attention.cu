// One autoregressive decode step of grouped-query attention on the stacked
// KV cache, with the new row written into the cache in place.
//
// Replaces the Pallas kernel fangyan_tts_tpu/ops/decode_attention.py
// (`fused_decode_attention`, body `_kernel`). Same function: write the new
// post-RoPE K/V row at (layer, b, min(idx[b], S-1)), then
// out = softmax(q.K^T / sqrt(hd) + bias) . V over the S slots of that layer,
// with float32 scores, softmax and accumulation.
//
// Bound on the H100: bytes. Per call the kernel must read one layer's K and V
// (B*S*KV*hd bf16 each) and a (B, S) float32 bias; the arithmetic is two
// dot products per (query head, slot), far below the card's ridge point.
// At B=1 that is well under a megabyte, so what the time is made of is
// latency, and the design spreads the slots over many SMs (split S):
//   - pass 1, one block per (row b, KV head, split of 64 slots), serves the
//     group's query heads, so K and V of a slot are read once for all 7 of
//     them. It takes its split's scores, their float32 max and sum, and the
//     unnormalised p . V, and writes those partials to a float32 workspace.
//     In the p . V product each warp reads whole V rows (coalesced).
//   - pass 2, one block per (row b, KV head), rescales the splits' partials
//     to their common max and writes out = sum(p . V) / sum(p) in bf16.
// The new row is written by the one block whose split holds the write slot,
// before it reads the split, so no two blocks write the same bytes and no
// block reads a row another block writes. The write slot is read from `idx`
// on the device (no host synchronisation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;                  // head dim
constexpr int kMaxG = 8;                 // query heads per KV head
constexpr int kSplit = 64;               // slots per pass-1 block
constexpr int kThreads = 2 * kSplit;     // pass 1: two threads per slot (heads 0-3 and 4-7)
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerWarp = kSplit / kWarps;  // p . V slots per warp
constexpr int kCombineThreads = kMaxG * kHd;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// workspace per (b, kvh, split): G*kHd unnormalised outputs, then G maxima
// and G sums, all float32
__global__ void __launch_bounds__(kThreads) decode_attention_split_kernel(
    const __nv_bfloat16* __restrict__ q,      // (B, KV*G, hd)
    const __nv_bfloat16* __restrict__ k_new,  // (B, KV, hd)
    const __nv_bfloat16* __restrict__ v_new,  // (B, KV, hd)
    __nv_bfloat16* cache_k,                   // (L, B, S, KV, hd), read after the write
    __nv_bfloat16* cache_v,
    const int32_t* __restrict__ idx,          // (B,)
    const float* __restrict__ bias,           // (B, S)
    float* __restrict__ part_o,               // (B, KV, nsplit, G, hd)
    float* __restrict__ part_ml,              // (B, KV, nsplit, G, 2)
    int B, int S, int KV, int G, int layer, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s0 = split * kSplit;

  __shared__ __align__(16) float q_s[kMaxG][kHd];
  __shared__ float p_s[kMaxG][kSplit];
  __shared__ float red_s[kWarps][kMaxG][kHd];

  const size_t slot_stride = (size_t)KV * kHd;
  const size_t base = ((size_t)layer * B + b) * (size_t)S * slot_stride + (size_t)kvh * kHd;
  __nv_bfloat16* ck = cache_k + base;
  __nv_bfloat16* cv = cache_v + base;

  // 1. the new row, at the clamped slot, by the block whose split holds it
  //    (rows that ran past the buffer keep writing the last slot, which their
  //    bias masks)
  int slot = idx[b];
  slot = slot < 0 ? 0 : (slot > S - 1 ? S - 1 : slot);
  if (slot >= s0 && slot < s0 + kSplit && tid < kHd) {
    const size_t src = ((size_t)b * KV + kvh) * kHd + tid;
    ck[(size_t)slot * slot_stride + tid] = k_new[src];
    cv[(size_t)slot * slot_stride + tid] = v_new[src];
  }
  // 2. this group's queries, as float32
  const __nv_bfloat16* qg = q + ((size_t)b * KV * G + (size_t)kvh * G) * kHd;
  for (int i = tid; i < kMaxG * kHd; i += kThreads)
    q_s[i / kHd][i % kHd] = i < G * kHd ? __bfloat162float(qg[i]) : 0.f;
  __syncthreads();  // the row write and q_s are visible to the whole block

  // 3. scores: thread (half, j) takes slot s0 + j for heads 4*half .. 4*half+3
  {
    const int j = tid % kSplit;
    const int h0 = (tid / kSplit) * 4;
    const int s = s0 + j;
    if (s < S) {
      const uint4* kr = reinterpret_cast<const uint4*>(ck + (size_t)s * slot_stride);
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c8 = 0; c8 < kHd / 8; ++c8) {
        const uint4 pk = kr[c8];
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&pk);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          const float4 qa = *reinterpret_cast<const float4*>(&q_s[h0 + hh][c8 * 8]);
          const float4 qb = *reinterpret_cast<const float4*>(&q_s[h0 + hh][c8 * 8 + 4]);
          dot[hh] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] + qb.x * kf[4] + qb.y * kf[5] +
                     qb.z * kf[6] + qb.w * kf[7];
        }
      }
      const float bs = bias[(size_t)b * S + s];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) p_s[h0 + hh][j] = dot[hh] * scale + bs;
    } else {
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) p_s[h0 + hh][j] = kNeg;
    }
  }
  __syncthreads();

  // 4. the split's softmax numerators, max and sum; warp w takes heads w, w+4
  const size_t part = ((size_t)b * KV + kvh) * nsplit + split;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = warp + r * kWarps;
    if (h < G) {
      const float a = p_s[h][lane], c = p_s[h][lane + 32];
      const float m = warp_max(fmaxf(a, c));
      const float pa = a <= kNeg ? 0.f : expf(a - m);
      const float pc = c <= kNeg ? 0.f : expf(c - m);
      p_s[h][lane] = pa;
      p_s[h][lane + 32] = pc;
      const float l = warp_sum(pa + pc);
      if (lane == 0) {
        part_ml[(part * G + h) * 2] = m;
        part_ml[(part * G + h) * 2 + 1] = l;
      }
    }
  }
  __syncthreads();

  // 5. p . V: warp w takes 16 slots, lane l owns dims 2l, 2l+1 of every head
  float acc[kMaxG][2];
#pragma unroll
  for (int h = 0; h < kMaxG; ++h) acc[h][0] = acc[h][1] = 0.f;
  const int i0 = warp * kSlotsPerWarp;
  const int n = min(kSlotsPerWarp, S - s0 - i0);
  const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(cv + (size_t)(s0 + i0) * slot_stride) + lane;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float2 v = __bfloat1622float2(vr[(size_t)i * (slot_stride / 2)]);
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      if (h < G) {
        const float p = p_s[h][i0 + i];
        acc[h][0] += p * v.x;
        acc[h][1] += p * v.y;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kMaxG; ++h) {
    red_s[warp][h][2 * lane] = acc[h][0];
    red_s[warp][h][2 * lane + 1] = acc[h][1];
  }
  __syncthreads();
  float* po = part_o + part * G * kHd;
  for (int o = tid; o < G * kHd; o += kThreads) {
    const int h = o / kHd, d = o % kHd;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_s[w][h][d];
    po[o] = sum;
  }
}

__global__ void __launch_bounds__(kCombineThreads) decode_attention_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ out,  // (B, KV*G, hd)
    int KV, int G, int nsplit) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int o = threadIdx.x;
  if (o >= G * kHd) return;
  const int h = o / kHd;
  const size_t part0 = ((size_t)b * KV + kvh) * nsplit;
  float m = kNeg;
  for (int sp = 0; sp < nsplit; ++sp) m = fmaxf(m, part_ml[((part0 + sp) * G + h) * 2]);
  float num = 0.f, den = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* ml = part_ml + ((part0 + sp) * G + h) * 2;
    const float w = expf(ml[0] - m);
    den += w * ml[1];
    num += w * part_o[(part0 + sp) * G * kHd + o];
  }
  out[((size_t)b * KV + kvh) * G * kHd + o] = __float2bfloat16(num / den);
}

}  // namespace

// `workspace` holds `ws_words` float32 words; it needs
// B * KV * ceil(S / 64) * G * (hd + 2).
extern "C" int fangyan_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* cache_k, void* cache_v,
    const void* idx, const void* bias, void* out, void* workspace, long long ws_words,
    int B, int S, int KV, int G, int hd, int layer, void* stream) {
  if (hd != kHd || G < 1 || G > kMaxG || B < 1 || S < 1 || KV < 1 || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + kSplit - 1) / kSplit;
  if (nsplit > 65535 || ws_words < (long long)B * KV * nsplit * G * (kHd + 2)) return (int)cudaErrorInvalidValue;
  float* part_o = (float*)workspace;
  float* part_ml = part_o + (size_t)B * KV * nsplit * G * kHd;
  const cudaStream_t st = (cudaStream_t)stream;
  decode_attention_split_kernel<<<dim3(KV, B, nsplit), kThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
      (__nv_bfloat16*)cache_k, (__nv_bfloat16*)cache_v, (const int32_t*)idx,
      (const float*)bias, part_o, part_ml, B, S, KV, G, layer, 0.125f);
  decode_attention_combine_kernel<<<dim3(KV, B), kCombineThreads, 0, st>>>(
      part_o, part_ml, (__nv_bfloat16*)out, KV, G, nsplit);
  return (int)cudaGetLastError();
}
