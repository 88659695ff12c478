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
// operations above it. Design, FlashAttention-3's shape at head dim 64:
//   - a work item is (b*h, 128 query rows): two consumer warpgroups of 64
//     rows and a producer warpgroup that gives its registers to them
//     (setmaxnreg). Q comes once by TMA; K and V tiles of 128 keys come by
//     TMA into a three-stage ring guarded by mbarriers, so the next tiles are
//     in flight while the tensor cores work on this one;
//   - the grid is persistent, one block an SM walking over the items in a
//     snake order that balances the chunk mask's uneven items, with two Q
//     buffers (the next item's loads overlap this item's last products) and
//     two O buffers (no one waits for an output store until its buffer comes
//     round again);
//   - S = Q.K^T on wgmma m64n128k16 with both operands in shared memory
//     (128-byte swizzle); P stays in registers (the score accumulators are
//     the A-operand layout) for P.V on wgmma m64n64k16, which reads V from
//     shared memory as an MN-major operand: no thread transposes V;
//   - each row's key limit lim(i) = min(mel_len[b], chunk > 0 ?
//     (i / chunk + 1) * chunk : L) is worked out once. A key tile below every
//     row's limit takes no mask, a tile that straddles a limit one compare
//     per score, a tile past every row's limit is not loaded;
//   - the softmax runs in base 2 with log2(e)/8 folded into one FMA a score;
//     the running max, sum and output stay in float32 registers;
//   - q, k and v are TMA tensor maps over strided (B, H, L, 64) views (the
//     DiT's qkv projection is read in place), and the output is written by a
//     TMA store into (B, L, H, 64) memory, which the caller views as
//     (B, H, L, 64). A row with no valid key comes out as zeros.
// The float32 route (`fangyan_chunk_flash_attention_f32`, at the end of the
// file) is a SIMT kernel of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;                       // head dim: one 128-byte swizzle row
constexpr int kBm = 64;                      // query rows per consumer warpgroup
constexpr int kBq = 2 * kBm;                 // query rows per block
constexpr int kBn = 128;                     // keys per tile
constexpr int kStages = 3;
constexpr int kThreads = 3 * 128;            // two consumer warpgroups, one producer warpgroup
constexpr int kQBytes = kBm * kD * 2;        // one warpgroup's Q (or O) tile
constexpr int kKvBytes = kBn * kD * 2;       // one K or V tile
constexpr int kOOff = 2 * 2 * kQBytes;       // two Q buffers of a block's 128 rows, then two O buffers
constexpr int kKOff = kOOff + 2 * 2 * kQBytes;
constexpr int kVOff = kKOff + kStages * kKvBytes;
constexpr int kBarOff = kVOff + kStages * kKvBytes;
constexpr int kSmem = kBarOff + (4 + 2 * kStages) * 8 + 1024;  // tiles, barriers, alignment slack

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// keys j < key_limit(i) are valid for query row i (0 <= i < L)
__device__ __forceinline__ int key_limit(int i, int len, int chunk, int L) {
  return min(len, chunk > 0 ? (i / chunk + 1) * chunk : L);
}

// A persistent grid of G blocks over the B*H*ceil(L/128) (bh, 128-row query
// tile) items, bh-major so that the blocks of a round share K and V in L2.
// In round n block j takes item n*G + j, or n*G + G-1-j when n is odd: the
// query tiles of a head differ in work under the chunk mask, and the snake
// order pairs a block's heavy items with light ones. Q is double-buffered,
// so the producer loads the next item's Q and first K/V tiles while the
// consumers finish this one; the K/V ring runs on across items. The output
// goes out through two O buffers by TMA stores that nobody waits for until
// the buffer comes round again.
__global__ void __launch_bounds__(kThreads, 1) chunk_flash_attention_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // (D, L, H, B) boxes of (64, kBm)
    const __grid_constant__ CUtensorMap tm_k,  // boxes of (64, kBn)
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o,  // (B, L, H, D) memory, boxes of (64, kBm)
    const int32_t* __restrict__ mel_len, int H, int L, int chunk, float scale_log2, int items) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBarOff);  // [2]: Q buffer loaded
  uint64_t* q_empty = q_full + 2;                                    // [2]: its products done, free again
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;

  const int nq = (L + kBq - 1) / kBq;
  const int wg = threadIdx.x / 128;
  // item -> (b, h, first query row, key tiles its last row needs: the limits grow with the row)
  auto item = [&](int it, int& b, int& h, int& q0, int& len, int& ntiles) {
    const int bh = it / nq;
    b = bh / H;
    h = bh % H;
    q0 = it % nq * kBq;
    len = max(0, min(mel_len[b], L));
    ntiles = (key_limit(min(q0 + kBq, L) - 1, len, chunk, L) + kBn - 1) / kBn;
  };

  auto round_item = [&](int n) {  // this block's item of round n
    return n * (int)gridDim.x + ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 2);  // one arrival a consumer warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup: 40 + 2 x 232 registers a thread is the
    // 3 x 168 that __launch_bounds__ gives the block
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_o);
      int gt = 0;  // key tiles loaded so far, over all items
      for (int n = 0, it = blockIdx.x; it < items; it = round_item(++n)) {
        int b, h, q0, len, ntiles;
        item(it, b, h, q0, len, ntiles);
        const int qb = n & 1;
        if (n >= 2) mbar_wait(&q_empty[qb], ((n >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[qb], 2 * kQBytes);
        tma_load_4d(smem + qb * 2 * kQBytes, &tm_q, &q_full[qb], 0, q0, h, b);
        tma_load_4d(smem + qb * 2 * kQBytes + kQBytes, &tm_q, &q_full[qb], 0, q0 + kBm, h, b);
        for (int t = 0; t < ntiles; ++t, ++gt) {
          const int s = gt % kStages;
          if (gt >= kStages) mbar_wait(&empty[s], (gt / kStages - 1) & 1);
          mbar_arrive_expect_tx(&full[s], 2 * kKvBytes);
          tma_load_4d(smem + kKOff + s * kKvBytes, &tm_k, &full[s], 0, t * kBn, h, b);
          tma_load_4d(smem + kVOff + s * kKvBytes, &tm_v, &full[s], 0, t * kBn, h, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 of each item
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
    int gt = 0;
    for (int n = 0, it = blockIdx.x; it < items; it = round_item(++n)) {
      int b, h, q0, len, ntiles;
      item(it, b, h, q0, len, ntiles);
      const int qb = n & 1;
      const int r0 = q0 + wg * kBm;
      const int row = r0 + 16 * warp + g;  // this thread's rows: row and row + 8
      const int lim0 = key_limit(min(row, L - 1), len, chunk, L);
      const int lim1 = key_limit(min(row + 8, L - 1), len, chunk, L);
      const int wg_lo = key_limit(min(r0, L - 1), len, chunk, L);
      const int wg_tiles = (key_limit(min(r0 + kBm, L) - 1, len, chunk, L) + kBn - 1) / kBn;
      uint8_t* qs = smem + qb * 2 * kQBytes + wg * kQBytes;
      const uint32_t q_addr = smem_u32(qs);

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      // Per key tile: S = Q.K^T on wgmma, the softmax in registers, then
      // O += P.V on wgmma; the other warpgroup's products fill the tensor
      // cores meanwhile, and the producer keeps the next tiles in flight.
      const int gt0 = gt;
      gt += ntiles;
      auto stage = [&](int t) { return (gt0 + t) % kStages; };
      auto wait_tile = [&](int t) { mbar_wait(&full[stage(t)], ((gt0 + t) / kStages) & 1); };
      auto release = [&](int t) {
        if (lane == 0) mbar_arrive(&empty[stage(t)]);
      };
      float sc[64];
      auto qk = [&](int t) {  // start S = Q.K(t)^T
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = 0.f;
        const uint32_t k_addr = smem_u32(smem + kKOff + stage(t) * kKvBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_ss_n128(sc, desc_sw128(q_addr + kk * 32, 16, 1024), desc_sw128(k_addr + kk * 32, 16, 1024));
        wgmma_commit();
      };
      auto pv = [&](int t, uint32_t(&pa)[kBn / 16][4]) {  // start O += P.V(t)
        // the score accumulators of key groups 2kk, 2kk+1 are the A operand of
        // the 16-key step kk; V rows kk*16 .. start 2048 bytes apart
        const uint32_t v_addr = smem_u32(smem + kVOff + stage(t) * kKvBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBn / 16; ++kk)
          wgmma_rs_n64<1>(o, pa[kk], desc_sw128(v_addr + kk * 16 * 128, 1024, 1024));
        wgmma_commit();
      };
      auto fence_s = [&] {
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(sc[i]);
      };
      auto fence_pv = [&](uint32_t(&pa)[kBn / 16][4]) {
#pragma unroll
        for (int kk = 0; kk < kBn / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) fence_operand(pa[kk][r]);
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(o[i]);
      };
      // mask, online softmax and P of the landed S(t); returns the factor O must take
      auto softmax = [&](int t, uint32_t(&pa)[kBn / 16][4], float (&corr)[2]) {
        // sc[4j + e]: row (e < 2 ? row : row + 8), key t * kBn + 8j + 2tg + e % 2
        const int k0 = t * kBn;
        if (k0 + kBn > wg_lo) {  // some row's limit falls inside this tile
#pragma unroll
          for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k0 + 8 * j + 2 * tg + (e & 1) >= (e < 2 ? lim0 : lim1)) sc[4 * j + e] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        float base[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          base[r] = m_new == -INFINITY ? 0.f : m_new * scale_log2;  // a row with no valid key yet stays at 0
          corr[r] = ex2(m[r] * scale_log2 - base[r]);
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(sc[4 * j + e], scale_log2, -base[e >> 1]));
            sc[4 * j + e] = p;
            rs[e >> 1] += p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
          l[r] = l[r] * corr[r] + rs[r];
        }
#pragma unroll
        for (int kk = 0; kk < kBn / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };
      uint32_t pa[kBn / 16][4];
      mbar_wait(&q_full[qb], (n >> 1) & 1);
      for (int t = 0; t < wg_tiles; ++t) {
        wait_tile(t);
        qk(t);
        wgmma_wait<0>();
        fence_s();
        float corr[2];
        softmax(t, pa, corr);
#pragma unroll
        for (int j = 0; j < kD / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
        pv(t, pa);
        wgmma_wait<0>();
        fence_pv(pa);
        release(t);
      }
      for (int t = wg_tiles; t < ntiles; ++t) {  // tiles past this warpgroup's rows' limits
        wait_tile(t);
        release(t);
      }

      // O / l in bf16 into this warpgroup's O buffer (the Q tile's swizzle),
      // then one TMA store; rows past L are not written. The buffer's last
      // store (two items ago) must have read it first.
      uint8_t* os = smem + kOOff + qb * 2 * kQBytes + wg * kQBytes;
      if (threadIdx.x % 128 == 0) tma_store_wait_read<1>();
      named_barrier(1 + wg, 128);  // this warpgroup is done with Q and may write O
      if (threadIdx.x % 128 == 0) mbar_arrive(&q_empty[qb]);
      const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rr = 16 * warp + g + 8 * r;  // rr % 8 == g
          *reinterpret_cast<uint32_t*>(os + rr * 128 + ((j ^ g) << 4) + 4 * tg) =
              pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        tma_store_4d(&tm_o, os, 0, r0, h, b);
        tma_store_commit();
      }
    }
    if (threadIdx.x % 128 == 0) tma_store_wait_read<0>();  // before the block's shared memory goes
  }
}

// (B, H, L, 64) view with element strides sb, sh, sl (last dim contiguous)
bool view_map(CUtensorMap* map, const void* base, int B, int H, int L, long long sb, long long sh, long long sl,
              int rows) {
  const uint64_t dims[4] = {(uint64_t)kD, (uint64_t)L, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sl * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {(uint32_t)kD, (uint32_t)rows, 1, 1};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

}  // namespace

// q, k, v: (B, H, L, 64) bf16 views, element strides (s*b, s*h, s*l), each a
// multiple of 8; out: (B, L, H, 64) bf16, contiguous.
extern "C" int fangyan_chunk_flash_attention(const void* q, const void* k, const void* v, const void* mel_len,
                                             void* out, int B, int H, int L, int D, int chunk, long long qsb,
                                             long long qsh, long long qsl, long long ksb, long long ksh,
                                             long long ksl, long long vsb, long long vsh, long long vsl,
                                             void* stream) {
  const long long strides[9] = {qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl};
  if (D != kD || B < 1 || H < 1 || L < 1 || chunk < 0) return (int)cudaErrorInvalidValue;
  for (long long s : strides)
    if (s < 0 || s % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!view_map(&tm_q, q, B, H, L, qsb, qsh, qsl, kBm) || !view_map(&tm_k, k, B, H, L, ksb, ksh, ksl, kBn) ||
      !view_map(&tm_v, v, B, H, L, vsb, vsh, vsl, kBn) ||
      !view_map(&tm_o, out, B, H, L, (long long)L * H * kD, kD, (long long)H * kD, kBm))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(chunk_flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long items = (long long)B * H * ((L + kBq - 1) / kBq);
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);  // one block an SM
  chunk_flash_attention_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_o, (const int32_t*)mel_len, H, L, chunk, 0.125f * 1.4426950408889634f, (int)items);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The float32 route: the same function on float32 (B, H, L, 64) q, k and v
// (the Pallas kernel computes in float32 and writes q's dtype), with float32
// scores, softmax and sums on the CUDA cores, so no TF32 rounding. Bound by
// operations: 4*64 FMA-operations a valid (query, key) pair against float32's
// 67 TFLOP/s outside the tensor cores. Shared memory hands the SM's lanes 32
// floats a clock against 128 FMAs, so a product that reads one operand float
// per 4 FMAs (an 8 x 8 register tile) already keeps it as busy as the FMA
// pipes; the design keeps to that ratio and spends no shared-memory traffic
// elsewhere. Design:
//   - a block of 256 threads takes 128 query rows of one (b, h), as two
//     groups of 128 threads that split its key tiles (group g takes tiles g,
//     g + 2, ...) and merge their running max, sum and output at the end;
//     within a group a thread owns 8 rows x 8 keys of each 64-key tile of
//     S = Q.K^T and the same 8 rows x 8 dims of O, with the running max and
//     sum of its rows in registers. Both products read their operands as
//     float4 from shared memory: 16 loads of 16 bytes per 256 FMAs (rows
//     4ty + c + 64h, keys and dims 4tx + c + 32h);
//   - Q (once a block) and the K tiles sit in shared memory as rows of 16
//     16-byte units, unit u of row r stored at u ^ ((r >> 2) & 7), so the 8
//     keys or 4 rows a warp reads at one time fall in distinct banks; V is
//     read along its rows (dims), which the warp's lanes split;
//   - P goes to the P.V product through a 16 KB shared tile per group, 128
//     rows x 32 keys, half a key tile at a time, written and read as float4
//     (the same swizzle) by the 8 threads that share its rows, all in one
//     warp: a __syncwarp, no block barrier. The row max and sum go by
//     shuffles among those 8 threads;
//   - K and V tiles come by cp.async into a ring of four stages (two tiles
//     computed, the next two in flight, one block barrier a round); rows
//     past L are zero-filled;
//   - key tiles past the block's last row's limit are not loaded, and the
//     per-element limit test runs only on tiles that reach past the block's
//     first row's limit;
//   - 192 KB of shared memory (Q 32 KB, the ring 128 KB, P 32 KB) and up to
//     255 registers a thread: one block, 8 warps, an SM. The grid takes the
//     (b*h, 128-row) items heaviest first (the last query tiles need the most
//     keys under the chunk mask), so the blocks that start late are the
//     light ones; splitting each item's keys over two groups gives the grid
//     three times as many rounds of items as a block of 128 threads at two
//     an SM would, so its last round leaves less of the card idle (L = 1472,
//     B*H = 32: 384 items for 132 SMs).
// The output goes to (B, L, H, D) memory as on the bf16 route, and a row with
// no valid key comes out as zeros, as there.

namespace {

using namespace hopper;

constexpr int kF32Rows = 128;                  // query rows a block
constexpr int kF32Keys = 64;                   // keys a tile
constexpr int kF32Group = 128;                 // threads of a group: 16 x 8
constexpr int kF32Threads = 2 * kF32Group;
constexpr int kF32Stages = 4;
constexpr int kF32QFloats = kF32Rows * kD;     // 32 KB
constexpr int kF32KvFloats = kF32Keys * kD;    // 16 KB a K or V tile
constexpr int kF32PFloats = kF32Rows * 32;     // 16 KB: half a key tile's P, a group
constexpr int kF32Smem = (kF32QFloats + 2 * kF32Stages * kF32KvFloats + 2 * kF32PFloats) * 4;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__global__ void __launch_bounds__(kF32Threads, 1) chunk_flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int32_t* __restrict__ mel_len, float* __restrict__ out, int H, int L, int chunk, long long qsb,
    long long qsh, long long qsl, long long ksb, long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, int bh_count) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                                  // [128][64] swizzled
  float* ks = qs + kF32QFloats;                     // [stage][64][64] swizzled
  float* vs = ks + kF32Stages * kF32KvFloats;       // [stage][64][64]
  const int tid = threadIdx.x, grp = tid / kF32Group, gt = tid % kF32Group;
  float* ps = vs + kF32Stages * kF32KvFloats + grp * kF32PFloats;  // [128][32] swizzled, this group's

  const int nq = (L + kF32Rows - 1) / kF32Rows;
  const int it = blockIdx.x;
  const int q0 = (nq - 1 - it / bh_count) * kF32Rows;  // heaviest query tiles first
  const int bh = it % bh_count, b = bh / H, h = bh % H;
  const int tx = gt % 8, ty = gt / 8, sw = ty & 7;
  const int len = max(0, min(mel_len[b], L));
  const float scale_log2 = 0.125f * 1.4426950408889634f;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;
  const int kend = key_limit(min(q0 + kF32Rows, L) - 1, len, chunk, L);  // keys the block's last row needs
  const int kfree = key_limit(q0, len, chunk, L);                         // keys valid for every row
  const int ntiles = (kend + kF32Keys - 1) / kF32Keys;

  auto row = [&](int r) { return 4 * ty + (r & 3) + 64 * (r >> 2); };  // the thread's rows (block-local)

  auto load_tile = [&](int t) {  // keys t * 64 .. into stage t % 4: 2 x 64 rows x 16 units over 256 threads
    if (t >= ntiles) return;
    float* kd = ks + t % kF32Stages * kF32KvFloats;
    float* vd = vs + t % kF32Stages * kF32KvFloats;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kF32Threads, j = e / 16, u = e % 16, key = t * kF32Keys + j;
      const bool ok = key < L;
      cp_async16(kd + j * kD + 4 * (u ^ ((j >> 2) & 7)), kb + (ok ? key * ksl + 4 * u : 0), ok);
      cp_async16(vd + j * kD + 4 * u, vb + (ok ? key * vsl + 4 * u : 0), ok);
    }
  };

  float o[8][8], m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[r][c] = 0.f;
  }

  if (ntiles > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // Q: 128 rows x 16 units
      const int e = tid + i * kF32Threads, r = e / 16, u = e % 16;
      const bool ok = q0 + r < L;
      cp_async16(qs + r * kD + 4 * (u ^ ((r >> 2) & 7)), qb + (ok ? (q0 + r) * qsl + 4 * u : 0), ok);
    }
    load_tile(0);
    load_tile(1);
    cp_async_commit();
  }
  for (int t0 = 0; t0 < ntiles; t0 += 2) {  // a round: tile t0 for group 0, t0 + 1 for group 1
    cp_async_wait<0>();
    __syncthreads();  // this round's tiles (and Q) landed for every thread, and the last round is computed
    if (t0 + 2 < ntiles) {
      load_tile(t0 + 2);  // into the stages that the last round left
      load_tile(t0 + 3);
      cp_async_commit();
    }
    const int t = t0 + grp;
    if (t < ntiles) {
      const float* kt = ks + t % kF32Stages * kF32KvFloats;
      const float* vt = vs + t % kF32Stages * kF32KvFloats;

      // S = Q.K^T: s[r][4h + c] is row row(r), key t * 64 + 4tx + c + 32h
      float s[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
#pragma unroll 1
      for (int u = 0; u < kD / 4; ++u) {
        float4 kf[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = ld4(kt + (4 * tx + (j & 3) + 32 * (j >> 2)) * kD + 4 * (u ^ tx));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 qf = ld4(qs + row(r) * kD + 4 * (u ^ sw));
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float a = s[r][j];
            a = fmaf(qf.x, kf[j].x, a);
            a = fmaf(qf.y, kf[j].y, a);
            a = fmaf(qf.z, kf[j].z, a);
            s[r][j] = fmaf(qf.w, kf[j].w, a);
          }
        }
      }

      // masks, online softmax in base 2; the factor O takes
      const int k0 = t * kF32Keys;
      if (k0 + kF32Keys > kfree) {  // some row's limit falls inside this tile
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int lim = key_limit(min(q0 + row(r), L - 1), len, chunk, L);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k0 + 4 * tx + (j & 3) + 32 * (j >> 2) >= lim) s[r][j] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float mx = s[r][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[r][j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[r], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new * scale_log2;  // a row with no valid key yet stays at 0
        const float corr = exp2f(m[r] * scale_log2 - base);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[r][j] = exp2f(fmaf(s[r][j], scale_log2, -base));
          rs += s[r][j];
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        rs += __shfl_xor_sync(0xffffffffu, rs, 4);
        l[r] = l[r] * corr + rs;
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < 8; ++c) o[r][c] *= corr;
      }

      // O += P.V, half a key tile at a time: the warp writes its rows' P, then reads them back as float4
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          *reinterpret_cast<float4*>(ps + row(r) * 32 + 4 * (tx ^ sw)) =
              make_float4(s[r][4 * hh], s[r][4 * hh + 1], s[r][4 * hh + 2], s[r][4 * hh + 3]);
        __syncwarp();
#pragma unroll 1
        for (int kq = 0; kq < 8; ++kq) {  // keys 32hh + 4kq ..
          float4 pf[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) pf[r] = ld4(ps + row(r) * 32 + 4 * (kq ^ sw));
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float* vr = vt + (32 * hh + 4 * kq + cc) * kD + 4 * tx;
            const float4 v0 = ld4(vr), v1 = ld4(vr + 32);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float p = cc == 0 ? pf[r].x : cc == 1 ? pf[r].y : cc == 2 ? pf[r].z : pf[r].w;
              o[r][0] = fmaf(p, v0.x, o[r][0]);
              o[r][1] = fmaf(p, v0.y, o[r][1]);
              o[r][2] = fmaf(p, v0.z, o[r][2]);
              o[r][3] = fmaf(p, v0.w, o[r][3]);
              o[r][4] = fmaf(p, v1.x, o[r][4]);
              o[r][5] = fmaf(p, v1.y, o[r][5]);
              o[r][6] = fmaf(p, v1.z, o[r][6]);
              o[r][7] = fmaf(p, v1.w, o[r][7]);
            }
          }
        }
        __syncwarp();  // P is read before the next half overwrites it
      }
    }
  }

  // merge the groups: group 1 leaves its max, sum and output in the (idle) ring, thread by thread;
  // group 0 takes them into its own in a fixed order and writes the rows
  float4* mo = reinterpret_cast<float4*>(ks);  // [16][128] float4: the group's O
  float* mm = ks + 16 * 4 * kF32Group;         // [8][128] max, then [8][128] sum
  __syncthreads();  // the ring is read
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      mo[(2 * r) * kF32Group + gt] = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      mo[(2 * r + 1) * kF32Group + gt] = make_float4(o[r][4], o[r][5], o[r][6], o[r][7]);
      mm[r * kF32Group + gt] = m[r];
      mm[(8 + r) * kF32Group + gt] = l[r];
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float m1 = mm[r * kF32Group + gt], l1 = mm[(8 + r) * kF32Group + gt];
    const float mt = fmaxf(m[r], m1);
    const float f0 = mt == -INFINITY ? 0.f : exp2f((m[r] - mt) * scale_log2);
    const float f1 = mt == -INFINITY ? 0.f : exp2f((m1 - mt) * scale_log2);
    const float lt = l[r] * f0 + l1 * f1;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    const float4 a = mo[(2 * r) * kF32Group + gt], c = mo[(2 * r + 1) * kF32Group + gt];
    const int i = q0 + row(r);
    if (i >= L) continue;
    float* orow = out + (((long long)b * L + i) * H + h) * kD + 4 * tx;
    *reinterpret_cast<float4*>(orow) =
        make_float4((o[r][0] * f0 + a.x * f1) * inv, (o[r][1] * f0 + a.y * f1) * inv,
                    (o[r][2] * f0 + a.z * f1) * inv, (o[r][3] * f0 + a.w * f1) * inv);
    *reinterpret_cast<float4*>(orow + 32) =
        make_float4((o[r][4] * f0 + c.x * f1) * inv, (o[r][5] * f0 + c.y * f1) * inv,
                    (o[r][6] * f0 + c.z * f1) * inv, (o[r][7] * f0 + c.w * f1) * inv);
  }
}

}  // namespace

// The float32 route: q, k, v float32 strided (B, H, L, 64) views (strides in
// elements, multiples of 4, pointers 16-byte aligned), out float32 (B, L, H, 64).
extern "C" int fangyan_chunk_flash_attention_f32(const void* q, const void* k, const void* v, const void* mel_len,
                                                 void* out, int B, int H, int L, int D, int chunk, long long qsb,
                                                 long long qsh, long long qsl, long long ksb, long long ksh,
                                                 long long ksl, long long vsb, long long vsh, long long vsl,
                                                 void* stream) {
  const long long strides[9] = {qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl};
  const long long items = (long long)B * H * ((L + kF32Rows - 1) / kF32Rows);
  if (D != kD || B < 1 || H < 1 || L < 1 || chunk < 0 || items > 0x7fffffff ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  for (long long s : strides)
    if (s < 0 || s % 4) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(chunk_flash_attention_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
    // all of the SM's unified memory as shared memory
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(chunk_flash_attention_f32_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  chunk_flash_attention_f32_kernel<<<(unsigned)items, kF32Threads, kF32Smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int32_t*)mel_len, (float*)out, H, L, chunk, qsb, qsh,
      qsl, ksb, ksh, ksl, vsb, vsh, vsl, B * H);
  return (int)cudaGetLastError();
}
