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
// hundreds) operations, 2*M*K*N. Design (Hopper, sm_90a):
//   - operands swapped: the kernel computes out^T = W^T . x^T on wgmma, so
//     the dequantized weight is the A operand, which wgmma takes from
//     registers, and x is the B operand, read by wgmma from shared memory
//     in its own (M, K) row-major layout (K-major). The token count is
//     wgmma's N dimension (16 or 128 tokens a block), so decode wastes no
//     64-row tile;
//   - a block owns 64 output channels at decode (one consumer warpgroup and
//     a producer warp, two blocks an SM), else 128, or 256 at 128 tokens
//     where those blocks fill the card (each x row then serves more
//     channels); with two consumer warpgroups each owns half of them, one or
//     two m64 tiles, over all the block's tokens, so no weight is
//     dequantized twice. A thread's accumulator rows are 2 or 4 adjacent
//     channels: one 16- or 32-bit shared load gives all their packed bytes
//     for a K pair, and one A-operand register is exactly one packed byte
//     (two consecutive K of one channel). The scale multiplies accumulator
//     rows;
//   - dequantization with bit operations, three a register: a byte permute
//     puts the byte's two nibbles at bits 0 and 16, one lop3 flips their
//     sign bits (n + 8) and sets the exponent of 128 (the bf16 pair 128 + u,
//     exact), and one bf16x2 FMA subtracts 136: exact for [-8, 7], no
//     int-to-float conversion;
//   - a ring of shared-memory stages filled by TMA (x with the 128-byte
//     swizzle that wgmma reads, the packed weight likewise) and guarded by
//     mbarriers; one producer thread starts the loads (a producer
//     warpgroup hands its registers to the consumers with setmaxnreg), and
//     the consumers keep two steps' products in flight and dequantize step
//     t+1 while wgmma runs step t. A decode step carries 256 K, so that a
//     block's few steps have many bytes in flight at once;
//   - one launch at every M. Without a split the grid is persistent (as
//     many blocks as the SMs hold, walking over the output tiles, each
//     block's ring running on from tile to tile). Where the output tiles
//     alone do not fill the card (at decode down_proj has 14 column tiles of
//     64), K is split over the blocks of a thread-block cluster of up to 8;
//     each block pushes its float32 partial, a slice to each block, into
//     their shared memory (distributed shared memory), and after one cluster
//     barrier each block sums its slice in rank order (no atomics, no
//     device-memory workspace, the same result from run to run).
//   - the packed weight (K/2, N) has only 64-128 contiguous bytes per block
//     and packed row, so each decode block requests many small TMA rows; at
//     decode the kernel takes about 5x its DRAM bound (see PERF.md).
// The float32 route (`fangyan_int4_matmul_f32`, at the end of the file) has
// SIMT kernels of its own.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int kBk = 64;                   // K of one box: one 128-byte swizzle row of x
constexpr int kMaxCluster = 8;

// BN tokens x NC CH channels a block; each of its NC consumer warpgroups
// owns CH channels (CH / 64 m64 tiles) over all BN tokens. Two consumer
// warpgroups come with a producer warpgroup that gives them its registers,
// one (at decode, two blocks an SM) with a producer warp.
template <int BN, int CH, int NC>
struct Tile {
  static constexpr int kN = NC * CH;                             // output channels of a block
  static constexpr int kT = CH / 64;                             // m64 tiles of a warpgroup
  static constexpr int kThreads = NC * 128 + (NC == 2 ? 128 : 32);
  static constexpr int kMinBlocks = NC == 2 ? 1 : 2;             // blocks an SM holds
  // output channels (bytes a row) of one weight box: 128 with the 128-byte
  // swizzle, or 64 unswizzled
  static constexpr int kBoxN = NC == 2 ? 128 : 64;
  // K of a pipeline step, in boxes of 64: a decode step carries more K, so
  // that each of the block's few steps has more loads and products in flight
  static constexpr int kSub = BN == 16 ? 4 : 1;
  static constexpr int kKK = 4 * kSub;                           // wgmma K steps (16) a pipeline step
  static constexpr int kWBox = kSub * kBk / 2 * kBoxN;           // one weight box: 32 kSub rows of kBoxN bytes
  static constexpr int kWBytes = kN / kBoxN * kWBox;
  static constexpr int kXBytes = BN * kBk * 2;                   // one x box: BN rows of 64 K
  static constexpr int kStage = kWBytes + kSub * kXBytes;        // a multiple of 1024
  static constexpr int kStages = BN == 16 ? 4 : CH == 64 ? 6 : 8;
  static constexpr int kGroups = BN * kN / 4;                    // float4 groups of a block's output tile
  // the cluster partials a block receives: cs slots of ceil(kGroups / cs) groups (no split at CH = 128)
  static constexpr int kRecvBytes = CH == 64 ? (kGroups + kMaxCluster) * 16 : 0;
  static constexpr int kRingBytes = kStages * kStage;
  static constexpr int kSmem = kRingBytes + kRecvBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
};

// byte (row r, column c) of a weight box: rows of 128 bytes with the 128-byte swizzle, or of 64 plain
template <int ROW>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (ROW == 64) return static_cast<uint32_t>(r * 64 + c);
  return static_cast<uint32_t>(r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15));
}

// packed byte j of v -> bf16 pair (low nibble, the smaller K, in the low
// half); y = v >> 4. Exact for nibbles in [-8, 7].
template <int J>
__device__ __forceinline__ uint32_t dequant(uint32_t v, uint32_t y) {
  uint32_t t, r;
  // bits 0-3: the low nibble (byte j of v); bits 16-19: the high nibble (byte j of y)
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(t) : "r"(v), "r"(y), "n"(((4 + J) << 8) | J));
  // b ? a ^ c : c with b = 0x000F000F, c = 0x43084308: inside the mask the nibble with its
  // sign bit flipped (u = n + 8), outside it 0x4300 (the bf16 128)
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(t) : "r"(t), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(t), "r"(0x3F803F80u), "r"(0xC308C308u));  // - 136
  return r;
}

// The A operand of one pipeline step: a[kk][t] for K step kk (16 K) and m64
// tile t. wt is the thread's weight box and c its first channel (byte) in
// it: accumulator row 16 * warp + g + 8h of tile t is channel c + 2t + h, so
// one 16-bit (T = 1) or 32-bit (T = 2) shared load gives all the thread's
// channels for one packed row.
template <int KK, int T, int ROW>
__device__ __forceinline__ void load_a(uint32_t (&a)[KK][T][4], const uint8_t* wt, int c, int tg) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // packed rows of K 16kk + 2tg (+1), and 8 further
      const uint8_t* p = wt + swz<ROW>(kk * 8 + 4 * i + tg, c);
      const uint32_t v = T == 1 ? *reinterpret_cast<const uint16_t*>(p) : *reinterpret_cast<const uint32_t*>(p);
      const uint32_t y = v >> 4;
      a[kk][0][2 * i] = dequant<0>(v, y);
      a[kk][0][2 * i + 1] = dequant<1>(v, y);
      if constexpr (T == 2) {
        a[kk][1][2 * i] = dequant<2>(v, y);
        a[kk][1][2 * i + 1] = dequant<3>(v, y);
      }
    }
  }
}

// x boxes of BN rows x 64 K, one after the other from xs
template <int BN, int KK, int T>
__device__ __forceinline__ void mma_step(float (&acc)[T][BN / 2], const uint32_t (&a)[KK][T][4], uint32_t xs) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint64_t desc = desc_sw128(xs + kk / 4 * (BN * kBk * 2) + kk % 4 * 32, 16, 1024);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if constexpr (BN == 16) wgmma_rs_n16<0>(acc[t], a[kk][t], desc);
      else wgmma_rs_n128<0>(acc[t], a[kk][t], desc);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Without a split (cs = 1) the grid is persistent: block j works on output
// tiles j, j + gridDim.x, ... of the tiles_n x token-tile grid (channel tile
// fastest, so the blocks of a round share x in L2), and the ring runs on
// across tiles, so the next tile's loads overlap this tile's last products
// and its stores. With a split the grid is (tiles_n, token tiles * cs) in
// clusters of (1, cs, 1): block y works on token tile y / cs and sums K
// steps [r * per, min((r + 1) * per, steps)) with r = y % cs, its rank in
// the cluster.
template <int BN, int CH, int NC>
__global__ void __launch_bounds__(Tile<BN, CH, NC>::kThreads, Tile<BN, CH, NC>::kMinBlocks) int4_matmul_kernel(
    const __grid_constant__ CUtensorMap tm_x,  // x (M, K) bf16, box (64, BN)
    const __grid_constant__ CUtensorMap tm_w,  // w (K/2, N) bytes, box (kBoxN, 32 kSub)
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int N, int steps, int per, int cs,
    int tiles) {
  using T = Tile<BN, CH, NC>;
  constexpr int kStages = T::kStages, kKK = T::kKK, kT = T::kT, kBoxN = T::kBoxN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float4* recv = reinterpret_cast<float4*>(smem + T::kRingBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kRingBytes + T::kRecvBytes);
  uint64_t* empty = full + kStages;
  auto w_tile = [&](int s) { return smem + s * T::kStage; };
  auto x_tile = [&](int s) { return smem + s * T::kStage + T::kWBytes; };

  const int wg = threadIdx.x / 128;
  const int tiles_n = N / T::kN;
  const int rank = blockIdx.y % cs;
  const int step0 = rank * per;
  const int nsteps = max(0, min(per, steps - step0));
  const int slot = (T::kGroups + cs - 1) / cs;  // groups each block of the cluster finishes
  // this block's output tiles: first, first + stride, ... < tiles
  const int first = cs == 1 ? (int)blockIdx.x : (int)blockIdx.x + (int)blockIdx.y / cs * tiles_n;
  const int stride = cs == 1 ? (int)gridDim.x : tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // every consumer warp releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: one thread keeps the ring full. A producer warpgroup
    // hands its registers to the consumers: 40 + 2 x 232 a thread is the
    // 3 x 168 that __launch_bounds__ gives the block.
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == NC * 128) {
      prefetch_map(&tm_x);
      prefetch_map(&tm_w);
      int gs = 0;  // steps loaded so far, over all tiles
      for (int tile = first; tile < tiles; tile += stride) {
        const int n0 = tile % tiles_n * T::kN, m0 = tile / tiles_n * BN;
        for (int t = 0; t < nsteps; ++t, ++gs) {
          const int s = gs % kStages;
          if (gs >= kStages) mbar_wait(&empty[s], (gs / kStages - 1) & 1);
          mbar_arrive_expect_tx(&full[s], T::kStage);
          const int k0 = (step0 + t) * T::kSub * kBk;  // K past the end reads as zeros
#pragma unroll
          for (int b = 0; b < T::kN / kBoxN; ++b)
            tma_load_2d(w_tile(s) + b * T::kWBox, &tm_w, &full[s], n0 + b * kBoxN, k0 / 2);
#pragma unroll
          for (int b = 0; b < T::kSub; ++b) tma_load_2d(x_tile(s) + b * T::kXBytes, &tm_x, &full[s], k0 + b * kBk, m0);
        }
      }
    }
    if (cs > 1) cg::this_cluster().sync();  // the partials have arrived
  } else {
    // ---- consumer warpgroup wg: channels CH wg .. CH wg + CH - 1 x BN tokens
    if constexpr (NC == 2) setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
    const int cb = kT * 2 * (8 * warp + g);                       // first channel in the weight box
    const int box_off = CH == 64 ? 64 * wg : 0;                   // this warpgroup's channels in the box
    const int box = CH == 64 ? 0 : wg;                            // ... and its box
    const int c = CH * wg + cb;                                   // first channel in the block
    // Two products in flight: step t's wgmma is started before step t-1's is
    // waited for. The A registers alternate between two fixed buffers, and a
    // buffer is rewritten only after the wait that covers the wgmma reading it.
    float acc[kT][BN / 2];
    uint32_t a0[kKK][kT][4], a1[kKK][kT][4];
    int g0 = 0;  // steps consumed before this tile, over all tiles
    auto stage = [&](int t) { return (g0 + t) % kStages; };
    auto wait_step = [&](int t) { mbar_wait(&full[stage(t)], ((g0 + t) / kStages) & 1); };
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(&empty[stage(t)]);
    };
    auto fence_a = [&](uint32_t(&a)[kKK][kT][4]) {
#pragma unroll
      for (int kk = 0; kk < kKK; ++kk)
#pragma unroll
        for (int t = 0; t < kT; ++t)
#pragma unroll
          for (int r = 0; r < 4; ++r) fence_operand(a[kk][t][r]);
    };
    auto step = [&](int t, uint32_t(&use)[kKK][kT][4], uint32_t(&other)[kKK][kT][4]) {
      wgmma_fence();
      mma_step<BN, kKK, kT>(acc, use, smem_u32(x_tile(stage(t))));
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();  // step t-1 is done: release its stage and registers
        fence_a(other);
        release(t - 1);
      }
      if (t + 1 < nsteps) {  // dequantize the next step while the tensor cores run this one
        wait_step(t + 1);
        load_a<kKK, kT, kBoxN>(other, w_tile(stage(t + 1)) + box * T::kWBox, box_off + cb, tg);
      }
    };

    for (int tile = first; tile < tiles; tile += stride, g0 += nsteps) {
      const int n0 = tile % tiles_n * T::kN, m0 = tile / tiles_n * BN;
#pragma unroll
      for (int t = 0; t < kT; ++t)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[t][j] = 0.f;
      if (nsteps > 0) {
        wait_step(0);
        load_a<kKK, kT, kBoxN>(a0, w_tile(stage(0)) + box * T::kWBox, box_off + cb, tg);
      }
      for (int t = 0; t < nsteps; t += 2) {
        step(t, a0, a1);
        if (t + 1 < nsteps) step(t + 1, a1, a0);
      }
      wgmma_wait<0>();
      fence_a(a0);
      fence_a(a1);
#pragma unroll
      for (int t = 0; t < kT; ++t)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) fence_operand(acc[t][j]);
      if (nsteps > 0) release(nsteps - 1);

      // acc[t][4j + 2h + e]: channel c + 2t + h, token m0 + 8j + 2tg + e
      if (cs == 1) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + 8 * j + 2 * tg + e;
            if (m >= M) continue;
            __nv_bfloat16* o = out + (size_t)m * N + n0 + c;
            if constexpr (kT == 1) {
              const float2 sc = *reinterpret_cast<const float2*>(scale + n0 + c);
              *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[0][4 * j + e] * sc.x, acc[0][4 * j + 2 + e] * sc.y);
            } else {
              const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + c);
              uint2 v;
              v.x = pack_bf16(acc[0][4 * j + e] * sc.x, acc[0][4 * j + 2 + e] * sc.y);
              v.y = pack_bf16(acc[1][4 * j + e] * sc.z, acc[1][4 * j + 2 + e] * sc.w);
              *reinterpret_cast<uint2*>(o) = v;
            }
          }
      } else if constexpr (kT == 1) {
        // Push each float32 partial to the block that finishes it: group i
        // (token i / 32, channels 4 (i % 32) ..) belongs to block i % cs and
        // lands in its slot `rank`; one cluster barrier, then each block sums
        // its groups over the slots in rank order.
        cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = (8 * j + 2 * tg + e) * (T::kN / 4) + c / 4;
            float4* dst = cluster.map_shared_rank(recv, i % cs) + rank * slot + i / cs;
            reinterpret_cast<float2*>(dst)[(c / 2) & 1] = make_float2(acc[0][4 * j + e], acc[0][4 * j + 2 + e]);
          }
        cluster.sync();
        for (int li = threadIdx.x; li < slot; li += NC * 128) {
          const int i = li * cs + rank;
          const int m = m0 + i / (T::kN / 4), cc = (i % (T::kN / 4)) * 4;
          if (i >= T::kGroups || m >= M) continue;
          float4 sum = recv[li];
          for (int q = 1; q < cs; ++q) {
            const float4 p = recv[q * slot + li];
            sum.x += p.x;
            sum.y += p.y;
            sum.z += p.z;
            sum.w += p.w;
          }
          const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + cc);
          uint2 v;
          v.x = pack_bf16(sum.x * sc.x, sum.y * sc.y);
          v.y = pack_bf16(sum.z * sc.z, sum.w * sc.w);
          *reinterpret_cast<uint2*>(out + (size_t)m * N + n0 + cc) = v;
        }
      }
    }
  }
}

template <int BN, int CH, int NC>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const float* scale, __nv_bfloat16* out, int M,
                   int N, int steps, int per, int cs, cudaStream_t stream) {
  using T = Tile<BN, CH, NC>;
  auto* kernel = int4_matmul_kernel<BN, CH, NC>;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int tiles = N / T::kN * ((M + BN - 1) / BN);
  cudaLaunchConfig_t cfg = {};
  // persistent without a split (as many blocks as the SMs hold), else a block per tile and split
  const int resident = sms * T::kMinBlocks;
  cfg.gridDim = cs == 1 ? dim3(tiles < resident ? tiles : resident) : dim3(N / T::kN, (M + BN - 1) / BN * cs);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = 1;
  la[0].val.clusterDim.y = cs;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = cs > 1 ? 1 : 0;  // without a split, no cluster
  return cudaLaunchKernelEx(&cfg, kernel, tm_x, tm_w, scale, out, M, N, steps, per, cs, tiles);
}

}  // namespace

// tile_m x tile_n: tokens x output channels a block covers, 16 x 64 (decode,
// two blocks an SM), 128 x 128 or 128 x 256 (the last without a split). K
// goes in steps of 256 or 64 (a step past K reads zeros) and is split over
// clusters of cs blocks (1-8), `per` steps each.
extern "C" int fangyan_int4_matmul(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
                                   int tile_m, int tile_n, int cs, int per, void* stream) {
  const bool shape_ok = (tile_m == 16 && tile_n == 64) || (tile_m == 128 && tile_n == 128) ||
                        (tile_m == 128 && tile_n == 256 && cs == 1);
  const int step_k = tile_m == 16 ? 4 * kBk : kBk;
  const int steps = (K + step_k - 1) / step_k;
  if (!shape_ok || M < 1 || K < kBk || K % kBk || N < tile_n || N % tile_n || cs < 1 || cs > kMaxCluster ||
      per < 1 || (long long)(cs - 1) * per >= steps || (long long)cs * per < steps ||
      (long long)(M + tile_m - 1) / tile_m * (N / tile_n) > 0x7fffffff || N / tile_n > 0x7fffffff ||
      (long long)(M + tile_m - 1) / tile_m * cs > 65535)
    return (int)cudaErrorInvalidValue;
  const int box_n = tile_n == 64 ? 64 : 128;  // weight box rows: 64 bytes plain, or 128 swizzled
  CUtensorMap tm_x, tm_w;
  const uint64_t xd[2] = {(uint64_t)K, (uint64_t)M}, xs[1] = {(uint64_t)K * 2};
  const uint32_t xb[2] = {(uint32_t)kBk, (uint32_t)tile_m};
  const uint64_t wd[2] = {(uint64_t)N, (uint64_t)K / 2}, ws[1] = {(uint64_t)N};
  const uint32_t wb[2] = {(uint32_t)box_n, (uint32_t)step_k / 2};
  if (!hopper_host::make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb) ||
      !hopper_host::make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wd, ws, wb,
                             box_n == 64 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  cudaError_t err;
  if (tile_m == 16) err = launch<16, 64, 1>(tm_x, tm_w, sc, o, M, N, steps, per, cs, s);
  else if (tile_n == 128) err = launch<128, 64, 2>(tm_x, tm_w, sc, o, M, N, steps, per, cs, s);
  else err = launch<128, 128, 2>(tm_x, tm_w, sc, o, M, N, steps, per, cs, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The float32 route: x (M, K) float32 against the same packed weight and
// scale, float32 out (the Pallas kernel writes x's dtype), with float32 FMAs
// on the CUDA cores and no TF32 rounding. One launch a call, of one of two
// tiles (`ops/int4_matmul.plan_f32`). Both split K over a thread-block
// cluster where the output tiles leave SMs idle; each block of the cluster
// sums a range of K into a float32 partial, and each block finishes a slice
// of the tile by adding the ranks' partials in rank order through
// distributed shared memory: no atomics, no device-memory workspace, no
// second kernel, the same result from run to run.
//
// Decode tile (M <= 16; the float32 batch decodes at M = 4): bound by the
// packed weight's bytes (K*N/2, read once for M tokens) at M <= 8 and near
// the balance at 16 (2*M*K*N operations against float32's 67 TFLOP/s).
//   - every row is a real token: M rounds up to a bucket of 4, 8 or 16 rows
//     (`MB`), and a thread holds MB x 64/MB accumulators (16, 8 or 4
//     channels), so the register count is the same in every bucket;
//   - the weight streams from device memory into registers: each packed
//     byte is read once, by one thread, neighbouring threads on neighbouring
//     addresses, 16, 8 or 4 bytes a load, 128 bytes in flight a thread; it
//     is dequantized in registers and never staged in shared memory. A
//     nibble becomes an exact float32 in two operations: one lop3 puts it
//     (sign bit flipped) into the mantissa of 2^23, one add or FMA takes
//     2^23 + 8 away. The bytes at odd positions of a 32-bit word come out
//     times 256, which their channel's scale takes back (exact: a power of
//     two);
//   - the block's K-range of x (MB rows, zeros past M) is staged once in
//     shared memory by 4-byte cp.async, transposed, while the first weight
//     loads fly, so the M values of one K come as float4 broadcasts: at most
//     one 16-byte shared load per 16 FMAs;
//   - a block of 256 threads covers 64 or 128 channels; its threads split
//     the K-range (thread rows klane, klane + KL, ...) and sum their
//     partials through shared memory in klane order. The sums go by st.async
//     straight into the shared memory of the block that finishes them, which
//     waits on its own mbarrier (`ClusterSum`): the launch, one DRAM latency
//     and these sums are most of a call's time at M = 4, not its bytes.
// Prefill tile (M > 16; M = 128 on the float32 batch): bound by operations.
//   - a register-blocked SIMT GEMM: a group of 128 threads covers 128 tokens
//     x 64 or 128 channels, 8 tokens x 8 or 16 channels a thread, read from
//     shared memory as float4 (16 loads of 16 bytes per 256 FMAs, or 24 per
//     512); x's rows are swizzled by 16-byte unit so that a warp's rows hit
//     distinct banks. Shared memory hands the SM's lanes 32 floats a clock
//     against 128 FMAs, so these tiles keep it about as busy as the FMA
//     pipes, and the tile runs near half of float32's peak;
//   - steps of 32 K in a two-stage ring filled by cp.async (x's tile and
//     the packed weight's bytes), so the next step's loads are in flight
//     while one is computed; the weight's step is dequantized into shared
//     memory once per group (exact sign-extended nibbles), not once per
//     thread;
//   - the planner gives gate_up_proj at M = 128 (76 tiles of 128 channels
//     for 132 SMs) a cluster of 3 and down_proj (14 tiles of 64) one of 8;
//     where the blocks still do not outnumber the SMs a block has two groups,
//     which take alternate steps of its K range and add their sums in order,
//     so each SM runs 8 warps. The partial tile (32-64 KB) stays in the
//     block's ring and the cluster reads it after a cluster barrier: a
//     receive area of its own would cost the ring's second block an SM.

namespace {

using namespace hopper;

constexpr int kF32Threads = 256;  // a decode block
constexpr int kF32DecodeStepK = 64;
constexpr int kF32Bm = 128;       // tokens of a prefill block
constexpr int kF32Bk = 32;        // K of a prefill step
constexpr int kF32Stages = 2;

template <int MB, int BN>
struct F32Decode {
  static constexpr int kCpt = 64 / MB;                // channels a thread: MB x kCpt = 64 accumulators
  static constexpr int kWords = kCpt / 4;             // 32-bit words of a packed row a thread loads
  static constexpr int kCl = BN / kCpt;               // threads across the channels
  static constexpr int kKl = kF32Threads / kCl;       // threads across K
  static constexpr int kU = 32 / kWords;              // packed rows a thread has in flight: 128 bytes
  static constexpr int kXk = 8192 / MB;               // K of x staged at once (32 KB)
  static constexpr int kGroups = MB * BN / 4;         // float4 groups of the block's output tile
  static constexpr int kRedFloats = kF32Threads * 64; // the threads' partials (aliases x)
  static constexpr int kSplit = kGroups < kF32Threads ? kF32Threads / kGroups : 1;  // threads summing a group
  static constexpr int kSmem = kRedFloats * 4 + (kGroups + kMaxCluster) * kSplit * 16;  // + the cluster's sums
};

template <int TN, int G>
struct F32Prefill {
  static constexpr int kBn = 8 * TN;                  // channels a block: 8 threads x TN
  static constexpr int kThreads = 128 * G;            // G groups of 16 x 8 threads, 8 tokens x TN channels each
  static constexpr int kMinBlocks = G == 2 ? 1 : TN == 8 ? 3 : 2;  // blocks an SM holds
  static constexpr int kXFloats = kF32Bm * kF32Bk;    // a stage of x: 128 rows x 32 K
  static constexpr int kWBytes = kF32Bk / 2 * kBn;    // a stage of the packed weight: 16 rows x kBn bytes
  static constexpr int kWOff = kF32Stages * kXFloats * 4;
  static constexpr int kFOff = kWOff + kF32Stages * kWBytes;
  static constexpr int kGroupSmem = kFOff + kF32Bk * kBn * 4;  // + the dequantized step, 32 x kBn floats
  static constexpr int kPart = kF32Bm * kBn * 4;      // a partial tile: group 1's, after group 0's memory
  static constexpr int kSmem = G * kGroupSmem > (G - 1) * kGroupSmem + kPart ? G * kGroupSmem
                                                                            : (G - 1) * kGroupSmem + kPart;
};

// the two nibbles of byte J of v (channel J of the word) as exact floats,
// times 2^(8 (J & 1)); v16 = v >> 16
template <int J>
__device__ __forceinline__ void nibbles(uint32_t v, uint32_t v16, float& lo, float& hi) {
  constexpr int kB = 8 * (J & 1);
  const uint32_t src = J < 2 ? v : v16;
  // the nibble with its sign bit flipped (n + 8 in [0, 15]) in the mantissa of 2^23
  const uint32_t lo_bits = (src & (0xFu << kB)) ^ ((0x8u << kB) | 0x4B000000u);
  const uint32_t hi_bits = (src & (0xF0u << kB)) ^ ((0x80u << kB) | 0x4B000000u);
  lo = __uint_as_float(lo_bits) - (8388608.f + 8.f * (1 << kB));
  hi = fmaf(__uint_as_float(hi_bits), 0.0625f, -(524288.f + 8.f * (1 << kB)));
}

template <int W>
__device__ __forceinline__ void load_words(uint32_t (&w)[W], const int8_t* p) {
  if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// out[m, n..n+3] = sum * scale[n..n+3]; the sums of odd channels carry 256
__device__ __forceinline__ void store_scaled(float* out, const float* scale, int n, float4 s) {
  const float4 sc = *reinterpret_cast<const float4*>(scale + n);
  *reinterpret_cast<float4*>(out) =
      make_float4(s.x * sc.x, s.y * (sc.y * 0.00390625f), s.z * sc.z, s.w * (sc.w * 0.00390625f));
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// The sum of a cluster's partials in rank order, through distributed shared
// memory: block r finishes the float4 groups [r slot, (r + 1) slot) of its
// tile, and every block pushes `srcs` contributions to each group (sums over
// disjoint parts of its K range) into the finishing block's `recv`
// [cs][srcs][slot] by st.async, which counts their bytes on that block's
// mbarrier; the finishing block adds them in (rank, src) order.
struct ClusterSum {
  float4* recv;
  uint64_t* bar;
  int cs, rank, slot, srcs, owned;

  __device__ ClusterSum(float4* recv_, uint64_t* bar_, int groups, int cs_, int rank_, int srcs_)
      : recv(recv_), bar(bar_), cs(cs_), rank(rank_), slot((groups + cs_ - 1) / cs_), srcs(srcs_) {
    owned = max(0, min(groups, (rank + 1) * slot) - rank * slot);
  }
  // at the kernel's start: the barrier expects the other blocks' bytes; the
  // cluster barrier's phase 0, waited on by ready(), says it is initialised
  __device__ void start() {
    if (cs == 1) return;
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      fence_barrier_init();
      mbar_arrive_expect_tx(bar, (cs - 1) * srcs * owned * 16);
    }
    cluster_arrive_relaxed();
  }
  __device__ void ready() {
    if (cs > 1) cluster_wait();
  }
  __device__ void push(int g, int src, float4 v) {
    const int r = g / slot, i = (rank * srcs + src) * slot + g - r * slot;
    if (r == rank) recv[i] = v;
    else st_async(cluster_map(recv + i, r), v, cluster_map(bar, r));
  }
  // after this block's pushes: f(group, sum) for each group it finishes
  template <typename F>
  __device__ void finish(int nthreads, F f) {
    __syncthreads();  // this block's own contributions
    if (cs > 1) mbar_wait(bar, 0);
    for (int i = threadIdx.x; i < owned; i += nthreads) {
      float4 s = recv[i];
      for (int j = 1; j < cs * srcs; ++j) add4(s, recv[j * slot + i]);
      f(rank * slot + i, s);
    }
  }
};

// Grid (N / BN, cs) in clusters of (1, cs, 1): block (x, r) covers channels
// BN x .. and packed rows [r * per * 32, min(K/2, (r + 1) * per * 32)).
template <int MB, int BN>
__global__ void __launch_bounds__(kF32Threads, 2) int4_matmul_f32_decode(
    const float* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    float* __restrict__ out, int M, int K, int N, int per, int cs) {
  using T = F32Decode<MB, BN>;
  constexpr int kCpt = T::kCpt, kW = T::kWords, kKl = T::kKl, kU = T::kU;
  extern __shared__ __align__(16) float f32_smem[];
  float* xs = f32_smem;  // [K of the chunk][MB]: x^T, zeros past M; then the threads' partials
  __shared__ uint64_t bar;
  const int tid = threadIdx.x, cl = tid % T::kCl, kl = tid / T::kCl;
  const int n0 = blockIdx.x * BN;
  const int rank = blockIdx.y;
  ClusterSum sum(reinterpret_cast<float4*>(f32_smem + T::kRedFloats), &bar, T::kGroups, cs, rank, T::kSplit);
  sum.start();
  const int r_begin = rank * per * (kF32DecodeStepK / 2), r_end = min(K / 2, r_begin + per * (kF32DecodeStepK / 2));
  const int8_t* wp = w + n0 + cl * kCpt;

  float acc[MB][kCpt];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[m][c] = 0.f;

  uint32_t wv[kU][kW];
  // packed rows r, r + kKl, ... r + (kU - 1) kKl below c1: all kU loads at once, in flight together
  auto load_batch = [&](int r, int c1) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * kKl;
      if (rr < c1) {
        load_words<kW>(wv[u], wp + (long long)rr * N);
      } else {
#pragma unroll
        for (int q = 0; q < kW; ++q) wv[u][q] = 0u;
      }
    }
  };
  for (int c0 = r_begin; c0 < r_end; c0 += T::kXk / 2) {  // chunks of packed rows
    const int c1 = min(r_end, c0 + T::kXk / 2), nk4 = (c1 - c0) / 2;  // K / 4 of the chunk
    load_batch(c0 + kl, c1);  // the first weight loads fly while x is staged
    __syncthreads();          // the last chunk's x is read
    for (int e = tid; e < MB * 4 * nk4; e += kF32Threads) {  // xs[k][m] = xs[e]: m = e % MB
      const int m = e % MB, k = e / MB;
      cp_async4(xs + e, x + (m < M ? (long long)m * K + 2 * c0 + k : 0), m < M);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = c0 + kl; r < c1; r += kKl * kU) {
      if (r != c0 + kl) load_batch(r, c1);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int rr = r + u * kKl;
        if (rr >= c1) continue;
        const float* xe = xs + 2 * (rr - c0) * MB;  // K = 2rr: MB floats, then K = 2rr + 1
#pragma unroll
        for (int q = 0; q < kW; ++q) {
          float lo[4], hi[4];
          const uint32_t v = wv[u][q], v16 = v >> 16;
          nibbles<0>(v, v16, lo[0], hi[0]);
          nibbles<1>(v, v16, lo[1], hi[1]);
          nibbles<2>(v, v16, lo[2], hi[2]);
          nibbles<3>(v, v16, lo[3], hi[3]);
#pragma unroll
          for (int mq = 0; mq < MB / 4; ++mq) {
            const float4 a = *reinterpret_cast<const float4*>(xe + 4 * mq);
            const float4 b = *reinterpret_cast<const float4*>(xe + MB + 4 * mq);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[4 * mq + i][4 * q + j] = fmaf(bv[i], hi[j], fmaf(av[i], lo[j], acc[4 * mq + i][4 * q + j]));
          }
        }
      }
    }
  }

  // the threads' partials, summed over the klanes in order: red[klane][m][q][cl] (16-byte units, so the
  // lanes of a store hit distinct banks); kSplit threads share a group's klanes, and their sums go to the
  // cluster's sum as contributions of their own
  __syncthreads();  // x is read: its memory takes the partials
  float4* red = reinterpret_cast<float4*>(f32_smem);
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int q = 0; q < kW; ++q)
      red[kl * T::kGroups + m * (BN / 4) + q * T::kCl + cl] =
          make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
  __syncthreads();
  constexpr int kPer = kKl / T::kSplit;
  sum.ready();
  for (int e = tid; e < T::kGroups * T::kSplit; e += kF32Threads) {
    const int g = e % T::kGroups, sp = e / T::kGroups;
    float4 s = red[sp * kPer * T::kGroups + g];
    for (int i = sp * kPer + 1; i < (sp + 1) * kPer; ++i) add4(s, red[i * T::kGroups + g]);
    sum.push(g, sp, s);
  }
  // group g: token g / (BN / 4), channels 4 (cl kW + q) .. of the block with q kCl + cl = g % (BN / 4)
  sum.finish(kF32Threads, [&](int g, float4 s) {
    const int m = g / (BN / 4), n = n0 + 4 * (g % T::kCl * kW + g % (BN / 4) / T::kCl);
    if (m < M) store_scaled(out + (long long)m * N + n, scale, n, s);
  });
}

// Grid (N / (8 TN), ceil(M / 128) * cs) in clusters of (1, cs, 1): block
// (x, y) covers tokens 128 (y / cs) .., channels 8 TN x .. and K steps
// [r * per, min(steps, (r + 1) * per)) with r = y % cs; its group g of G
// takes the steps g, g + G, ... of that range.
template <int TN, int G>
__global__ void __launch_bounds__(F32Prefill<TN, G>::kThreads, F32Prefill<TN, G>::kMinBlocks) int4_matmul_f32_prefill(
    const float* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    float* __restrict__ out, int M, int K, int N, int per, int cs) {
  using T = F32Prefill<TN, G>;
  constexpr int BN = T::kBn, kJ = TN / 4;  // a thread's channels: 4tx + 32j + c, j < kJ
  extern __shared__ __align__(16) uint8_t f32p_smem[];
  const int tid = threadIdx.x, grp = tid / 128, gt = tid % 128, tx = gt % 8, ty = gt / 8, sw = ty & 7;
  uint8_t* gsm = f32p_smem + grp * T::kGroupSmem;
  float* xs = reinterpret_cast<float*>(gsm);               // [stage][128][32], unit u of row m at u ^ ((m >> 2) & 7)
  uint8_t* ws = gsm + T::kWOff;                            // [stage][16][BN] packed bytes
  float* wf = reinterpret_cast<float*>(gsm + T::kFOff);    // [32][BN] the dequantized step
  const int n0 = blockIdx.x * BN;
  const int rank = blockIdx.y % cs, m0 = blockIdx.y / cs * kF32Bm;
  const int steps = K / kF32Bk, s0 = rank * per, nsteps = max(0, min(per, steps - s0));
  const int ng = nsteps > grp ? (nsteps - grp + G - 1) / G : 0;  // this group's steps: s0 + grp + G t

  auto issue = [&](int t) {  // the group's step t: x and the packed weight into stage t % kF32Stages
    if (t < ng) {
      const int st = t % kF32Stages, k0 = (s0 + grp + G * t) * kF32Bk;
      float* xd = xs + st * T::kXFloats;
#pragma unroll
      for (int i = 0; i < kF32Bm * kF32Bk / 4 / 128; ++i) {
        const int e = gt + 128 * i, m = e / (kF32Bk / 4), u = e % (kF32Bk / 4);
        const bool ok = m0 + m < M;
        cp_async16(xd + m * kF32Bk + 4 * (u ^ ((m >> 2) & 7)), x + (ok ? (long long)(m0 + m) * K + k0 + 4 * u : 0),
                   ok);
      }
      for (int e = gt; e < T::kWBytes / 16; e += 128) {
        const int pr = e / (BN / 16), c = e % (BN / 16) * 16;
        cp_async16(ws + st * T::kWBytes + pr * BN + c, w + (long long)(k0 / 2 + pr) * N + n0 + c, true);
      }
    }
    cp_async_commit();  // an empty group past the last step keeps the count of groups simple
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < kF32Stages - 1; ++t) issue(t);
  for (int t = 0; t < ng; ++t) {
    cp_async_wait<kF32Stages - 2>();  // step t has landed (this thread's copies) ...
    named_barrier(1 + grp, 128);      // ... the group's; and step t - 1 is computed: its stage and wf are free
    issue(t + kF32Stages - 1);
    {  // dequantize the step once for the group: packed row pr -> K rows 2pr (low nibbles), 2pr + 1
      const uint8_t* wst = ws + (t % kF32Stages) * T::kWBytes;
#pragma unroll
      for (int i = 0; i < T::kWBytes / 4 / 128; ++i) {
        const int e = gt + 128 * i, pr = e / (BN / 4), c = e % (BN / 4) * 4;
        const uint32_t v = *reinterpret_cast<const uint32_t*>(wst + pr * BN + c);
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = (float)((int)(v << (28 - 8 * j)) >> 28);
          hi[j] = (float)((int)(v << (24 - 8 * j)) >> 28);
        }
        *reinterpret_cast<float4*>(wf + 2 * pr * BN + c) = make_float4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<float4*>(wf + (2 * pr + 1) * BN + c) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
    named_barrier(1 + grp, 128);
    const float* xst = xs + (t % kF32Stages) * T::kXFloats;
#pragma unroll
    for (int kq = 0; kq < kF32Bk / 4; ++kq) {  // 4 K at a time
      float4 a[8];  // token 4ty + (i & 3) + 64 (i >> 2), K 4kq ..
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(xst + (4 * ty + (i & 3) + 64 * (i >> 2)) * kF32Bk + 4 * (kq ^ sw));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[kJ];  // channels 4tx + 32j .. at K 4kq + kk
#pragma unroll
        for (int j = 0; j < kJ; ++j) b[j] = *reinterpret_cast<const float4*>(wf + (4 * kq + kk) * BN + 4 * tx + 32 * j);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            acc[i][4 * j] = fmaf(av, b[j].x, acc[i][4 * j]);
            acc[i][4 * j + 1] = fmaf(av, b[j].y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(av, b[j].z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(av, b[j].w, acc[i][4 * j + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // a thread's outputs as float4 units of a 128 x BN tile: (row of i, tx + 8j)
  auto unit = [&](int i, int j) { return (4 * ty + (i & 3) + 64 * (i >> 2)) * (BN / 4) + tx + 8 * j; };
  if constexpr (G == 2) {  // group 1 hands its sums to group 0, which adds them after its own
    __syncthreads();       // both rings are read
    float4* mrg = reinterpret_cast<float4*>(f32p_smem + T::kGroupSmem);
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          mrg[unit(i, j)] = make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const float4 p = mrg[unit(i, j)];
          acc[i][4 * j] += p.x;
          acc[i][4 * j + 1] += p.y;
          acc[i][4 * j + 2] += p.z;
          acc[i][4 * j + 3] += p.w;
        }
    }
  }
  if (cs == 1) {
    if (grp != 0) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + 4 * ty + (i & 3) + 64 * (i >> 2);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int n = n0 + 4 * tx + 32 * j;
        const float4 sc = *reinterpret_cast<const float4*>(scale + n);
        *reinterpret_cast<float4*>(out + (long long)m * N + n) =
            make_float4(acc[i][4 * j] * sc.x, acc[i][4 * j + 1] * sc.y, acc[i][4 * j + 2] * sc.z,
                        acc[i][4 * j + 3] * sc.w);
      }
    }
    return;
  }
  // the cluster: each block's partial, 128 x BN, in its shared memory; block `rank` finishes the
  // groups [rank * slot, (rank + 1) * slot), summing the ranks in order
  __syncthreads();  // the ring is read
  float4* part = reinterpret_cast<float4*>(f32p_smem);
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        part[unit(i, j)] = make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int kGroups = kF32Bm * BN / 4;
  const int slot = (kGroups + cs - 1) / cs;
  for (int g = rank * slot + tid; g < min(kGroups, (rank + 1) * slot); g += T::kThreads) {
    const int m = m0 + g / (BN / 4), n = n0 + g % (BN / 4) * 4;
    if (m >= M) continue;
    float4 s = cluster.map_shared_rank(part, 0)[g];
    for (int q = 1; q < cs; ++q) add4(s, cluster.map_shared_rank(part, q)[g]);
    const float4 sc = *reinterpret_cast<const float4*>(scale + n);
    *reinterpret_cast<float4*>(out + (long long)m * N + n) = make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// one launch of `kernel` (its dynamic shared memory already allowed), in clusters of (1, cs, 1) where cs > 1
template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, int smem, dim3 grid, int threads, int cs, cudaStream_t stream, const float* x,
                       const int8_t* w, const float* scale, float* out, int M, int K, int N, int per) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = 1;
  la[0].val.clusterDim.y = cs;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = cs > 1 ? 1 : 0;  // without a split, no cluster
  return cudaLaunchKernelEx(&cfg, kernel, x, w, scale, out, M, K, N, per, cs);
}

template <int MB, int BN>
cudaError_t launch_f32_decode(const float* x, const int8_t* w, const float* scale, float* out, int M, int K, int N,
                              int cs, int per, cudaStream_t s) {
  auto* kernel = int4_matmul_f32_decode<MB, BN>;
  constexpr int kSmem = F32Decode<MB, BN>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  return launch_f32(kernel, kSmem, dim3(N / BN, cs), kF32Threads, cs, s, x, w, scale, out, M, K, N, per);
}

template <int TN, int G>
cudaError_t launch_f32_prefill(const float* x, const int8_t* w, const float* scale, float* out, int M, int K, int N,
                               int cs, int per, cudaStream_t s) {
  using T = F32Prefill<TN, G>;
  auto* kernel = int4_matmul_f32_prefill<TN, G>;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return attr;
  return launch_f32(kernel, T::kSmem, dim3(N / T::kBn, (M + kF32Bm - 1) / kF32Bm * cs), T::kThreads, cs, s, x, w,
                    scale, out, M, K, N, per);
}

}  // namespace

// The float32 route: x (M, K) float32, w (K/2, N) int8, scale (N,) float32,
// out (M, N) float32, pointers 16-byte aligned; K a multiple of 64, N of
// tile_n. tile_m 4, 8 or 16 is the decode tile (M <= tile_m, steps of 64 K),
// 128 the prefill tile (steps of 32 K); tile_n 64 or 128 channels a block;
// K split over clusters of cs blocks (1-8), `per` steps each.
extern "C" int fangyan_int4_matmul_f32(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
                                       int tile_m, int tile_n, int cs, int per, void* stream) {
  const bool decode = tile_m == 4 || tile_m == 8 || tile_m == 16;
  const int step_k = decode ? kF32DecodeStepK : kF32Bk;
  const int steps = K / step_k;
  if (!(decode || tile_m == kF32Bm) || (decode && M > tile_m) || (tile_n != 64 && tile_n != 128) ||
      M < 1 ||
      K < 64 || K % 64 || N < tile_n || N % tile_n || cs < 1 || cs > kMaxCluster || per < 1 ||
      (long long)(cs - 1) * per >= steps || (long long)cs * per < steps ||
      (long long)(M + kF32Bm - 1) / kF32Bm * cs > 65535 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)scale | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const int8_t* wp = (const int8_t*)w;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tile_m == 4) {
    err = tile_n == 64 ? launch_f32_decode<4, 64>(xf, wp, sc, o, M, K, N, cs, per, s)
                       : launch_f32_decode<4, 128>(xf, wp, sc, o, M, K, N, cs, per, s);
  } else if (tile_m == 8) {
    err = tile_n == 64 ? launch_f32_decode<8, 64>(xf, wp, sc, o, M, K, N, cs, per, s)
                       : launch_f32_decode<8, 128>(xf, wp, sc, o, M, K, N, cs, per, s);
  } else if (tile_m == 16) {
    err = tile_n == 64 ? launch_f32_decode<16, 64>(xf, wp, sc, o, M, K, N, cs, per, s)
                       : launch_f32_decode<16, 128>(xf, wp, sc, o, M, K, N, cs, per, s);
  } else {
    // two groups a block, splitting its K steps, where the blocks do not outnumber the SMs
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
    }
    const long long blocks = (long long)N / tile_n * ((M + kF32Bm - 1) / kF32Bm) * cs;
    if (tile_n == 64)
      err = blocks <= sms ? launch_f32_prefill<8, 2>(xf, wp, sc, o, M, K, N, cs, per, s)
                          : launch_f32_prefill<8, 1>(xf, wp, sc, o, M, K, N, cs, per, s);
    else
      err = blocks <= sms ? launch_f32_prefill<16, 2>(xf, wp, sc, o, M, K, N, cs, per, s)
                          : launch_f32_prefill<16, 1>(xf, wp, sc, o, M, K, N, cs, per, s);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
