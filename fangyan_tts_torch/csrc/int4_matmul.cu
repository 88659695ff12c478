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
// The float32 route (`fangyan_int4_matmul_f32`, at the end of the file) is a
// separate SIMT kernel.

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
// on the CUDA cores and no TF32 rounding. A simple tiled SIMT kernel: a block
// of 256 threads computes a 64 x 64 output tile in steps of 32 K; x's tile is
// stored transposed and the weight's dequantized (two's complement nibbles
// to exact float32 values) in shared memory, and each thread sums 4 tokens x
// 4 channels (channels strided by 16, so the shared-memory reads do not
// conflict). The scale multiplies the float32 sum, as on the bf16 route.
// Where the output tiles leave the card idle (decode: down_proj has 14 tiles
// at M <= 64), K is split over `splits` blocks a tile (blockIdx.z): each
// writes its partial tile to a float32 workspace (splits, M, N), and a second
// kernel sums the partials in split order and applies the scale, so the
// result does not vary from run to run.

namespace {

constexpr int kF32Bm = 64, kF32Bn = 64, kF32Bk = 32;
constexpr int kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads) int4_matmul_f32_kernel(const float* __restrict__ x,
                                                                      const int8_t* __restrict__ w,
                                                                      const float* __restrict__ scale,
                                                                      float* __restrict__ out, int M, int K, int N,
                                                                      int k_per) {
  __shared__ __align__(16) float xs[kF32Bk][kF32Bm + 4];  // x^T tile, rows padded to keep float4 alignment
  __shared__ float ws[kF32Bk][kF32Bn];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kF32Bm, n0 = blockIdx.x * kF32Bn;
  const int k_begin = blockIdx.z * k_per, k_end = min(K, k_begin + k_per);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kF32Bk) {
    __syncthreads();  // the last step's tiles are read
    for (int e = tid; e < kF32Bm * kF32Bk / 4; e += kF32Threads) {
      const int r = e / (kF32Bk / 4), c = e % (kF32Bk / 4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) v = *reinterpret_cast<const float4*>(x + (long long)(m0 + r) * K + k0 + c);
      xs[c][r] = v.x;
      xs[c + 1][r] = v.y;
      xs[c + 2][r] = v.z;
      xs[c + 3][r] = v.w;
    }
    {  // 16 packed rows x 64 channels: one 4-byte word a thread
      const int pr = tid / (kF32Bn / 4), c = tid % (kF32Bn / 4) * 4;
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(w + (long long)(k0 / 2 + pr) * N + n0 + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int byte = (int)(int8_t)(word >> (8 * j));
        ws[2 * pr][c + j] = (float)((int)((uint32_t)byte << 28) >> 28);  // low nibble: input row 2i
        ws[2 * pr + 1][c + j] = (float)(byte >> 4);  // high nibble: input row 2i + 1
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kF32Bk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      float bw[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bw[c] = ws[kk][tx + 16 * c];
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bw[c], acc[r][c]);
    }
  }
  // one split: the scaled result; several: this split's partial (no scale) at workspace slice blockIdx.z
  float* dst = gridDim.z == 1 ? out : out + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      dst[(long long)m * N + n] = gridDim.z == 1 ? acc[r][c] * scale[n] : acc[r][c];
    }
  }
}

// out[m, n] = scale[n] * (sum over the splits, in order, of ws[s, m, n])
__global__ void __launch_bounds__(256) int4_matmul_f32_reduce(const float* __restrict__ ws,
                                                               const float* __restrict__ scale,
                                                               float* __restrict__ out, int M, int N, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += ws[z * mn + i];
  out[i] = sum * scale[i % N];
}

}  // namespace

// The float32 route: x (M, K) float32, w (K/2, N) int8, scale (N,) float32,
// out (M, N) float32; K a multiple of 32, N of 64, pointers 16-byte aligned.
// splits K-splits a tile (each a multiple of 32 K); with splits > 1, ws is a
// float32 workspace of splits x M x N.
extern "C" int fangyan_int4_matmul_f32(const void* x, const void* w, const void* scale, void* out, void* ws, int M,
                                       int K, int N, int splits, void* stream) {
  if (M < 1 || K < kF32Bk || K % kF32Bk || N < kF32Bn || N % kF32Bn || (M + kF32Bm - 1) / kF32Bm > 65535 ||
      splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr) ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const int steps = K / kF32Bk;
  const int k_per = (steps + splits - 1) / splits * kF32Bk;
  if ((long long)(splits - 1) * k_per >= K) return (int)cudaErrorInvalidValue;  // every split has K to sum
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(N / kF32Bn, (M + kF32Bm - 1) / kF32Bm, splits);
  int4_matmul_f32_kernel<<<grid, kF32Threads, 0, s>>>((const float*)x, (const int8_t*)w, (const float*)scale,
                                                        (float*)(splits > 1 ? ws : out), M, K, N, k_per);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    int4_matmul_f32_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>((const float*)ws, (const float*)scale,
                                                                        (float*)out, M, N, splits);
  }
  return (int)cudaGetLastError();
}
