// One autoregressive decode step of grouped-query attention on the stacked
// KV cache, with the new row written into the cache in place.
//
// Replaces the Pallas kernel fangyan_tts_tpu/ops/decode_attention.py
// (`fused_decode_attention`, body `_kernel`). Same function: write the new
// post-RoPE K/V row at (layer, b, clamp(idx[b], 0, S-1)), then
// out = softmax(q.K^T / sqrt(hd) + bias) . V over the S slots of that layer,
// with float32 scores, softmax and accumulation and a bf16 output.
//
// Bound on the H100: bytes. Per call the kernel must read one layer's K and V
// (B*S*KV*hd bf16 each) and a (B, S) float32 bias; the arithmetic is two dot
// products per (query head, slot), far below the card's ridge point. At the
// decode loop's sizes that is well under a megabyte, so the time is latency:
// the launch, the trips to memory in series and the combine. The design cuts
// each to one:
//   - one launch. A thread-block cluster of n <= 8 blocks per (row b, KV
//     head) splits that row's S slots (`per` a block, a multiple of 16). Each
//     warp (up to 8 a block) keeps an online softmax over its 16-slot groups;
//     the block merges its warps' partials in shared memory, and each block
//     but rank 0 stores its merged partial (G maxima, G sums, G x 64
//     unnormalised outputs, all float32) into the rank-0 block's shared memory
//     with st.async (distributed shared memory), which counts the bytes on an
//     mbarrier of rank 0, and exits. Rank 0 waits on that barrier alone (no
//     cluster-wide release), merges the n partials in rank order, so the
//     result does not vary from run to run, and writes bf16 `out`. No
//     workspace, no second kernel; with n = 1 the block writes `out` itself.
//   - every byte in flight at entry. One thread starts the K and V tiles of
//     up to two buffers of 256 slots, one TMA box (64 dims x slots, 128-byte
//     swizzle) each, completing on one mbarrier a buffer, while the others
//     load q and the new row into registers and the bias by 4-byte cp.async.
//     Only then does any thread wait. The maps are 3-D, (KV*hd, S, L*B), so
//     slots past S read as zeros; they are encoded on the host once per
//     (cache, shape, box) and cached. A block with more than 512 slots (S >
//     4096 with clusters of 8) refills a buffer once its warps are done with it.
//   - the new row. The owning block writes k_new / v_new to the cache, and
//     into its shared tile over the old row once that tile has landed; no
//     block reads the new row back from global memory. The write slot is read
//     from `idx` on the device (no host synchronisation).
//   - the products on mma.sync m16n8k16 (bf16 in, float32 sums). Scores:
//     A = q (the G heads in rows 0-7, rows 8-15 zero), B = K rows read by
//     ldmatrix through the swizzle (no bank conflicts). P.V: A = P straight
//     from the score registers, split into a bf16 high and low part (two
//     products, so P keeps about 16 bits), B = V by ldmatrix.trans.
//   - q, k_new and v_new may have a batch stride (the fused qkv buffer's
//     views); their last two dims are contiguous.
// The float32 route (`fangyan_decode_attention_f32`, at the end of the file)
// is a separate SIMT kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kHd = 64;                     // head dim
constexpr int kMaxG = 8;                    // query heads per KV head
constexpr int kMaxCluster = 8;
constexpr int kGroup = 16;                  // slots of one mma step
constexpr int kChunk = 256;                 // slots of one shared-memory buffer (the largest TMA box)
constexpr int kMaxWarps = 8;
constexpr int kRowBytes = kHd * 2;          // one KV head's slot row: 128 bytes, one swizzle row
constexpr int kPart = kHd + 2;              // floats of one head's partial: outputs, max, sum
constexpr int kSmemLimit = 232448;          // dynamic shared memory a block may use
constexpr float kNeg = -1e30f;              // score of a slot past the block's run; starting max

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Shared memory of a block of a cluster of n blocks with `per` slots each,
// from a 1024-byte aligned base: nbuf buffers of (K tile, V tile) of chunk
// rows, nbuf bias rows of chunk floats, the warps' partials (warps * G heads)
// and the partials rank 0 receives (n * G heads), nbuf + 1 mbarriers. A block of
// partials for R heads is R x 64 outputs, then R maxima, then R sums.
struct Layout {
  int warps, chunk, nbuf, tile;
  int bias_off, warp_off, recv_off, bar_off, total;
};

__host__ __device__ inline Layout layout(int n, int per, int g) {
  Layout l;
  l.warps = imin(kMaxWarps, per / kGroup);
  l.chunk = imin(per, kChunk);
  l.nbuf = imin(2, (per + l.chunk - 1) / l.chunk);
  l.tile = l.chunk * kRowBytes;  // a multiple of 1024: chunk is a multiple of 16
  l.bias_off = l.nbuf * 2 * l.tile;
  l.warp_off = l.bias_off + l.nbuf * l.chunk * 4;
  l.recv_off = (l.warp_off + l.warps * g * kPart * 4 + 15) / 16 * 16;  // float4 stores
  l.bar_off = (l.recv_off + n * g * kPart * 4 + 7) / 8 * 8;
  l.total = l.bar_off + (l.nbuf + 1) * 8 + 1024;  // + the base's alignment
  return l;
}

struct Params {
  const __nv_bfloat16* q;      // (B, KV*G, hd), batch stride q_sb
  const __nv_bfloat16* k_new;  // (B, KV, hd), batch stride kn_sb
  const __nv_bfloat16* v_new;  // (B, KV, hd), batch stride vn_sb
  __nv_bfloat16* cache_k;      // (L, B, S, KV, hd)
  __nv_bfloat16* cache_v;
  const int32_t* idx;          // (B,)
  const float* bias;           // (B, S)
  __nv_bfloat16* out;          // (B, KV*G, hd), contiguous
  long long q_sb, kn_sb, vn_sb;
  int B, S, KV, G, layer, per;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16, bf16; rows 8-15 zero) . b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  asm(  // not volatile: registers only, so the compiler may interleave one group's products with the next's
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p -> its bf16 pair (high part) and the bf16 pair of what that leaves (low part)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  const float2 hf = __bfloat1622float2(h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * kRowBytes + ((c ^ (r & 7)) << 4); }

static_assert(kMaxWarps <= kMaxCluster, "merge() takes at most kMaxCluster partials");

// The first `count` partials (count <= kMaxCluster) of head h merged in order,
// outputs d .. d+3: max m, sum l, unnormalised outputs o.
struct Merged {
  float m, l;
  float4 o;
};

__device__ __forceinline__ Merged merge(const float* parts, int rows, int count, int G, int h, int d) {
  const float* pm = parts + rows * kHd;
  const float* pl = pm + rows;
  Merged r{kNeg, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
  for (int i = 0; i < kMaxCluster; ++i)
    if (i < count) r.m = fmaxf(r.m, pm[i * G + h]);
#pragma unroll
  for (int i = 0; i < kMaxCluster; ++i) {
    if (i < count) {
      const float w = __expf(pm[i * G + h] - r.m);
      const float4 v = *reinterpret_cast<const float4*>(parts + (i * G + h) * kHd + d);
      r.l += w * pl[i * G + h];
      r.o.x += w * v.x;
      r.o.y += w * v.y;
      r.o.z += w * v.z;
      r.o.w += w * v.w;
    }
  }
  return r;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* dst, const Merged& r) {
  const float inv = 1.f / r.l;
  uint2 v;
  v.x = pack_bf16(r.o.x * inv, r.o.y * inv);
  v.y = pack_bf16(r.o.z * inv, r.o.w * inv);
  *reinterpret_cast<uint2*>(dst) = v;
}

// Grid (n, KV, B) in clusters of (n, 1, 1): block (r, kvh, b) takes slots
// [r * per, min((r + 1) * per, S)) of row b and KV head kvh.
__global__ void __launch_bounds__(kMaxWarps * 32) decode_attention_kernel(const __grid_constant__ CUtensorMap tm_k,
                                                                          const __grid_constant__ CUtensorMap tm_v,
                                                                          const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int rank = blockIdx.x, n = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int G = p.G, S = p.S;
  const Layout lo = layout(n, p.per, G);
  const int s_begin = rank * p.per, s_end = min(s_begin + p.per, S);
  const int chunks = (s_end - s_begin + lo.chunk - 1) / lo.chunk;  // this block's (the last may have fewer)
  auto k_tile = [&](int i) { return smem + i * 2 * lo.tile; };
  auto v_tile = [&](int i) { return smem + (i * 2 + 1) * lo.tile; };
  auto bias_buf = [&](int i) { return reinterpret_cast<float*>(smem + lo.bias_off) + i * lo.chunk; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lo.bar_off);

  // chunk c's K and V tiles into buffer c % nbuf (one thread)
  auto load_tiles = [&](int c) {
    const int bi = c % lo.nbuf, r0 = s_begin + c * lo.chunk, plane = p.layer * p.B + b;
    mbar_arrive_expect_tx(&bars[bi], 2 * lo.tile);
    tma_load_3d(k_tile(bi), &tm_k, &bars[bi], kvh * kHd, r0, plane);
    tma_load_3d(v_tile(bi), &tm_v, &bars[bi], kvh * kHd, r0, plane);
  };
  // chunk c's bias; the slots past the block's run get kNeg (a weight of 0)
  auto load_bias = [&](int c) {
    const int r0 = s_begin + c * lo.chunk, count = min(lo.chunk, s_end - r0);
    float* bs = bias_buf(c % lo.nbuf);
    const float* src = p.bias + (size_t)b * S + r0;
    const int padded = (count + kGroup - 1) / kGroup * kGroup;
    for (int r = tid; r < padded; r += nthreads) {
      if (r < count) cp_async_4(bs + r, src + r);
      else bs[r] = kNeg;
    }
  };

  // bars[nbuf] counts the bytes of the other blocks' partials into rank 0
  if (tid == 0) {
    for (int i = 0; i <= lo.nbuf; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
    for (int c = 0; c < imin(lo.nbuf, chunks); ++c) load_tiles(c);
    if (rank == 0 && n > 1) mbar_arrive_expect_tx(&bars[lo.nbuf], (n - 1) * G * kPart * 4);
  }
  // the cluster barrier's phase 0, waited on before the first remote store:
  // every block has started and initialised its barriers by then
  if (n > 1) cluster_arrive_relaxed();
  // register loads, used later: the write slot, q row g as mma A fragments
  // (K pairs 16kk + 2t and 16kk + 8 + 2t), and 16 bytes of the new row
  const int raw = p.idx[b];
  uint32_t qa[4][2];
  if (g < G) {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(p.q + b * p.q_sb + (size_t)(kvh * G + g) * kHd);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      qa[kk][0] = qr[8 * kk + t];
      qa[kk][1] = qr[8 * kk + 4 + t];
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) qa[kk][0] = qa[kk][1] = 0u;
  }
  uint4 row_new = make_uint4(0, 0, 0, 0);
  if (tid < 16) {
    const __nv_bfloat16* src = tid < 8 ? p.k_new + b * p.kn_sb : p.v_new + b * p.vn_sb;
    row_new = reinterpret_cast<const uint4*>(src + kvh * kHd)[tid & 7];
  }
  for (int c = 0; c < imin(lo.nbuf, chunks); ++c) load_bias(c);

  // the new row goes to the cache by the block that holds its slot
  const size_t slot_stride = (size_t)p.KV * kHd;
  const size_t base = ((size_t)p.layer * p.B + b) * (size_t)S * slot_stride + (size_t)kvh * kHd;
  const int slot = raw < 0 ? 0 : (raw > S - 1 ? S - 1 : raw);
  const bool owner = slot >= s_begin && slot < s_end;
  if (owner && tid < 16)
    reinterpret_cast<uint4*>((tid < 8 ? p.cache_k : p.cache_v) + base + (size_t)slot * slot_stride)[tid & 7] =
        row_new;
  __syncthreads();  // the barriers are initialised

  // this warp's online softmax over its groups: row g of the mma tiles is
  // query head g; lane (g, t) holds the head's max, its share of the sum,
  // and outputs 8j + 2t, 8j + 2t + 1 of each 8-wide tile j
  float m_run = kNeg, l_run = 0.f;
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int bi = c % lo.nbuf;
    const int r0 = s_begin + c * lo.chunk;
    const int count = min(lo.chunk, s_end - r0);
    mbar_wait(&bars[bi], (c / lo.nbuf) & 1);
    if (owner && tid < 16 && slot >= r0 && slot < r0 + count)  // over the old row the copy brought
      *reinterpret_cast<uint4*>((tid < 8 ? k_tile(bi) : v_tile(bi)) + swz(slot - r0, tid & 7)) = row_new;
    cp_async_wait_all();
    __syncthreads();  // the new row and the bias are visible

    const uint32_t kb = smem_u32(k_tile(bi)), vb = smem_u32(v_tile(bi));
    const float* bs = bias_buf(bi);
    const int groups = (count + kGroup - 1) / kGroup;
    for (int grp = warp; grp < groups; grp += lo.warps) {
      const int g0 = grp * kGroup;
      // scores of slots g0 + 8 nt + 2t (+1) for head g; a lane's ldmatrix row
      // is g0 + 8 nt + (lane & 7), so its swizzle phase is lane & 7
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t k0[4], k1[4];
        const int row = g0 + 8 * nt + (lane & 7);
        ldmatrix_x4(k0, kb + swz(row, lane >> 3));      // dims 0-31: K pairs of kk = 0, 1
        ldmatrix_x4(k1, kb + swz(row, 4 + (lane >> 3)));  // dims 32-63: kk = 2, 3
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        mma(sc[nt], qa[0][0], qa[0][1], k0[0], k0[1]);
        mma(sc[nt], qa[1][0], qa[1][1], k0[2], k0[3]);
        mma(sc[nt], qa[2][0], qa[2][1], k1[0], k1[1]);
        mma(sc[nt], qa[3][0], qa[3][1], k1[2], k1[3]);
      }
      const float2 b0 = *reinterpret_cast<const float2*>(bs + g0 + 2 * t);
      const float2 b1 = *reinterpret_cast<const float2*>(bs + g0 + 8 + 2 * t);
      const float x0 = sc[0][0] * 0.125f + b0.x, x1 = sc[0][1] * 0.125f + b0.y;
      const float x2 = sc[1][0] * 0.125f + b1.x, x3 = sc[1][1] * 0.125f + b1.y;
      float mx = fmaxf(fmaxf(x0, x1), fmaxf(x2, x3));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float corr = __expf(m_run - m_new);
      const float p0 = __expf(x0 - m_new), p1 = __expf(x1 - m_new);
      const float p2 = __expf(x2 - m_new), p3 = __expf(x3 - m_new);
      l_run = l_run * corr + ((p0 + p1) + (p2 + p3));
      m_run = m_new;
      uint32_t h01, l01, h23, l23;
      split_bf16(p0, p1, h01, l01);
      split_bf16(p2, p3, h23, l23);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j][0] *= corr;
        o[j][1] *= corr;
      }
      // P . V over the group's 16 slots, tiles of 8 dims in pairs
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + swz(g0 + (lane & 7) + 8 * ((lane >> 3) & 1), 2 * pr + (lane >> 4)));
        mma(o[2 * pr], h01, h23, vf[0], vf[1]);
        mma(o[2 * pr], l01, l23, vf[0], vf[1]);
        mma(o[2 * pr + 1], h01, h23, vf[2], vf[3]);
        mma(o[2 * pr + 1], l01, l23, vf[2], vf[3]);
      }
    }
    if (c + lo.nbuf < chunks) {  // refill this buffer once every warp is done with it
      fence_proxy_async();       // this thread's reads and writes of it come before the copies
      __syncthreads();
      if (tid == 0) load_tiles(c + lo.nbuf);
      load_bias(c + lo.nbuf);
    }
  }
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);

  // the block's partial: its warps' merged in order
  float* wp = reinterpret_cast<float*>(smem + lo.warp_off);
  const int wrows = lo.warps * G;
  if (g < G) {
    const int row = warp * G + g;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(wp + row * kHd + 8 * j + 2 * t) = make_float2(o[j][0], o[j][1]);
    if (t == 0) {
      wp[wrows * kHd + row] = m_run;
      wp[wrows * kHd + wrows + row] = l_run;
    }
  }
  __syncthreads();
  __nv_bfloat16* out = p.out + ((size_t)b * p.KV + kvh) * G * kHd;  // this (row, KV head)'s G x 64 outputs
  if (n == 1) {
    for (int i = tid; i < G * 16; i += nthreads) {
      const int h = i >> 4, d = (i & 15) * 4;
      store_out(out + h * kHd + d, merge(wp, wrows, lo.warps, G, h, d));
    }
    return;
  }
  // the other blocks push theirs into rank 0's shared memory, completing on
  // its bars[nbuf], and are done; rank 0 adds its own and waits for them
  const int rrows = n * G;
  float* rp = reinterpret_cast<float*>(smem + lo.recv_off);
  if (rank != 0) cluster_wait();
  const uint32_t recv = cluster_map(rp, 0), done = cluster_map(&bars[lo.nbuf], 0);
  for (int i = tid; i < G * 16; i += nthreads) {
    const int h = i >> 4, d = (i & 15) * 4;
    const Merged r = merge(wp, wrows, lo.warps, G, h, d);
    const int row = rank * G + h;
    if (rank == 0) {
      *reinterpret_cast<float4*>(rp + row * kHd + d) = r.o;
      if (d == 0) {
        rp[rrows * kHd + row] = r.m;
        rp[rrows * kHd + rrows + row] = r.l;
      }
    } else {
      st_async(recv + (row * kHd + d) * 4, r.o, done);
      if (d == 0) {
        st_async(recv + (rrows * kHd + row) * 4, r.m, done);
        st_async(recv + (rrows * kHd + rrows + row) * 4, r.l, done);
      }
    }
  }
  if (rank != 0) return;
  __syncthreads();
  mbar_wait(&bars[lo.nbuf], 0);

  // rank 0: out = sum_r w_r o_r / sum_r w_r l_r, w_r = exp(m_r - max m), in rank order
  for (int i = tid; i < G * 16; i += nthreads) {
    const int h = i >> 4, d = (i & 15) * 4;
    store_out(out + h * kHd + d, merge(rp, rrows, n, G, h, d));
  }
}

// The 3-D TMA map of one cache (KV*hd elements, S slots, L*B planes) with a
// box of (hd, rows, 1) and the 128-byte swizzle, encoded once per (cache,
// shape, box) and kept: the decode loop calls the kernel 24 times a step on
// the same two caches, and the host is its bottleneck.
bool cache_map(CUtensorMap* map, const void* cache, int L, int B, int S, int KV, int rows) {
  struct Entry {
    const void* cache;
    int L, B, S, KV, rows;
    CUtensorMap map;
  };
  constexpr int kEntries = 16;
  static Entry entries[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = entries[i];
    if (e.cache == cache && e.L == L && e.B == B && e.S == S && e.KV == KV && e.rows == rows) {
      *map = e.map;
      return true;
    }
  }
  const uint64_t dims[3] = {(uint64_t)KV * kHd, (uint64_t)S, (uint64_t)L * B};
  const uint64_t strides[2] = {(uint64_t)KV * kRowBytes, (uint64_t)S * KV * kRowBytes};
  const uint32_t box[3] = {(uint32_t)kHd, (uint32_t)rows, 1};
  if (!hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, cache, dims, strides, box)) return false;
  entries[next] = Entry{cache, L, B, S, KV, rows, *map};
  next = (next + 1) % kEntries;
  used = used < kEntries ? used + 1 : used;
  return true;
}

}  // namespace

// n blocks a cluster (1-8), `per` slots a block (a multiple of 16, with
// (n - 1) * per < S <= n * per); batch strides in elements (multiples of 8).
extern "C" int fangyan_decode_attention(const void* q, const void* k_new, const void* v_new, void* cache_k,
                                        void* cache_v, const void* idx, const void* bias, void* out, long long q_sb,
                                        long long kn_sb, long long vn_sb, int L, int B, int S, int KV, int G, int hd,
                                        int layer, int n, int per, void* stream) {
  const bool aligned = ((uintptr_t)q | (uintptr_t)k_new | (uintptr_t)v_new | (uintptr_t)cache_k |
                        (uintptr_t)cache_v | (uintptr_t)out) % 16 == 0 &&
                       (q_sb | kn_sb | vn_sb) % 8 == 0;
  if (!aligned || hd != kHd || G < 1 || G > kMaxG || B < 1 || S < 1 || KV < 1 || L < 1 || B > 65535 ||
      KV > 65535 || layer < 0 || layer >= L || n < 1 || n > kMaxCluster || per < kGroup || per % kGroup ||
      (long long)(n - 1) * per >= S || (long long)n * per < S || (long long)L * B * S >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const Layout lo = layout(n, per, G);
  if (lo.total > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_k, tm_v;
  if (!cache_map(&tm_k, cache_k, L, B, S, KV, lo.chunk) || !cache_map(&tm_v, cache_v, L, B, S, KV, lo.chunk))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      cudaFuncSetAttribute(decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return (int)attr;
  Params p;
  p.q = (const __nv_bfloat16*)q;
  p.k_new = (const __nv_bfloat16*)k_new;
  p.v_new = (const __nv_bfloat16*)v_new;
  p.cache_k = (__nv_bfloat16*)cache_k;
  p.cache_v = (__nv_bfloat16*)cache_v;
  p.idx = (const int32_t*)idx;
  p.bias = (const float*)bias;
  p.out = (__nv_bfloat16*)out;
  p.q_sb = q_sb;
  p.kn_sb = kn_sb;
  p.vn_sb = vn_sb;
  p.B = B;
  p.S = S;
  p.KV = KV;
  p.G = G;
  p.layer = layer;
  p.per = per;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, KV, B);
  cfg.blockDim = dim3(32 * lo.warps);
  cfg.dynamicSmemBytes = lo.total;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = n;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = n > 1 ? 1 : 0;  // one block: no cluster, no barrier
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_kernel, tm_k, tm_v, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The float32 route: the same function on float32 q, k_new, v_new and caches
// (the Pallas kernel is dtype-generic: it casts q to float32 in its body and
// writes the output in q's dtype), with float32 scores, softmax and sums and
// no tensor cores, so no TF32 rounding. A simple SIMT kernel: one block of
// kF32Warps warps per (KV head, row b). The block writes the new row into the
// cache and keeps it in shared memory, where the loops read it; lane j of a
// warp owns one slot of each 32-slot tile the warp takes, works out its G
// scores from its own K row (float4 loads), and the warp keeps an online
// softmax a head (maxima and sums by shuffles) and accumulates P.V with each
// lane owning two of the 64 output dims. The warps' partials merge in shared
// memory in warp order, so the result does not vary from run to run.

namespace {

constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;

struct ParamsF32 {
  const float* q;
  const float* k_new;
  const float* v_new;
  float* cache_k;
  float* cache_v;
  const int32_t* idx;
  const float* bias;
  float* out;
  long long q_sb, kn_sb, vn_sb;
  int B, S, KV, G, layer;
};

__global__ void __launch_bounds__(kF32Threads) decode_attention_f32_kernel(const ParamsF32 p) {
  __shared__ __align__(16) float qs[kMaxG][kHd];
  __shared__ __align__(16) float knew[kHd];
  __shared__ __align__(16) float vnew[kHd];
  __shared__ float part_m[kF32Warps][kMaxG];
  __shared__ float part_l[kF32Warps][kMaxG];
  __shared__ float part_o[kF32Warps][kMaxG][kHd];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = p.S, KV = p.KV, G = p.G;
  const float log2e = 1.4426950408889634f;
  const float qscale = 0.125f * log2e;  // 1 / sqrt(64), in base 2
  int slot = p.idx[b];
  slot = slot < 0 ? 0 : (slot > S - 1 ? S - 1 : slot);
  const long long row0 = ((long long)p.layer * p.B + b) * S;  // this (layer, b)'s first slot
  float* ck = p.cache_k + row0 * KV * kHd + kvh * kHd;         // slot s's row: ck + s * KV * kHd
  float* cv = p.cache_v + row0 * KV * kHd + kvh * kHd;
  const long long rs = (long long)KV * kHd;

  if (tid < kHd) {
    const float k = p.k_new[b * p.kn_sb + kvh * kHd + tid];
    knew[tid] = k;
    ck[slot * rs + tid] = k;
  } else if (tid < 2 * kHd) {
    const float v = p.v_new[b * p.vn_sb + kvh * kHd + tid - kHd];
    vnew[tid - kHd] = v;
    cv[slot * rs + tid - kHd] = v;
  }
  for (int e = tid; e < G * kHd; e += kF32Threads)
    qs[e / kHd][e % kHd] = p.q[b * p.q_sb + (kvh * G + e / kHd) * kHd + e % kHd] * qscale;
  __syncthreads();

  float m[kMaxG], l[kMaxG], acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = 0.f;
  }
  const float* brow = p.bias + (long long)b * S;
  for (int base = warp * 32; base < S; base += kF32Threads) {
    const int s = base + lane;
    float sc[kMaxG];
    if (s < S) {
      const float4* kr = reinterpret_cast<const float4*>(s == slot ? knew : ck + s * rs);
      float dot[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
#pragma unroll 4
      for (int d4 = 0; d4 < kHd / 4; ++d4) {
        const float4 kk = kr[d4];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4 qq = reinterpret_cast<const float4*>(qs[g])[d4];
            dot[g] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, dot[g]))));
          }
        }
      }
      const float bl = brow[s] * log2e;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[g] = dot[g] + bl;
    } else {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[g] = -INFINITY;
    }
    float pr[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float t = sc[g];
#pragma unroll
        for (int o = 16; o; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
        const float mn = fmaxf(m[g], t);  // finite: lane 0's slot is valid and the bias finite
        const float alpha = exp2f(m[g] - mn);
        pr[g] = exp2f(sc[g] - mn);
        float sum = pr[g];
#pragma unroll
        for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        l[g] = l[g] * alpha + sum;
        acc[g][0] *= alpha;
        acc[g][1] *= alpha;
        m[g] = mn;
      } else {
        pr[g] = 0.f;
      }
    }
    const int n = S - base < 32 ? S - base : 32;
    for (int j = 0; j < n; ++j) {
      const int sj = base + j;
      const float2 vv = reinterpret_cast<const float2*>(sj == slot ? vnew : cv + sj * rs)[lane];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, pr[g], j);
          acc[g][0] = fmaf(pj, vv.x, acc[g][0]);
          acc[g][1] = fmaf(pj, vv.y, acc[g][1]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      part_o[warp][g][2 * lane] = acc[g][0];
      part_o[warp][g][2 * lane + 1] = acc[g][1];
      if (lane == 0) {
        part_m[warp][g] = m[g];
        part_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * kHd; e += kF32Threads) {
    const int g = e / kHd, d = e % kHd;
    float mx = -INFINITY;
    for (int w = 0; w < kF32Warps; ++w) mx = fmaxf(mx, part_m[w][g]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kF32Warps; ++w) {
      const float f = exp2f(part_m[w][g] - mx);  // 0 for a warp that had no slot
      num = fmaf(f, part_o[w][g][d], num);
      den = fmaf(f, part_l[w][g], den);
    }
    p.out[((long long)b * KV * G + kvh * G + g) * kHd + d] = num / den;
  }
}

}  // namespace

// The float32 route: q, k_new, v_new, the caches and out float32, idx int32,
// bias float32; batch strides in elements (multiples of 4).
extern "C" int fangyan_decode_attention_f32(const void* q, const void* k_new, const void* v_new, void* cache_k,
                                            void* cache_v, const void* idx, const void* bias, void* out,
                                            long long q_sb, long long kn_sb, long long vn_sb, int L, int B, int S,
                                            int KV, int G, int hd, int layer, void* stream) {
  const bool aligned = ((uintptr_t)q | (uintptr_t)k_new | (uintptr_t)v_new | (uintptr_t)cache_k |
                        (uintptr_t)cache_v | (uintptr_t)out) % 16 == 0 &&
                       (q_sb | kn_sb | vn_sb) % 4 == 0;
  if (!aligned || hd != kHd || G < 1 || G > kMaxG || B < 1 || S < 1 || KV < 1 || L < 1 || B > 65535 ||
      KV > 65535 || layer < 0 || layer >= L || (long long)L * B * S * KV * kHd >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  ParamsF32 p;
  p.q = (const float*)q;
  p.k_new = (const float*)k_new;
  p.v_new = (const float*)v_new;
  p.cache_k = (float*)cache_k;
  p.cache_v = (float*)cache_v;
  p.idx = (const int32_t*)idx;
  p.bias = (const float*)bias;
  p.out = (float*)out;
  p.q_sb = q_sb;
  p.kn_sb = kn_sb;
  p.vn_sb = vn_sb;
  p.B = B;
  p.S = S;
  p.KV = KV;
  p.G = G;
  p.layer = layer;
  decode_attention_f32_kernel<<<dim3(KV, B), kF32Threads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
