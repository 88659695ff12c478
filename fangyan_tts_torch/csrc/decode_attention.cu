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
// is a separate SIMT kernel of the same shape.

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
// box of (128 bytes of a slot row, rows, 1) and the 128-byte swizzle: hd bf16
// elements, or half of hd float32 ones (the float32 route). Encoded once per
// (cache, shape, box, type) and kept: the decode loop calls the kernel 24
// times a step on the same two caches, and the host is its bottleneck.
bool cache_map(CUtensorMap* map, const void* cache, int L, int B, int S, int KV, int rows,
               CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  struct Entry {
    const void* cache;
    int L, B, S, KV, rows;
    CUtensorMapDataType type;
    CUtensorMap map;
  };
  constexpr int kEntries = 16;
  static Entry entries[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = entries[i];
    if (e.cache == cache && e.L == L && e.B == B && e.S == S && e.KV == KV && e.rows == rows && e.type == type) {
      *map = e.map;
      return true;
    }
  }
  const uint64_t elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const uint64_t dims[3] = {(uint64_t)KV * kHd, (uint64_t)S, (uint64_t)L * B};
  const uint64_t strides[2] = {(uint64_t)KV * kHd * elem, (uint64_t)S * KV * kHd * elem};
  const uint32_t box[3] = {(uint32_t)(kRowBytes / elem), (uint32_t)rows, 1};
  if (!hopper_host::make_map(map, type, 3, cache, dims, strides, box)) return false;
  entries[next] = Entry{cache, L, B, S, KV, rows, type, *map};
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
// The float32 route (`fangyan_decode_attention_f32`): the same function on
// float32 q, k_new, v_new and caches (the Pallas kernel is dtype-generic: it
// casts q to float32 in its body and writes the output in q's dtype), with
// float32 scores, softmax and sums in FMAs on the CUDA cores: no tensor cores,
// so no TF32 rounding.
//
// Bound on the H100: bytes, as the bf16 route, twice as many of them (a
// slot's K and V rows are 256 bytes each). At phase 4's float32 batch (B = 4,
// S = 128, 0.34 MB) the time is latency: the launch, one trip to memory, a
// chunk's barriers, the combine. At the GRPO rollout bucket's shape (B = 32,
// S = 384, 12.6 MB) it is the bytes, and behind them each SM's issue rate:
// without tensor cores a slot costs 2 x 8 heads x 64 FMAs, and an SM's 128
// lanes take about as long for a 128-slot chunk as its loads do. The route
// takes the bf16 route's shape (tools/decode_attention_sweep.py --f32 times
// each part and every plan):
//   - one launch, a thread-block cluster of n blocks (up to 16: past 8 a
//     non-portable cluster) per (row b, KV head) that splits the row's S
//     slots in runs of `per`, a multiple of 32 (`ops/decode_attention.
//     plan_f32`). Latency: runs of 32 slots where S allows, so at B = 4,
//     S = 128 each of 32 blocks takes 32 slots with all its warps. Bytes:
//     past one block an SM the clusters take fewer, longer runs, since
//     shorter ones add waves and partials, not issue slots: at B = 32,
//     S = 384, 128 blocks of 192 slots (96 KB each, all asked for at entry).
//   - every byte in flight before any thread waits. One thread starts the K
//     and V tiles of up to three buffers of up to 128 slots by TMA, each on
//     its own mbarrier, while the others start q and the bias by cp.async and
//     load the new row into registers. A float32 map with a box of 32 dims,
//     two boxes a tile: each 128-byte half row takes the 128-byte swizzle, so
//     the float4 reads below are free of bank conflicts (eight lanes that read
//     one 16-byte column of eight rows, or eight columns of one row, meet
//     eight distinct groups of banks). A longer run refills a buffer once the
//     block is done with it.
//   - every warp busy, no per-slot shuffles. A chunk's scores: P = 8, 4 or 2
//     lanes a slot (chunks of up to 32, 64, 128 slots), each lane over 64 / P
//     dims of K in shared memory against q in shared memory (broadcast
//     reads), the dot products summed over the P lanes by log2(P) shuffles.
//     The chunk's maximum per head by shuffles and one exchange between the
//     warps in shared memory; the probabilities (base 2: q's scale carries
//     log2(e) / 8) go to shared memory; then P.V, each thread owning one
//     float4 of the 64 output dims of every head over a sixteenth of the
//     chunk's slots, V from shared memory. The loops run over all 8 heads
//     with no branch on G, so that the heads' shuffles and products issue
//     together. The block keeps one running maximum a head across its chunks
//     (the online softmax), so its threads' sums add without rescaling: the
//     16 slot subsets of an output sit in one half-warp and meet by a
//     reduce-scatter of shuffles, with no barrier and no shared memory.
//   - the combine as the bf16 route: each block but rank 0 stores its partial
//     (G maxima, G sums, G x 64 outputs) into rank 0's shared memory by
//     st.async against one mbarrier and exits; rank 0 merges the n partials
//     in rank order and writes `out`. No atomics: the result does not vary
//     from run to run. With n = 1 the block writes `out` itself.
//   - the new row. The block that holds the slot writes k_new / v_new to the
//     cache from registers, and over the old row in its shared tile once the
//     tile has landed; no block reads it back from global memory. The write
//     slot is read from `idx` on the device.

namespace {

constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32Group = 32;       // a block's slots are a multiple of this
constexpr int kF32Chunk = 128;      // slots of one shared-memory buffer at most
constexpr int kF32MaxBuf = 3;
constexpr int kF32MaxCluster = 16;  // past 8 a non-portable cluster
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kF32Warps == 8, "the warps' maxima of a head are read as two float4");

// Shared memory of a block of a cluster of n blocks with `per` slots each,
// from a 1024-byte aligned base: nbuf buffers of four half tiles (K dims 0-31,
// K 32-63, V 0-31, V 32-63; chunk rows of 128 bytes each), nbuf bias rows of
// chunk floats, the chunk's probabilities (heads 0-3 of each slot, then heads
// 4-7), the warps' maxima (8 warps x 8 heads), q (8 x 64), the partials rank
// 0 receives (n * G heads: outputs, then maxima, then sums) and nbuf + 1
// mbarriers. As many buffers as fit, up to kF32MaxBuf and the block's chunks.
struct LayoutF32 {
  int chunk, nbuf, half;
  int bias_off, p_off, wmax_off, q_off, recv_off, bar_off, total;
};

// slots of one chunk: the run split in as few chunks of at most kF32Chunk as
// it needs, each a multiple of kF32Group
__host__ __device__ inline int chunk_f32(int per) {
  const int k = (per + kF32Chunk - 1) / kF32Chunk;
  return ((per + k - 1) / k + kF32Group - 1) / kF32Group * kF32Group;
}

__host__ __device__ inline LayoutF32 layout_f32(int n, int per, int g) {
  LayoutF32 l;
  l.chunk = chunk_f32(per);
  l.half = l.chunk * kRowBytes;  // a multiple of 4096: chunk is a multiple of 32
  for (l.nbuf = imin(kF32MaxBuf, (per + l.chunk - 1) / l.chunk);; --l.nbuf) {
    l.bias_off = l.nbuf * 4 * l.half;
    l.p_off = l.bias_off + l.nbuf * l.chunk * 4;
    l.wmax_off = l.p_off + l.chunk * kMaxG * 4;
    l.q_off = l.wmax_off + kMaxG * kF32Warps * 4;
    l.recv_off = l.q_off + kMaxG * kHd * 4;
    l.bar_off = l.recv_off + n * g * kPart * 4;  // 8-byte aligned: kPart * 4 = 264
    l.total = l.bar_off + (l.nbuf + 1) * 8 + 1024;  // + the base's alignment
    if (l.total <= kSmemLimit || l.nbuf == 1) return l;
  }
}

struct ParamsF32 {
  const float* q;      // (B, KV*G, hd), batch stride q_sb
  const float* k_new;  // (B, KV, hd), batch stride kn_sb
  const float* v_new;  // (B, KV, hd), batch stride vn_sb
  float* cache_k;      // (L, B, S, KV, hd)
  float* cache_v;
  const int32_t* idx;  // (B,)
  const float* bias;   // (B, S)
  float* out;          // (B, KV*G, hd), contiguous
  long long q_sb, kn_sb, vn_sb;
  int B, S, KV, G, layer, per;
};

__device__ __forceinline__ float ex2(float x) {  // 2^x (ex2.approx: about 2 ulp; 2^-inf = 0)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The first `count` partials (count <= kF32MaxCluster) of head h merged in
// order, outputs d .. d+3; maxima in base 2.
__device__ __forceinline__ Merged merge_f32(const float* parts, int rows, int count, int G, int h, int d) {
  const float* pm = parts + rows * kHd;
  const float* pl = pm + rows;
  Merged r{-INFINITY, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
  for (int i = 0; i < kF32MaxCluster; ++i)
    if (i < count) r.m = fmaxf(r.m, pm[i * G + h]);
#pragma unroll
  for (int i = 0; i < kF32MaxCluster; ++i) {
    if (i < count) {
      const float w = ex2(pm[i * G + h] - r.m);
      const float4 v = *reinterpret_cast<const float4*>(parts + (i * G + h) * kHd + d);
      r.l = fmaf(w, pl[i * G + h], r.l);
      r.o.x = fmaf(w, v.x, r.o.x);
      r.o.y = fmaf(w, v.y, r.o.y);
      r.o.z = fmaf(w, v.z, r.o.z);
      r.o.w = fmaf(w, v.w, r.o.w);
    }
  }
  return r;
}

// One round of a reduce-scatter over the lanes `kOff` apart: of the 2 kHalf
// values in v, a lane keeps the upper half if its bit kOff is set, else the
// lower, adds its partner's copy of that half and leaves it in v[0, kHalf).
template <int kHalf, int kOff>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = upper ? v[kHalf + i] : v[i], send = upper ? v[i] : v[kHalf + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

__device__ __forceinline__ void store_out_f32(float* dst, float4 o, float l) {
  const float inv = 1.f / l;
  *reinterpret_cast<float4*>(dst) = make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
}

// Grid (n, KV, B) in clusters of (n, 1, 1): block (r, kvh, b) takes slots
// [r * per, min((r + 1) * per, S)) of row b and KV head kvh. P lanes a slot
// in the scores: 8, 4 or 2 for chunks of up to 32, 64 or 128 slots. The hot
// loops run over all kMaxG heads with no branch on G (q's rows past G are
// zeros, and their sums are never stored), so that the compiler can issue
// the heads' shuffles and products together.
template <int P>
__global__ void __launch_bounds__(kF32Threads)
    decode_attention_f32_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                                const ParamsF32 p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int rank = blockIdx.x, n = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.G, S = p.S;
  const LayoutF32 lo = layout_f32(n, p.per, G);
  const int s_begin = rank * p.per, s_end = min(s_begin + p.per, S);
  const int chunks = (s_end - s_begin + lo.chunk - 1) / lo.chunk;  // this block's (the last may have fewer slots)
  auto tile = [&](int bi, int i) { return smem + (bi * 4 + i) * lo.half; };  // i: K 0-31, K 32-63, V 0-31, V 32-63
  float* bias_s = reinterpret_cast<float*>(smem + lo.bias_off);
  float* ps = reinterpret_cast<float*>(smem + lo.p_off);      // (2, chunk, 4): probabilities of head 4i + g, slot j
  float* wmax = reinterpret_cast<float*>(smem + lo.wmax_off);  // (8, 8): warp w's maximum of head g
  float* qs = reinterpret_cast<float*>(smem + lo.q_off);      // (8, 64): q, zero past row G
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lo.bar_off);

  // chunk c's K and V tiles into buffer c % nbuf (one thread)
  auto load_tiles = [&](int c) {
    const int bi = c % lo.nbuf, r0 = s_begin + c * lo.chunk, plane = p.layer * p.B + b;
    mbar_arrive_expect_tx(&bars[bi], 4 * lo.half);
    for (int i = 0; i < 4; ++i)
      tma_load_3d(tile(bi, i), i < 2 ? &tm_k : &tm_v, &bars[bi], kvh * kHd + (i & 1) * 32, r0, plane);
  };
  // chunk c's bias
  auto load_bias = [&](int c) {
    const int r0 = s_begin + c * lo.chunk, count = min(lo.chunk, s_end - r0);
    float* bs = bias_s + (c % lo.nbuf) * lo.chunk;
    const float* src = p.bias + (size_t)b * S + r0;
    for (int r = tid; r < count; r += kF32Threads) cp_async_4(bs + r, src + r);
  };

  // bars[nbuf] counts the bytes of the other blocks' partials into rank 0
  if (tid == 0) {
    for (int i = 0; i <= lo.nbuf; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
    for (int c = 0; c < imin(lo.nbuf, chunks); ++c) load_tiles(c);
    if (rank == 0 && n > 1) mbar_arrive_expect_tx(&bars[lo.nbuf], (n - 1) * G * kPart * 4);
  }
  // the cluster barrier's phase 0, waited on before the first remote store
  if (n > 1) cluster_arrive_relaxed();
  // q and the bias by cp.async, the new row and the write slot into registers:
  // nothing here is waited for before the first tiles are
  if (tid < kMaxG * 16) {
    const int g = tid >> 4;
    cp_async16(qs + 4 * tid, p.q + b * p.q_sb + (size_t)(kvh * G + (g < G ? g : 0)) * kHd + 4 * (tid & 15), g < G);
  }
  for (int c = 0; c < imin(lo.nbuf, chunks); ++c) load_bias(c);
  float4 row_new = make_float4(0.f, 0.f, 0.f, 0.f);  // threads 0-15 k_new, 16-31 v_new, a float4 each
  if (tid < 32)
    row_new = reinterpret_cast<const float4*>((tid < 16 ? p.k_new + b * p.kn_sb : p.v_new + b * p.vn_sb) +
                                              kvh * kHd)[tid & 15];
  const int raw = p.idx[b];
  __syncthreads();  // the mbarriers are initialised
  const int slot = raw < 0 ? 0 : (raw > S - 1 ? S - 1 : raw);
  const bool owner = slot >= s_begin && slot < s_end;

  // the block's online softmax: one running maximum a head (the same in every
  // thread), and this thread's sums of each head and outputs 4 d4 .. 4 d4 + 3
  // of each head over the chunk's slots sub, sub + 16, ...: the 16 slot
  // subsets of an output in the 16 lanes of one half-warp
  float m_run[kMaxG], l_run[kMaxG], acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }
  const float qscale = 0.125f * kLog2e;     // 1 / sqrt(64), in base 2
  const int js = tid / P, part = tid % P;    // scores: slot js, 16-byte columns part * 8 / P .. of each half row
  const int d4 = 2 * warp + (lane >> 4), sub = lane & 15;  // P.V
  for (int c = 0; c < chunks; ++c) {
    const int bi = c % lo.nbuf, r0 = s_begin + c * lo.chunk;
    const int count = min(lo.chunk, s_end - r0);
    mbar_wait(&bars[bi], (c / lo.nbuf) & 1);
    if (owner && tid < 32 && slot >= r0 && slot < r0 + count) {  // the new row: to the cache, and over the old
      reinterpret_cast<float4*>((tid < 16 ? p.cache_k : p.cache_v) + ((size_t)p.layer * p.B + b) * S * p.KV * kHd +
                                ((size_t)slot * p.KV + kvh) * kHd)[tid & 15] = row_new;
      *reinterpret_cast<float4*>(tile(bi, (tid >> 4) * 2 + ((tid >> 3) & 1)) + swz(slot - r0, tid & 7)) = row_new;
    }
    cp_async_wait_all();
    __syncthreads();  // the new row, q and the bias are visible

    // slot js's scores for every head over this lane's columns, summed over its P lanes
    float sc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
    if (js < count) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int k = 0; k < 8 / P; ++k) {
          const int col = part * (8 / P) + k;
          const float4 kk = *reinterpret_cast<const float4*>(tile(bi, h) + swz(js, col));
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            const float4 qq = reinterpret_cast<const float4*>(qs + g * kHd)[h * 8 + col];
            sc[g] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y, fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, sc[g]))));
          }
        }
      }
    }
#pragma unroll
    for (int o = 1; o < P; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
    }
    const float bl = js < count ? bias_s[bi * lo.chunk + js] * kLog2e : -INFINITY;
    float mx[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      sc[g] = fmaf(sc[g], qscale, bl);
      mx[g] = sc[g];
    }
#pragma unroll
    for (int o = P; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
    }
    if (lane == 0) {
      reinterpret_cast<float4*>(wmax)[2 * warp] = make_float4(mx[0], mx[1], mx[2], mx[3]);
      reinterpret_cast<float4*>(wmax)[2 * warp + 1] = make_float4(mx[4], mx[5], mx[6], mx[7]);
    }
    __syncthreads();  // the warps' maxima are visible

    // the running maximum over this chunk too, and the chunk's probabilities
    float mc[kMaxG], alpha[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) mc[g] = -INFINITY;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) {
      const float4 x = reinterpret_cast<const float4*>(wmax)[2 * w];
      const float4 y = reinterpret_cast<const float4*>(wmax)[2 * w + 1];
      mc[0] = fmaxf(mc[0], x.x);
      mc[1] = fmaxf(mc[1], x.y);
      mc[2] = fmaxf(mc[2], x.z);
      mc[3] = fmaxf(mc[3], x.w);
      mc[4] = fmaxf(mc[4], y.x);
      mc[5] = fmaxf(mc[5], y.y);
      mc[6] = fmaxf(mc[6], y.z);
      mc[7] = fmaxf(mc[7], y.w);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      const float mn = fmaxf(m_run[g], mc[g]);  // finite: the chunk has a slot, and the bias is finite
      alpha[g] = ex2(m_run[g] - mn);
      m_run[g] = mn;
    }
    if (part == 0 && js < count) {
      float pr[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) pr[g] = ex2(sc[g] - m_run[g]);
      reinterpret_cast<float4*>(ps)[js] = make_float4(pr[0], pr[1], pr[2], pr[3]);
      reinterpret_cast<float4*>(ps)[lo.chunk + js] = make_float4(pr[4], pr[5], pr[6], pr[7]);
    }
    __syncthreads();  // the probabilities are visible

    // P.V over this thread's slots of the chunk
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      l_run[g] *= alpha[g];
      acc[g][0] *= alpha[g];
      acc[g][1] *= alpha[g];
      acc[g][2] *= alpha[g];
      acc[g][3] *= alpha[g];
    }
    const uint8_t* vt = tile(bi, 2 + (d4 >> 3));
    for (int j = sub; j < count; j += 16) {
      const float4 v = *reinterpret_cast<const float4*>(vt + swz(j, d4 & 7));
      const float4 p0 = reinterpret_cast<const float4*>(ps)[j];
      const float4 p1 = reinterpret_cast<const float4*>(ps)[lo.chunk + j];
      const float pr[kMaxG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        l_run[g] += pr[g];
        acc[g][0] = fmaf(pr[g], v.x, acc[g][0]);
        acc[g][1] = fmaf(pr[g], v.y, acc[g][1]);
        acc[g][2] = fmaf(pr[g], v.z, acc[g][2]);
        acc[g][3] = fmaf(pr[g], v.w, acc[g][3]);
      }
    }
    if (c + lo.nbuf < chunks) {  // refill this buffer once every thread is done with it
      fence_proxy_async();       // this thread's reads and writes of it come before the copies
      __syncthreads();
      if (tid == 0) load_tiles(c + lo.nbuf);
      load_bias(c + lo.nbuf);
    }
  }

  // the block's partial, in registers: a reduce-scatter over the 16 lanes of
  // each half-warp (xor 8, 4, 2, 1; each round keeps half the values) leaves
  // lane `sub` with head g = sub / 2's sum and outputs d, d + 1 (d = 4 d4 +
  // 2 (sub & 1)), summed over the 16 slot subsets in a fixed order
  float v[32], lv[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    lv[g] = l_run[g];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[4 * g + e] = acc[g][e];
  }
  fold<16, 8>(v, sub);
  fold<8, 4>(v, sub);
  fold<4, 2>(v, sub);
  fold<2, 1>(v, sub);
  fold<4, 8>(lv, sub);
  fold<2, 4>(lv, sub);
  fold<1, 2>(lv, sub);
  lv[0] += __shfl_xor_sync(0xffffffffu, lv[0], 1);
  const int g = sub >> 1, d = 4 * d4 + 2 * (sub & 1);
  float m = m_run[0];
#pragma unroll
  for (int i = 1; i < kMaxG; ++i)
    if (g == i) m = m_run[i];
  const bool mine = g < G, head0 = mine && d == 0;  // head0: this lane also carries head g's maximum and sum
  float* out = p.out + ((size_t)b * p.KV + kvh) * G * kHd;  // this (row, KV head)'s G x 64 outputs
  if (n == 1) {
    if (mine) {
      const float inv = 1.f / lv[0];
      *reinterpret_cast<float2*>(out + g * kHd + d) = make_float2(v[0] * inv, v[1] * inv);
    }
    return;
  }
  // the other blocks push theirs into rank 0's shared memory, completing on
  // its bars[nbuf], and are done; rank 0 adds its own and waits for them
  const int rrows = n * G;
  float* rp = reinterpret_cast<float*>(smem + lo.recv_off);
  if (rank != 0) {
    cluster_wait();
    const uint32_t recv = cluster_map(rp, 0), done = cluster_map(&bars[lo.nbuf], 0);
    const int row = rank * G + g;
    if (mine) {
      st_async(recv + (row * kHd + d) * 4, v[0], done);
      st_async(recv + (row * kHd + d + 1) * 4, v[1], done);
    }
    if (head0) {
      st_async(recv + (rrows * kHd + row) * 4, m, done);
      st_async(recv + (rrows * kHd + rrows + row) * 4, lv[0], done);
    }
    return;
  }
  if (mine) *reinterpret_cast<float2*>(rp + g * kHd + d) = make_float2(v[0], v[1]);
  if (head0) {
    rp[rrows * kHd + g] = m;
    rp[rrows * kHd + rrows + g] = lv[0];
  }
  __syncthreads();
  mbar_wait(&bars[lo.nbuf], 0);

  // rank 0: out = sum_r w_r o_r / sum_r w_r l_r, w_r = 2^(m_r - max m), in rank order
  if (tid < G * 16) {  // thread (head h, outputs 4 e .. 4 e + 3)
    const int h = tid >> 4, e = (tid & 15) * 4;
    const Merged r = merge_f32(rp, rrows, n, G, h, e);
    store_out_f32(out + h * kHd + e, r.o, r.l);
  }
}

template <int P>
cudaError_t launch_f32(const CUtensorMap& tm_k, const CUtensorMap& tm_v, const ParamsF32& p, int n, int smem,
                       cudaStream_t stream) {
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_f32_kernel<P>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(decode_attention_f32_kernel<P>,
                                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, p.KV, p.B);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = n;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = n > 1 ? 1 : 0;  // one block: no cluster, no barrier
  return cudaLaunchKernelEx(&cfg, decode_attention_f32_kernel<P>, tm_k, tm_v, p);
}

}  // namespace

// The float32 route: q, k_new, v_new, the caches and out float32, idx int32,
// bias float32; n blocks a cluster (1-16), `per` slots a block (a multiple of
// 32, with (n - 1) * per < S <= n * per); batch strides in elements
// (multiples of 4).
extern "C" int fangyan_decode_attention_f32(const void* q, const void* k_new, const void* v_new, void* cache_k,
                                            void* cache_v, const void* idx, const void* bias, void* out,
                                            long long q_sb, long long kn_sb, long long vn_sb, int L, int B, int S,
                                            int KV, int G, int hd, int layer, int n, int per, void* stream) {
  const bool aligned = ((uintptr_t)q | (uintptr_t)k_new | (uintptr_t)v_new | (uintptr_t)cache_k |
                        (uintptr_t)cache_v | (uintptr_t)out) % 16 == 0 &&
                       (q_sb | kn_sb | vn_sb) % 4 == 0;
  if (!aligned || hd != kHd || G < 1 || G > kMaxG || B < 1 || S < 1 || KV < 1 || L < 1 || B > 65535 ||
      KV > 65535 || layer < 0 || layer >= L || n < 1 || n > kF32MaxCluster || per < kF32Group ||
      per % kF32Group || (long long)(n - 1) * per >= S || (long long)n * per < S ||
      (long long)L * B >= (1ll << 31) || (long long)L * B * S * KV * kHd >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  const LayoutF32 lo = layout_f32(n, per, G);
  if (lo.total > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_k, tm_v;
  if (!cache_map(&tm_k, cache_k, L, B, S, KV, lo.chunk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !cache_map(&tm_v, cache_v, L, B, S, KV, lo.chunk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
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
  p.per = per;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = lo.chunk <= 32   ? launch_f32<8>(tm_k, tm_v, p, n, lo.total, st)
                          : lo.chunk <= 64 ? launch_f32<4>(tm_k, tm_v, p, n, lo.total, st)
                                           : launch_f32<2>(tm_k, tm_v, p, n, lo.total, st);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
