// mla_decode for Hopper (sm_90a): absorbed multi-head latent attention for
// one decode token, in one launch.  out (B, H, V) from q (B, H, D) and the
// latent cache (B, S, D), all bf16, and pos, a 0-dim int32 on the device.
// Each row of the cache is one position's [c_kv (V) | roped k_pe (D - V)]
// and serves every head at once: scores q . row over all D columns (times
// scale) for the slots 0 .. min(pos, S - 1), an fp32 online softmax, and the
// output the softmax's mixture of the rows' first V columns, rounded once.
//
// Replaces no TPU kernel: the reference package has no latent attention.
// It was added because the GQA decode kernel (decode_attention.cu) takes K
// and V of one width up to 256; absorbed MLA is one latent "kv head" under
// H <= 16 query heads, 576-wide scores and values read from the same rows.
//
// What bounds it: bytes.  Each live latent row (1,152 bytes at D 576) is
// read once for all 16 heads, so the kernel does 16 x (2 D + 2 V) FLOP a
// row: ~30 FLOP a byte (~44 counting P's two parts), below the card's ~295.
// At DeepSeek-V2-Lite's serving step (B 128, S 8,256, pos ~8,220) one call
// reads 1.21 GB of rows: 362 us at 3.35 TB/s.  To come near that, each SM
// must keep well over 100 KB of reads in flight while it reduces what has
// landed, and the reduction must never hold the loads.  The design:
//   * one persistent CTA a SM, its work balanced.  The live rows of every
//     batch row are cut into tiles of 32; the B x T tiles, flattened in
//     (batch row, tile) order, are split into equal runs (+-1 tile), one a
//     CTA, on the device from pos (a CUDA graph replays the launch with pos
//     changing).  A CTA's run crosses batch rows: each piece of it in one
//     row is a segment, with one (m, l, acc) partial per head;
//   * a producer warp and a ring.  One warp walks the run and, for each
//     tile, waits for its stage's "empty" mbarrier and issues TMA copies
//     (cp.async.bulk.tensor) of boxes of 64 columns x 32 rows, 128-byte
//     swizzled so that the 8 rows an ldmatrix reads fall in distinct banks,
//     marked to leave L2 first; completion is counted in bytes on the
//     stage's "full" mbarrier.  At D 576 a stage is 9 boxes (36 KB) and the
//     ring 6 stages: five tiles, 184 KB, stay in flight while the consumers
//     reduce the sixth.  A batch row's last, ragged tile is copied on a
//     side barrier; the producer writes its rows past the span as zeros
//     before it hands the stage over;
//   * one consumer warpgroup that never holds the producer.  It waits on
//     the stage's full barrier and syncs only among its 4 warps (named
//     barrier 1, twice a tile): scores, each warp over a quarter of the D
//     columns for all 32 rows (q's fragments held in registers for the
//     segment, the next k-step's loads in flight), summed across warps in
//     shared memory in a fixed order; the fp32 online softmax, 8 threads a
//     head and 4 rows a thread; P as two bf16 parts (hi + lo: 16 bits of
//     mantissa) times the rows' first V columns on mma.sync (fp32 sums),
//     warp w taking every 4th 8 columns, the products of 8 of them
//     interleaved.  Each warp releases the stage on its empty barrier as
//     soon as both products have read it;
//   * the merge.  A counter per batch row counts its segments as they end;
//     the CTA that ends the last merges the row's partials in segment order
//     (so the result does not depend on which CTA came last: two calls are
//     bit-equal) and sets the counter back to 0 for the next call and the
//     next replay.  Partials are indexed by batch row + CTA, unique and in
//     segment order along each row.
// kernels/mla_decode.py::split_plan and merge_plan are the Python copy of
// the split.
//
// Plain C interface for ctypes: the function launches on the given stream,
// does not synchronise and returns cudaGetLastError() (or
// cudaErrorInvalidValue on arguments the kernel does not take).

#include "hopper.cuh"

namespace {

using T = __nv_bfloat16;

constexpr int kConsumerWarps = 4;                      // one warpgroup
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;              // and the producer warp
constexpr int kTile = 32;        // latent rows a stage
constexpr int kBox = 64;         // columns a TMA box: 128 bytes, one swizzle span
constexpr int kBoxBytes = kTile * kBox * 2;            // 4 KB: 32 rows of 128 bytes
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kMaxH = 16;        // query heads: an mma tile's rows
constexpr int kMaxD = 576;       // a latent row's width
constexpr int kMaxV = 512;       // value columns
constexpr int kKsWarp = (kMaxD / 16 + kConsumerWarps - 1) / kConsumerWarps;  // 9
constexpr int kNTiles = kMaxV / 8 / kConsumerWarps;   // n8 tiles of V a warp at most
constexpr int kPvGroup = 8;      // n8 tiles whose P V products interleave
constexpr int kMaxSplits = 32;   // CTAs a batch row at most: the grid is <= 32 B
constexpr int kMaxSegs = kMaxSplits + 1;               // segments a batch row
constexpr int kMergeItems = kMaxH * kMaxV / 4 / kConsumers;  // float4s a thread
constexpr float kNeg = -1e30f;
constexpr int kPld = 40;  // bf16 a row of probabilities: 80 bytes, no conflicts
// Shared memory past the ring: the warps' partial scores (4 x 16 x 32 fp32,
// columns XOR-swizzled; the merge's m, l, weights and sums reuse it), the
// probabilities as two bf16 parts (2 x 16 x kPld), rescale factors (16),
// full and empty mbarriers a stage and one for a ragged tile's copy, a flag.
constexpr int kPartBytes = kConsumerWarps * kMaxH * 32 * 4;
constexpr int kFixedBytes =
    kPartBytes + 2 * kMaxH * kPld * 2 + kMaxH * 4 + (2 * kMaxStages + 1) * 8 + 8;
static_assert((2 * kMaxSegs + 1) * kMaxH * 4 <= kPartBytes, "the merge's m, l and sums fit");

// The byte offset, inside a stage, of the 16 bytes at (tile row r, columns
// 8 c8 .. 8 c8 + 7): box c8 / 8, row r's 128 bytes, chunk c8 % 8 swizzled
// by the row (TMA's 128-byte swizzle over a 1024-byte aligned box), so the
// 8 rows one ldmatrix reads fall in distinct banks.
__device__ __forceinline__ uint32_t swz(int r, int c8) {
  return (uint32_t)((c8 >> 3) * kBoxBytes + r * 128 + (((c8 & 7) ^ (r & 7)) << 4));
}

// the consumer warpgroup's own barrier: the producer never waits on it
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

struct Args {
  const T* q;
  const T* lat;
  const int32_t* pos;
  float* part_m;
  float* part_l;
  float* part_acc;
  int32_t* counters;
  T* out;
  int B, H, S, D, V, smem_bytes;
  float scale;
};

// a stage: the boxes of 32 rows that cover D columns (zeros past D)
__host__ __device__ constexpr int stage_bytes(int D) {
  return (D + kBox - 1) / kBox * kBoxBytes;
}

// the CTA whose run holds flattened tile f, when G CTAs split W tiles
__device__ __forceinline__ int cta_of(int64_t f, int G, int64_t W) {
  return static_cast<int>(((f + 1) * G - 1) / W);
}

__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_kernel(const __grid_constant__ CUtensorMap tm, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];

  const int H = a.H, S = a.S, D = a.D, V = a.V;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int pos = *a.pos;
  const int n = max(min(pos, S - 1) + 1, 0);  // live slots 0 .. n - 1
  const int n_tiles = (n + kTile - 1) / kTile;  // tiles a batch row
  const int64_t W = (int64_t)a.B * n_tiles;      // tiles in all
  if (W == 0) {  // no slot seen: every output is 0, as the merge would give
    const int64_t total = (int64_t)a.B * H * V;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + tid; i < total;
         i += (int64_t)gridDim.x * kThreads)
      a.out[i] = __float2bfloat16(0.f);
    return;
  }
  // fewer tiles than CTAs: only the first W CTAs work, one tile each, so
  // every working CTA's run is non-empty and a row's CTAs are consecutive
  const int G = (int)min((int64_t)gridDim.x, W), cta = blockIdx.x;
  if (cta >= G) return;
  const int64_t f_beg = cta * W / G, f_end = (cta + 1) * W / G;

  // The ring starts at the first 1024-byte boundary (the swizzle's period);
  // as many stages as fit the rest beside the fixed part.
  const uint32_t base = smem_u32(smem);
  const uint32_t pad = ((base + 1023u) & ~1023u) - base;
  const int n_boxes = (D + kBox - 1) / kBox, st_bytes = stage_bytes(D);
  const int NS = min(kMaxStages, (a.smem_bytes - kFixedBytes - (int)pad) / st_bytes);
  const uint32_t ring = base + pad;
  unsigned char* fixed = smem + pad + NS * st_bytes;
  float* s_part = reinterpret_cast<float*>(fixed);              // 4 x 16 x 32
  T* s_p = reinterpret_cast<T*>(fixed + kPartBytes);            // 2 x 16 x kPld
  float* s_corr = reinterpret_cast<float*>(s_p + 2 * kMaxH * kPld);  // 16
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_corr + kMaxH);
  int* s_last = reinterpret_cast<int*>(bars + 2 * kMaxStages + 1);
  // the merge reuses s_part: kMaxSegs x 16 m's (then weights), as many l's,
  // 16 sums
  float* s_w = s_part;
  float* s_l = s_part + kMaxSegs * kMaxH;
  float* s_sum = s_l + kMaxSegs * kMaxH;
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kMaxStages;
  const uint32_t ragged_bar = empty0 + 8 * kMaxStages;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrival
      mbar_init(empty0 + 8 * s, kConsumerWarps);   // one arrival a consumer warp
    }
    mbar_init(ragged_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ------------------------------------------------------------ producer
    int b = (int)(f_beg / n_tiles), t = (int)(f_beg - (int64_t)b * n_tiles);
    int s = 0, round = 0, ragged_phase = 0;
    uint64_t evict_first;  // each row is read once: its lines go first from L2
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));
    for (int64_t f = f_beg; f < f_end; ++f) {
      if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
      const int rows = min(kTile, n - t * kTile);
      const uint32_t dst = ring + s * st_bytes, full = full0 + 8 * s;
      if (rows == kTile) {
        if (lane == 0) {
          mbar_expect_tx(full, st_bytes);
          for (int k = 0; k < n_boxes; ++k)
            tma_load_3d_cache_hint(dst + k * kBoxBytes, &tm, full, k * kBox, t * kTile, b,
                                   evict_first);
        }
      } else {
        // A batch row's last, ragged tile: its rows past the span hold
        // whatever the cache holds there (or TMA's zeros past S), so the
        // producer waits for the copy and writes them as zeros before it
        // hands the stage over: P V, whose probabilities there are 0, must
        // not meet a NaN.
        if (lane == 0) {
          mbar_expect_tx(ragged_bar, st_bytes);
          for (int k = 0; k < n_boxes; ++k)
            tma_load_3d_cache_hint(dst + k * kBoxBytes, &tm, ragged_bar, k * kBox,
                                   t * kTile, b, evict_first);
        }
        mbar_wait(ragged_bar, ragged_phase);
        ragged_phase ^= 1;
        if (lane >= rows)
          for (int k = 0; k < n_boxes; ++k)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                               dst + k * kBoxBytes + lane * 128 + c * 16),
                           "r"(0u)
                           : "memory");
        // the zeros are generic writes that later copies overwrite
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(full);
      }
      if (++t == n_tiles) {
        t = 0;
        ++b;
      }
      if (++s == NS) {
        s = 0;
        ++round;
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int grp = lane >> 2, tig = lane & 3;
  const int n_ks = (D + 15) / 16;
  const int ks0 = warp * n_ks / kConsumerWarps, ks1 = (warp + 1) * n_ks / kConsumerWarps;
  const int n_nt = V / 8;
  const int hh = tid >> 3, r4 = (tid & 7) * 4;  // softmax: head hh, rows r4 .. r4 + 3
  // ldmatrix rows: the scores' B (tile rows 0-15, lanes 8-15 and 24-31 the
  // next 8 columns); P's A (heads 0-15, lanes 16-31 the next 8 columns)
  const int krow = (lane >> 4) * 8 + (lane & 7), khalf = (lane >> 3) & 1;
  const uint32_t pa0 = smem_u32(s_p) +
                       (((lane & 7) + ((lane >> 3) & 1) * 8) * kPld + (lane >> 4) * 8) * 2;
  // the partial scores of head h, column c sit at h * 32 + (c ^ 8 (h & 3)):
  // a warp's float2 stores and a quarter-warp's float4 loads hit 32 banks
  float* sp_mine = s_part + warp * kMaxH * 32;

  int s = 0, round = 0;
  int64_t f = f_beg;
  while (f < f_end) {
    const int b = (int)(f / n_tiles);
    const int64_t seg_end = min(f_end, (int64_t)(b + 1) * n_tiles);

    // q's fragments for this warp's k-steps (zeros past H and D)
    uint32_t qf[kKsWarp][4];
    const T* qb = a.q + (int64_t)b * H * D;
#pragma unroll
    for (int i = 0; i < kKsWarp; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = grp + 8 * (r & 1), col = (ks0 + i) * 16 + 2 * tig + 8 * (r >> 1);
        qf[i][r] = ks0 + i < ks1 && h < H && col < D
                       ? __ldg(reinterpret_cast<const unsigned int*>(qb + h * D + col))
                       : 0u;
      }
    float o[kNTiles][4];  // O's fragments: heads grp, grp + 8; the warp's n8 tiles
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m = kNeg, lsum = 0.f;  // head hh, over this thread's rows

    for (; f < seg_end; ++f) {
      mbar_wait(full0 + 8 * s, round & 1);
      const uint32_t kt = ring + s * st_bytes;
      const int j0 = (int)(f - (int64_t)b * n_tiles) * kTile;

      // this warp's share of S = Q R^T: its k-steps, all 32 tile rows.  No
      // branch, so that the loads run a k-step ahead of the products: a
      // k-step past the warp's share has q's fragments 0 and reads a column
      // inside the stage
      float c[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
      uint32_t kb[2][8];  // B fragments of two k-steps: rows 0-15, 16-31
      auto load_k = [&](uint32_t* r, int i) {
        const int c8 = 2 * min(ks0 + i, n_ks - 1) + khalf;
        ldsm_x4(r, kt + swz(krow, c8));
        ldsm_x4(r + 4, kt + swz(krow + 16, c8));
      };
      load_k(kb[0], 0);
#pragma unroll
      for (int i = 0; i < kKsWarp; ++i) {
        if (i + 1 < kKsWarp) load_k(kb[(i + 1) & 1], i + 1);
        const uint32_t* r = kb[i & 1];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(c[nt], qf[i], r[2 * nt], r[2 * nt + 1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = (8 * nt + 2 * tig) ^ (8 * (grp & 3));
        *reinterpret_cast<float2*>(sp_mine + grp * 32 + col) = make_float2(c[nt][0], c[nt][1]);
        *reinterpret_cast<float2*>(sp_mine + (grp + 8) * 32 + col) =
            make_float2(c[nt][2], c[nt][3]);
      }
      consumers_sync();

      // softmax of head hh over rows r4 .. r4 + 3: the warps' parts summed in
      // warp order; a head with no live slot in the tile (or past H) keeps
      // m and gets p = 0, corr = 1
      const int my_col = r4 ^ (8 * (hh & 3));
      float sc[4];
      {
        const float4 v = *reinterpret_cast<const float4*>(s_part + hh * 32 + my_col);
        sc[0] = v.x, sc[1] = v.y, sc[2] = v.z, sc[3] = v.w;
      }
#pragma unroll
      for (int w = 1; w < kConsumerWarps; ++w) {
        const float4 v =
            *reinterpret_cast<const float4*>(s_part + (w * kMaxH + hh) * 32 + my_col);
        sc[0] += v.x, sc[1] += v.y, sc[2] += v.z, sc[3] += v.w;
      }
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ok[i] = hh < H && j0 + r4 + i < n;
        sc[i] *= a.scale;
        mx = fmaxf(mx, ok[i] ? sc[i] : kNeg);
      }
      mx = xor_reduce<8>(mx, Max{});  // the 8 lanes of head hh
      float p[4] = {0.f, 0.f, 0.f, 0.f}, corr = 1.f;
      if (mx > kNeg) {  // the same for the 8 lanes of the head
        const float m_new = fmaxf(m, mx);
        corr = expf(m - m_new);
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ok[i] ? expf(sc[i] - m_new) : 0.f;
        lsum = lsum * corr + ((p[0] + p[1]) + (p[2] + p[3]));
        m = m_new;
      }
      // p = hi + lo in two bf16 parts (to 2^-16 of p)
      T hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = __float2bfloat16(p[i]);
        lo[i] = __float2bfloat16(p[i] - __bfloat162float(hi[i]));
      }
      *reinterpret_cast<uint2*>(s_p + hh * kPld + r4) =
          make_uint2(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]));
      *reinterpret_cast<uint2*>(s_p + (kMaxH + hh) * kPld + r4) =
          make_uint2(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]));
      if (r4 == 0) s_corr[hh] = corr;
      consumers_sync();

      // O = O corr + (P_hi + P_lo) R[:, :V] over the tile's 32 rows
      uint32_t pa[2][2][4];  // [part][k-step]
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          ldsm_x4(pa[part][kk], pa0 + (part * kMaxH * kPld + kk * 16) * 2);
      const float c_lo = s_corr[grp], c_hi = s_corr[grp + 8];
      // the warp's n8 tiles in groups, each product of a group issued for
      // every tile of it before the next, so the chains on O interleave; a
      // tile past V repeats the last (its O is never written).  ldmatrix.trans
      // rows: tile rows 0-31, a lane each.
#pragma unroll
      for (int g = 0; g < kNTiles; g += kPvGroup) {
        uint32_t vb[kPvGroup][4];  // k-step 0: rows 0-15; k-step 1: rows 16-31
#pragma unroll
        for (int jj = 0; jj < kPvGroup; ++jj)
          ldsm_x4_trans(vb[jj],
                        kt + swz(lane, min(warp + kConsumerWarps * (g + jj), n_nt - 1)));
#pragma unroll
        for (int jj = 0; jj < kPvGroup; ++jj) {
          o[g + jj][0] *= c_lo;
          o[g + jj][1] *= c_lo;
          o[g + jj][2] *= c_hi;
          o[g + jj][3] *= c_hi;
        }
#pragma unroll
        for (int step = 0; step < 4; ++step)  // (k-step, part): hi then lo
#pragma unroll
          for (int jj = 0; jj < kPvGroup; ++jj)
            mma_bf16(o[g + jj], pa[step & 1][step >> 1], vb[jj][2 * (step >> 1)],
                     vb[jj][2 * (step >> 1) + 1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is read
      if (++s == NS) {
        s = 0;
        ++round;
      }
    }

    // this segment's partial for each head, at slot b + cta
    const int64_t row0 = ((int64_t)b + cta) * H;
    const float l = xor_reduce<8>(lsum, Sum{});
    if (hh < H && r4 == 0) {
      a.part_m[row0 + hh] = m;
      a.part_l[row0 + hh] = l;
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int nt = warp + kConsumerWarps * j;
      if (nt < n_nt) {
        const int d = nt * 8 + 2 * tig;
        if (grp < H)
          *reinterpret_cast<float2*>(a.part_acc + (row0 + grp) * V + d) =
              make_float2(o[j][0], o[j][1]);
        if (grp + 8 < H)
          *reinterpret_cast<float2*>(a.part_acc + (row0 + grp + 8) * V + d) =
              make_float2(o[j][2], o[j][3]);
      }
    }
    __threadfence();
    consumers_sync();
    // the row's segments: CTAs c_first .. c_last, partial slots b + c
    const int c_first = cta_of((int64_t)b * n_tiles, G, W);
    const int n_seg = cta_of((int64_t)(b + 1) * n_tiles - 1, G, W) - c_first + 1;
    if (tid == 0) *s_last = atomicAdd(a.counters + b, 1) == n_seg - 1;
    consumers_sync();
    if (!*s_last) continue;

    // The last CTA of this batch row merges its partials in segment order:
    // out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30).
    __threadfence();
    if (tid == 0) a.counters[b] = 0;  // every segment of this call has counted
    // The segments' m and l come to shared memory in one round trip; the
    // weights e^(m_i - M) replace the m's there.
    const int64_t seg0 = (int64_t)b + c_first;
    for (int i = tid; i < n_seg * H; i += kConsumers) {
      const int seg = i / H, g = i - seg * H;
      s_w[seg * kMaxH + g] = __ldcg(a.part_m + seg0 * H + i);
      s_l[seg * kMaxH + g] = __ldcg(a.part_l + seg0 * H + i);
    }
    consumers_sync();
    if (tid < H) {
      float M = kNeg;
      for (int i = 0; i < n_seg; ++i) M = fmaxf(M, s_w[i * kMaxH + tid]);
      float L = 0.f;
      for (int i = 0; i < n_seg; ++i) {
        const float cm = expf(s_w[i * kMaxH + tid] - M);
        L += s_l[i * kMaxH + tid] * cm;
        s_w[i * kMaxH + tid] = cm;
      }
      s_sum[tid] = fmaxf(L, 1e-30f);
    }
    consumers_sync();
    // a thread takes kMergeItems float4s of the row's output, item k at
    // tid + 128 k, and loads all of a segment's before it sums them (no
    // branch: an item past H V / 4 repeats the last and is not written)
    const int q4 = V / 4, n_items = H * q4;
    float4 acc[kMergeItems];
#pragma unroll
    for (int k = 0; k < kMergeItems; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < n_seg; ++i) {
      const float4* px = reinterpret_cast<const float4*>(a.part_acc + (seg0 + i) * H * V);
#pragma unroll
      for (int k = 0; k < kMergeItems; ++k) {
        const int idx = min(tid + k * kConsumers, n_items - 1);
        const float cm = s_w[i * kMaxH + idx / q4];
        const float4 x = __ldcg(px + idx);
        acc[k].x = fmaf(x.x, cm, acc[k].x);
        acc[k].y = fmaf(x.y, cm, acc[k].y);
        acc[k].z = fmaf(x.z, cm, acc[k].z);
        acc[k].w = fmaf(x.w, cm, acc[k].w);
      }
    }
#pragma unroll
    for (int k = 0; k < kMergeItems; ++k) {
      const int idx = tid + k * kConsumers;
      if (idx < n_items) {
        const float L = s_sum[idx / q4];
        uint2 u;
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
        h2[0] = __floats2bfloat162_rn(acc[k].x / L, acc[k].y / L);
        h2[1] = __floats2bfloat162_rn(acc[k].z / L, acc[k].w / L);
        *reinterpret_cast<uint2*>(a.out + (int64_t)b * H * V + (int64_t)idx * 4) = u;
      }
    }
    consumers_sync();  // s_w and s_sum are read before the next scores land there
  }
}

}  // namespace

// q (B, H, D), lat (B, S, D) and out (B, H, V) bf16; pos a 0-dim int32 on
// the device.  n_splits is the grid: CTAs, at most 32 a batch row.
// part_m and part_l hold (B + n_splits) * H floats, part_acc that times V,
// counters B int32 that are 0 before the call and 0 after it: scratch the
// caller owns.  smem_bytes sizes the ring: as many stages (up to 8) as fit
// beside the fixed part, at least 3 wherever the block's shared memory
// starts.
extern "C" int mla_decode_bf16(const void* q, const void* lat, const void* pos,
                               void* part_m, void* part_l, void* part_acc,
                               void* counters, void* out, int B, int H, int S, int D,
                               int V, float scale, int n_splits, int smem_bytes,
                               void* stream) {
  if (H < 1 || H > kMaxH || D <= 0 || D % 8 != 0 || D > kMaxD || V <= 0 || V % 8 != 0 ||
      V > kMaxV || V > D || n_splits < 1 || (int64_t)n_splits > (int64_t)kMaxSplits * B ||
      (smem_bytes - kFixedBytes - 1008) / stage_bytes(D) < kMinStages || !aligned16(q) ||
      !aligned16(lat) || !aligned16(out) || !aligned16(part_acc))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  // the latent cache as (D, S, B), boxes of 64 columns x 32 rows of one
  // batch row, 128-byte swizzle, zeros past D and S
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {kBox, kTile, 1}, unit[3] = {1, 1, 1};
  if (encode(&tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(lat), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int err = set_smem_limit((const void*)mla_decode_kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const T*>(q), static_cast<const T*>(lat),
               static_cast<const int32_t*>(pos), static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<float*>(part_acc),
               static_cast<int32_t*>(counters), static_cast<T*>(out), B, H, S, D, V,
               smem_bytes, scale};
  mla_decode_kernel<<<n_splits, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      tm, a);
  return (int)cudaGetLastError();
}
