// flash_attention's fp32 path for Hopper (sm_90a): blocked online-softmax
// GQA attention, out (B, H, Sq, hd) from q (B, H, Sq, hd) and k, v (B, KV,
// Sk, hd), where query head h reads kv head h / G (G = H / KV).  Options:
// causal, sliding window (key > q_pos - window), softcap cap * tanh(s / cap),
// q_offset (the global position of query row 0) and k_len (keys at or past
// it are masked).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_kernel for fp32 inputs; bf16 inputs go to
// flash_attention_wgmma.cu.  That TPU kernel walks a sequential (B, H,
// q block, kv block) grid with m, l and acc in VMEM scratch, one query head
// per program, and skips a fully masked kv block with pl.when.
//
// What bounds it.  At the gemma2-9b prefill shape in fp32 (B 4, H 16, KV 8,
// Sq = Sk = 512, hd 256, causal) the two products are 8.6 GFLOP: 128 us on
// the CUDA cores' 67 TFLOP/s, 52 us as the 3 x 8.6 GFLOP of split TF32 on
// the tensor cores' 495 TFLOP/s, against 100.7 MB of traffic, 30 us at
// 3.35 TB/s.  So it is bound by operations, and the design puts them on the
// tensor cores at fp32 accuracy and keeps their operands flowing from
// shared memory:
//   * split TF32 (3xTF32, CUTLASS's "fast fp32"): each fp32 operand x is
//     big = rna(x) plus small = rna(x - big), both TF32 rounded to nearest
//     with ties away (cvt.rna.tf32.f32's rounding, done on integers: see
//     split), and each product is big.big + big.small + small.big on
//     mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 with fp32 accumulation;
//     the dropped small.small and the rounding of small leave ~2^-21 of a
//     product, near an fp32 product's 2^-24 and inside the 1e-5 the kernel
//     is held to (TF32 alone keeps ~2^-11 and misses it).  S = Q K^T keeps
//     the three products in three accumulators, so that no product of a
//     step waits on another, and loads the next step's q and K pairs while
//     it splits and multiplies this step's.  mma.sync, not wgmma: TF32
//     wgmma takes only a K-major B from shared memory, and V in P V is not
//     K-major;
//   * rows are ordered (query, head of the group), so the G heads that share
//     a kv head share every K/V tile.  A CTA has 8 warps.  Up to hd 128 each
//     owns 16 rows (one mma M tile; 128 rows a CTA, K/V tiles of 64 keys).
//     Above, 128 rows of q would not fit beside two K/V stages, and one warp
//     a scheduler could not hide the mma latency, so a pair of warps shares
//     16 rows (64 a CTA, tiles of 32 keys): each takes half the tile's keys
//     in S and half the head dims in P V, the pair meeting at a named
//     barrier to take each row's max over both halves and to hand each
//     other its half of P through shared memory;
//   * K/V tiles are loaded with cp.async, 16 bytes a thread, into two
//     stages: tile t + 1 loads while tile t computes.  q is staged once and
//     split into fragments as they are loaded;
//   * the online softmax runs on the accumulator fragments in the log2
//     domain (scale and softcap times log2 e, one exp2f a probability, a
//     masked key's 0 by a bit mask, no branch): a lane holds two rows (g and
//     g + 8 of the 16), whose max and sum reduce over the quad of lanes by
//     __shfl_xor_sync 1 and 2.  P goes from the C layout of S straight into
//     the A layout of P V with no shuffle: mma's k index t stands for key 2t
//     and t + 4 for key 2t + 1, and V's B fragment reads the same keys.  The
//     softcap's tanhf comes before the mask;
//   * a tile's P V is summed from zero in mma's accumulators, 8 blocks of 8
//     head dims at a time so that 8 mma chains interleave, and joins O by
//     one fmaf (O corr + P V, rounded to nearest).  mma's own fp32 sums
//     thus run over one tile's keys, not over the row's: summed into O
//     directly, their error grew with Sk;
//   * the CTA's kv range comes from its rows' causal and window bounds and
//     k_len; a group of 16 rows skips a tile none of its rows sees, and
//     masks per element only a tile that crosses one of its rows' bounds.
//     Masked keys get probability 0, so a row with no visible key ends with
//     l = 0 and is written as 0 (acc times 1 / max(l, 1e-30)).  m, l and acc
//     are fp32, as on the TPU.  CTAs start longest kv range first
//     (blockIdx.x reversed);
//   * one instance serves head dims up to HD = 32, 64, 128 or 256.  V rows
//     in shared memory hold HD head dims, those past hd zero, so that P V is
//     one unrolled loop without a branch and O stays in registers;
//   * each operand is split as it is loaded from shared memory, by every
//     warp that uses it: the split's integer ops and the loads are about as
//     many instructions as the mma's, which is what a later version would
//     cut (a split once a tile needs twice the shared memory);
//   * shared-memory rows are padded so that no fragment load conflicts:
//     q and K rows (read as 8-byte pairs of head dims) to a stride of 8 or 24
//     words mod 32, V rows (read as single words of keys 2t and 2t + 1) to
//     HD + 4, P rows to keys + 8.
//
// Shared memory: rows x ldq (q) + 2 x keys x ldq (K) + 2 x keys x (HD + 4)
// (V) fp32, ldq = hd + 8 where 16 divides hd, else hd, and above hd 128 the
// pairs' P (64 rows x 40) and row statistics (4 x 2 x 16): 212,480 bytes at
// hd 256, 206,848 at hd 128, so it is dynamic shared memory above the 48 KB
// static limit.  The Python wrapper (flash_attention.py::launch_spec)
// computes the same figure and refuses a launch above 232,448 bytes;
// cp.async needs q, k and v at 16-byte-aligned addresses, which the wrapper
// checks before the launch.
//
// Plain C interface for ctypes: the function launches on the given stream,
// does not synchronise and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take (too few
// shared-memory bytes, a head dim it does not take, misaligned inputs).

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The CTA for head dims up to HD: 8 warps; kSplit warps share 16 rows, each
// taking 1 / kSplit of a tile's keys in S and of the head dims in P V.
template <int HD>
struct Tile {
  static constexpr int kWarps = 8;
  static constexpr int kSplit = HD <= 128 ? 1 : 2;
  static constexpr int kRows = 16 * kWarps / kSplit;
  static constexpr int kKeys = HD <= 128 ? 64 : 32;
  static constexpr int kLdP = kKeys + 8;  // a row of P in shared memory
};

// Row strides in floats: q and K rows are read as float2 pairs of head dims
// by 16 lanes (4 rows x 4 pairs), V rows as words of 2 keys x 8 head dims.
// V rows hold HD head dims, those past hd zero, so that P V runs the same
// unrolled, branch-free loop at every head dim of the instance.
__host__ __device__ constexpr int ld_qk(int hd) { return hd % 16 == 0 ? hd + 8 : hd; }
template <int HD>
__host__ __device__ constexpr int ld_v() { return HD + 4; }

// Floats of the exchange area of the warps that share rows: per group of 16
// rows, P (16 x kLdP) and one row statistic per warp (2 x 16).
template <int HD>
__host__ __device__ constexpr int exchange_floats() {
  using T = Tile<HD>;
  return T::kSplit == 1 ? 0 : T::kRows / 16 * (16 * T::kLdP + T::kSplit * 16);
}

template <int HD>
__host__ __device__ constexpr int smem_bytes_for(int hd) {
  using T = Tile<HD>;
  return (T::kRows * ld_qk(hd) + 2 * T::kKeys * (ld_qk(hd) + ld_v<HD>()) +
          exchange_floats<HD>()) * (int)sizeof(float);
}

// x = big + small to ~2^-22 of x, both TF32 rounded to nearest, ties away
// (cvt.rna.tf32.f32's rounding): big adds half a TF32 ulp to the magnitude
// and clears the 13 bits TF32 drops; small, the exact rest, only adds the
// half ulp, since mma reads a TF32 operand's top 19 bits and ignores the
// others.  Two integer ops and a subtraction for big, one op for small,
// where cvt.rna compiles to these plus a test for infinities on each.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c += a b: A 16 x 8 TF32 (row), B 8 x 8 TF32 (col), C 16 x 8 fp32
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int H, KV, Sq, Sk, hd;
  float scale;
  int causal, window;
  float cap;
  int q_offset, k_len;
};

// The keys query position p sees: [lo(p), hi(p)).
__device__ __forceinline__ int key_lo(const Args& a, int p) {
  return a.window > 0 ? max(0, p - a.window + 1) : 0;
}
__device__ __forceinline__ int key_hi(const Args& a, int p) {
  return a.causal ? min(a.k_len, p + 1) : a.k_len;
}

// The warps that share a group of rows meet at named barrier 1 + group.
__device__ __forceinline__ void group_sync(int group, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(threads) : "memory");
}

// HD: the largest head dim of the instance (32, 64, 128 or 256).
template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kWarps * 32)
flash_attention_kernel(const Args a) {
  using T = Tile<HD>;
  constexpr int kRows = T::kRows;
  constexpr int kKeys = T::kKeys;
  constexpr int kSplit = T::kSplit;
  constexpr int kThreads = T::kWarps * 32;
  constexpr int kNT = kKeys / 8 / kSplit;  // this warp's S tiles of 8 keys
  constexpr int kDT = HD / 8 / kSplit;     // this warp's O tiles of 8 head dims
  constexpr int ldv = ld_v<HD>();
  constexpr int ldp = T::kLdP;
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd;
  const int ldq = ld_qk(hd);
  float* q_s = smem;                    // kRows x ldq
  float* k_s = q_s + kRows * ldq;       // 2 stages x kKeys x ldq
  float* v_s = k_s + 2 * kKeys * ldq;   // 2 stages x kKeys x ldv

  const int G = a.H / a.KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // row = query * G + head
  const int n_rows = a.Sq * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = warp / kSplit;  // this warp's group of 16 rows
  const int part = warp % kSplit; // and its share of keys and head dims
  const int g = lane >> 2;        // the lane's rows g and g + 8 of the 16
  const int t = lane & 3;
  const int chunks = hd / 4;      // 16-byte chunks of a row
  // kSplit 2: the group's P and row statistics
  float* p_s = v_s + 2 * kKeys * ldv + grp * 16 * ldp;
  float* stat = v_s + 2 * kKeys * ldv + kRows * ldp + grp * kSplit * 16;

  if (hd < HD) {  // V's head dims past hd, in both stages
    for (int i = tid; i < 2 * kKeys * (HD - hd); i += kThreads) {
      const int j = i / (HD - hd);
      v_s[j * ldv + hd + (i - j * (HD - hd))] = 0.f;
    }
  }
  for (int i = tid; i < kRows * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int row = row0 + r;
    const float* src = a.q;
    int bytes = 0;
    if (row < n_rows) {
      const int qi = row / G;
      const int h = kvh * G + (row - qi * G);
      src = a.q + (((int64_t)b * a.H + h) * a.Sq + qi) * hd + c * 4;
      bytes = 16;
    }
    cp_async16(q_s + r * ldq + c * 4, src, bytes);
  }

  // The keys any row of this CTA can see: [kbeg, kend).
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int kend = key_hi(a, a.q_offset + last_row / G);
  const int kbeg = key_lo(a, a.q_offset + row0 / G);
  const int n_tiles = kend > kbeg ? (kend - kbeg + kKeys - 1) / kKeys : 0;

  const int64_t kv_off = ((int64_t)b * a.KV + kvh) * a.Sk * hd;
  const float* kb = a.k + kv_off;
  const float* vb = a.v + kv_off;
  auto load_tile = [&](int tile) {
    const int key0 = kbeg + tile * kKeys;
    float* kd = k_s + (tile & 1) * kKeys * ldq;
    float* vd = v_s + (tile & 1) * kKeys * ldv;
    for (int i = tid; i < kKeys * chunks; i += kThreads) {
      const int j = i / chunks;
      const int c = i - j * chunks;
      const bool live = key0 + j < kend;
      const int64_t off = live ? (int64_t)(key0 + j) * hd + c * 4 : 0;
      cp_async16(kd + j * ldq + c * 4, kb + off, live ? 16 : 0);
      cp_async16(vd + j * ldv + c * 4, vb + off, live ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();  // q and tile 0

  // The group's rows and the bounds that decide a tile's fate: the same for
  // every warp of the group, so all of them reach its barriers or none.
  const int wrow0 = row0 + grp * 16;
  const bool has_rows = wrow0 < n_rows;
  const int wlast = min(wrow0 + 16, n_rows) - 1;
  const int lo_first = key_lo(a, a.q_offset + wrow0 / G);
  const int hi_first = key_hi(a, a.q_offset + wrow0 / G);
  const int lo_last = key_lo(a, a.q_offset + wlast / G);
  const int hi_last = key_hi(a, a.q_offset + wlast / G);
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = a.q_offset + (wrow0 + g + 8 * r) / G;
    lo[r] = key_lo(a, p);
    hi[r] = key_hi(a, p);
  }

  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this lane's part of each row's sum
  const float* q_w = q_s + grp * 16 * ldq;
  // scores go to the log2 domain, so that each probability is one exp2f
  const float scale_log2 = a.scale * kLog2e;
  const float inv_cap = 1.f / a.cap;
  const float cap_log2 = a.cap * kLog2e;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile (and q) landed; tile + 1 in flight
    __syncthreads();

    const int key0 = kbeg + tile * kKeys;
    if (has_rows && key0 < hi_last && key0 + kKeys > lo_first) {
      const bool masked = !(key0 >= lo_last && key0 + kKeys <= hi_first);
      // this warp's keys: n tiles part * kNT ...
      const float* k_t = k_s + (tile & 1) * kKeys * ldq + part * kNT * 8 * ldq;
      const int wkey0 = key0 + part * kNT * 8;

      // S = Q K^T: mma k index t is head dim 2t, t + 4 is 2t + 1.  Three
      // accumulators, so that no two products of a step wait on each other.
      float s[kNT][4], s_bs[kNT][4], s_sb[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s_bs[j][e] = s_sb[j][e] = 0.f;
      // The next step's operands are loaded while this step's are split
      // and multiplied.
      float2 qa = *reinterpret_cast<const float2*>(q_w + g * ldq + 2 * t);
      float2 qb = *reinterpret_cast<const float2*>(q_w + (g + 8) * ldq + 2 * t);
      float2 kk[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        kk[j] = *reinterpret_cast<const float2*>(k_t + (8 * j + g) * ldq + 2 * t);
#pragma unroll 2
      for (int d0 = 0; d0 < hd; d0 += 8) {
        uint32_t ab[4], as[4];
        split(qa.x, ab[0], as[0]);
        split(qb.x, ab[1], as[1]);
        split(qa.y, ab[2], as[2]);
        split(qb.y, ab[3], as[3]);
        uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          split(kk[j].x, bb[j][0], bs[j][0]);
          split(kk[j].y, bb[j][1], bs[j][1]);
        }
        const int dn = d0 + 8 < hd ? d0 + 8 : d0;
        qa = *reinterpret_cast<const float2*>(q_w + g * ldq + dn + 2 * t);
        qb = *reinterpret_cast<const float2*>(q_w + (g + 8) * ldq + dn + 2 * t);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          kk[j] = *reinterpret_cast<const float2*>(k_t + (8 * j + g) * ldq + dn + 2 * t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(s_sb[j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(s_bs[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(s[j], ab, bb[j][0], bb[j][1]);
      }

      // Online softmax in the log2 domain; s becomes P.  s[j][e] is row
      // g + 8 (e / 2), key wkey0 + 8 j + 2 t + e % 2.
      float mx[2] = {kNeg, kNeg};
      uint32_t ok = 0xffffffffu;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] + (s_bs[j][e] + s_sb[j][e]);
          x = a.cap > 0.f ? cap_log2 * tanhf(x * a.scale * inv_cap) : x * scale_log2;
          if (masked) {
            const int key = wkey0 + 8 * j + 2 * t + (e & 1);
            if (key < lo[e >> 1] || key >= hi[e >> 1]) {
              ok &= ~(1u << (4 * j + e));
              x = kNeg;
            }
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = xor_reduce<4, true>(mx[r], Max{});
      if (kSplit > 1) {  // the row max over the group's warps
        if (t == 0) {
          stat[part * 16 + g] = mx[0];
          stat[part * 16 + g + 8] = mx[1];
        }
        group_sync(grp, kSplit * 32);
#pragma unroll
        for (int w = 0; w < kSplit; ++w) {
          mx[0] = fmaxf(mx[0], stat[w * 16 + g]);
          mx[1] = fmaxf(mx[1], stat[w * 16 + g + 8]);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked key's probability is 0, with no branch
          const uint32_t keep = 0u - ((ok >> (4 * j + e)) & 1u);
          const float p = __uint_as_float(__float_as_uint(exp2f(s[j][e] - m[e >> 1])) & keep);
          s[j][e] = p;
          l[e >> 1] += p;
        }
      // O = corr O + P V: mma k index t is key 2t of the 8, t + 4 is key
      // 2t + 1, so P's A fragment is S's C fragment as it stands; with
      // kSplit warps to a group, each reads the group's whole P from shared
      // memory.  P is split once for the tile.  Each block of 8 head dims
      // sums the tile's keys from zero in mma's accumulator and joins O by
      // one fmaf, rounded to nearest: the mma chain that adds into a running
      // sum is one tile's, not the whole row's.
      if (kSplit > 1) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int c = (part * kNT + j) * 8 + 2 * t;
          *reinterpret_cast<float2*>(p_s + g * ldp + c) = make_float2(s[j][0], s[j][1]);
          *reinterpret_cast<float2*>(p_s + (g + 8) * ldp + c) = make_float2(s[j][2], s[j][3]);
        }
        group_sync(grp, kSplit * 32);
      }
      constexpr int kJ = kNT * kSplit;  // the tile's groups of 8 keys
      uint32_t pb[kJ][4], ps[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float pa[4];
        if (kSplit > 1) {
          const float2 x = *reinterpret_cast<const float2*>(p_s + g * ldp + 8 * j + 2 * t);
          const float2 y = *reinterpret_cast<const float2*>(p_s + (g + 8) * ldp + 8 * j + 2 * t);
          pa[0] = x.x, pa[1] = y.x, pa[2] = x.y, pa[3] = y.y;
        } else {
          pa[0] = s[j % kNT][0], pa[1] = s[j % kNT][2], pa[2] = s[j % kNT][1],
          pa[3] = s[j % kNT][3];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split(pa[e], pb[j][e], ps[j][e]);
      }
      const float* v_g = v_s + (tile & 1) * kKeys * ldv + part * kDT * 8 + 2 * t * ldv + g;
      // kDB blocks of head dims at a time, so that kDB mma chains interleave
      constexpr int kDB = kDT < 8 ? kDT : 8;
#pragma unroll
      for (int d0 = 0; d0 < kDT; d0 += kDB) {
        float pv[kDB][4];
#pragma unroll
        for (int d = 0; d < kDB; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[d][e] = 0.f;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          uint32_t bb0[kDB], bs0[kDB], bb1[kDB], bs1[kDB];
#pragma unroll
          for (int d = 0; d < kDB; ++d) {
            const float* v0 = v_g + 8 * j * ldv + 8 * (d0 + d);
            split(v0[0], bb0[d], bs0[d]);
            split(v0[ldv], bb1[d], bs1[d]);
          }
#pragma unroll
          for (int d = 0; d < kDB; ++d) mma(pv[d], ps[j], bb0[d], bb1[d]);
#pragma unroll
          for (int d = 0; d < kDB; ++d) mma(pv[d], pb[j], bs0[d], bs1[d]);
#pragma unroll
          for (int d = 0; d < kDB; ++d) mma(pv[d], pb[j], bb0[d], bb1[d]);
        }
#pragma unroll
        for (int d = 0; d < kDB; ++d) {
          o[d0 + d][0] = fmaf(o[d0 + d][0], corr[0], pv[d][0]);
          o[d0 + d][1] = fmaf(o[d0 + d][1], corr[0], pv[d][1]);
          o[d0 + d][2] = fmaf(o[d0 + d][2], corr[1], pv[d][2]);
          o[d0 + d][3] = fmaf(o[d0 + d][3], corr[1], pv[d][3]);
        }
      }
    }
    __syncthreads();  // the stage (and the group's P) is consumed
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = xor_reduce<4, true>(l[r], Sum{});
  if (kSplit > 1) {  // each warp summed its own keys
    if (t == 0) {
      stat[part * 16 + g] = l[0];
      stat[part * 16 + g + 8] = l[1];
    }
    group_sync(grp, kSplit * 32);
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int w = 0; w < kSplit; ++w) {
      l[0] += stat[w * 16 + g];
      l[1] += stat[w * 16 + g + 8];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + g + 8 * r;
    if (row >= n_rows) continue;
    const int qi = row / G;
    const int h = kvh * G + (row - qi * G);
    float* out = a.out + (((int64_t)b * a.H + h) * a.Sq + qi) * hd + part * kDT * 8 + 2 * t;
#pragma unroll
    for (int d = 0; d < kDT; ++d)
      if (part * kDT * 8 + 8 * d < hd)
        *reinterpret_cast<float2*>(out + 8 * d) =
            make_float2(o[d][2 * r] * inv[r], o[d][2 * r + 1] * inv[r]);
  }
}

template <int HD>
int launch(const Args& a, int B, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes < smem_bytes_for<HD>(a.hd)) return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<HD>;
  const int err = set_smem_limit((const void*)kern, smem_bytes);
  if (err != cudaSuccess) return err;
  const int rows = a.Sq * (a.H / a.KV);
  dim3 grid((unsigned)((rows + Tile<HD>::kRows - 1) / Tile<HD>::kRows), (unsigned)a.KV,
            (unsigned)B);
  kern<<<grid, Tile<HD>::kWarps * 32, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// window <= 0: no window; cap <= 0: no softcap.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int KV, int Sq,
                                   int Sk, int hd, float scale, int causal,
                                   int window, float cap, int q_offset,
                                   int k_len, int smem_bytes, void* stream) {
  if (hd <= 0 || hd % 8 != 0 || hd > 256 || KV <= 0 || H % KV != 0 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0 || B == 0) return (int)cudaGetLastError();
  const Args a{(const float*)q, (const float*)k, (const float*)v, (float*)out,
               H, KV, Sq, Sk, hd, scale, causal, window, cap, q_offset, k_len};
  cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 32) return launch<32>(a, B, smem_bytes, st);
  if (hd <= 64) return launch<64>(a, B, smem_bytes, st);
  if (hd <= 128) return launch<128>(a, B, smem_bytes, st);
  return launch<256>(a, B, smem_bytes, st);
}
