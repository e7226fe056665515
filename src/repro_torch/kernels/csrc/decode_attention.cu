// decode_attention for Hopper (sm_90a): one query token for the G heads of
// each kv group over a full or ring KV cache, in one launch.  out (B, KV, G,
// hd) from q (B, KV, G, hd), caches (B, KV, S, hd), slot_pos (S,) int32 (the
// position each slot holds; < 0 for a slot never written) and pos, a 0-dim
// int32 on the device.  Slot s is seen when 0 <= slot_pos[s] <= pos and, with
// a window, slot_pos[s] > pos - window.  Scores are scaled by hd**-0.5, soft-
// capped to cap * tanh(s / cap), and go through an fp32 online softmax; the
// output is rounded once.  Optionally it also writes each row's log-sum-exp
// (fp32 (B, KV, G); -inf for a row that sees no slot), with which a caller
// merges partial attentions over disjoint slots, as the ranks of a cache
// split over its sequence do.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention_kernel, which walks a sequential (B, KV, cache block)
// grid with m, l and acc in VMEM scratch.
//
// What bounds it: bytes.  Each live cache row of K and V is read once; the
// scores and P.V are 4 FLOP per cache element, far below the compute roof.
// At B 4, KV 8, S 1024, hd 256, bf16, pos 1023 the rows are 33.6 MB, 10.0 us
// at 3.35 TB/s; at the serving step's pos 527, 17.3 MB, 5.2 us.  What the
// design does about it:
//   * one launch a call.  A CTA takes one (batch row, kv head) and a run of
//     the live slots, and writes one (m, l, acc) partial per head.  A counter
//     per (batch row, kv head) counts the CTAs that are done; the last one
//     merges the partials in split order, so the result does not depend on
//     which CTA came last, and sets the counter back to 0 for the next call
//     (and the next replay of a CUDA graph).  The counters are a zeroed
//     buffer the wrapper keeps per device;
//   * 16-byte loads.  Tiles of 32 cache rows of K and V, and their slot
//     positions, go through shared memory with cp.async (16 bytes a thread,
//     neighbouring threads on neighbouring addresses: 512 bytes a warp) into
//     a ring of 2 stages, so the next tile's loads are in flight while this
//     one is reduced.  Each staged row is padded by 16 bytes, so the 8 rows
//     an ldmatrix reads fall in distinct banks;
//   * all G heads of the kv group are scored against one staged tile.  In
//     bf16 (the serving path) on the tensor cores: the G <= 16 heads are the
//     16 rows of an mma.sync m16n8k16, warp w computes the scores of tile
//     rows 8w .. 8w + 7 (fp32 sums), the softmax runs a lane a row in fp32,
//     and P, split into two bf16 parts (hi + lo: 16 bits of mantissa, where
//     one bf16 P left errors near the 2e-2 tolerance on short spans), times
//     V goes back to the tensor cores, warp w taking every 4th 8 columns of
//     hd.  The reduction over hd is the mma's own: no shuffle a slot.  In
//     fp32 (exact products; no tensor-core type keeps them) on the CUDA
//     cores: a lane owns 4 (or 8) contiguous head dims and sums them for
//     each of its warp's rows, and one transposing butterfly (31 shuffles
//     for 32 rows) leaves each lane with one row's whole score, so the
//     reduction runs once a tile, not once a slot; warp w takes heads w,
//     w + 4, ...;
//   * the merge loads the m, l and acc of up to 16 splits in one round trip
//     and sums them in registers, in split order;
//   * a split over the live span, decided on the device.  pos stays on the
//     device; each CTA derives from it the live positions
//     [max(0, pos - window + 1), pos] (for a ring cache also > pos - S, mapped
//     to slots modulo S, so the run may wrap) and takes its share of their
//     tiles.  The grid is sized on the host for the worst case (all S slots
//     live), and the CTAs share whatever span this step has.  A call that
//     declares no layout (an arbitrary slot_pos) splits over all S slots.  The
//     per-slot mask on slot_pos holds in every case.
// kernels/decode_attention.py::split_plan is the Python copy of the split.
//
// Plain C interface for ctypes: the functions launch on the given stream, do
// not synchronise and return cudaGetLastError() (or cudaErrorInvalidValue on
// arguments the kernel does not take).

#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;        // cache rows per stage: one per lane
constexpr int kStages = 2;
constexpr int kMaxG = 16;         // heads of a kv group: an mma tile's rows
constexpr int kMaxSplits = 32;
constexpr int kMergeChunk = 16;  // splits the merge loads in one round trip
constexpr float kNeg = -1e30f;

// the cache layout a call declares (decode_attention.py::LAYOUTS)
constexpr int kAnyLayout = 0;    // no layout: split over all S slots
constexpr int kFullLayout = 1;   // slot i holds position i
constexpr int kRingLayout = 2;   // slot i holds the latest p == i (mod S)

template <typename T>
struct Elt;

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;  // elements in 16 bytes
  __device__ static void unpack(uint4 u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store4(__nv_bfloat16* p, const float* f) {
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(f[0], f[1]);
    h[1] = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

template <>
struct Elt<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static void store4(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// One step of the transposing butterfly over a lane's 2W row sums: keep the
// W rows of the half that bit W of the lane picks, plus the partner's sums
// of the same rows.  Unrolled with constant indices, so part stays in
// registers.
template <int W>
__device__ __forceinline__ void butterfly(float* part, int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? part[i] : part[i + W];
    const float keep = upper ? part[i + W] : part[i];
    part[i] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// The butterfly steps that reduce R row sums: widths R / 2, ..., 1.
template <int R>
__device__ __forceinline__ void butterflies(float* part, int lane) {
  if constexpr (R > 1) {
    butterfly<R / 2>(part, lane);
    butterflies<R / 2>(part, lane);
  }
}

// The live span of this step: its first slot and its number of slots, as
// decode_attention.py::live_span computes it.
__device__ __forceinline__ void live_span(int layout, int pos, int S, int window,
                                          int* first, int* count) {
  if (layout == kAnyLayout) {
    *first = 0;
    *count = S;
    return;
  }
  int lo = window > 0 ? pos - window + 1 : 0;
  int hi = pos;
  if (layout == kFullLayout)
    hi = min(hi, S - 1);
  else
    lo = max(lo, pos - S + 1);
  lo = max(lo, 0);
  *count = max(hi - lo + 1, 0);
  *first = layout == kRingLayout ? lo % S : lo;
}

struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const int32_t* slot_pos;
  const int32_t* pos;
  float* part_m;
  float* part_l;
  float* part_acc;
  int32_t* counters;
  void* out;
  float* lse;  // (B, KV, G) log-sum-exp of each row's scores, or null
  int B, KV, G, S, hd, n_splits, layout, window;
  float scale, cap;
};

// Shared memory of a CTA (smem_need): kStages stages of 32 K rows and 32 V
// rows, each row padded by one 16-byte chunk (zeros), so that the 8 rows an
// ldmatrix reads fall in 8 distinct bank groups; the stages' slot positions;
// the tile's scratch, kScratchBytes: the bf16 path's scores (16 x 32 fp32),
// probabilities as two bf16 parts (2 x 16 x kPld) and rescale factors (16
// fp32), or the fp32 path's 32 probabilities a warp; and, on the bf16 path,
// Q's G rows and a zero row, padded as the stages' rows.
constexpr int kPld = 40;  // bf16 a row of probabilities: 80 bytes, no conflicts
constexpr int kScratchBytes = 16 * kTile * 4 + 2 * 16 * kPld * 2 + 16 * 4;

template <typename T>
__host__ __device__ constexpr int row_ld(int hd) {
  return hd + 16 / (int)sizeof(T);
}

struct TileIn {  // what a tile step reads besides the staged rows
  const int* sp;  // the tile's 32 slot positions (-1 past the span)
  int pos, window;
  float scale, cap;
  __device__ bool seen(int row) const {
    const int p = sp[row];
    return p >= 0 && p <= pos && (window <= 0 || p > pos - window);
  }
  __device__ float score(float dot) const {
    const float s = dot * scale;
    return cap > 0.f ? cap * tanhf(s / cap) : s;
  }
};

// The fp32 path, on the CUDA cores (fp32 products, which no tensor-core
// type keeps).  NCH: 16-byte chunks of a row each lane owns (hd * 4 <= 512 *
// NCH); HPW: heads each warp takes, warp w taking heads w + 4 h.  A lane
// sums its 4 x NCH head dims for each of the tile's 32 rows; one
// transposing butterfly (31 shuffles) leaves lane i with row i's whole
// score, so the reduction runs once a tile, not once a slot.
template <typename T, int NCH, int HPW>
struct SimtHeads {
  using E = Elt<T>;
  static constexpr int kV = E::kVec;
  static constexpr int kE = kV * NCH;  // elements a lane owns

  float qv[HPW][kE], acc[HPW][kE], m[HPW], lsum[HPW];
  int lane, warp, G, hd, ld, C;

  __device__ void init(const T* qb, int lane_, int warp_, int G_, int hd_, T* q_smem,
                       int tid) {
    (void)q_smem;
    (void)tid;
    lane = lane_;
    warp = warp_;
    G = G_;
    hd = hd_;
    ld = row_ld<T>(hd);
    C = hd / kV;
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const int g = warp + kWarps * h;
      m[h] = kNeg;
      lsum[h] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ch = lane + 32 * c;
        float f[kV];
        if (g < G && ch < C) {
          E::unpack(__ldg(reinterpret_cast<const uint4*>(qb + g * hd + ch * kV)), f);
        } else {
#pragma unroll
          for (int e = 0; e < kV; ++e) f[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          qv[h][c * kV + e] = f[e];
          acc[h][c * kV + e] = 0.f;
        }
      }
    }
  }

  __device__ void tile(const T* kt, const T* vt, const TileIn& in,
                       unsigned char* scratch) {
    const bool ok = in.seen(lane);  // lane holds row lane's score
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const int g = warp + kWarps * h;
      if (g >= G) break;  // the same for the whole warp
      // part[r]: this lane's share of row r's score
      float part[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int ch = lane + 32 * c;
          if (ch < C) {
            float f[kV];
            E::unpack(*reinterpret_cast<const uint4*>(kt + r * ld + ch * kV), f);
#pragma unroll
            for (int e = 0; e < kV; ++e) d = fmaf(qv[h][c * kV + e], f[e], d);
          }
        }
        part[r] = d;
      }
      butterflies<kTile>(part, lane);
      const float s = in.score(part[0]);
      const float mx = xor_reduce<32>(ok ? s : kNeg, Max{});
      if (mx <= kNeg) continue;  // no live slot in the tile
      const float m_new = fmaxf(m[h], mx);
      const float corr = expf(m[h] - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      lsum[h] = lsum[h] * corr + p;
      m[h] = m_new;
      float* pw = reinterpret_cast<float*>(scratch) + warp * kTile;
      pw[lane] = p;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[h][e] *= corr;
#pragma unroll
      for (int r4 = 0; r4 < kTile; r4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r4);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const int ch = lane + 32 * c;
            if (ch < C) {
              float f[kV];
              E::unpack(*reinterpret_cast<const uint4*>(vt + (r4 + u) * ld + ch * kV), f);
#pragma unroll
              for (int e = 0; e < kV; ++e)
                acc[h][c * kV + e] = fmaf(pr[u], f[e], acc[h][c * kV + e]);
            }
          }
        }
      }
      __syncwarp();
    }
  }

  // This CTA's partial for each head: m, l and acc (m = -1e30, l = 0,
  // acc = 0 where no slot was seen).
  __device__ void finish(const Args& a, int64_t row_base, int split, int n_splits) {
#pragma unroll
    for (int h = 0; h < HPW; ++h) {
      const int g = warp + kWarps * h;
      if (g >= G) break;
      const float l = xor_reduce<32>(lsum[h], Sum{});
      const int64_t row = (row_base + g) * n_splits + split;
      if (lane == 0) {
        a.part_m[row] = m[h];
        a.part_l[row] = l;
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ch = lane + 32 * c;
        if (ch < C) {
          float4* dst = reinterpret_cast<float4*>(a.part_acc + row * hd + ch * kV);
#pragma unroll
          for (int e = 0; e < kV; e += 4)
            dst[e / 4] = make_float4(acc[h][c * kV + e], acc[h][c * kV + e + 1],
                                     acc[h][c * kV + e + 2], acc[h][c * kV + e + 3]);
        }
      }
    }
  }
};

// The bf16 path, on the tensor cores (mma.sync m16n8k16, fp32 sums).  The
// G <= 16 heads of the kv group are the 16 rows of A.  Scores: warp w takes
// tile rows 8w .. 8w + 7 as one n8 tile, S = Q K^T over hd / 16 k-steps,
// Q and K read by ldmatrix from shared memory.  Softmax:
// warp w takes heads 4w .. 4w + 3, a lane a row, in fp32; P goes to shared
// memory as two bf16 parts, hi + lo, each multiplied by V on the tensor
// cores, so P keeps 16 bits of mantissa.
// O += P V: warp w takes the n8 tiles w, w + 4, ... of hd, two k-steps over
// the 32 rows, V read by ldmatrix.trans.
struct MmaHeads {
  using T = __nv_bfloat16;
  float o[8][4];        // O's fragments: heads grp, grp + 8; 8 n8 tiles of hd
  float m[4], lsum[4];  // the softmax warp's 4 heads
  const T* qrow;        // this lane's row of Q for ldmatrix (a zero row past G)
  int lane, warp, grp, tig, G, hd, ld, n_ks, n_nt;

  // Q's G rows go to shared memory (q_smem: G + 1 rows of ld, the last one
  // zeros, which the A fragments' rows past G read).
  __device__ void init(const T* qb, int lane_, int warp_, int G_, int hd_, T* q_smem,
                       int tid) {
    lane = lane_;
    warp = warp_;
    grp = lane >> 2;
    tig = lane & 3;
    G = G_;
    hd = hd_;
    ld = row_ld<T>(hd);
    n_ks = (hd + 15) / 16;
    n_nt = hd / 8;
    const int C = ld / 8;  // 16-byte chunks of a padded row
    for (int i = tid; i < (G + 1) * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      *reinterpret_cast<uint4*>(q_smem + r * ld + c * 8) =
          r < G && c * 8 < hd ? __ldg(reinterpret_cast<const uint4*>(qb + r * hd + c * 8))
                              : make_uint4(0u, 0u, 0u, 0u);
    }
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
    qrow = q_smem + min(row, G) * ld + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNeg;
      lsum[i] = 0.f;
    }
  }

  __device__ void tile(const T* kt, const T* vt, const TileIn& in,
                       unsigned char* scratch) {
    float* s_s = reinterpret_cast<float*>(scratch);          // 16 x 32
    T* s_p = reinterpret_cast<T*>(s_s + 16 * kTile);  // 2 x 16 x kPld: hi, lo
    float* s_corr = reinterpret_cast<float*>(s_p + 2 * 16 * kPld);  // 16
    // S = Q K^T for rows 8w .. 8w + 7 (B fragments: lanes 0-7 address the
    // rows' first 8 head dims of the k-step, lanes 8-15 the next 8)
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const T* krow = kt + (8 * warp + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      if (ks < n_ks) {
        uint32_t qa[4], b0, b1;
        ldsm_x4(qa, smem_u32(qrow + ks * 16));
        ldsm_x2(b0, b1, krow + ks * 16);
        mma_bf16(c, qa, b0, b1);
      }
    }
    const int col = 8 * warp + 2 * tig;
    s_s[grp * kTile + col] = c[0];
    s_s[grp * kTile + col + 1] = c[1];
    s_s[(grp + 8) * kTile + col] = c[2];
    s_s[(grp + 8) * kTile + col + 1] = c[3];
    __syncthreads();
    // softmax of heads 4w .. 4w + 3 over the tile, a lane a row; a head
    // with no live slot in the tile keeps m and gets p = 0, corr = 1
    const bool ok = in.seen(lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = 4 * warp + i;
      float p = 0.f, corr = 1.f;
      if (g < G) {  // the same for the whole warp
        const float s = in.score(s_s[g * kTile + lane]);
        const float mx = xor_reduce<32>(ok ? s : kNeg, Max{});
        if (mx > kNeg) {
          const float m_new = fmaxf(m[i], mx);
          corr = expf(m[i] - m_new);
          p = ok ? expf(s - m_new) : 0.f;
          lsum[i] = lsum[i] * corr + p;
          m[i] = m_new;
        }
      }
      // p = hi + lo in two bf16 parts (to 2^-16 of p), so that P V on
      // the tensor cores keeps P's fp32 value nearly whole
      const T hi = __float2bfloat16(p);
      s_p[g * kPld + lane] = hi;
      s_p[(16 + g) * kPld + lane] = __float2bfloat16(p - __bfloat162float(hi));
      if (lane == 0) s_corr[g] = corr;
    }
    __syncthreads();
    // O = O corr + (P_hi + P_lo) V over the tile's 32 rows (two k-steps)
    uint32_t pa[2][2][4];  // [part][k-step]
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldsm_x4(pa[part][kk],
                smem_u32(s_p + (16 * part + (lane & 7) + ((lane >> 3) & 1) * 8) * kPld +
                         kk * 16 + (lane >> 4) * 8));
    const float c_lo = s_corr[grp], c_hi = s_corr[grp + 8];
    const T* vrow = vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nt = warp + kWarps * j;
      if (nt < n_nt) {
        o[j][0] *= c_lo;
        o[j][1] *= c_lo;
        o[j][2] *= c_hi;
        o[j][3] *= c_hi;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, vrow + kk * 16 * ld + nt * 8);
          mma_bf16(o[j], pa[0][kk], b0, b1);
          mma_bf16(o[j], pa[1][kk], b0, b1);
        }
      }
    }
  }

  // This CTA's partial for each head: m, l and acc (m = -1e30, l = 0,
  // acc = 0 where no slot was seen).
  __device__ void finish(const Args& a, int64_t row_base, int split, int n_splits) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = 4 * warp + i;
      if (g < G) {  // the same for the whole warp
        const float l = xor_reduce<32>(lsum[i], Sum{});
        if (lane == 0) {
          a.part_m[(row_base + g) * n_splits + split] = m[i];
          a.part_l[(row_base + g) * n_splits + split] = l;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nt = warp + kWarps * j;
      if (nt < n_nt) {
        const int d = nt * 8 + 2 * tig;
        if (grp < G)
          *reinterpret_cast<float2*>(
              a.part_acc + ((row_base + grp) * n_splits + split) * hd + d) =
              make_float2(o[j][0], o[j][1]);
        if (grp + 8 < G)
          *reinterpret_cast<float2*>(
              a.part_acc + ((row_base + grp + 8) * n_splits + split) * hd + d) =
              make_float2(o[j][2], o[j][3]);
      }
    }
  }
};

template <typename T, typename Heads>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  using E = Elt<T>;
  constexpr int kV = E::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int n_splits = gridDim.x, split = blockIdx.x;
  const int KV = a.KV, G = a.G, S = a.S, hd = a.hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = hd / kV;            // 16-byte chunks a row
  const int ld = row_ld<T>(hd);     // a staged row, padded by one chunk
  const int64_t bk = (int64_t)blockIdx.z * KV + blockIdx.y;

  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kStages * kTile * ld;
  int* sps = reinterpret_cast<int*>(vs + kStages * kTile * ld);
  unsigned char* scratch = reinterpret_cast<unsigned char*>(sps + kStages * kTile);
  T* q_smem = reinterpret_cast<T*>(scratch + kScratchBytes);  // bf16 path

  const int pos = *a.pos;
  int first, n;
  live_span(a.layout, pos, S, a.window, &first, &n);
  const int n_tiles = (n + kTile - 1) / kTile;
  // (n_tiles x 32 splits stays far below 2^31 for any cache a card holds)
  const int t_beg = split * n_tiles / n_splits;
  const int t_end = (split + 1) * n_tiles / n_splits;

  const T* kb = static_cast<const T*>(a.kc) + bk * S * hd;
  const T* vb = static_cast<const T*>(a.vc) + bk * S * hd;

  // Tile t holds the span's rows 32 t .. 32 t + 31: slot (first + j) mod S.
  // Rows past the span are zero-filled and get slot position -1.
  auto load_tile = [=](int tile, int stage) {
    const int j0 = tile * kTile;
    const int rows = min(kTile, n - j0);
    T* kd = ks + stage * kTile * ld;
    T* vd = vs + stage * kTile * ld;
    for (int i = tid; i < kTile * C; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      int64_t off = 0;
      if (r < rows) {
        int slot = first + j0 + r;
        if (slot >= S) slot -= S;
        off = (int64_t)slot * hd + c * kV;
      }
      const int bytes = r < rows ? 16 : 0;
      cp_async16(kd + r * ld + c * kV, kb + off, bytes);
      cp_async16(vd + r * ld + c * kV, vb + off, bytes);
    }
    if (tid < kTile) {
      if (tid < rows) {
        int slot = first + j0 + tid;
        if (slot >= S) slot -= S;
        cp_async4(sps + stage * kTile + tid, a.slot_pos + slot);
      } else {
        sps[stage * kTile + tid] = -1;
      }
    }
  };
  // the rows' padding chunks stay zero (a k-step of 16 head dims may reach
  // into it where hd is not a multiple of 16)
  for (int r = tid; r < 2 * kStages * kTile; r += kThreads)
    *reinterpret_cast<uint4*>(ks + r * ld + hd) = make_uint4(0u, 0u, 0u, 0u);

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (t_beg + k < t_end) load_tile(t_beg + k, k);
    cp_async_commit();
  }
  // q's loads wait while the first tiles' are in flight
  Heads heads;
  heads.init(static_cast<const T*>(a.q) + bk * G * hd, lane, warp, G, hd, q_smem, tid);
  for (int t = t_beg; t < t_end; ++t) {
    const int k = t - t_beg;
    const int stage = k % kStages;
    if (t + kStages - 1 < t_end) load_tile(t + kStages - 1, (k + kStages - 1) % kStages);
    cp_async_commit();
    // this tile's group is done; the next kStages - 1 stay in flight
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const TileIn in{sps + stage * kTile, pos, a.window, a.scale, a.cap};
    heads.tile(ks + stage * kTile * ld, vs + stage * kTile * ld, in, scratch);
    __syncthreads();  // the stage is read; the next load may overwrite it
  }
  heads.finish(a, bk * G, split, n_splits);
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(a.counters + bk, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;

  // The last CTA of this (batch row, kv head) merges the partials in split
  // order: out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30).
  // A thread takes 4 elements of one head's output; it loads the m, l and
  // acc of up to kMergeChunk splits in one round trip before it sums them.
  __threadfence();
  if (tid == 0) a.counters[bk] = 0;  // every CTA of this call has counted
  const int q4 = hd / 4;  // float4s in a row
  T* ob = static_cast<T*>(a.out) + bk * G * hd;
  for (int idx = tid; idx < G * q4; idx += kThreads) {
    const int g = idx / q4;
    const int c4 = idx - g * q4;
    const int64_t r0 = (bk * G + g) * n_splits;
    const float* pm = a.part_m + r0;
    const float* pl = a.part_l + r0;
    const float4* pa = reinterpret_cast<const float4*>(a.part_acc + r0 * hd) + c4;
    float mi[kMergeChunk], li[kMergeChunk];
    float4 xi[kMergeChunk];
    auto load = [&](int i0) {
#pragma unroll
      for (int i = 0; i < kMergeChunk; ++i) {
        const bool in = i0 + i < n_splits;
        mi[i] = in ? __ldcg(pm + i0 + i) : kNeg;
        li[i] = in ? __ldcg(pl + i0 + i) : 0.f;
        xi[i] = in ? __ldcg(pa + (int64_t)(i0 + i) * q4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    load(0);
    float M = kNeg;
#pragma unroll
    for (int i = 0; i < kMergeChunk; ++i) M = fmaxf(M, mi[i]);
#pragma unroll 8
    for (int i = kMergeChunk; i < n_splits; ++i) M = fmaxf(M, __ldcg(pm + i));
    float L = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = 0; i0 < n_splits; i0 += kMergeChunk) {
      if (i0 > 0) load(i0);
#pragma unroll
      for (int i = 0; i < kMergeChunk; ++i) {
        if (i0 + i >= n_splits) break;
        const float c = expf(mi[i] - M);
        L += li[i] * c;
        o[0] = fmaf(xi[i].x, c, o[0]);
        o[1] = fmaf(xi[i].y, c, o[1]);
        o[2] = fmaf(xi[i].z, c, o[2]);
        o[3] = fmaf(xi[i].w, c, o[3]);
      }
    }
    // each row's log-sum-exp, for a caller that merges this call's output
    // with another's over other slots (a cache split over ranks); -inf
    // where no slot is seen, whose output is then 0
    if (a.lse != nullptr && c4 == 0)
      a.lse[bk * G + g] = L > 0.f ? M + logf(L) : -CUDART_INF_F;
    L = fmaxf(L, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = o[e] / L;
    E::store4(ob + g * hd + c4 * 4, o);
  }
}

template <typename T>
int smem_need(int hd, int G) {
  const int q_rows = sizeof(T) == 2 ? G + 1 : 0;  // the bf16 path's Q
  return (2 * kStages * kTile + q_rows) * row_ld<T>(hd) * (int)sizeof(T) +
         kStages * kTile * 4 + kScratchBytes;
}

template <typename T, typename Heads>
int launch(const Args& a, int smem_bytes, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, Heads>;
  const int err = set_smem_limit((const void*)kern, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)a.n_splits, (unsigned)a.KV, (unsigned)a.B);
  kern<<<grid, kThreads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NCH>
int simt_by_heads(const Args& a, int smem_bytes, cudaStream_t stream) {
  if (a.G <= kWarps) return launch<float, SimtHeads<float, NCH, 1>>(a, smem_bytes, stream);
  if (a.G <= 2 * kWarps)
    return launch<float, SimtHeads<float, NCH, 2>>(a, smem_bytes, stream);
  return launch<float, SimtHeads<float, NCH, 4>>(a, smem_bytes, stream);
}

template <typename T>
int dispatch(const Args& a, int smem_bytes, void* stream) {
  if (a.hd <= 0 || a.hd % 8 != 0 || a.hd > 256 || a.G < 1 || a.G > kMaxG ||
      a.n_splits < 1 || a.n_splits > kMaxSplits || a.layout < kAnyLayout ||
      a.layout > kRingLayout || smem_bytes < smem_need<T>(a.hd, a.G) ||
      !aligned16(a.q) || !aligned16(a.kc) || !aligned16(a.vc) ||
      !aligned16(a.out) || !aligned16(a.part_acc))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.KV == 0 || a.S == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 2) {
    return launch<T, MmaHeads>(a, smem_bytes, st);
  } else {
    // a lane owns one 16-byte chunk of a row up to 512 bytes, two up to 1,024
    if (a.hd * (int)sizeof(T) <= 512) return simt_by_heads<1>(a, smem_bytes, st);
    return simt_by_heads<2>(a, smem_bytes, st);
  }
}

Args make_args(const void* q, const void* kc, const void* vc, const void* slot_pos,
               const void* pos, void* part_m, void* part_l, void* part_acc,
               void* counters, void* out, void* lse, int B, int KV, int G, int S,
               int hd, int n_splits, int layout, float scale, int window, float cap) {
  return Args{q, kc, vc, (const int32_t*)slot_pos, (const int32_t*)pos,
              (float*)part_m, (float*)part_l, (float*)part_acc, (int32_t*)counters,
              out, (float*)lse, B, KV, G, S, hd, n_splits, layout, window, scale, cap};
}

}  // namespace

// window <= 0: no window; cap <= 0: no softcap; layout 0 (any slot_pos), 1
// (full cache) or 2 (ring cache).  part_m and part_l hold B*KV*G*n_splits
// floats, part_acc that times hd, counters B*KV int32 that are 0 before the
// call and 0 after it: scratch the caller owns.  lse, when not null, receives
// B*KV*G floats: each row's log-sum-exp over the slots it sees.
extern "C" int decode_attention_f32(
    const void* q, const void* kc, const void* vc, const void* slot_pos,
    const void* pos, void* part_m, void* part_l, void* part_acc, void* counters,
    void* out, void* lse, int B, int KV, int G, int S, int hd, int n_splits,
    int layout, float scale, int window, float cap, int smem_bytes, void* stream) {
  return dispatch<float>(make_args(q, kc, vc, slot_pos, pos, part_m, part_l, part_acc,
                                   counters, out, lse, B, KV, G, S, hd, n_splits,
                                   layout, scale, window, cap),
                         smem_bytes, stream);
}

extern "C" int decode_attention_bf16(
    const void* q, const void* kc, const void* vc, const void* slot_pos,
    const void* pos, void* part_m, void* part_l, void* part_acc, void* counters,
    void* out, void* lse, int B, int KV, int G, int S, int hd, int n_splits,
    int layout, float scale, int window, float cap, int smem_bytes, void* stream) {
  return dispatch<__nv_bfloat16>(
      make_args(q, kc, vc, slot_pos, pos, part_m, part_l, part_acc, counters, out, lse,
                B, KV, G, S, hd, n_splits, layout, scale, window, cap),
      smem_bytes, stream);
}
