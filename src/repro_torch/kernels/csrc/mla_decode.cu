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
// row: ~70 FLOP a byte, below the card's ~295, so memory bound.  At
// DeepSeek-V2-Lite's serving step (B 128, S 8,256, pos ~8,220) one call
// reads 1.21 GB of rows: 362 us at 3.35 TB/s.  What the design does about
// it, beside decode_attention.cu's bf16 path, whose shape it keeps:
//   * one launch a call.  A CTA takes one batch row and a run of the live
//     slots, and writes one (m, l, acc) partial per head; a counter per
//     batch row counts the CTAs that are done, and the last merges the
//     partials in split order (so the result does not depend on which CTA
//     came last) and sets the counter back to 0 for the next call and the
//     next replay of a CUDA graph;
//   * one copy of each row in shared memory.  Tiles of 32 latent rows go
//     through shared memory with cp.async (16 bytes a thread, neighbours on
//     neighbouring addresses) into a ring of 2 stages, so the next tile's
//     loads are in flight while this one is reduced; each staged row is
//     padded by 16 bytes, so the 8 rows an ldmatrix reads fall in distinct
//     banks.  The scores read all D columns of the staged rows, P V their
//     first V: the values cost no second read;
//   * both products on the tensor cores (mma.sync m16n8k16, fp32 sums): the
//     H <= 16 heads are the 16 rows of A; warp w scores tile rows 8w ..
//     8w + 7 over D / 16 k-steps; the softmax runs a lane a row, warp w
//     taking heads 4w .. 4w + 3; P goes to shared memory as two bf16 parts
//     (hi + lo: 16 bits of mantissa), each multiplied by the rows' first V
//     columns, warp w taking every 4th 8 of them;
//   * a split over the live span, decided on the device from pos; the grid
//     is sized on the host for the worst case (all S slots live), two CTAs
//     a SM at D 576 (99 KB of shared memory each), and the CTAs share
//     whatever span this step has.
// kernels/mla_decode.py::split_plan is the Python copy of the split.
//
// Plain C interface for ctypes: the function launches on the given stream,
// does not synchronise and returns cudaGetLastError() (or
// cudaErrorInvalidValue on arguments the kernel does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

using T = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;        // latent rows per stage: one per lane
constexpr int kStages = 2;
constexpr int kMaxH = 16;        // query heads: an mma tile's rows
constexpr int kMaxD = 576;       // a latent row's width
constexpr int kMaxV = 512;       // value columns
constexpr int kKSteps = kMaxD / 16;            // score k-steps at most
constexpr int kNTiles = kMaxV / 8 / kWarps;    // n8 tiles of V a warp at most
constexpr int kMaxSplits = 32;
constexpr int kMergeChunk = 16;  // splits the merge loads in one round trip
constexpr int kMaxDevices = 64;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPld = 40;  // bf16 a row of probabilities: 80 bytes, no conflicts
constexpr int kScratchBytes = 16 * kTile * 4 + 2 * 16 * kPld * 2 + 16 * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes 0 fills the 16 with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), C 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  int B, H, S, D, V, n_splits;
  float scale;
};

// a staged row: D elements and one 16-byte chunk of zeros
__host__ __device__ constexpr int row_ld(int D) { return D + 8; }

// Shared memory of a CTA: kStages stages of 32 latent rows, 16 rows of q
// (zeros past H), then the tile's scratch: scores (16 x 32 fp32),
// probabilities as two bf16 parts (2 x 16 x kPld) and rescale factors (16).
int smem_need(int D) {
  return (kStages * kTile + kMaxH) * row_ld(D) * (int)sizeof(T) + kScratchBytes;
}

__global__ void __launch_bounds__(kThreads) mla_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int n_splits = gridDim.x, split = blockIdx.x, b = blockIdx.y;
  const int H = a.H, S = a.S, D = a.D, V = a.V;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int ld = row_ld(D);
  const int C = D / 8;  // 16-byte chunks of a row
  const int n_ks = (D + 15) / 16, n_nt = V / 8;

  T* ls = reinterpret_cast<T*>(smem);
  T* q_smem = ls + kStages * kTile * ld;
  float* s_s = reinterpret_cast<float*>(q_smem + kMaxH * ld);  // 16 x 32
  T* s_p = reinterpret_cast<T*>(s_s + 16 * kTile);             // 2 x 16 x kPld
  float* s_corr = reinterpret_cast<float*>(s_p + 2 * 16 * kPld);  // 16

  const int pos = *a.pos;
  const int n = max(min(pos, S - 1) + 1, 0);  // live slots 0 .. n - 1
  const int n_tiles = (n + kTile - 1) / kTile;
  const int t_beg = split * n_tiles / n_splits;
  const int t_end = (split + 1) * n_tiles / n_splits;
  const T* lb = a.lat + (int64_t)b * S * D;

  // Tile t holds slots 32 t .. 32 t + 31; rows past the span are zeros.
  auto load_tile = [=](int tile, int stage) {
    const int j0 = tile * kTile;
    const int rows = min(kTile, n - j0);
    T* dst = ls + stage * kTile * ld;
    for (int i = tid; i < kTile * C; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      const int64_t off = r < rows ? (int64_t)(j0 + r) * D + c * 8 : 0;
      cp_async16(dst + r * ld + c * 8, lb + off, r < rows ? 16 : 0);
    }
  };
  // the rows' padding chunks stay zero (the last k-step of 16 columns
  // reaches into it where D is not a multiple of 16)
  for (int r = tid; r < kStages * kTile; r += kThreads)
    *reinterpret_cast<uint4*>(ls + r * ld + D) = make_uint4(0u, 0u, 0u, 0u);

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (t_beg + k < t_end) load_tile(t_beg + k, k);
    cp_async_commit();
  }
  // q's loads wait while the first tiles' are in flight
  const T* qb = a.q + (int64_t)b * H * D;
  for (int i = tid; i < kMaxH * (ld / 8); i += kThreads) {
    const int r = i / (ld / 8), c = i - r * (ld / 8);
    *reinterpret_cast<uint4*>(q_smem + r * ld + c * 8) =
        r < H && c < C ? __ldg(reinterpret_cast<const uint4*>(qb + r * D + c * 8))
                       : make_uint4(0u, 0u, 0u, 0u);
  }
  float o[kNTiles][4];  // O's fragments: heads grp, grp + 8; the warp's n8 tiles
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[4], lsum[4];  // the softmax warp's 4 heads
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    lsum[i] = 0.f;
  }
  // ldmatrix addresses: A rows (lanes 0-15 rows 0-15 at column 0, lanes
  // 16-31 at column 8); B rows of the scores (tile rows 8w .. 8w + 7,
  // lanes 8-15 the next 8 columns); the P V k-steps' rows
  const T* qrow = q_smem + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;

  for (int t = t_beg; t < t_end; ++t) {
    const int k = t - t_beg;
    const int stage = k % kStages;
    if (t + kStages - 1 < t_end) load_tile(t + kStages - 1, (k + kStages - 1) % kStages);
    cp_async_commit();
    // this tile's group is done; the next kStages - 1 stay in flight
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* kt = ls + stage * kTile * ld;

    // S = Q R^T for tile rows 8w .. 8w + 7 over all D columns
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const T* krow = kt + (8 * warp + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll 4
    for (int ks = 0; ks < kKSteps; ++ks) {
      if (ks < n_ks) {
        uint32_t qa[4], b0, b1;
        ldsm_x4(qa, qrow + ks * 16);
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

    // softmax of heads 4w .. 4w + 3 over the tile, a lane a row; a head with
    // no live slot in the tile keeps m and gets p = 0, corr = 1
    const bool ok = t * kTile + lane < n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = 4 * warp + i;
      float p = 0.f, corr = 1.f;
      if (g < H) {  // the same for the whole warp
        const float s = s_s[g * kTile + lane] * a.scale;
        const float mx = warp_max(ok ? s : kNeg);
        if (mx > kNeg) {
          const float m_new = fmaxf(m[i], mx);
          corr = expf(m[i] - m_new);
          p = ok ? expf(s - m_new) : 0.f;
          lsum[i] = lsum[i] * corr + p;
          m[i] = m_new;
        }
      }
      // p = hi + lo in two bf16 parts (to 2^-16 of p)
      const T hi = __float2bfloat16(p);
      s_p[g * kPld + lane] = hi;
      s_p[(16 + g) * kPld + lane] = __float2bfloat16(p - __bfloat162float(hi));
      if (lane == 0) s_corr[g] = corr;
    }
    __syncthreads();

    // O = O corr + (P_hi + P_lo) R[:, :V] over the tile's 32 rows
    uint32_t pa[2][2][4];  // [part][k-step]
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldsm_x4(pa[part][kk], s_p + (16 * part + brow) * kPld + kk * 16 + (lane >> 4) * 8);
    const float c_lo = s_corr[grp], c_hi = s_corr[grp + 8];
    const T* vrow = kt + brow * ld;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
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
    __syncthreads();  // the stage and the scratch are read
  }

  // this CTA's partial for each head: m, l and acc (m = -1e30, l = 0 and
  // acc = 0 where it saw no slot)
  const int64_t row0 = (int64_t)b * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = 4 * warp + i;
    if (g < H) {
      const float l = warp_sum(lsum[i]);
      if (lane == 0) {
        a.part_m[(row0 + g) * n_splits + split] = m[i];
        a.part_l[(row0 + g) * n_splits + split] = l;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int nt = warp + kWarps * j;
    if (nt < n_nt) {
      const int d = nt * 8 + 2 * tig;
      if (grp < H)
        *reinterpret_cast<float2*>(a.part_acc + ((row0 + grp) * n_splits + split) * V + d) =
            make_float2(o[j][0], o[j][1]);
      if (grp + 8 < H)
        *reinterpret_cast<float2*>(a.part_acc +
                                   ((row0 + grp + 8) * n_splits + split) * V + d) =
            make_float2(o[j][2], o[j][3]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(a.counters + b, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;

  // The last CTA of this batch row merges the partials in split order:
  // out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30).  A
  // thread takes 4 elements of one head's output and loads the m, l and acc
  // of up to kMergeChunk splits in one round trip before it sums them.
  __threadfence();
  if (tid == 0) a.counters[b] = 0;  // every CTA of this call has counted
  const int q4 = V / 4;
  for (int idx = tid; idx < H * q4; idx += kThreads) {
    const int g = idx / q4;
    const int c4 = idx - g * q4;
    const int64_t r0 = (row0 + g) * n_splits;
    const float* pm = a.part_m + r0;
    const float* pl = a.part_l + r0;
    const float4* px = reinterpret_cast<const float4*>(a.part_acc + r0 * V) + c4;
    float mi[kMergeChunk], li[kMergeChunk];
    float4 xi[kMergeChunk];
    auto load = [&](int i0) {
#pragma unroll
      for (int i = 0; i < kMergeChunk; ++i) {
        const bool in = i0 + i < n_splits;
        mi[i] = in ? __ldcg(pm + i0 + i) : kNeg;
        li[i] = in ? __ldcg(pl + i0 + i) : 0.f;
        xi[i] = in ? __ldcg(px + (int64_t)(i0 + i) * q4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    load(0);
    float M = kNeg;
#pragma unroll
    for (int i = 0; i < kMergeChunk; ++i) M = fmaxf(M, mi[i]);
#pragma unroll 8
    for (int i = kMergeChunk; i < n_splits; ++i) M = fmaxf(M, __ldcg(pm + i));
    float L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = 0; i0 < n_splits; i0 += kMergeChunk) {
      if (i0 > 0) load(i0);
#pragma unroll
      for (int i = 0; i < kMergeChunk; ++i) {
        if (i0 + i >= n_splits) break;
        const float cm = expf(mi[i] - M);
        L += li[i] * cm;
        acc[0] = fmaf(xi[i].x, cm, acc[0]);
        acc[1] = fmaf(xi[i].y, cm, acc[1]);
        acc[2] = fmaf(xi[i].z, cm, acc[2]);
        acc[3] = fmaf(xi[i].w, cm, acc[3]);
      }
    }
    L = fmaxf(L, 1e-30f);
    uint2 u;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
    h2[0] = __floats2bfloat162_rn(acc[0] / L, acc[1] / L);
    h2[1] = __floats2bfloat162_rn(acc[2] / L, acc[3] / L);
    *reinterpret_cast<uint2*>(a.out + (row0 + g) * V + c4 * 4) = u;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q (B, H, D), lat (B, S, D) and out (B, H, V) bf16; pos a 0-dim int32 on
// the device.  part_m and part_l hold B*H*n_splits floats, part_acc that
// times V, counters B int32 that are 0 before the call and 0 after it:
// scratch the caller owns.
extern "C" int mla_decode_bf16(const void* q, const void* lat, const void* pos,
                               void* part_m, void* part_l, void* part_acc,
                               void* counters, void* out, int B, int H, int S, int D,
                               int V, float scale, int n_splits, int smem_bytes,
                               void* stream) {
  if (H < 1 || H > kMaxH || D <= 0 || D % 8 != 0 || D > kMaxD || V <= 0 || V % 8 != 0 ||
      V > kMaxV || V > D || n_splits < 1 || n_splits > kMaxSplits ||
      smem_bytes < smem_need(D) || !aligned16(q) || !aligned16(lat) || !aligned16(out) ||
      !aligned16(part_acc))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaGetLastError();
  // The dynamic shared-memory limit is set once per device, and again only
  // when a launch needs more than was set, never while a CUDA graph is being
  // captured after a first call.
  static std::mutex smem_mutex;
  static int smem_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(smem_mutex);
    if (smem_set[device] < smem_bytes) {
      err = cudaFuncSetAttribute(mla_decode_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      smem_set[device] = smem_bytes;
    }
  }
  const Args a{static_cast<const T*>(q), static_cast<const T*>(lat),
               static_cast<const int32_t*>(pos), static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<float*>(part_acc),
               static_cast<int32_t*>(counters), static_cast<T*>(out), B, H, S, D, V,
               n_splits, scale};
  const dim3 grid((unsigned)n_splits, (unsigned)B);
  mla_decode_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
