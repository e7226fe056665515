// flash_attention's bf16 path for Hopper (sm_90a): the same function as
// flash_attention.cu -- blocked online-softmax GQA attention, out (B, H, Sq,
// hd) from q (B, H, Sq, hd) and k, v (B, KV, Sk, hd), query head h reading kv
// head h / G, with causal, sliding-window, softcap, q_offset and k_len masks
// -- with both matrix products on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_kernel for bf16 inputs (fp32 inputs keep the CUDA-core
// kernel of flash_attention.cu, whose products are real fp32).  The TPU
// kernel walks a sequential (B, H, q block, kv block) grid with m, l and acc
// in VMEM scratch, one head per program.  Here:
//   * a CTA is 384 threads: two consumer warpgroups of 64 rows each and one
//     producer warpgroup, of which one thread issues every copy.  setmaxnreg
//     moves registers from the producer (24) to the consumers (240);
//   * the producer loads the CTA's q tile once and then K and V tiles of 64
//     keys into a ring of shared-memory stages with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, boxes of 64 head dims, so hd
//     256 is four boxes), completed on "full" mbarriers; consumers release a
//     stage on its "empty" mbarrier.  TMA's zero fill covers ragged Sq and
//     Sk and a head dim below the padded 64, 128 or 256;
//   * S = Q K^T is wgmma m64n64k16 with Q and K in swizzled shared memory.
//     The fp32 S accumulator becomes bf16 P in its own fragment layout, which
//     is wgmma's register A operand for O += P V; V is read from shared
//     memory through the transpose bit (MN-major B), so it needs no copy.
//     m, l and O stay fp32, as on the TPU.  P rounded to bf16 is the one
//     rounding the fp32 reference does not have (sized on the CPU in
//     tests/test_torch_attention.py);
//   * where G = H / KV divides 64, a warpgroup's 64 rows are 64 / G queries
//     of all G heads of one kv head (one 4-d TMA box over q viewed as (hd,
//     Sq, H, B)), so every K/V tile feeds the whole group; otherwise they
//     are 64 queries of one head;
//   * the CTA's kv range comes from its rows' causal and window bounds and
//     k_len; a warpgroup skips a tile none of its rows sees and applies the
//     per-element mask only on tiles that cross one of its rows' bounds.
//     log2(e) is folded into the score scale (exp2f), the softcap keeps
//     tanhf (its error would be multiplied by the cap), and row max and sum
//     reduce within the accumulator's quad of lanes;
//   * CTAs are launched longest kv range first (blockIdx.z reversed), so the
//     causal imbalance leaves no tail.  A row with no visible key is 0.
//
// What bounds it at the main-path shape (gemma2-9b prefill, B 4, H 16, KV 8,
// Sq = Sk = 512, hd 256, causal): 50.3 MB of traffic, 15 us at 3.35 TB/s,
// against 8.6 GFLOP, 8.7 us on the bf16 tensor cores: bytes, barely.  At
// S 4608 with window 4096 it is 1.7e11 FLOP, 175 us: operations.  This
// version waits for each wgmma before the softmax that follows it, so one
// warpgroup's softmax overlaps only the other warpgroup's products.
// Overlapping a tile's softmax with the next tile's S = Q K^T, ping-pong
// scheduling of the two warpgroups, a persistent grid and TMA stores of the
// output are left for later versions.
//
// Shared memory: 1 KB of alignment slack, q (128 rows x padded hd bf16),
// stages x (K and V tiles of 64 keys x padded hd bf16), 128 bytes of
// mbarriers; at hd 256, 2 stages, 197,760 bytes.  The Python wrapper
// (flash_attention.py::launch_spec) computes the same figure and the grid.
//
// Plain C interface for ctypes: the function builds the three tensor maps on
// the host (cuTensorMapEncodeTiled, reached through the runtime's driver
// entry point so the library needs no -lcuda), launches on the given stream,
// does not synchronise and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.

#include "hopper.cuh"

namespace {

constexpr int kBlockN = 64;               // keys per K/V tile
constexpr int kRowsWG = 64;               // rows per consumer warpgroup
constexpr int kConsumers = 2;             // consumer warpgroups per CTA
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kMaxStages = 4;
constexpr int kBox = 64;                  // head dims per TMA box: 128 bytes
constexpr int kBoxBytes = 64 * 128;       // one box of 64 rows (or keys)
constexpr float kNeg = -1e30f;

static_assert(kBlockN * 128 == kBoxBytes, "K/V boxes are 64 keys");

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles whose 8-row
// swizzle atoms are 1024 bytes apart (SBO).  K-major (Q, K: the reduction
// dim contiguous): LBO is unused; a 16-element step along K adds 32 bytes to
// the start address.  MN-major (V: the output dim contiguous): LBO is the
// distance between 64-element column blocks.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (uint64_t(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous instruction that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, bf16 in registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The keys a query row sees: [lo(q), hi(q)), q counted from row 0 of q.
// Both are non-decreasing in q, which the tile plan relies on
// (flash_attention.py::tile_plan does the same arithmetic).
struct Bounds {
  int causal, window, q_offset, k_len;
  __device__ __forceinline__ int lo(int q) const {
    return window > 0 ? max(0, q_offset + q - window + 1) : 0;
  }
  __device__ __forceinline__ int hi(int q) const {
    return causal ? min(k_len, q_offset + q + 1) : k_len;
  }
};

template <int HDP>
struct Smem {
  static constexpr int kChunks = HDP / kBox;                // TMA boxes along hd
  static constexpr int kQBytes = kConsumers * kChunks * kBoxBytes;
  static constexpr int kTileBytes = kChunks * kBoxBytes;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static int bytes(int stages) { return 1024 + kQBytes + stages * kStageBytes + 128; }
};

// One tile's online softmax for a consumer thread: s (the 64 x 64 score
// accumulator's 32 values of this thread, two rows) becomes P in bf16 as
// wgmma's A fragments, m and l (this thread's partial row sums) advance,
// and O is rescaled.  Accumulator value i sits at row r0 + 8 * ((i % 4) / 2)
// and column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
template <bool kMask, int HDP>
__device__ __forceinline__ void softmax_tile(float* s, float* o, float* m, float* l,
                                             uint32_t (*pf)[4], float score_mul,
                                             float cap_mul, const Bounds& bd,
                                             const int* qrow, int key0, int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i];
    x = cap_mul > 0.f ? cap_mul * tanhf(x * score_mul) : x * score_mul;
    if (kMask) {
      const int key = key0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const int q = qrow[(i % 4) / 2];
      if (key < bd.lo(q) || key >= bd.hi(q)) x = -INFINITY;
    }
    s[i] = x;
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = xor_reduce<4, true>(mx, Max{});
    const float m_new = fmaxf(m[r], mx);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[4 * j + 2 * r] - m_new);
      const float p1 = exp2f(s[4 * j + 2 * r + 1] - m_new);
      s[4 * j + 2 * r] = p0;
      s[4 * j + 2 * r + 1] = p1;
      sum += p0 + p1;
    }
    l[r] = l[r] * corr[r] + sum;
  }
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] *= corr[(i % 4) / 2];
  // A fragment of k-step kk (keys 16 kk .. 16 kk + 15): the accumulator's
  // column blocks 2 kk and 2 kk + 1, rows r0 and r0 + 8.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pf[kk][x] = pack_bf16_rn(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

template <int HDP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t db) {
  if constexpr (HDP == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HDP == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// grid (H / gh, B, M tiles); gh heads of one kv group share a CTA's rows.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ out, int H, int KV, int Sq,
                             int hd, int gh, int n_stages, float score_mul,
                             float cap_mul, int causal, int window, int q_offset,
                             int k_len) {
  using L = Smem<HDP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = base;                 // [warpgroup][hd box][64 rows][128 B]
  uint8_t* kv_s = q_s + L::kQBytes;    // [stage][K, V][hd box][64 keys][128 B]
  const uint32_t bar_q = smem_u32(kv_s + n_stages * L::kStageBytes);
  const uint32_t bar_full = bar_q + 8;                  // [kMaxStages]
  const uint32_t bar_empty = bar_full + 8 * kMaxStages; // [kMaxStages]

  const Bounds bd{causal, window, q_offset, k_len};
  const int qm = kRowsWG / gh;                 // queries per warpgroup
  const int h0 = blockIdx.x * gh;
  const int b = blockIdx.y;
  const int kvh = h0 / (H / KV);
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kConsumers * qm;
  const int kbeg = bd.lo(q0);
  const int kend = bd.hi(min(q0 + kConsumers * qm, Sq) - 1);
  const int n_tiles = kend > kbeg ? (kend - kbeg + kBlockN - 1) / kBlockN : 0;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kConsumers * 4 && lane == 0 && n_tiles > 0) {
      const int n_q = q0 + qm < Sq ? 2 : 1;     // warpgroups with rows
      mbar_expect_tx(bar_q, n_q * L::kChunks * kBoxBytes);
      for (int w = 0; w < n_q; ++w)
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_4d(smem_u32(q_s + (w * L::kChunks + c) * kBoxBytes), &tm_q,
                      bar_q, c * kBox, q0 + w * qm, h0, b);
      const int kv_row = b * KV + kvh;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % n_stages;
        if (t >= n_stages) mbar_wait(bar_empty + 8 * s, ((t / n_stages) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, L::kStageBytes);
        const uint32_t k_dst = smem_u32(kv_s + s * L::kStageBytes);
        const uint32_t v_dst = k_dst + L::kTileBytes;
        const int key0 = kbeg + t * kBlockN;
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_3d(k_dst + c * kBoxBytes, &tm_k, full, c * kBox, key0, kv_row);
          tma_load_3d(v_dst + c * kBoxBytes, &tm_v, full, c * kBox, key0, kv_row);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4;
    const int r0 = (warp % 4) * 16 + lane / 4;   // this thread's rows: r0, r0 + 8
    const int qw0 = q0 + wg * qm;                // the warpgroup's first query
    const bool has_rows = qw0 < Sq;
    const int qw_last = min(qw0 + qm, Sq) - 1;
    int qrow[2], hrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qrow[r] = qw0 + (r0 + 8 * r) % qm;
      hrow[r] = h0 + (r0 + 8 * r) / qm;
    }
    // keys some row of the warpgroup sees, and keys every row sees
    const int see_lo = bd.lo(qw0), see_hi = has_rows ? bd.hi(qw_last) : 0;
    const int all_lo = bd.lo(qw_last), all_hi = bd.hi(qw0);

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    const uint32_t q_base = smem_u32(q_s + wg * L::kChunks * kBoxBytes);
    if (n_tiles > 0) mbar_wait(bar_q, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % n_stages;
      mbar_wait(bar_full + 8 * s, (t / n_stages) & 1);
      const int key0 = kbeg + t * kBlockN;
      if (has_rows && key0 < see_hi && key0 + kBlockN > see_lo) {
        const uint32_t k_base = smem_u32(kv_s + s * L::kStageBytes);
        const uint32_t v_base = k_base + L::kTileBytes;
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        fence_regs<32>(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
          wgmma_ss_n64(sc, desc_k_major(q_base + off), desc_k_major(k_base + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(sc);

        uint32_t pf[4][4];
        if (key0 >= all_lo && key0 + kBlockN <= all_hi)
          softmax_tile<false, HDP>(sc, o, m, l, pf, score_mul, cap_mul, bd, qrow, key0, lane);
        else
          softmax_tile<true, HDP>(sc, o, m, l, pf, score_mul, cap_mul, bd, qrow, key0, lane);

        fence_regs<HDP / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          wgmma_pv<HDP>(o, pf[kk], desc_mn_major(v_base + kk * 16 * 128, kBoxBytes));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<HDP / 2>(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    // Epilogue: the full row sums, then out = O / l (0 for a row with no
    // visible key), the first hd columns of the rows that exist.
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = xor_reduce<4, true>(l[r], Sum{});
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] >= Sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst = out + ((int64_t(b) * H + hrow[r]) * Sq + qrow[r]) * hd;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        if (8 * j < hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
              o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// A bf16 tensor map with 128-byte swizzle and zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
           int Sq, int Sk, int hd, float scale, int causal, int window, float cap,
           int q_offset, int k_len, dim3 grid, int gh, int n_stages, int smem_bytes,
           cudaStream_t stream) {
  if (smem_bytes < Smem<HDP>::bytes(n_stages)) return (int)cudaErrorInvalidValue;
  const int qm = kRowsWG / gh;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  CUtensorMap tm_q, tm_k, tm_v;
  const cuuint64_t q_dims[4] = {(cuuint64_t)hd, (cuuint64_t)Sq, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t q_strides[3] = {hd * e, (cuuint64_t)Sq * hd * e,
                                   (cuuint64_t)H * Sq * hd * e};
  const cuuint32_t q_box[4] = {kBox, (cuuint32_t)qm, (cuuint32_t)gh, 1};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)hd, (cuuint64_t)Sk, (cuuint64_t)B * KV};
  const cuuint64_t kv_strides[2] = {hd * e, (cuuint64_t)Sk * hd * e};
  const cuuint32_t kv_box[3] = {kBox, kBlockN, 1};
  if (!make_map(&tm_q, q, 4, q_dims, q_strides, q_box) ||
      !make_map(&tm_k, k, 3, kv_dims, kv_strides, kv_box) ||
      !make_map(&tm_v, v, 3, kv_dims, kv_strides, kv_box))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_wgmma_kernel<HDP>;
  const int err = set_smem_limit((const void*)kern, smem_bytes);
  if (err != cudaSuccess) return err;
  constexpr float kLog2e = 1.4426950408889634f;
  const float score_mul = cap > 0.f ? scale / cap : scale * kLog2e;
  const float cap_mul = cap > 0.f ? cap * kLog2e : 0.f;
  kern<<<grid, kThreads, smem_bytes, stream>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)out, H, KV, Sq, hd, gh, n_stages, score_mul,
      cap_mul, causal, window, q_offset, k_len);
  return (int)cudaGetLastError();
}

}  // namespace

// window <= 0: no window; cap <= 0: no softcap.  grid, gh (heads per
// warpgroup tile: G where it divides 64, else 1), stages and smem_bytes come
// from flash_attention.py::launch_spec and are checked here.
extern "C" int flash_attention_bf16_wgmma(
    const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
    int Sq, int Sk, int hd, float scale, int causal, int window, float cap,
    int q_offset, int k_len, int grid_x, int grid_y, int grid_z, int gh,
    int n_stages, int smem_bytes, void* stream) {
  if (hd % 8 != 0 || hd <= 0 || hd > 256 || KV <= 0 || H % KV != 0 || gh <= 0 ||
      (H / KV) % gh != 0 || kRowsWG % gh != 0 || n_stages < 1 ||
      n_stages > kMaxStages || k_len < 0 || k_len > Sk || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int per_cta = kConsumers * (kRowsWG / gh);
  if (grid_x * gh != H || grid_y != B || grid_z != (Sq + per_cta - 1) / per_cta)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0 || B == 0 || Sk == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y, (unsigned)grid_z);
  cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 64)
    return launch<64>(q, k, v, out, B, H, KV, Sq, Sk, hd, scale, causal, window, cap,
                      q_offset, k_len, grid, gh, n_stages, smem_bytes, st);
  if (hd <= 128)
    return launch<128>(q, k, v, out, B, H, KV, Sq, Sk, hd, scale, causal, window, cap,
                       q_offset, k_len, grid, gh, n_stages, smem_bytes, st);
  return launch<256>(q, k, v, out, B, H, KV, Sq, Sk, hd, scale, causal, window, cap,
                     q_offset, k_len, grid, gh, n_stages, smem_bytes, st);
}
