// flash_attention for Hopper (sm_90a): blocked online-softmax GQA attention,
// out (B, H, Sq, hd) from q (B, H, Sq, hd) and k, v (B, KV, Sk, hd), where
// query head h reads kv head h / G (G = H / KV).  Options: causal, sliding
// window (key > q_pos - window), softcap cap * tanh(s / cap), q_offset (the
// global position of query row 0) and k_len (keys at or past it are masked).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_kernel for fp32 inputs, whose products need real fp32
// arithmetic that neither TF32 nor bf16 wgmma gives; bf16 inputs go to
// flash_attention_wgmma.cu.  That TPU kernel walks a sequential (B, H,
// q block, kv block) grid with m, l and acc in VMEM scratch, one query head
// per program, and skips a fully masked kv block with pl.when.  Here:
//   * one CTA serves 32 (query row, head) pairs of one (batch, kv head):
//     rows are ordered (query, head of the group), so the G heads that share
//     a kv head share every K/V tile the CTA stages in shared memory;
//   * the causal and window bounds of the CTA's rows set the kv loop's
//     range, in place of the TPU's per-block predicate, and each key is
//     masked against its row's own bounds and k_len;
//   * 8 warps own 4 rows each.  For the scores a lane owns one key of the
//     32-key tile and computes its dot products against the warp's 4 rows
//     (q read as shared-memory broadcasts); for P.V a lane owns head dims
//     lane + 32 i and the probabilities are broadcast by shuffles;
//   * m, l and acc are fp32, as on the TPU.
//     Masked keys get probability 0, so a row whose keys are all masked
//     ends with l = 0 and is written as 0 (acc / max(l, 1e-30)).
//
// What bounds it at the gemma2-9b prefill shape in fp32 (B 4, H 16, KV 8,
// Sq = Sk = 512, hd 256, causal): 8.6 GFLOP of fp32 products, 128 us on
// the CUDA cores' 67 TFLOP/s, against 100.7 MB of traffic, 30 us at
// 3.35 TB/s.  It reads q from shared memory for every four multiply-adds,
// so it runs at the rate shared memory serves it, above that bound.
//
// Shared memory: (32 rows of q + 32 keys of K + 32 of V) x (hd + 4) fp32,
// 99,840 bytes at hd 256, so it is dynamic shared memory above the 48 KB
// static limit.  The row stride hd + 4 (hd % 8 == 0) keeps the 16-byte key
// reads of a quarter-warp on distinct banks.  The Python wrapper computes
// the same figure and refuses a launch above 232,448 bytes.
//
// Plain C interface for ctypes: the function launches on the given stream,
// does not synchronise and returns cudaGetLastError() (or cudaErrorInvalidValue
// when the shared-memory bytes given are below what the launch needs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query row, head) pairs per CTA
constexpr int kBlockK = 32;                   // keys per tile, one per lane
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// DPL: head dims each lane owns in P.V (hd <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int KV, int Sq, int Sk, int hd, float scale, int causal,
                       int window, float cap, int q_offset, int k_len) {
  extern __shared__ float smem[];
  const int ld = hd + 4;
  float* q_s = smem;                // kRows x ld
  float* k_s = q_s + kRows * ld;    // kBlockK x ld
  float* v_s = k_s + kBlockK * ld;  // kBlockK x ld

  const int G = H / KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;  // row = query index * G + head in group
  const int n_rows = Sq * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kRows * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int row = row0 + r;
    float val = 0.f;
    if (row < n_rows) {
      const int qi = row / G;
      const int h = kvh * G + (row - qi * G);
      val = to_float(q[(((int64_t)b * H + h) * Sq + qi) * hd + d]);
    }
    q_s[r * ld + d] = val;
  }

  // The keys any row of this CTA can see: [kbeg, kend).
  const int last_row = min(row0 + kRows, n_rows) - 1;
  int kend = k_len;
  if (causal) kend = min(kend, q_offset + last_row / G + 1);
  const int kbeg = window > 0 ? max(0, q_offset + row0 / G - window + 1) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
    qpos[r] = q_offset + (row0 + warp * kRowsPerWarp + r) / G;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int64_t kv_off = ((int64_t)b * KV + kvh) * Sk * hd;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  const float* q_warp = q_s + warp * kRowsPerWarp * ld;

  for (int k0 = kbeg; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed; q is staged
    for (int i = tid; i < kBlockK * hd; i += blockDim.x) {
      const int j = i / hd;
      const int d = i - j * hd;
      const int key = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (key < kend) {
        kval = to_float(kb[(int64_t)key * hd + d]);
        vval = to_float(vb[(int64_t)key * hd + d]);
      }
      k_s[j * ld + d] = kval;
      v_s[j * ld + d] = vval;
    }
    __syncthreads();

    // Scores: this lane's key against the warp's rows.
    const int key = k0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * ld);
#pragma unroll 4
    for (int d4 = 0; d4 < hd / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(q_warp + r * ld)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // Online softmax; s[r] becomes this lane's probability.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float sr = s[r] * scale;
      if (cap > 0.f) sr = cap * tanhf(sr / cap);
      bool ok = key < kend;
      if (causal) ok = ok && key <= qpos[r];
      if (window > 0) ok = ok && key > qpos[r] - window;
      sr = ok ? sr : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = ok ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      s[r] = p;
    }

    // P.V: this lane's head dims, every key of the tile.
    for (int j = 0; j < kBlockK; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(kFull, s[r], j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) {
          const float vv = v_s[j * ld + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] = fmaf(pj[r], vv, acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    if (row >= n_rows) continue;
    const int qi = row / G;
    const int h = kvh * G + (row - qi * G);
    T* o = out + (((int64_t)b * H + h) * Sq + qi) * hd;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store(o + d, acc[r][i] / denom);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int Sq, int Sk, int hd, float scale, int causal,
           int window, float cap, int q_offset, int k_len, int smem_bytes,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DPL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int G = H / KV;
  dim3 grid((unsigned)((Sq * G + kRows - 1) / kRows), (unsigned)KV, (unsigned)B);
  kern<<<grid, kWarps * 32, smem_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KV, Sq, Sk, hd, scale,
      causal, window, cap, q_offset, k_len);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int KV, int Sq, int Sk, int hd, float scale, int causal,
             int window, float cap, int q_offset, int k_len, int smem_bytes,
             void* stream) {
  const int need = (kRows + 2 * kBlockK) * (hd + 4) * (int)sizeof(float);
  if (smem_bytes < need || hd % 8 != 0 || hd > 256 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0 || B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 32)
    return launch<T, 1>(q, k, v, out, B, H, KV, Sq, Sk, hd, scale, causal,
                        window, cap, q_offset, k_len, smem_bytes, st);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, out, B, H, KV, Sq, Sk, hd, scale, causal,
                        window, cap, q_offset, k_len, smem_bytes, st);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, out, B, H, KV, Sq, Sk, hd, scale, causal,
                        window, cap, q_offset, k_len, smem_bytes, st);
  return launch<T, 8>(q, k, v, out, B, H, KV, Sq, Sk, hd, scale, causal,
                      window, cap, q_offset, k_len, smem_bytes, st);
}

}  // namespace

// window <= 0: no window; cap <= 0: no softcap.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int KV, int Sq,
                                   int Sk, int hd, float scale, int causal,
                                   int window, float cap, int q_offset,
                                   int k_len, int smem_bytes, void* stream) {
  return dispatch<float>(q, k, v, out, B, H, KV, Sq, Sk, hd, scale, causal,
                         window, cap, q_offset, k_len, smem_bytes, stream);
}
