// decode_attention for Hopper (sm_90a): one query token for the G heads of
// each kv group over a full or ring KV cache.  out (B, KV, G, hd) from
// q (B, KV, G, hd), caches (B, KV, S, hd), slot_pos (S,) int32 (the position
// each slot holds; < 0 for a slot never written) and pos, a 0-dim int32 on
// the device.  Slot s is seen when 0 <= slot_pos[s] <= pos and, with a
// window, slot_pos[s] > pos - window.  Softcap cap * tanh(s / cap).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// decode_attention_kernel, which walks a sequential (B, KV, cache block)
// grid with m, l and acc in VMEM scratch.  At the main-path shape (gemma2-9b
// decode, KV 8, B 1 to 4) that is only 8 to 32 programs, and on this card
// B x KV CTAs would fill 32 of 132 SMs.  So the cache is split:
//   * pass 1, grid (splits, KV x row groups, B): a CTA takes a contiguous
//     run of slots and up to 4 heads of one kv group; each of its 4 warps
//     takes every 4th pair of slots, lanes across head dims (coalesced
//     reads of whole cache rows), a shuffle reduction per (slot, head), and
//     keeps its own online-softmax state (m, l, acc) in fp32.  The CTA
//     merges its warps and writes one (m, l, acc) partial per head;
//   * pass 2, grid (B x KV x G): one CTA per head merges the partials,
//     out = sum(acc_i e^(m_i - M)) / max(sum(l_i e^(m_i - M)), 1e-30).
// This is the TPU kernel's math with the sums reassociated.  Masked slots
// are skipped before their rows are read, so a full cache at position pos
// reads only pos + 1 rows.  pos and slot_pos are read on the device, so a
// decode step needs no host sync and can be captured in a CUDA graph.
//
// What bounds it: bytes.  At B 4, S 1024 (or B 1, S 4096), KV 8, hd 256,
// bf16, the cache rows are 33.6 MB, 10.0 us at 3.35 TB/s; the scores and
// P.V are 4 FLOP per cache element, far below the compute roof.  Splitting
// gives about 512 CTAs so enough loads are in flight to approach it.  A
// later version tunes the split and stages rows with TMA (ROADMAP.md).
//
// Shared memory (pass 1): 4 warps x 4 heads x (hd + 2) fp32 for the merge,
// 16,512 bytes at hd 256.
//
// Plain C interface for ctypes: the functions launch both passes on the
// given stream, do not synchronise and return cudaGetLastError() (or
// cudaErrorInvalidValue on arguments the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsMax = 4;   // heads of one kv group per CTA
constexpr int kUnroll = 2;    // slots a warp reads before it reduces
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// DPL: head dims each lane owns (hd <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc,
                      const int32_t* __restrict__ slot_pos,
                      const int32_t* __restrict__ pos_ptr,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int KV, int G, int S,
                      int hd, int split_len, float scale, int window,
                      float cap) {
  extern __shared__ float smem[];  // kWarps x kRowsMax x (hd + 2)
  const int n_splits = gridDim.x;
  const int split = blockIdx.x;
  const int n_groups = (G + kRowsMax - 1) / kRowsMax;
  const int kvh = blockIdx.y / n_groups;
  const int g0 = (blockIdx.y - kvh * n_groups) * kRowsMax;
  const int rows = min(kRowsMax, G - g0);
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos = *pos_ptr;

  const int64_t bk = (int64_t)b * KV + kvh;
  float qr[kRowsMax][DPL], acc[kRowsMax][DPL], m[kRowsMax], l[kRowsMax];
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      acc[r][i] = 0.f;
      qr[r][i] = (r < rows && d < hd) ? to_float(q[(bk * G + g0 + r) * hd + d]) : 0.f;
    }
  }

  const T* kb = kc + bk * S * hd;
  const T* vb = vc + bk * S * hd;
  const int start = split * split_len;
  const int end = min(S, start + split_len);
  for (int base = start + warp * kUnroll; base < end; base += kWarps * kUnroll) {
    bool ok[kUnroll];
    float kr[kUnroll][DPL], vr[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u;
      ok[u] = false;
      if (slot < end) {
        const int sp = slot_pos[slot];
        ok[u] = sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const bool rd = ok[u] && d < hd;
        kr[u][i] = rd ? to_float(kb[(int64_t)slot * hd + d]) : 0.f;
        vr[u][i] = rd ? to_float(vb[(int64_t)slot * hd + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;  // the same for every lane
#pragma unroll
      for (int r = 0; r < kRowsMax; ++r) {
        if (r >= rows) break;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part = fmaf(qr[r][i], kr[u][i], part);
        float s = warp_sum(part) * scale;
        if (cap > 0.f) s = cap * tanhf(s / cap);
        const float m_new = fmaxf(m[r], s);
        const float corr = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = l[r] * corr + p;
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(p, vr[u][i], acc[r][i] * corr);
      }
    }
  }

  // Merge the warps: slot (w, r) of shared memory holds m, l, acc[hd].
  const int ld = hd + 2;
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) {
    float* cell = smem + (warp * kRowsMax + r) * ld;
    if (lane == 0) {
      cell[0] = m[r];
      cell[1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) cell[2 + d] = acc[r][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    float mx = kNeg;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, smem[(w * kRowsMax + r) * ld]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* cell = smem + (w * kRowsMax + r) * ld;
      const float c = expf(cell[0] - mx);
      lsum += cell[1] * c;
      a += cell[2 + d] * c;
    }
    const int64_t part = (bk * G + g0 + r) * n_splits + split;
    part_acc[part * hd + d] = a;
    if (d == 0) {
      part_m[part] = mx;
      part_l[part] = lsum;
    }
  }
}

// Pass 2: one CTA per (b, kv head, head in group), one thread per head dim.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int n_splits,
                                      int hd) {
  const int64_t row = blockIdx.x;
  const float* pm = part_m + row * n_splits;
  const float* pl = part_l + row * n_splits;
  float mx = kNeg;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, pm[i]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float lsum = 0.f, a = 0.f;
    for (int i = 0; i < n_splits; ++i) {
      const float c = expf(pm[i] - mx);
      lsum += pl[i] * c;
      a += part_acc[(row * n_splits + i) * hd + d] * c;
    }
    store(out + row * hd + d, a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* kc, const void* vc, const void* slot_pos,
           const void* pos, float* part_m, float* part_l, float* part_acc,
           void* out, int B, int KV, int G, int S, int hd, int split_len,
           int n_splits, float scale, int window, float cap, int smem_bytes,
           cudaStream_t stream) {
  auto kern = decode_partial_kernel<T, DPL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int n_groups = (G + kRowsMax - 1) / kRowsMax;
  dim3 grid((unsigned)n_splits, (unsigned)(KV * n_groups), (unsigned)B);
  kern<<<grid, kWarps * 32, smem_bytes, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (const int32_t*)slot_pos,
      (const int32_t*)pos, part_m, part_l, part_acc, KV, G, S, hd, split_len,
      scale, window, cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T><<<(unsigned)(B * KV * G), 256, 0, stream>>>(
      part_m, part_l, part_acc, (T*)out, n_splits, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc,
             const void* slot_pos, const void* pos, void* part_m, void* part_l,
             void* part_acc, void* out, int B, int KV, int G, int S, int hd,
             int split_len, int n_splits, float scale, int window, float cap,
             int smem_bytes, void* stream) {
  const int need = kWarps * kRowsMax * (hd + 2) * (int)sizeof(float);
  if (smem_bytes < need || hd % 8 != 0 || hd > 256 || split_len <= 0 ||
      n_splits <= 0 || (int64_t)split_len * n_splits < S)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || KV == 0 || G == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  float* pm = (float*)part_m;
  float* pl = (float*)part_l;
  float* pa = (float*)part_acc;
  if (hd <= 32)
    return launch<T, 1>(q, kc, vc, slot_pos, pos, pm, pl, pa, out, B, KV, G, S,
                        hd, split_len, n_splits, scale, window, cap,
                        smem_bytes, st);
  if (hd <= 64)
    return launch<T, 2>(q, kc, vc, slot_pos, pos, pm, pl, pa, out, B, KV, G, S,
                        hd, split_len, n_splits, scale, window, cap,
                        smem_bytes, st);
  if (hd <= 128)
    return launch<T, 4>(q, kc, vc, slot_pos, pos, pm, pl, pa, out, B, KV, G, S,
                        hd, split_len, n_splits, scale, window, cap,
                        smem_bytes, st);
  return launch<T, 8>(q, kc, vc, slot_pos, pos, pm, pl, pa, out, B, KV, G, S,
                      hd, split_len, n_splits, scale, window, cap, smem_bytes,
                      st);
}

}  // namespace

// window <= 0: no window; cap <= 0: no softcap.  part_m and part_l hold
// B*KV*G*n_splits floats, part_acc that times hd: scratch the caller owns.
extern "C" int decode_attention_f32(
    const void* q, const void* kc, const void* vc, const void* slot_pos,
    const void* pos, void* part_m, void* part_l, void* part_acc, void* out,
    int B, int KV, int G, int S, int hd, int split_len, int n_splits,
    float scale, int window, float cap, int smem_bytes, void* stream) {
  return dispatch<float>(q, kc, vc, slot_pos, pos, part_m, part_l, part_acc,
                         out, B, KV, G, S, hd, split_len, n_splits, scale,
                         window, cap, smem_bytes, stream);
}

extern "C" int decode_attention_bf16(
    const void* q, const void* kc, const void* vc, const void* slot_pos,
    const void* pos, void* part_m, void* part_l, void* part_acc, void* out,
    int B, int KV, int G, int S, int hd, int split_len, int n_splits,
    float scale, int window, float cap, int smem_bytes, void* stream) {
  return dispatch<__nv_bfloat16>(q, kc, vc, slot_pos, pos, part_m, part_l,
                                 part_acc, out, B, KV, G, S, hd, split_len,
                                 n_splits, scale, window, cap, smem_bytes,
                                 stream);
}
