// seg_combine for Hopper (sm_90a): per-partition sums of a (N, D) value
// block keyed by int32 ids, out (P, D) fp32 = sum over n with ids[n] == p.
//
// Replaces the TPU kernel repro/kernels/seg_combine.py::seg_combine_kernel,
// which builds a one-hot (P x block_n) matrix and multiplies it into each
// (block_n x block_d) value block on the MXU, accumulating over N with all
// of P in one output block.  That shape suits a matrix unit with a large
// VMEM; on this card a one-hot product would do P x N multiply-adds to move
// a few megabytes.  Here the sums are a reduce-by-key: rows with equal ids
// are summed in registers and shared memory first, and only what a CTA
// cannot finish goes to global fp32 atomics.
//
// What bounds it: bytes, and below them launch latency.  A call reads N*D
// values and N ids and writes P*D sums once: 2.1 MB at the engine's spill
// (N 262,144, D 1, P ~4,128), 0.6 us at 3.35 TB/s, so the floor is the
// launch and the memory latency of one pass, not the bandwidth.  What the
// design does about the rest:
//
//   * one host call: the C entry point zeroes `out` with cudaMemsetAsync
//     and launches the kernel, both on the caller's stream (so both are
//     captured in a CUDA graph); the wrapper allocates `out` uninitialised;
//   * the callers' ids are skewed: in wordcount half of all words fall in
//     64 hot keys, which share two 128-byte lines of `out`: one atomic per
//     row would serialise every hot row at L2.  Rows are therefore reduced
//     by key before any global atomic.
//
// Three routes, chosen by the wrapper from (N, D, P) (seg_combine.py::route)
// and passed in.  The two D == 1 routes share their first stage:
//
//   each thread loads 8 consecutive rows with 16-byte loads (ids as int4,
//   values as float4 or 8 bf16) and sums its runs of equal ids in
//   registers.  A thread's middle runs are complete; its first and last
//   runs join a segmented inclusive scan over the CTA (within a warp 5
//   __shfl_up_sync steps, head flags from the previous lane's last id;
//   then the warps' tails, combined in warp order through shared memory),
//   so a chain of equal ids across threads is summed once, by the thread
//   where it ends.  A CTA walks `rows_per_cta` rows in passes of 2,048.
//
//   The finished sums then go to global atomics or to shared memory:
//
//   bins (D == 1, P <= 12,288): the CTA holds P bins in shared memory (48
//     KB at most) and picks, pass by pass, where a pass's sums go.  It
//     counts them (a warp reduction, then the scan's second barrier): up
//     to one a 4 rows (sorted ids: a few chains a pass, as in the engine's
//     spills, P ~4,128) go straight to `out`; more (unsorted ids: about
//     one run a row, as in the distributed caller's words, P 8,192, half
//     of them in 64 hot keys) go into the bins, zeroed at the CTA's first
//     such pass and flushed once at its end, one global atomic per
//     non-zero bin.  So unsorted ids cost at most P global atomics a CTA,
//     and the hot keys' contention stays in each SM's shared memory.
//     Measured in chip_smoke.py's phase 1 on an H100 while this was
//     designed: bins for every pass cost sorted spills about a third more
//     device time (zeroing and flushing P bins), and `out` for every pass
//     cost the unsorted words 16x (the hot keys' atomics serialise at L2).
//   global (D == 1, P > 12,288: too many bins for shared memory): every
//     pass adds to `out`.  On sorted ids a CTA issues one atomic per
//     distinct id it holds: at most P + (passes over all CTAs) in all.
//     Unsorted ids cost about one atomic per run.
//   columns (D > 1): a CTA takes 64 rows x 128 columns; each thread walks
//     down its column, sums while the id is unchanged and adds on each
//     change, so loads stay coalesced across the columns.
//
// Ids outside [0, P) are dropped, as the TPU kernel's one-hot drops them; a
// dropped id breaks a run and adds nothing.  Ids may come in any order.
// fp32 sums are reassociated (atomics land in any order); sums of ones
// (pair counts) stay exact below 2^24.  The 16-byte loads need `values` and
// `ids` 16-byte aligned; otherwise (a view that starts off a 16-byte
// boundary) and for a ragged last thread, the same rows are loaded one by
// one.  seg_combine.py::reduce_plan repeats the routes' association and
// counts their global atomics on the CPU.
//
// Plain C interface for ctypes: the entry points zero `out` and launch on
// the given stream, do not synchronise, and return the memset's error or
// cudaGetLastError() after the launch.  Geometry from the caller
// (seg_combine.py::launch_spec): rows routes 256 threads a CTA and a
// multiple of 2,048 rows a CTA, one CTA per `rows_per_cta` rows on x; the
// columns route 128 threads a CTA, 64 rows a CTA on x, 128 columns on y.

#include "hopper.cuh"

namespace {

constexpr int kRows = 8;                   // consecutive rows of one thread
constexpr int kThreads = 256;              // rows routes: threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kPass = kThreads * kRows;    // rows a CTA loads at once
constexpr int kBinsAt = kPass / 4;         // more sums a pass: to the bins
constexpr int kColThreads = 128;           // columns route: columns a CTA
constexpr int kDropped = -1;               // an id outside [0, P), a row past N
constexpr int kNone = -2;                  // no neighbour: equals no id

enum Route { kBinsRoute = 0, kGlobal = 1, kColumns = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 values from `values + r`, 16-byte loads when `vec`.
__device__ __forceinline__ void load_values(const float* __restrict__ values,
                                            int64_t r, bool vec,
                                            float (&v)[kRows]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(values + r));
    const float4 b = __ldg(reinterpret_cast<const float4*>(values + r + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = values[r + j];
  }
}

__device__ __forceinline__ void load_values(
    const __nv_bfloat16* __restrict__ values, int64_t r, bool vec,
    float (&v)[kRows]) {
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(values + r));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < kRows / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = __bfloat162float(values[r + j]);
  }
}

// The 8 rows of one thread from row r: ids outside [0, p), and rows at or
// past `hi`, come back as kDropped with value 0.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ values,
                                          const int32_t* __restrict__ ids,
                                          int64_t r, int64_t hi, int64_t p,
                                          bool vec, int (&id)[kRows],
                                          float (&v)[kRows]) {
  if (r + kRows <= hi) {
    if (vec) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(ids + r));
      const int4 b = __ldg(reinterpret_cast<const int4*>(ids + r + 4));
      id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
      id[4] = b.x; id[5] = b.y; id[6] = b.z; id[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) id[j] = ids[r + j];
    }
    load_values(values, r, vec, v);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const bool in = r + j < hi;
      id[j] = in ? ids[r + j] : kDropped;
      v[j] = in ? to_float(values[r + j]) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (id[j] < 0 || id[j] >= p) id[j] = kDropped;
}

// Adds `v` into bin `id` of shared memory or into `out`.
__device__ __forceinline__ void add(bool to_bins, float* bins, float* out,
                                    int id, float v) {
  if (to_bins) atomicAdd(bins + id, v);
  else atomicAdd(out + id, v);
}

// D == 1: the bins and global routes (see the head note).
template <typename T, bool kBins>
__global__ void __launch_bounds__(kThreads)
    seg_combine_rows(const T* __restrict__ values,
                     const int32_t* __restrict__ ids, float* __restrict__ out,
                     int64_t n, int64_t p, int64_t rows_per_cta) {
  extern __shared__ float bins[];          // the bins route's p bins
  __shared__ int warp_first[kWarps], warp_last[kWarps], warp_head[kWarps];
  __shared__ int warp_adds[kWarps];
  __shared__ float warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = ((reinterpret_cast<uintptr_t>(values) |
                     reinterpret_cast<uintptr_t>(ids)) & 15) == 0;
  const int64_t lo = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t hi = min(n, lo + rows_per_cta);
  bool zeroed = false;                     // the bins hold sums: flush at the end

  for (int64_t base = lo; base < hi; base += kPass) {
    int id[kRows];
    float v[kRows];
    load_rows(values, ids, base + (int64_t)threadIdx.x * kRows, hi, p, vec,
              id, v);
    // this thread's runs: the first and the last go into the scan, those
    // between (`closed`) are complete here
    int first = id[0], last = id[0], runs = 1;
    float first_sum = 0.f, last_sum = v[0];
    bool closed = false;
#pragma unroll
    for (int j = 1; j < kRows; ++j) {
      if (id[j] == last) {
        last_sum += v[j];
      } else {
        if (runs == 1) first_sum = last_sum;
        else closed = true;
        ++runs;
        last = id[j];
        last_sum = v[j];
      }
    }
    const bool single = runs == 1;
    if (single) first_sum = last_sum;
    if (lane == 0) warp_first[warp] = first;
    if (lane == 31) warp_last[warp] = last;
    __syncthreads();
    int prev = __shfl_up_sync(kFull, last, 1);
    int next = __shfl_down_sync(kFull, first, 1);
    if (lane == 0) prev = warp > 0 ? warp_last[warp - 1] : kNone;
    if (lane == 31) next = warp < kWarps - 1 ? warp_first[warp + 1] : kNone;
    const bool cont = first == prev;
    // segmented inclusive scan of the last runs: a head is a thread whose
    // last run does not continue the chain of the thread before it
    int head = !(single && cont);
    float s = last_sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float s_up = __shfl_up_sync(kFull, s, off);
      const int h_up = __shfl_up_sync(kFull, head, off);
      if (lane >= off) {
        if (!head) s = s_up + s;
        head |= h_up;
      }
    }
    if (lane == 31) {
      warp_sum[warp] = s;
      warp_head[warp] = head;
    }
    // the chain that ends at this thread's first run, and the one that
    // ends at its last run unless the next thread carries it on
    const bool add_first = !single && first != kDropped;
    const bool add_last = next != last && last != kDropped;
    if (kBins) {
      const int adds = __reduce_add_sync(
          kFull, max(runs - 2, 0) + add_first + add_last);
      if (lane == 0) warp_adds[warp] = adds;
    }
    __syncthreads();
    // the pass's sums go to the bins when there are more than a quarter as
    // many as rows (unsorted ids), else straight to `out` (sorted ids)
    bool to_bins = false;
    if (kBins) {
      int adds = 0;
      for (int w = 0; w < kWarps; ++w) adds += warp_adds[w];
      to_bins = adds > kBinsAt;
      if (to_bins && !zeroed) {
        for (int i = threadIdx.x; i < p; i += kThreads) bins[i] = 0.f;
        __syncthreads();
        zeroed = true;
      }
    }
    // the chain's sum at the end of the previous warp, in warp order
    float carry = 0.f;
    for (int w = 0; w < warp; ++w)
      carry = warp_head[w] ? warp_sum[w] : carry + warp_sum[w];
    if (!head) s = carry + s;
    float s_prev = __shfl_up_sync(kFull, s, 1);
    if (lane == 0) s_prev = carry;
    if (closed) {                          // the middle runs, walked again
      int cur = id[0], r = 0;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (id[j] != cur) {
          if (r > 0 && cur != kDropped) add(to_bins, bins, out, cur, acc);
          ++r;
          cur = id[j];
          acc = 0.f;
        }
        acc += v[j];
      }
    }
    if (add_first)
      add(to_bins, bins, out, first, cont ? s_prev + first_sum : first_sum);
    if (add_last) add(to_bins, bins, out, last, s);
    __syncthreads();                       // the warp arrays are rewritten
  }
  if (zeroed) {
    for (int i = threadIdx.x; i < p; i += kThreads) {
      const float s = bins[i];
      if (s != 0.f) atomicAdd(out + i, s);
    }
  }
}

// D > 1: a CTA takes rows_per_cta rows x 128 columns, a thread one column.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
    seg_combine_columns(const T* __restrict__ values,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ out, int64_t n, int64_t d,
                        int64_t p, int64_t rows_per_cta) {
  const int64_t c = (int64_t)blockIdx.y * kColThreads + threadIdx.x;
  if (c >= d) return;
  const int64_t lo = (int64_t)blockIdx.x * rows_per_cta;
  const int64_t hi = min(n, lo + rows_per_cta);
  int cur = kDropped;
  float acc = 0.f;
#pragma unroll 4
  for (int64_t r = lo; r < hi; ++r) {
    int id = __ldg(ids + r);
    if (id < 0 || id >= p) id = kDropped;
    const float x = to_float(values[r * d + c]);
    if (id == cur) {
      acc += x;
    } else {
      if (cur != kDropped) atomicAdd(out + cur * d + c, acc);
      cur = id;
      acc = x;
    }
  }
  if (cur != kDropped) atomicAdd(out + cur * d + c, acc);
}

template <typename T>
int launch(const void* values, const void* ids, void* out, int64_t n,
           int64_t d, int64_t p, int route, int grid_x, int grid_y,
           int threads, int64_t rows_per_cta, int smem_bytes, void* stream) {
  const bool rows = route == kBinsRoute || route == kGlobal;
  if ((rows && (d != 1 || threads != kThreads || rows_per_cta % kPass)) ||
      (route == kColumns && threads != kColThreads) ||
      (!rows && route != kColumns))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)(p * d) * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y, 1);
  const T* v = (const T*)values;
  const int32_t* i = (const int32_t*)ids;
  float* o = (float*)out;
  if (route == kBinsRoute)
    seg_combine_rows<T, true><<<grid, threads, smem_bytes, s>>>(
        v, i, o, n, p, rows_per_cta);
  else if (route == kGlobal)
    seg_combine_rows<T, false><<<grid, threads, 0, s>>>(v, i, o, n, p,
                                                       rows_per_cta);
  else
    seg_combine_columns<T><<<grid, threads, 0, s>>>(v, i, o, n, d, p,
                                                    rows_per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int seg_combine_f32(const void* values, const void* ids, void* out,
                               int64_t n, int64_t d, int64_t p, int route,
                               int grid_x, int grid_y, int threads,
                               int64_t rows_per_cta, int smem_bytes,
                               void* stream) {
  return launch<float>(values, ids, out, n, d, p, route, grid_x, grid_y,
                       threads, rows_per_cta, smem_bytes, stream);
}

extern "C" int seg_combine_bf16(const void* values, const void* ids, void* out,
                                int64_t n, int64_t d, int64_t p, int route,
                                int grid_x, int grid_y, int threads,
                                int64_t rows_per_cta, int smem_bytes,
                                void* stream) {
  return launch<__nv_bfloat16>(values, ids, out, n, d, p, route, grid_x,
                               grid_y, threads, rows_per_cta, smem_bytes,
                               stream);
}
