// seg_combine for Hopper (sm_90a): per-partition sums of a (N, D) value
// block keyed by int32 ids, out (P, D) fp32 = sum over n with ids[n] == p.
//
// Replaces the TPU kernel repro/kernels/seg_combine.py::seg_combine_kernel,
// which builds a one-hot (P x block_n) matrix and multiplies it into each
// (block_n x block_d) value block on the MXU, accumulating over N with all
// of P in one output block.  That shape suits a matrix unit with a large
// VMEM; on this card the main path (the engine's combiner) has N = 262,144,
// D = 1 and P of about 4,128, so a one-hot product would do P x N
// multiply-adds to move ~2 MB.  Here each thread takes one (n, d) element
// and atomically adds it into out[id, d].
//
// What bounds it: bytes.  The main-path call reads N*D values and N ids and
// writes P*D sums, about 2 MB, under 1 us at 3.35 TB/s, so launch cost
// dominates.  The engine's ids arrive sorted (np.unique's inverse), so
// neighbouring threads hit the same address; a later version can exploit
// that with a warp-segmented reduction before the atomics.
//
// Ids outside [0, P) are dropped, as the TPU kernel's one-hot drops them.
// fp32 atomics reorder the sums from run to run; sums of ones (pair counts)
// stay exact below 2^24.
//
// Plain C interface for ctypes: the functions return cudaGetLastError()
// after the launch; they launch on the given stream and do not synchronise.
// The caller zero-fills `out`.  The grid comes from the caller: one thread
// per element, `threads` a block, `blocks` = ceil(n * d / threads)
// (seg_combine.py::launch_spec), and the kernel drops the threads past
// n * d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void seg_combine_kernel(const T* __restrict__ values,
                                   const int32_t* __restrict__ ids,
                                   float* __restrict__ out, int64_t n,
                                   int64_t d, int64_t p) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * d) return;
  int64_t row = i / d;
  int64_t col = i - row * d;
  int32_t id = ids[row];
  if (id < 0 || id >= p) return;
  atomicAdd(out + (int64_t)id * d + col, to_float(values[i]));
}

template <typename T>
static int launch(const void* values, const void* ids, void* out, int64_t n,
                  int64_t d, int64_t p, int blocks, int threads, void* stream) {
  if (n * d > 0) {
    seg_combine_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)values, (const int32_t*)ids, (float*)out, n, d, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int seg_combine_f32(const void* values, const void* ids, void* out,
                               int64_t n, int64_t d, int64_t p, int blocks,
                               int threads, void* stream) {
  return launch<float>(values, ids, out, n, d, p, blocks, threads, stream);
}

extern "C" int seg_combine_bf16(const void* values, const void* ids, void* out,
                                int64_t n, int64_t d, int64_t p, int blocks,
                                int threads, void* stream) {
  return launch<__nv_bfloat16>(values, ids, out, n, d, p, blocks, threads,
                               stream);
}
