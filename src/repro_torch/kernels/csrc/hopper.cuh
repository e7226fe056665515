// What the port's kernels share of Hopper (sm_90a) and of the CUDA runtime:
// the PTX wrappers and the host helpers that more than one source in csrc/
// needs.  A helper that only one source uses stays in that source.
//
// Every definition sits in an anonymous namespace: each source is built
// into a library of its own (kernels/_build.py), and the build's hash
// covers this header, so an edit here builds every kernel anew.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp
constexpr int kMaxDevices = 64;          // cards whose shared-memory limit is tracked

// ---------------------------------------------------------------- device

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

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase with the given parity has completed.  (No
// __trap() on a timeout here: a trap path makes ptxas drop the consumers'
// setmaxnreg budget, and flash_attention_wgmma.cu then spills at hd 256.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box global -> shared at coordinates (c0, c1, c2) of the map,
// completion counted in bytes on bar's transactions.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// tma_load_3d with an L2 cache hint: policy (createpolicy) says how long the
// lines it brings stay in L2.
__device__ __forceinline__ void tma_load_3d_cache_hint(uint32_t dst, const CUtensorMap* map,
                                                       uint32_t bar, int c0, int c1, int c2,
                                                       uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "l"(policy)
      : "memory");
}

// four 8 x 8 b16 matrices from shared memory; lane i addresses a row of
// matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// two floats rounded to nearest bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 values as they are, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// v reduced by op over each aligned run of Lanes lanes (a power of two) by
// xor shuffles, every lane of the run left with the result.  The offsets
// run Lanes / 2 down to 1, or with Ascending 1 up to Lanes / 2: a sum's
// rounding depends on that order, so each caller keeps its own.
template <int Lanes, bool Ascending = false, typename Op>
__device__ __forceinline__ float xor_reduce(float v, Op op) {
  if constexpr (Ascending) {
#pragma unroll
    for (int o = 1; o < Lanes; o <<= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  } else {
#pragma unroll
    for (int o = Lanes / 2; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;
}

// ------------------------------------------------------------------ host

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Raise kernel's dynamic shared-memory limit to bytes on the current device:
// once per device and kernel, and again only when a launch needs more than
// was set, so never while a CUDA graph is being captured after a first call.
// Returns a CUDA error code.
int set_smem_limit(const void* kernel, int bytes) {
  static std::mutex mutex;
  static std::map<const void*, int> set[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mutex);
  int& now = set[device][kernel];
  if (now < bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    now = bytes;
  }
  return (int)cudaSuccess;
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point so
// that a library needs no -lcuda; null where the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
