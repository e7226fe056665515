// fixture_copy for Hopper (sm_90a): out = x for a contiguous fp32 (R, C)
// tensor, one CTA per (tile_r, tile_c) tile.
//
// Replaces the TPU kernel of the static analyzer's known-bad launch fixture,
// repro/analysis/fixtures.py::_bad_pallas_probe, whose kernel is
// `o_ref[...] = x_ref[...]` over a (4, 1000) f32 array in (1, 300) blocks.
// That Pallas launch exists to be flagged: its block does not divide 1000
// and its out index map is 1-ary on a 2-d grid.  On the card the kernel
// computes its own offsets from blockIdx and masks the tensor's edge, so
// those two faults have no counterpart; the fault that remains is the grid.
// The analyzer's launch-geometry checker flags a grid cut by floor division,
// (4, 1000 // 300) = (4, 3), which never writes columns 900-999, and the
// port's fixtures launch exactly that geometry to show on the card which
// elements stay unwritten.  fixture_copy.py::launch_spec uses ceiling
// division, which covers the tensor.
//
// What bounds it: bytes.  R * C * 4 bytes are read and as many written; at
// (4, 1000) that is 32 KB, so launch cost dominates; at the large timing
// shape of chip_smoke.py, (16384, 4096), 512 MiB take 0.16 ms at 3.35 TB/s.
//
// Design: blockIdx.x is the row tile, blockIdx.y the column tile, as the
// Pallas grid (i, j).  A tile row is moved in vectors of W floats: 16-byte
// float4s (W = 4) where C and tile_c are multiples of 4 and both pointers
// are 16-byte aligned, single floats (W = 1) otherwise.  The block lies
// over the tile once: where a tile row has fewer vectors than the block has
// threads, the threads split into groups of whole rows, and each thread
// walks down the tile's rows in steps of the group count, 8 rows at a
// time: 8 loads in flight, then 8 stores.  No element pays an integer
// division.  (Streaming cache hints, 4 or 16 rows at a time, and blocks of
// 128 or 512 threads were no faster on an H100.)
// The tile is clipped to the tensor once per thread (rows below R, whole
// vectors left of C), so a grid that reaches past the tensor writes
// nothing out of bounds and one that falls short leaves its elements as
// they were.
//
// Plain C interface for ctypes: the function launches on the given stream
// with the grid and block it is given, writes the path it took to `*path`
// (1 vector, 0 scalar; fixture_copy.py::route states the same choice), does
// not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 8;                  // rows a thread loads before storing

template <int W> struct Vec;
template <> struct Vec<4> { using type = float4; };
template <> struct Vec<1> { using type = float; };

template <int W>
__global__ void fixture_copy_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int64_t R,
                                    int64_t C, int tile_r, int tile_c) {
  using V = typename Vec<W>::type;
  const int64_t r0 = (int64_t)blockIdx.x * tile_r;
  const int64_t c0 = (int64_t)blockIdx.y * tile_c;
  const int per_row = tile_c / W;          // vectors in one tile row
  int col = threadIdx.x, col_step = blockDim.x, row = 0, row_step = 1;
  if (per_row < (int)blockDim.x) {
    row_step = blockDim.x / per_row;
    col = threadIdx.x % per_row;
    col_step = per_row;
    row = threadIdx.x / per_row;
    if (row >= row_step) return;           // past the last whole group
  }
  // the tile clipped to the tensor: rows below R, whole vectors left of C
  const int64_t rows = min((int64_t)tile_r, R - r0);
  const int64_t cols = min((int64_t)per_row, (C - c0) / W);
  const int64_t ld = C / W;                // a tensor row, in vectors
  const V* src = reinterpret_cast<const V*>(x + r0 * C + c0);
  V* dst = reinterpret_cast<V*>(out + r0 * C + c0);
  for (int64_t c = col; c < cols; c += col_step) {
    for (int64_t r = row; r < rows; r += kBatch * row_step) {
      V buf[kBatch];                       // kBatch loads in flight, then stores
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int64_t rk = r + k * row_step;
        if (rk < rows) buf[k] = src[rk * ld + c];
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int64_t rk = r + k * row_step;
        if (rk < rows) dst[rk * ld + c] = buf[k];
      }
    }
  }
}

}  // namespace

extern "C" int fixture_copy_f32(const void* x, void* out, int64_t R,
                                int64_t C, int tile_r, int tile_c, int grid_x,
                                int grid_y, int threads, int* path,
                                void* stream) {
  const bool vec = C % 4 == 0 && tile_c % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  *path = vec ? 1 : 0;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y, 1);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    fixture_copy_kernel<4><<<grid, threads, 0, s>>>(
        (const float*)x, (float*)out, R, C, tile_r, tile_c);
  else
    fixture_copy_kernel<1><<<grid, threads, 0, s>>>(
        (const float*)x, (float*)out, R, C, tile_r, tile_c);
  return (int)cudaGetLastError();
}
