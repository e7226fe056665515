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
// Pallas grid (i, j).  The block's threads walk the tile's elements in
// row-major order, so consecutive threads touch consecutive columns and a
// warp reads and writes 128 contiguous bytes wherever tile_c >= 32.  Each
// element is guarded against the tensor's edge (r < R, c < C), so a grid
// that reaches past the tensor writes nothing out of bounds.  Plain scalar
// loads: this is a first, simple kernel.
//
// Plain C interface for ctypes: the function launches on the given stream
// with the grid and block it is given, does not synchronise and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void fixture_copy_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int64_t R,
                                    int64_t C, int tile_r, int tile_c) {
  const int64_t r0 = (int64_t)blockIdx.x * tile_r;
  const int64_t c0 = (int64_t)blockIdx.y * tile_c;
  const int n = tile_r * tile_c;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int64_t r = r0 + e / tile_c;
    const int64_t c = c0 + e % tile_c;
    if (r < R && c < C) out[r * C + c] = x[r * C + c];
  }
}

extern "C" int fixture_copy_f32(const void* x, void* out, int64_t R,
                                int64_t C, int tile_r, int tile_c, int grid_x,
                                int grid_y, int threads, void* stream) {
  dim3 grid((unsigned)grid_x, (unsigned)grid_y, 1);
  fixture_copy_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, R, C, tile_r, tile_c);
  return (int)cudaGetLastError();
}
