// Per-channel moments kernel for Hopper (sm_90a), bound to Python with ctypes
// (sota_imagenet_tpu_torch/ops/moments.py).
//
// Replaces sota_imagenet_tpu/ops/pallas_norm.py::moments (kernel body
// _moments_kernel, launched by _moments_impl). For a row-major (R, C) tensor
// of bf16 or f32 values (the (..., C) input flattened over its leading axes)
// it sums x and x^2 per channel in f32. Each block writes one row of partial
// sums for its chunk of rows, (chunks, C) f32 each; the wrapper reduces them
// with torch.sum and forms mean = S1 / R and var = max(S2 / R - mean^2, 0) as
// the Pallas wrapper does. No atomics, so the result is the same from run to
// run.
//
// What bounds it: memory. It reads each element once and writes 2 * chunks * C
// floats; at (256, 112, 112, 64) bf16 that is 411 MB, at least 123 us at the
// H100's 3.35 TB/s, against 3 operations per element.
//
// Design (first version: simple and right): a block is 32 channels by 8 row
// lanes. Each thread owns one channel and walks its row lane through the
// block's chunk of rows, so a warp reads 32 neighbouring channels of a row
// (coalesced) and keeps two f32 sums in registers; the loop bound masks the
// ragged tail, where the Pallas kernel padded the input and masked with an
// iota. The 8 row lanes are then summed in shared memory in a fixed order.
// The Pallas kernel's sequential accumulation into one output block across
// the grid has no counterpart: blocks run in parallel, so the cross-chunk
// reduction is the wrapper's torch.sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // channels per block (one warp wide)
constexpr int kLanes = 8;  // row lanes per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kCols* kLanes)
    moments_kernel(const T* __restrict__ x, float* __restrict__ part_sum, float* __restrict__ part_sq, long long rows,
                   int C, long long chunk_rows) {
  __shared__ float red[2][kLanes][kCols];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int lane = threadIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk_rows;
  const long long r1 = min(rows, r0 + chunk_rows);
  float s1 = 0.0f;
  float s2 = 0.0f;
  if (col < C) {
#pragma unroll 4
    for (long long r = r0 + lane; r < r1; r += kLanes) {
      const float v = to_f32(x[r * C + col]);
      s1 += v;
      s2 += v * v;
    }
  }
  red[0][lane][threadIdx.x] = s1;
  red[1][lane][threadIdx.x] = s2;
  __syncthreads();
  if (lane < 2 && col < C) {
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s += red[lane][l][threadIdx.x];
    float* part = lane ? part_sq : part_sum;
    part[static_cast<size_t>(blockIdx.y) * C + col] = s;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x is a contiguous
// (rows, C) device tensor, bf16 when x_is_bf16 else f32; part_sum and part_sq
// are (chunks, C) f32 with chunks * chunk_rows >= rows.
extern "C" int moments_launch(const void* x, int x_is_bf16, void* part_sum, void* part_sq, long long rows, int C,
                              int chunks, long long chunk_rows, void* stream) {
  if (rows < 0 || C <= 0 || chunks <= 0 || chunks > 65535 || chunk_rows <= 0 ||
      static_cast<long long>(chunks) * chunk_rows < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((C + kCols - 1) / kCols, chunks);
  const dim3 block(kCols, kLanes);
  auto* p1 = static_cast<float*>(part_sum);
  auto* p2 = static_cast<float*>(part_sq);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    moments_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(xb, p1, p2, rows, C, chunk_rows);
  } else {
    moments_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(x), p1, p2, rows, C, chunk_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
