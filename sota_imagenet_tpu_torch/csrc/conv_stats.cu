// Fused 1x1-conv (matmul) + BatchNorm-statistics kernel for Hopper (sm_90a),
// bound to Python with ctypes (sota_imagenet_tpu_torch/ops/conv_stats.py).
//
// Replaces sota_imagenet_tpu/ops/pallas_conv_stats.py::conv1x1_stats (kernel
// body _kernel, launched by _conv1x1_stats_fwd_impl). Computes, for bf16
// x (M, K) and bf16 w (N, K), both K-contiguous (w is the OIHW weight of the
// 1x1 conv, squeezed, so no transpose is copied per step):
//   y = x @ w^T        bf16 tensor-core products, f32 accumulation, rounded
//                      once to bf16 (__float2bfloat16_rn) and stored (M, N);
//   per-column sums    sum of y and of y^2 over the bf16-ROUNDED y, in f32,
//                      one row of partials per 128-row tile: (tiles_m, N) f32
//                      each. The wrapper reduces them with torch.sum, as the
//                      Pallas wrapper sums its partials outside the kernel, so
//                      the result is the same from run to run (no atomics).
//
// What bounds it: at ResNet-50's shapes (K and N of 64..2048, M of 12,544..
// 802,816 at batch 256, 224 px) memory. It must read x and w and write y:
// 2(MK + KN + MN) bytes, against 2MKN operations. At the largest shape
// (M=802816, K=64, N=256) that is 0.54 GB (161 us at 3.35 TB/s) against 26
// GFLOP (27 us at 989 TFLOP/s); summed over the 36 launches of a train step
// the bound is 2.60 ms, of which the bytes decide most. The point of fusing
// the statistics is that y is not read back from memory for BatchNorm.
//
// Design (first version: simple and right). A block of 256 threads (8 warps,
// 2 along M by 4 along N, each warp 64 x 32) computes a 128 x 128 tile of y,
// walking K in steps of 32 through a two-stage shared-memory ring filled by
// cp.async (16-byte copies; a row or K chunk past the edge is zero-filled).
// Operands reach the tensor cores through ldmatrix and mma.sync m16n8k16
// (bf16 in, f32 accumulators). Shared rows are padded to 80 bytes so that
// ldmatrix is free of bank conflicts. The epilogue rounds each accumulator to
// bf16, stores it (two columns per 4-byte store), and sums the rounded values
// and their squares over the tile's valid rows: per thread, then across the
// warp with shuffles, then across the two M-warps in shared memory, in a
// fixed order. Ragged M, N and K are masked; K not a multiple of 8 (or an
// unaligned operand) takes element-wise loads instead of cp.async. None of
// the Pallas kernel's Mosaic constraints carries over: no padding of M or N
// in memory, no 8-row replicated statistics blocks, no /8. wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kBM = 128;  // tile rows (M)
constexpr int kBN = 128;  // tile columns (N)
constexpr int kBK = 32;   // K step
constexpr int kThreads = 256;
constexpr int kWarpM = 64;  // 2 warps along M
constexpr int kWarpN = 32;  // 4 warps along N
constexpr int kLd = kBK + 8;  // padded shared row: 40 bf16 = 80 bytes
constexpr int kStages = 2;

struct __align__(16) Smem {
  __nv_bfloat16 a[kStages][kBM][kLd];
  __nv_bfloat16 b[kStages][kBN][kLd];
  float red[2][2][kBN];  // [sum | sum of squares][warp row][tile column]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + 128) and K columns [k0, k0 + 32) of a (rows, K) bf16
// matrix into a padded shared tile; outside the matrix the tile holds zeros.
template <bool kAsync>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLd], const __nv_bfloat16* __restrict__ src, int rows,
                                          int K, int row0, int k0) {
  constexpr int kChunks = kBK / 8;  // 16-byte chunks per tile row
  static_assert(kBM == kBN && (kBM * kChunks) % kThreads == 0, "tile copy must split evenly over the block");
#pragma unroll
  for (int i = 0; i < kBM * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks;
    const int kc = (c % kChunks) * 8;
    const int gr = row0 + r;
    const int gk = k0 + kc;
    __nv_bfloat16* d = &dst[r][kc];
    if (kAsync) {
      // K % 8 == 0: a chunk lies wholly inside or wholly outside the matrix
      const bool valid = gr < rows && gk < K;
      cp_async16(d, valid ? src + static_cast<size_t>(gr) * K + gk : src, valid ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d[j] = (gr < rows && gk + j < K) ? src[static_cast<size_t>(gr) * K + gk + j] : __float2bfloat16_rn(0.0f);
      }
    }
  }
}

template <bool kAsync>
__global__ void __launch_bounds__(kThreads)
    conv1x1_stats_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ y, float* __restrict__ part_sum, float* __restrict__ part_sq,
                         int M, int N, int K, int tiles_n) {
  // raw bytes, so that no constructor of the bf16 type runs on shared memory
  __shared__ __align__(16) unsigned char smem_raw[sizeof(Smem)];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  // N tiles of one M tile are neighbours in launch order, so x is read once
  // from memory and the other N tiles find it in L2.
  const int tile_m = blockIdx.x / tiles_n;
  const int tile_n = blockIdx.x % tiles_n;
  const int m0 = tile_m * kBM;
  const int n0 = tile_n * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;

  float acc[4][4][4];  // [m16 tile][n8 tile][mma fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int k_tiles = (K + kBK - 1) / kBK;
  load_tile<kAsync>(sm.a[0], x, M, K, m0, 0);
  load_tile<kAsync>(sm.b[0], w, N, K, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < k_tiles) {
      load_tile<kAsync>(sm.a[st ^ 1], x, M, K, m0, (kt + 1) * kBK);
      load_tile<kAsync>(sm.b[st ^ 1], w, N, K, n0, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
      uint32_t bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // lanes 0-15: rows 0-15 at k 0-7; lanes 16-31: rows 0-15 at k 8-15
        ldmatrix_x4(af[mi], &sm.a[st][warp_m * kWarpM + mi * 16 + (lane % 16)][kk + (lane / 16) * 8]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
        const int row = warp_n * kWarpN + nj * 16 + (lane % 8) + (lane / 16) * 8;
        ldmatrix_x4(bf[nj], &sm.b[st][row][kk + ((lane / 8) % 2) * 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], af[mi], bf[ni / 2][(ni % 2) * 2], bf[ni / 2][(ni % 2) * 2 + 1]);
        }
    }
    __syncthreads();
  }

  // Epilogue. Fragment layout of m16n8: c0, c1 at (row g, cols 2t, 2t+1),
  // c2, c3 at (row g + 8, same cols), g = lane / 4, t = lane % 4.
  const int g = lane / 4;
  const int t = lane % 4;
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) s1[ni][0] = s1[ni][1] = s2[ni][0] = s2[ni][1] = 0.0f;
  const bool pairs = (N % 2) == 0;  // then (row, 2t) starts an aligned bf16 pair
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * kWarpM + mi * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + warp_n * kWarpN + ni * 8 + 2 * t;
        const __nv_bfloat16 b0 = __float2bfloat16_rn(acc[mi][ni][2 * h]);
        const __nv_bfloat16 b1 = __float2bfloat16_rn(acc[mi][ni][2 * h + 1]);
        const float v0 = __bfloat162float(b0);
        const float v1 = __bfloat162float(b1);
        __nv_bfloat16* dst = y + static_cast<size_t>(row) * N + col;
        if (col + 1 < N) {
          if (pairs) {
            __nv_bfloat162 pair;
            pair.x = b0;
            pair.y = b1;
            *reinterpret_cast<__nv_bfloat162*>(dst) = pair;
          } else {
            dst[0] = b0;
            dst[1] = b1;
          }
          s1[ni][0] += v0;
          s2[ni][0] += v0 * v0;
          s1[ni][1] += v1;
          s2[ni][1] += v1 * v1;
        } else if (col < N) {
          dst[0] = b0;
          s1[ni][0] += v0;
          s2[ni][0] += v0 * v0;
        }
      }
    }
  }
  // reduce over the 8 row groups g of the warp (lane bits 2-4)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[ni][j] += __shfl_xor_sync(0xffffffffu, s1[ni][j], off);
        s2[ni][j] += __shfl_xor_sync(0xffffffffu, s2[ni][j], off);
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = warp_n * kWarpN + ni * 8 + 2 * t + j;
        sm.red[0][warp_m][c] = s1[ni][j];
        sm.red[1][warp_m][c] = s2[ni][j];
      }
    }
  }
  __syncthreads();
  // threads 0-127 write the sums, 128-255 the sums of squares
  const int which = threadIdx.x / kBN;
  const int c = threadIdx.x % kBN;
  if (n0 + c < N) {
    float* part = which ? part_sq : part_sum;
    part[static_cast<size_t>(tile_m) * N + n0 + c] = sm.red[which][0][c] + sm.red[which][1][c];
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x (M, K), w (N, K)
// and y (M, N) are bf16, part_sum and part_sq (ceil(M / 128), N) f32, all
// device pointers of contiguous tensors; the caller checks shapes and types.
extern "C" int conv1x1_stats_launch(const void* x, const void* w, void* y, void* part_sum, void* part_sq, int M, int N,
                                    int K, void* stream) {
  if (M < 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const long long tiles_m = (M + kBM - 1) / kBM;
  const long long tiles_n = (N + kBN - 1) / kBN;
  if (tiles_m * tiles_n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles_m * tiles_n));
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* p1 = static_cast<float*>(part_sum);
  auto* p2 = static_cast<float*>(part_sq);
  auto s = static_cast<cudaStream_t>(stream);
  const bool async = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (async) {
    conv1x1_stats_kernel<true><<<grid, kThreads, 0, s>>>(xb, wb, yb, p1, p2, M, N, K, static_cast<int>(tiles_n));
  } else {
    conv1x1_stats_kernel<false><<<grid, kThreads, 0, s>>>(xb, wb, yb, p1, p2, M, N, K, static_cast<int>(tiles_n));
  }
  return static_cast<int>(cudaGetLastError());
}
