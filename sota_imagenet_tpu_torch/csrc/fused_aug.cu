// Fused train-augment kernel for Hopper (sm_90a), bound to Python with ctypes
// (sota_imagenet_tpu_torch/ops/fused_aug.py).
//
// Replaces sota_imagenet_tpu/ops/pallas_aug.py::pallas_augment (kernel body
// _make_kernel). Per image, on (B, H, W, 3) uint8 NHWC pixels:
//   colour twist  one per-image 3x3 YIQ matrix + offset, then round half to
//                 even and clip to [0, 255] (DALI's uint8 staging);
//   grayscale     YIQ luma under a per-image flag, rounded the same way;
//   erase         up to re_count boxes (anchor/shape in [0, 1] image units,
//                 pixel-centre-free membership y/h >= ay ...) filled with 128;
//   normalise     (x - 127.5) * f32(1/51), stored as bf16 (or f32).
// Each stage is compiled in or out by its switch (prob > 0), exactly as the
// Pallas kernel specialises on its static arguments. The per-image scalars
// are the (B, 12 + 4*re_count) f32 rows of draw_augment_scalars:
// m00..m22, offset, apply_gray, apply_re, then (ay, ax, sy, sx) per box.
//
// What bounds it: memory. At B=256, 224x224 it reads 38.5 MB of uint8 and
// writes 77.1 MB of bf16, 115.6 MB in all, so it takes at least ~34.5 us at
// the H100's 3.35 TB/s; its ~40 flops per pixel are far below the card's rate.
//
// Design (first version: simple and right): one thread handles kPix
// consecutive pixels of one image; grid.y is the image. The block reads its
// image's scalars into shared memory itself (no scalar prefetch). Pixels are
// read as NHWC uint8 and written as NHWC bf16 directly, with plain coalesced
// 4-byte loads and 8/16-byte stores when H*W is a multiple of kPix (the
// 224x224 main path), and element by element otherwise. None of the Pallas
// kernel's Mosaic workarounds (planar (3*rows, 128) layout, bf16-fed pixels,
// 8-row padding) has a counterpart here. Folding the mirror that follows this
// kernel into the store index is later work.
//
// Arithmetic follows the Pallas body operation by operation, so the kernel
// agrees bit for bit with its plain PyTorch version: every product and sum is
// an explicitly rounded __fmul_rn / __fadd_rn (nvcc would otherwise contract
// a*b+c into an FMA), rounding is rintf (half to even), the erase coordinates
// are (lin % w) * f32(1/w) as in the Pallas body, and the bf16 store is
// __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBaseScalars = 12;  // m00..m22, offset, apply_gray, apply_re
constexpr int kMaxBoxes = 16;
constexpr int kMaxScalars = kBaseScalars + 4 * kMaxBoxes;
constexpr int kPix = 4;  // pixels per thread: 12 input bytes, 12 outputs
constexpr int kThreads = 256;

struct Params {
  int hw;  // pixels per image
  int w;
  int n_scalars;
  int color, gray, erase, re_count;
  float inv_w, inv_h, inv_std;
};

__device__ __forceinline__ float u8_round(float v) { return fminf(fmaxf(rintf(v), 0.0f), 255.0f); }

// (a*x + b*y) + c*z with every operation rounded, as the Pallas body's
// m0*r + m1*g + m2*b evaluates it.
__device__ __forceinline__ float dot3(float a, float b, float c, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), __fmul_rn(c, z));
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void augment_pixel(const float* s, const Params& p, int lin, float& r, float& g,
                                              float& b) {
  if (p.color) {
    const float rt = __fadd_rn(dot3(s[0], s[1], s[2], r, g, b), s[9]);
    const float gt = __fadd_rn(dot3(s[3], s[4], s[5], r, g, b), s[9]);
    const float bt = __fadd_rn(dot3(s[6], s[7], s[8], r, g, b), s[9]);
    r = u8_round(rt);
    g = u8_round(gt);
    b = u8_round(bt);
  }
  if (p.gray && s[10] != 0.0f) {
    const float luma = u8_round(dot3(0.299f, 0.587f, 0.114f, r, g, b));
    r = luma;
    g = luma;
    b = luma;
  }
  if (p.erase && s[11] != 0.0f) {
    const float px = __fmul_rn(static_cast<float>(lin % p.w), p.inv_w);
    const float py = __fmul_rn(static_cast<float>(lin / p.w), p.inv_h);
    bool inside = false;
    for (int k = 0; k < p.re_count; ++k) {
      const float* box = s + kBaseScalars + 4 * k;  // ay, ax, sy, sx
      inside |= (py >= box[0]) && (py < __fadd_rn(box[0], box[2])) && (px >= box[1]) &&
                (px < __fadd_rn(box[1], box[3]));
    }
    if (inside) {
      r = 128.0f;
      g = 128.0f;
      b = 128.0f;
    }
  }
}

__device__ __forceinline__ float normalise(float v, float inv_std) { return __fmul_rn(__fadd_rn(v, -127.5f), inv_std); }

// Four consecutive outputs as one aligned 16-byte (f32) or 8-byte (bf16) store.
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// kVec: H*W % kPix == 0 and the pointers are aligned, so a thread's 12 input
// bytes are three aligned 4-byte words and its 12 outputs three aligned
// 8-byte (bf16) or 16-byte (f32) vectors.
template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_aug_kernel(const uint8_t* __restrict__ img, const float* __restrict__ scalars, OutT* __restrict__ out,
                     Params p) {
  __shared__ float s[kMaxScalars];
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < p.n_scalars; k += blockDim.x) s[k] = scalars[static_cast<size_t>(b) * p.n_scalars + k];
  __syncthreads();

  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * kPix;
  if (p0 >= p.hw) return;
  const int n = min(kPix, p.hw - p0);
  const size_t base = (static_cast<size_t>(b) * p.hw + p0) * 3;

  float v[3 * kPix];
  if (kVec) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(img + base);
    const uint32_t words[3] = {src[0], src[1], src[2]};
#pragma unroll
    for (int i = 0; i < 3 * kPix; ++i) v[i] = static_cast<float>((words[i / 4] >> (8 * (i % 4))) & 0xffu);
  } else {
#pragma unroll
    for (int i = 0; i < 3 * kPix; ++i) v[i] = i < 3 * n ? static_cast<float>(img[base + i]) : 0.0f;
  }

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (j < n) augment_pixel(s, p, p0 + j, v[3 * j], v[3 * j + 1], v[3 * j + 2]);
  }

  if (kVec) {
#pragma unroll
    for (int i = 0; i < 3 * kPix; ++i) v[i] = normalise(v[i], p.inv_std);
    store4(out + base, v);
    store4(out + base + 4, v + 4);
    store4(out + base + 8, v + 8);
  } else {
#pragma unroll
    for (int i = 0; i < 3 * kPix; ++i) {
      if (i < 3 * n) out[base + i] = to_out<OutT>(normalise(v[i], p.inv_std));
    }
  }
}

template <typename OutT>
void launch(const uint8_t* img, const float* scalars, OutT* out, int batch, const Params& p, cudaStream_t stream) {
  const int threads_needed = (p.hw + kPix - 1) / kPix;
  const dim3 grid((threads_needed + kThreads - 1) / kThreads, batch);
  const bool vec = p.hw % kPix == 0 && reinterpret_cast<uintptr_t>(img) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    fused_aug_kernel<OutT, true><<<grid, kThreads, 0, stream>>>(img, scalars, out, p);
  } else {
    fused_aug_kernel<OutT, false><<<grid, kThreads, 0, stream>>>(img, scalars, out, p);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). All pointers are
// device pointers of contiguous tensors; the caller checks shapes and types.
extern "C" int fused_aug_launch(const void* img, const void* scalars, void* out, int out_is_bf16, int batch, int h,
                                int w, int n_scalars, int color, int gray, int erase, int re_count, float inv_w,
                                float inv_h, float inv_std, void* stream) {
  if (batch < 0 || batch > 65535 || h <= 0 || w <= 0 || re_count < 0 || re_count > kMaxBoxes ||
      n_scalars != kBaseScalars + 4 * re_count) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const Params p{h * w, w, n_scalars, color, gray, erase, re_count, inv_w, inv_h, inv_std};
  const auto* src = static_cast<const uint8_t*>(img);
  const auto* sc = static_cast<const float*>(scalars);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16) {
    launch(src, sc, static_cast<__nv_bfloat16*>(out), batch, p, s);
  } else {
    launch(src, sc, static_cast<float*>(out), batch, p, s);
  }
  return static_cast<int>(cudaGetLastError());
}
