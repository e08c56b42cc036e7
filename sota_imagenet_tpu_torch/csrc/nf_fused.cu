// The elementwise chains of the ECA-NFNet block (models/nfnet.py), forward and
// backward, for Hopper (sm_90a), bound to Python with ctypes
// (sota_imagenet_tpu_torch/ops/nf_fused.py, which holds the plain version of
// every kernel here and the hand-derived backward they follow).
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA, which
// fuses them into the neighbouring convolutions' loops. Op by op in eager
// PyTorch each link (bias, SiLU, x gamma, x beta, ECA's float32 copy and mean,
// x gate, x attn_gain, drop-path's divide and select, x skipinit_gain, x alpha,
// + shortcut, and each one's backward) is a pass over the whole bf16
// activation; these kernels make each chain one pass in each direction.
//
//   nf_act_fwd    y = s * silu(x + b)                          (every SiLU site)
//   nf_act_bwd    dx = dy * s * silu'(x + b), per-block partial sums of dx for db
//   nf_colsum     the column sums of a (rows, n) float32 array: the second stage
//                 of every gradient that sums over rows (db, the ECA taps, the gain)
//   nf_tail_mean  m[b, c] = mean_hw(h + b_c) in float32        (ECA's pooled vector)
//   nf_tail_fwd   out = shortcut + k_b * g[b, c] * (h + b_c), or exactly shortcut
//                 where the sample was dropped; g = sigmoid(conv1d_3(m)) in the prologue
//   nf_tail_sums  P[b, c] = sum_hw dy * (h + b_c), D[b, c] = sum_hw dy
//   nf_tail_gate_bwd  on (B, C): the gate's backward (dg, the taps' gradient,
//                 conv1d^T), the bias's and the gain's per-sample terms
//   nf_tail_bwd   dh = dy * k_b * g[b, c] + dm[b, c] / HW
//   nf_ws_fwd     the scaled weight standardisation (ScaledStdConv's
//                 standardized_weight, cast to bf16) of a group of convs' weights
//                 (a block's), one block an output channel
//   nf_ws_bwd     its backward: the weights' and the gains' gradients
//
// k_b = alpha * skipinit_gain * attn_gain * mask_b / keep_prob, the product of
// the float32 constant k = alpha * attn_gain / keep_prob and the gain, read on
// the device. No kernel name holds a fragment the benchmark files under
// conv/matmul (port_bench/harness.py KERNEL_GROUPS).
//
// The weight standardisation is small work (the weights, not the
// activations) in many small ops: op by op it is ~8 launches a conv forward
// and ~19 backward, most of the host's launches in an NFNet step; here a
// block's convs take one launch each way.
//
// What bounds the activation kernels: memory. Every one does a few flops a
// byte. Layout: the activations are channels-last bf16, (rows, C) with rows =
// B*H*W and sample b's rows [b*HW, (b+1)*HW). A thread owns one 8-channel
// vector (a 16-byte load) of its block's channel tile and walks rows, kUnroll
// loads in flight, so its per-channel operands (bias, gate) stay in registers;
// blockDim is (tx, 256 / tx) with tx the vectors of the tile, a power of two
// dividing C / 8 (the wrapper picks it), so a warp reads whole 16-byte runs of
// rows. Reductions over rows (ECA's mean, P and D) take one block per (sample,
// channel tile) and reduce across threadIdx.y in shared memory; reductions over
// samples or over all rows (the bias's gradient) write per-block partials that
// nf_colsum sums in a fixed order, so a seeded run repeats (no float atomics).
// Inside, everything is float32, with one rounding at each bf16 output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;  // bf16 channels per 16-byte load
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kSumRows = 32;  // nf_colsum's blockDim.y

__device__ __forceinline__ void load8(const bf16* __restrict__ p, float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* __restrict__ p, const float (&v)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 8 float32 values from p (16-byte aligned), or zeros where p is null.
__device__ __forceinline__ void load_f8(const float* __restrict__ p, float (&v)[kVec]) {
  if (p == nullptr) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = 0.0f;
    return;
  }
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The fast exponential and reciprocal (two special-function instructions, a
// few float32 ulps): with an IEEE division the act kernels run enough
// instructions a byte to fall to ~60% of the bandwidth bound. 1 / inf is 0.
__device__ __forceinline__ float sigmoid(float z) { return __fdividef(1.0f, 1.0f + __expf(-z)); }

__device__ __forceinline__ bool dropped(const uint8_t* mask, int b) { return mask != nullptr && mask[b] == 0; }

// The sum over threadIdx.y of every thread's acc, for the block's tile of
// blockDim.x * kVec channels: thread t < that width gets channel t's sum.
// red holds kThreads * kVec floats.
__device__ __forceinline__ float sum_over_y(float* red, const float (&acc)[kVec]) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kVec; ++i) red[t * kVec + i] = acc[i];
  __syncthreads();
  float s = 0.0f;
  if (t < blockDim.x * kVec) {
    for (int y = 0; y < blockDim.y; ++y) s += red[y * blockDim.x * kVec + t];
  }
  return s;
}

// ---------------------------------------------------------------- nf_act ---

__global__ void __launch_bounds__(kThreads) nf_act_fwd(const bf16* __restrict__ x, const float* __restrict__ bias,
                                                        bf16* __restrict__ y, long long rows, int c, int chunk_rows,
                                                        float scale) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  float b[kVec];
  load_f8(bias == nullptr ? nullptr : bias + col, b);
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk_rows;
  const long long r1 = min(rows, r0 + chunk_rows);
  const long long step = blockDim.y;
  for (long long r = r0 + threadIdx.y; r < r1; r += step * kUnroll) {
    float t[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < r1) load8(x + (r + u * step) * c + col, t[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < r1) {
        float o[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float z = t[u][i] + b[i];
          o[i] = scale * (z * sigmoid(z));
        }
        store8(y + (r + u * step) * c + col, o);
      }
    }
  }
}

// partial: (gridDim.y, c) float32, the sums of dx over each block's rows; null
// where the site has no bias.
__global__ void __launch_bounds__(kThreads) nf_act_bwd(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                                                        const float* __restrict__ bias, bf16* __restrict__ dx,
                                                        float* __restrict__ partial, long long rows, int c,
                                                        int chunk_rows, float scale) {
  __shared__ float red[kThreads * kVec];
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  float b[kVec], acc[kVec];
  load_f8(bias == nullptr ? nullptr : bias + col, b);
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk_rows;
  const long long r1 = min(rows, r0 + chunk_rows);
  const long long step = blockDim.y;
  for (long long r = r0 + threadIdx.y; r < r1; r += step * kUnroll) {
    float g[kUnroll][kVec], t[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < r1) {
        load8(dy + (r + u * step) * c + col, g[u]);
        load8(x + (r + u * step) * c + col, t[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < r1) {
        float o[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float z = t[u][i] + b[i];
          const float s = sigmoid(z);
          o[i] = g[u][i] * scale * (s * (1.0f + z * (1.0f - s)));
          acc[i] += o[i];
        }
        store8(dx + (r + u * step) * c + col, o);
      }
    }
  }
  if (partial == nullptr) return;  // uniform over the block
  const float s = sum_over_y(red, acc);
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (t < blockDim.x * kVec) partial[static_cast<long long>(blockIdx.y) * c + blockIdx.x * blockDim.x * kVec + t] = s;
}

// out[j] = sum over r of partial[r, j], r in order: blockDim (32, kSumRows).
__global__ void nf_colsum(const float* __restrict__ partial, float* __restrict__ out, int rows, int n) {
  __shared__ float red[kSumRows][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (j < n) {
#pragma unroll 8
    for (int r = threadIdx.y; r < rows; r += kSumRows) s += partial[static_cast<long long>(r) * n + j];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    float t = 0.0f;
    for (int y = 0; y < kSumRows; ++y) t += red[y][threadIdx.x];
    out[j] = t;
  }
}

// --------------------------------------------------------------- nf_tail ---

// k_b * g[b, ch]: the gate from the pooled vector m (null without ECA; the
// 3 taps w zero-padded at the channel edges), times k and the gain.
__device__ __forceinline__ float gate_scale(const float* __restrict__ m, const float* __restrict__ w, float kb, int b,
                                            int ch, int c) {
  if (m == nullptr) return kb;
  const float* row = m + static_cast<long long>(b) * c;
  float logit = w[1] * row[ch];
  if (ch > 0) logit += w[0] * row[ch - 1];
  if (ch + 1 < c) logit += w[2] * row[ch + 1];
  return kb * sigmoid(logit);
}

// grid (C / (8 blockDim.x), B): m[b, c] = sum_hw h / HW + bias[c]; 0 for a dropped sample.
__global__ void __launch_bounds__(kThreads) nf_tail_mean(const bf16* __restrict__ h, const float* __restrict__ bias,
                                                          const uint8_t* __restrict__ mask, float* __restrict__ m,
                                                          int hw, int c, float inv_hw) {
  __shared__ float red[kThreads * kVec];
  const int b = blockIdx.y;
  const int width = blockDim.x * kVec;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  float* out = m + static_cast<long long>(b) * c + blockIdx.x * width;
  if (dropped(mask, b)) {
    if (t < width) out[t] = 0.0f;
    return;
  }
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const bf16* base = h + static_cast<long long>(b) * hw * c + col;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
  for (int r = threadIdx.y; r < hw; r += blockDim.y * kUnroll) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * static_cast<int>(blockDim.y) < hw) load8(base + static_cast<long long>(r + u * blockDim.y) * c, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * static_cast<int>(blockDim.y) < hw) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] += v[u][i];
      }
    }
  }
  const float s = sum_over_y(red, acc);
  if (t < width) out[t] = s * inv_hw + (bias == nullptr ? 0.0f : bias[blockIdx.x * width + t]);
}

// grid (C / (8 blockDim.x), chunks of HW, B).
__global__ void __launch_bounds__(kThreads) nf_tail_fwd(const bf16* __restrict__ h, const float* __restrict__ bias,
                                                         const bf16* __restrict__ sc, const float* __restrict__ m,
                                                         const float* __restrict__ w, const float* __restrict__ gain,
                                                         const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                                                         int hw, int c, int chunk_rows, float k) {
  __shared__ float gk[kThreads];
  const int b = blockIdx.z;
  const int width = blockDim.x * kVec;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const int lo = blockIdx.y * chunk_rows;
  const int hi = min(hw, lo + chunk_rows);
  const long long base = static_cast<long long>(b) * hw;
  if (dropped(mask, b)) {  // exactly the shortcut, whatever the branch holds
    for (int r = lo + threadIdx.y; r < hi; r += blockDim.y) {
      const long long off = (base + r) * c + col;
      *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(sc + off);
    }
    return;
  }
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (t < width) gk[t] = gate_scale(m, w, gain == nullptr ? k : k * gain[0], b, blockIdx.x * width + t, c);
  __syncthreads();
  float g[kVec], bb[kVec];
  load_f8(bias == nullptr ? nullptr : bias + col, bb);
#pragma unroll
  for (int i = 0; i < kVec; ++i) g[i] = gk[threadIdx.x * kVec + i];
  const int step = blockDim.y;
  for (int r = lo + threadIdx.y; r < hi; r += step * kUnroll) {
    float x[kUnroll][kVec], s[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < hi) {
        const long long off = (base + r + u * step) * c + col;
        load8(h + off, x[u]);
        load8(sc + off, s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < hi) {
        float o[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) o[i] = s[u][i] + g[i] * (x[u][i] + bb[i]);
        store8(out + (base + r + u * step) * c + col, o);
      }
    }
  }
}

// grid (C / (8 blockDim.x), B): P[b, c] = sum_hw dy (h + bias), D[b, c] = sum_hw dy; 0 for a dropped sample.
__global__ void __launch_bounds__(kThreads) nf_tail_sums(const bf16* __restrict__ dy, const bf16* __restrict__ h,
                                                          const float* __restrict__ bias,
                                                          const uint8_t* __restrict__ mask, float* __restrict__ p,
                                                          float* __restrict__ d, int hw, int c) {
  __shared__ float red[kThreads * kVec];
  const int b = blockIdx.y;
  const int width = blockDim.x * kVec;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const long long out = static_cast<long long>(b) * c + blockIdx.x * width;
  if (dropped(mask, b)) {
    if (t < width) p[out + t] = d[out + t] = 0.0f;
    return;
  }
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const long long base = static_cast<long long>(b) * hw * c + col;
  float bb[kVec], ap[kVec], ad[kVec];
  load_f8(bias == nullptr ? nullptr : bias + col, bb);
#pragma unroll
  for (int i = 0; i < kVec; ++i) ap[i] = ad[i] = 0.0f;
  const int step = blockDim.y;
  for (int r = threadIdx.y; r < hw; r += step * kUnroll) {
    float g[kUnroll][kVec], x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < hw) {
        const long long off = base + static_cast<long long>(r + u * step) * c;
        load8(dy + off, g[u]);
        load8(h + off, x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < hw) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          ap[i] += g[u][i] * (x[u][i] + bb[i]);
          ad[i] += g[u][i];
        }
      }
    }
  }
  const float sp = sum_over_y(red, ap);
  __syncthreads();  // red is read again below
  const float sd = sum_over_y(red, ad);
  if (t < width) {
    p[out + t] = sp;
    d[out + t] = sd;
  }
}

__device__ __forceinline__ float block_sum(float v, float* red32) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red32 may still be read by an earlier call
  if (lane == 0) red32[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i) s += red32[i];
  }
  return s;
}

// grid B, blockDim kThreads, dynamic shared memory 2 * C floats. For sample b:
//   gk[b, c] = k_b g, ds[b, c] = dm / HW, with dg = k_b P, dl = dg g (1 - g) and
//   dm = conv1d^T(dl) (ECA; else g = 1 and dm = 0), and row b of terms (B, C + 4):
//   [k_b g D + dm (the bias's), sum dl m[c-1], sum dl m[c], sum dl m[c+1] (the taps'),
//    k sum g P (the gain's: dk_b/dgain = k, no division by the gain)]; zeros for a dropped sample.
__global__ void __launch_bounds__(kThreads) nf_tail_gate_bwd(const float* __restrict__ p, const float* __restrict__ d,
                                                              const float* __restrict__ m, const float* __restrict__ w,
                                                              const float* __restrict__ gain,
                                                              const uint8_t* __restrict__ mask,
                                                              float* __restrict__ gk, float* __restrict__ ds,
                                                              float* __restrict__ terms, int c, float inv_hw,
                                                              float k) {
  extern __shared__ float sm[];
  __shared__ float red32[kThreads / 32];
  float* g_s = sm;
  float* dl_s = sm + c;
  const int b = blockIdx.x;
  const long long row = static_cast<long long>(b) * c;
  float* term = terms + static_cast<long long>(b) * (c + 4);
  if (dropped(mask, b)) {
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) gk[row + ch] = ds[row + ch] = term[ch] = 0.0f;
    if (threadIdx.x < 4) term[c + threadIdx.x] = 0.0f;
    return;
  }
  const float kb = gain == nullptr ? k : k * gain[0];
  float s_gp = 0.0f, s_w0 = 0.0f, s_w1 = 0.0f, s_w2 = 0.0f;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float pc = p[row + ch];
    float g = 1.0f, dl = 0.0f;
    if (m != nullptr) {
      const float mc = m[row + ch];
      const float ml = ch > 0 ? m[row + ch - 1] : 0.0f;
      const float mr = ch + 1 < c ? m[row + ch + 1] : 0.0f;
      g = sigmoid(w[0] * ml + w[1] * mc + w[2] * mr);
      dl = kb * pc * (g * (1.0f - g));
      s_w0 += dl * ml;
      s_w1 += dl * mc;
      s_w2 += dl * mr;
    }
    g_s[ch] = g;
    dl_s[ch] = dl;
    s_gp += g * pc;
    gk[row + ch] = kb * g;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float dm = 0.0f;
    if (m != nullptr) {
      dm = w[1] * dl_s[ch];
      if (ch + 1 < c) dm += w[0] * dl_s[ch + 1];
      if (ch > 0) dm += w[2] * dl_s[ch - 1];
    }
    ds[row + ch] = dm * inv_hw;
    term[ch] = kb * g_s[ch] * d[row + ch] + dm;
  }
  s_gp = block_sum(s_gp, red32);
  s_w0 = block_sum(s_w0, red32);
  s_w1 = block_sum(s_w1, red32);
  s_w2 = block_sum(s_w2, red32);
  if (threadIdx.x == 0) {
    term[c] = s_w0;
    term[c + 1] = s_w1;
    term[c + 2] = s_w2;
    term[c + 3] = k * s_gp;
  }
}

// grid (C / (8 blockDim.x), chunks of HW, B): dh = dy gk + ds; 0 for a dropped sample.
__global__ void __launch_bounds__(kThreads) nf_tail_bwd(const bf16* __restrict__ dy, const float* __restrict__ gk,
                                                         const float* __restrict__ ds,
                                                         const uint8_t* __restrict__ mask, bf16* __restrict__ dh,
                                                         int hw, int c, int chunk_rows) {
  const int b = blockIdx.z;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const int lo = blockIdx.y * chunk_rows;
  const int hi = min(hw, lo + chunk_rows);
  const long long base = static_cast<long long>(b) * hw;
  if (dropped(mask, b)) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int r = lo + threadIdx.y; r < hi; r += blockDim.y) {
      *reinterpret_cast<uint4*>(dh + (base + r) * c + col) = zero;
    }
    return;
  }
  float g[kVec], s[kVec];
  load_f8(gk + static_cast<long long>(b) * c + col, g);
  load_f8(ds + static_cast<long long>(b) * c + col, s);
  const int step = blockDim.y;
  for (int r = lo + threadIdx.y; r < hi; r += step * kUnroll) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < hi) load8(dy + (base + r + u * step) * c + col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < hi) {
        float o[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) o[i] = v[u][i] * g[i] + s[i];
        store8(dh + (base + r + u * step) * c + col, o);
      }
    }
  }
}

// ----------------------------------------------------------------- nf_ws ---

// The sum of v over a 1-d block of whole warps, in every thread, in a fixed order.
__device__ __forceinline__ float block_allsum(float v, float* red32) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red32 may still be read by an earlier call
  if (lane == 0) red32[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i) s += red32[i];
  return s;
}

// A group of up to kMaxWs convs' weights, one launch each way (a block's
// convs, or the stem's and the final conv's): launch block i works on output
// channel i - row_start[j] of weight j, row_start[j] <= i < row_start[j + 1].
// Passed by value, in the kernel's parameter space.
constexpr int kMaxWs = 8;

struct WsGroup {
  const float* w[kMaxWs];     // each (O, fan-in) rows, OIHW or channels-last alike
  const float* gain[kMaxWs];  // O values, or null (1)
  void* out[kMaxWs];          // forward: bf16 y; backward: float32 dw, rows as w's
  float* stats[kMaxWs];       // (O, 2): mu and r, written forward, read backward
  const bf16* dy[kMaxWs];     // backward: y's gradient, rows as w's
  float* dgain[kMaxWs];       // backward: the gain's gradient, null where gain is
  int row_start[kMaxWs + 1];
  int n[kMaxWs];
  float scale[kMaxWs];
  float eps[kMaxWs];
  int count;
};

__device__ __forceinline__ int ws_item(const WsGroup& g, int block) {
  int j = 0;
  while (j + 1 < g.count && block >= g.row_start[j + 1]) ++j;
  return j;
}

// blockDim kThreads, a block a row: for row o of weight j, its n = fan-in
// values contiguous: mu = mean, r = rsqrt(var + eps) (biased variance, two
// passes), y = bf16((w - mu) r a) with a = gain[o] scale (scale where gain is
// null); stats[o] = (mu, r) for the backward.
__global__ void __launch_bounds__(kThreads) nf_ws_fwd(const WsGroup g) {
  __shared__ float red32[kThreads / 32];
  const int j = ws_item(g, blockIdx.x);
  const long long o = blockIdx.x - g.row_start[j];
  const int n = g.n[j];
  const float* row = g.w[j] + o * n;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += row[i];
  const float mu = block_allsum(s, red32) / static_cast<float>(n);
  float q = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = row[i] - mu;
    q += d * d;
  }
  const float r = rsqrtf(block_allsum(q, red32) / static_cast<float>(n) + g.eps[j]);
  const float a = g.gain[j] == nullptr ? g.scale[j] : g.gain[j][o] * g.scale[j];
  bf16* y = static_cast<bf16*>(g.out[j]) + o * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = __float2bfloat16_rn((row[i] - mu) * r * a);
  if (threadIdx.x == 0) {
    g.stats[j][2 * o] = mu;
    g.stats[j][2 * o + 1] = r;
  }
}

// blockDim kThreads, a block a row: with t = (w - mu) r and g = dy, S1 = sum
// g, S2 = sum g t over the row: dw = r a (g - S1 / n - t S2 / n) (the
// standardisation's exact backward, eps included) and dgain[o] = scale S2.
__global__ void __launch_bounds__(kThreads) nf_ws_bwd(const WsGroup g) {
  __shared__ float red32[kThreads / 32];
  const int j = ws_item(g, blockIdx.x);
  const long long o = blockIdx.x - g.row_start[j];
  const int n = g.n[j];
  const float* row = g.w[j] + o * n;
  const bf16* grow = g.dy[j] + o * n;
  const float mu = g.stats[j][2 * o], r = g.stats[j][2 * o + 1];
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = __bfloat162float(grow[i]);
    s1 += d;
    s2 += d * ((row[i] - mu) * r);
  }
  s1 = block_allsum(s1, red32);
  s2 = block_allsum(s2, red32);
  const float scale = g.scale[j];
  const float a = g.gain[j] == nullptr ? scale : g.gain[j][o] * scale;
  const float inv_n = 1.0f / static_cast<float>(n);
  const float m1 = s1 * inv_n, m2 = s2 * inv_n, ra = r * a;
  float* dw = static_cast<float*>(g.out[j]) + o * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float t = (row[i] - mu) * r;
    dw[i] = ra * (__bfloat162float(grow[i]) - m1 - t * m2);
  }
  if (g.dgain[j] != nullptr && threadIdx.x == 0) g.dgain[j][o] = scale * s2;
}

// The group from the launchers' flat arrays: ptrs[stride * j + k] the k-th
// pointer of weight j (stride 4 forward: w, gain, y, stats; 6 backward: dy,
// w, gain, stats, dw, dgain), dims[2 j] its rows and dims[2 j + 1] its fan-in,
// consts[2 j] its scale and consts[2 j + 1] its eps. False where a count or a
// size is out of range.
bool ws_group(WsGroup& g, int count, const void* const* ptrs, int stride, const int* dims, const float* consts) {
  if (count <= 0 || count > kMaxWs) return false;
  g = WsGroup{};
  g.count = count;
  long long rows = 0;
  for (int j = 0; j < count; ++j) {
    const void* const* p = ptrs + stride * j;
    const bool bwd = stride == 6;
    g.w[j] = static_cast<const float*>(p[bwd ? 1 : 0]);
    g.gain[j] = static_cast<const float*>(p[bwd ? 2 : 1]);
    g.stats[j] = static_cast<float*>(const_cast<void*>(p[3]));
    g.out[j] = const_cast<void*>(p[bwd ? 4 : 2]);
    if (bwd) {
      g.dy[j] = static_cast<const bf16*>(p[0]);
      g.dgain[j] = static_cast<float*>(const_cast<void*>(p[5]));
      if ((g.gain[j] == nullptr) != (g.dgain[j] == nullptr)) return false;
    }
    if (dims[2 * j] <= 0 || dims[2 * j + 1] <= 0) return false;
    g.row_start[j] = static_cast<int>(rows);
    rows += dims[2 * j];
    g.n[j] = dims[2 * j + 1];
    g.scale[j] = consts[2 * j];
    g.eps[j] = consts[2 * j + 1];
  }
  if (rows > 0x7fffffff) return false;
  for (int j = count; j <= kMaxWs; ++j) g.row_start[j] = static_cast<int>(rows);
  return true;
}

bool bad_block(int tx, int c) {
  return tx <= 0 || kThreads % tx != 0 || c <= 0 || c % kVec != 0 || (c / kVec) % tx != 0;
}

}  // namespace

// Launchers: each returns the cudaError_t of its launch (0 on success). All
// pointers are device pointers of contiguous tensors, 16-byte aligned; a
// null bias, gate (m, w), gain or mask is absent. tx is blockDim.x (the
// wrapper's tiling, a power of two dividing C / 8); the caller checks shapes
// and types.

extern "C" int nf_act_fwd_launch(const void* x, const void* bias, void* y, long long rows, int c, int tx,
                                 int chunk_rows, int chunks, float scale, void* stream) {
  if (bad_block(tx, c) || rows < 0 || chunk_rows <= 0 || chunks <= 0 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const dim3 grid(c / kVec / tx, chunks), block(tx, kThreads / tx);
  nf_act_fwd<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(bias), static_cast<bf16*>(y), rows, c, chunk_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_act_bwd_launch(const void* dy, const void* x, const void* bias, void* dx, void* partial,
                                 long long rows, int c, int tx, int chunk_rows, int chunks, float scale,
                                 void* stream) {
  if (bad_block(tx, c) || rows < 0 || chunk_rows <= 0 || chunks <= 0 || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const dim3 grid(c / kVec / tx, chunks), block(tx, kThreads / tx);
  nf_act_bwd<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(x), static_cast<const float*>(bias),
      static_cast<bf16*>(dx), static_cast<float*>(partial), rows, c, chunk_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_colsum_launch(const void* partial, void* out, int rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + 31) / 32), block(32, kSumRows);
  nf_colsum<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(partial),
                                                                    static_cast<float*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_tail_mean_launch(const void* h, const void* bias, const void* mask, void* m, int batch, int hw,
                                   int c, int tx, void* stream) {
  if (bad_block(tx, c) || batch <= 0 || batch > 65535 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(c / kVec / tx, batch), block(tx, kThreads / tx);
  nf_tail_mean<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const float*>(bias), static_cast<const uint8_t*>(mask),
      static_cast<float*>(m), hw, c, 1.0f / static_cast<float>(hw));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_tail_fwd_launch(const void* h, const void* bias, const void* sc, const void* m, const void* w,
                                  const void* gain, const void* mask, void* out, int batch, int hw, int c, int tx,
                                  int chunk_rows, int chunks, float k, void* stream) {
  if (bad_block(tx, c) || batch <= 0 || batch > 65535 || hw <= 0 || chunk_rows <= 0 || chunks <= 0 ||
      chunks > 65535 || (m == nullptr) != (w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(c / kVec / tx, chunks, batch), block(tx, kThreads / tx);
  nf_tail_fwd<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const float*>(bias), static_cast<const bf16*>(sc),
      static_cast<const float*>(m), static_cast<const float*>(w), static_cast<const float*>(gain),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), hw, c, chunk_rows, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_tail_sums_launch(const void* dy, const void* h, const void* bias, const void* mask, void* p,
                                   void* d, int batch, int hw, int c, int tx, void* stream) {
  if (bad_block(tx, c) || batch <= 0 || batch > 65535 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(c / kVec / tx, batch), block(tx, kThreads / tx);
  nf_tail_sums<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(h), static_cast<const float*>(bias),
      static_cast<const uint8_t*>(mask), static_cast<float*>(p), static_cast<float*>(d), hw, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_tail_gate_bwd_launch(const void* p, const void* d, const void* m, const void* w, const void* gain,
                                       const void* mask, void* gk, void* ds, void* terms, int batch, int hw, int c,
                                       float k, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(c) * sizeof(float);
  if (batch <= 0 || hw <= 0 || c <= 0 || smem > 48 * 1024 || (m == nullptr) != (w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nf_tail_gate_bwd<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(d), static_cast<const float*>(m),
      static_cast<const float*>(w), static_cast<const float*>(gain), static_cast<const uint8_t*>(mask),
      static_cast<float*>(gk), static_cast<float*>(ds), static_cast<float*>(terms), c, 1.0f / static_cast<float>(hw),
      k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_tail_bwd_launch(const void* dy, const void* gk, const void* ds, const void* mask, void* dh,
                                  int batch, int hw, int c, int tx, int chunk_rows, int chunks, void* stream) {
  if (bad_block(tx, c) || batch <= 0 || batch > 65535 || hw <= 0 || chunk_rows <= 0 || chunks <= 0 ||
      chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(c / kVec / tx, chunks, batch), block(tx, kThreads / tx);
  nf_tail_bwd<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const float*>(gk), static_cast<const float*>(ds),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(dh), hw, c, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

// nf_ws: count weights (at most kMaxWs), laid out as ws_group reads them.
extern "C" int nf_ws_fwd_launch(int count, const void* const* ptrs, const int* dims, const float* consts,
                                void* stream) {
  WsGroup g;
  if (!ws_group(g, count, ptrs, 4, dims, consts)) return static_cast<int>(cudaErrorInvalidValue);
  nf_ws_fwd<<<g.row_start[count], kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_ws_bwd_launch(int count, const void* const* ptrs, const int* dims, const float* consts,
                                void* stream) {
  WsGroup g;
  if (!ws_group(g, count, ptrs, 6, dims, consts)) return static_cast<int>(cudaErrorInvalidValue);
  nf_ws_bwd<<<g.row_start[count], kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
