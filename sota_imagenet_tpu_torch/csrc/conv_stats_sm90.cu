// Fused 1x1-conv (matmul) + BatchNorm-statistics kernel for Hopper (sm_90a):
// TMA loads into an mbarrier ring, wgmma, a persistent warp-specialised grid
// and TMA stores. Bound to Python with ctypes (ops/conv_stats.py), which
// sends here every operand pair the tensor maps accept (K and N multiples of
// 8, 16-byte aligned bases; choose_path) and the rest to the mma.sync kernel
// of conv_stats.cu.
//
// Replaces sota_imagenet_tpu/ops/pallas_conv_stats.py::_kernel (:41-51, the
// body of conv1x1_stats). For bf16 x (M, K) and w (N, K), both K-contiguous:
//   y = x @ w^T      bf16 operands, f32 accumulation in the tensor cores,
//                    rounded once to bf16 (cvt.rn) and stored (M, N);
//   per-column sums  sum of y and of y^2 over the bf16-ROUNDED y, in f32, as
//                    rows of partials that the wrapper sums with torch.sum.
//
// What bounds it at ResNet-50's 15 shapes (batch 256, 224 px; bytes
// 2(MK + KN + MN) at 3.35 TB/s against 2MKN at 989 TFLOP/s): operations at
// (M, K, N) = (50176,512,1024), (50176,1024,512), (12544,512,2048),
// (12544,1024,2048) and (12544,2048,512); bytes at the other ten, where y
// (N = 4K at the expanding convs) is most of the traffic. Summed over a
// train step's 36 launches the bound is 2.60 ms.
//
// Design.
// * A block of 384 threads, one block per SM (persistent). Warpgroups 0 and
//   1 are consumers, 64 rows of the 128-row tile each (setmaxnreg 232);
//   warpgroup 2 is the producer (setmaxnreg 40), in which one thread keeps
//   TMA loads in flight through a ring of kStages (x, w) K-slices of 64 bf16
//   (128 bytes: one row of the 128-byte swizzle, the layout wgmma reads).
//   TMA zero-fills rows of M and N and columns of K past the edge, so no
//   load is masked, and a zero row adds nothing to the sums.
// * Tiles are BM = 128 by BN = 64, 128 or 256, chosen by the wrapper from
//   M, N and the SM count (plan in ops/conv_stats.py). The grid is
//   groups x tiles_n blocks; block b keeps N-tile b % tiles_n for its whole
//   life and walks M-tiles b / tiles_n, + groups, ... in a fixed order. The
//   tiles_n blocks that share an M-tile are neighbours and run together, so
//   x comes from memory once and from L2 after that. While the consumers
//   run a tile's epilogue, the producer already loads the next tiles'
//   slices, which is what the K = 64 shapes (one slice a tile) need.
// * Main loop: wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulators), both
//   operands from shared memory, one commit group per slice. A slice goes
//   back to the producer (8 warp arrivals on its empty barrier) as soon as
//   its group has retired; the other warpgroup's group keeps the tensor
//   cores busy meanwhile, and the producer runs kStages - 1 slices ahead
//   (keeping one group in flight instead measured 1-2% slower).
// * Epilogue: each accumulator is rounded to bf16 and written with
//   stmatrix (16-byte rows of 8 x 8 blocks) to a staging tile in shared
//   memory in the 128-byte-swizzled layout (bank-conflict free),
//   fence.proxy.async, then one thread per warpgroup stores it with TMA
//   (boxes of 64 x 64; TMA clips rows and columns past the edge). The
//   statistics are read back from that staging tile rather than shuffled
//   out of the wgmma fragments (at BN = 256, 64 conflict-free shared loads
//   a thread instead of 384 shuffles): thread t of a warpgroup owns a pair
//   of columns and a fixed set of rows, sums the tile's rounded values and
//   their squares, and adds those tile sums into four f32 registers that it
//   carries over all of the block's tiles. At the end it writes them as one
//   row of partials: (groups x 2 warpgroups x 256 / BN) rows of N columns.
//   Every sum runs in a fixed order, with no atomics, so the same inputs
//   give the same y and sums, bit for bit.
// * What holds it back (PERF.md has the numbers): at the memory-bound
//   shapes the y stores reach about 80% of the memory rate; at the K-deep
//   ones the epilogue's staging writes cost ~20% of the time, and neither
//   giving each warpgroup its own tiles in turn (ping-pong) nor storing y
//   by other warps has won that back.
//
// Tile per r50 shape, (M, K, N) BN, from plan() with 132 SMs:
//   (802816, 64, 64) 64     (802816, 64, 256) 256   (802816, 256, 64) 64
//   (802816, 256, 128) 128  (200704, 128, 512) 256  (200704, 256, 512) 256
//   (200704, 512, 128) 128  (200704, 512, 256) 256  (50176, 256, 1024) 256
//   (50176, 512, 1024) 256  (50176, 1024, 256) 256  (50176, 1024, 512) 256
//   (12544, 512, 2048) 256  (12544, 1024, 2048) 256 (12544, 2048, 512) 128
// Stages: 3 at BN = 256, 6 at 128, 8 at 64 (dynamic shared memory 214,064,
// 230,496 and 214,144 bytes, with the staging tile). ptxas (sm_90a, CUDA
// 12.9): 168 registers at launch (setmaxnreg then gives the consumers 232
// and the producer 40), no spills, in all three instantiations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBM = 128;  // tile rows: 64 per consumer warpgroup
constexpr int kBK = 64;   // K slice: 64 bf16 = 128 bytes, one swizzle row
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
// A wait on an mbarrier that lasts this long (about 2 s) is a bug: trap, so
// that it surfaces as a launch failure instead of a hung card.
constexpr long long kHangCycles = 1LL << 32;

template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 256 ? 3 : (BN == 128 ? 6 : 8);
  static constexpr int kABytes = kBM * kBK * 2;  // 16 KB
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStagingBytes = kBM * BN * 2;  // the bf16 y tile
  static constexpr int kSmem = 1024 /* alignment slack */ + kStages * kStageBytes + kStagingBytes + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "shared memory of one block on sm_90");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > kHangCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}

// Four 8 x 8 b16 blocks from registers to shared memory: register i of lane
// l holds row l / 4, columns 2(l % 4), 2(l % 4) + 1 of block i (the mma
// fragment), and lanes 8i..8i+7 give the addresses of block i's rows.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0), "r"(r1), "r"(r2),
               "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round each to nearest even; lo at the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart, tile base on 1024 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  uint64_t desc = (addr & 0x3FFFF) >> 4;
  desc |= uint64_t(16 >> 4) << 16;    // leading byte offset (unused for K-major swizzled)
  desc |= uint64_t(1024 >> 4) << 32;  // stride byte offset: next 8-row group
  desc |= uint64_t(1) << 62;          // 128-byte swizzle
  return desc;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x BN f32, wgmma fragment) (+)= A (64 x 16, K-major) * B (BN x 16,
// K-major)^T; scale_d = 0 overwrites d. Fragment: thread (warp w, lane l)
// holds d[4j + 2h + e] at row 16w + l / 4 + 8h, column 8j + 2(l % 4) + e.
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv1x1_stats_sm90_kernel(__grid_constant__ const CUtensorMap tm_x, __grid_constant__ const CUtensorMap tm_w,
                              __grid_constant__ const CUtensorMap tm_y, float* __restrict__ part_sum,
                              float* __restrict__ part_sq, int N, int K, int tiles_m, int tiles_n) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on 1024
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sa = smem;                               // [kStages][128][64] bf16
  unsigned char* sb = sa + C::kStages * C::kABytes;       // [kStages][BN][64] bf16
  unsigned char* staging = sb + C::kStages * C::kBBytes;  // [2 wg][BN / 64][64][64] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + C::kStagingBytes);
  uint64_t* empty = full + C::kStages;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int tile_n = blockIdx.x % tiles_n;  // fixed for the block's life
  const int group = blockIdx.x / tiles_n;
  const int groups = gridDim.x / tiles_n;
  const int k_tiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile_m = group; tile_m < tiles_m; tile_m += groups) {
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);  // passes at once on a fresh barrier
          const uint32_t bar = smem_u32(&full[stage]);
          mbar_expect_tx(bar, C::kStageBytes);  // whole boxes: TMA counts zero-filled bytes too
          tma_load_2d(smem_u32(sa + stage * C::kABytes), &tm_x, bar, kt * kBK, tile_m * kBM);
          tma_load_2d(smem_u32(sb + stage * C::kBBytes), &tm_w, bar, kt * kBK, tile_n * BN);
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = tid / 32;
    const int lane = tid % 32;
    unsigned char* stage_wg = staging + wg * (BN * 128);  // BN / 64 subtiles of 64 x 64 bf16
    const uint32_t stage_wg_u32 = smem_u32(stage_wg);
    // statistics: the thread owns columns 2p, 2p + 1 and rows rs, rs + kRowSets, ...
    constexpr int kPairs = BN / 2;
    constexpr int kRowSets = 256 / BN;
    const int p = tid % kPairs;
    const int rs = tid / kPairs;
    const int col = 2 * p;
    const unsigned char* stat_base = stage_wg + (col / 64) * 8192 + (col % 8) * 2;
    const int chunk = (col % 64) / 8;
    float s1a = 0.f, s1b = 0.f, s2a = 0.f, s2b = 0.f;

    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile_m = group; tile_m < tiles_m; tile_m += groups) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t a = smem_u32(sa + stage * C::kABytes + wg * 64 * 128);
        const uint32_t b = smem_u32(sb + stage * C::kBBytes);
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // 16 bf16 = 32 bytes along K inside the swizzled row
          wgmma_bf16<BN>(d, wgmma_desc(a + kk * 32), wgmma_desc(b + kk * 32), (kt > 0 || kk > 0) ? 1 : 0);
        }
        wgmma_commit();
        // the slice goes back to the producer as soon as its products are
        // done: the other warpgroup's group keeps the tensor cores busy
        // meanwhile, and the producer runs kStages - 1 slices ahead
        wgmma_wait<0>();
        fence_regs(d);
        if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // ---- epilogue ----
      // the last tile's TMA store has read the staging tile, and every
      // thread has read its statistics from it
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + wg, 128);
      {
        // stmatrix x4 writes four 8 x 8 bf16 blocks of the fragment: rows
        // 0-7 and 8-15 of the warp's 16 at 16-byte chunks j and j + 1; lane
        // l gives the address of row l % 8 (+ 8 for lanes 8-15 and 24-31) of
        // block l / 8
        const int row = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
        const uint32_t row_addr = stage_wg_u32 + row * 128;
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          const int jj = j + lane / 16;  // j even: j and j + 1 lie in one 64-column subtile
          stmatrix_x4(row_addr + (j / 8) * 8192 + (((jj % 8) ^ (lane % 8)) << 4), pack_bf16(d[4 * j], d[4 * j + 1]),
                      pack_bf16(d[4 * j + 2], d[4 * j + 3]), pack_bf16(d[4 * j + 4], d[4 * j + 5]),
                      pack_bf16(d[4 * j + 6], d[4 * j + 7]));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes -> TMA store reads
      named_sync(1 + wg, 128);
      if (tid == 0) {
        const int n0 = tile_n * BN;
#pragma unroll
        for (int sub = 0; sub < BN / 64; ++sub) {
          if (n0 + sub * 64 < N) tma_store_2d(&tm_y, stage_wg_u32 + sub * 8192, n0 + sub * 64, tile_m * kBM + wg * 64);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      // statistics of the rounded y, read back from the staging tile: the
      // tile's sums first, then into the block's running sums
      float t1a = 0.f, t1b = 0.f, t2a = 0.f, t2b = 0.f;
#pragma unroll 4
      for (int r = rs; r < 64; r += kRowSets) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(stat_base + r * 128 + ((chunk ^ (r % 8)) << 4));
        const float2 f = __bfloat1622float2(v);
        t1a += f.x;
        t2a += f.x * f.x;
        t1b += f.y;
        t2b += f.y * f.y;
      }
      s1a += t1a;
      s2a += t2a;
      s1b += t1b;
      s2b += t2b;
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    const int n_col = tile_n * BN + col;
    const size_t row = (static_cast<size_t>(group) * 2 + wg) * kRowSets + rs;
    if (n_col < N) {  // N % 8 == 0: the pair is whole
      part_sum[row * N + n_col] = s1a;
      part_sum[row * N + n_col + 1] = s1b;
      part_sq[row * N + n_col] = s2a;
      part_sq[row * N + n_col + 1] = s2b;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (as of CUDA 12.0) from the driver, looked up once
// at run time so that the library needs no -lcuda.
EncodeTiled lookup_encode() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
}

// A (rows, cols) row-major bf16 matrix, boxes of box_rows x 64 columns in the
// 128-byte swizzle; out-of-range elements read as zero and are not written.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const void* x, const void* w, void* y, float* ps, float* pq, int M, int N, int K, int grid,
           cudaStream_t stream) {
  using C = Cfg<BN>;
  // the shared-memory limit is an attribute of the function in each device's
  // context: set it once per device (ordinals 0-63)
  static std::atomic<unsigned long long> attr_set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(attr_set.load() & bit)) {
    e = cudaFuncSetAttribute(conv1x1_stats_sm90_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set.fetch_or(bit);
  }
  static const EncodeTiled fn = lookup_encode();  // thread-safe static initialisation
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_x, tm_w, tm_y;
  if (!encode(fn, &tm_x, x, M, K, kBM) || !encode(fn, &tm_w, w, N, K, BN) || !encode(fn, &tm_y, y, M, N, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + BN - 1) / BN;
  conv1x1_stats_sm90_kernel<BN><<<grid, kThreads, C::kSmem, stream>>>(tm_x, tm_w, tm_y, ps, pq, N, K, tiles_m, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). x (M, K), w (N, K)
// and y (M, N) are contiguous bf16 device tensors with 16-byte aligned bases,
// K and N multiples of 8, M > 0; bn is 64, 128 or 256; grid a multiple of
// ceil(N / bn); part_sum and part_sq are (grid / ceil(N / bn) * 2 * 256 / bn,
// N) f32. The caller (ops/conv_stats.py) checks shapes and types.
extern "C" int conv1x1_stats_sm90_launch(const void* x, const void* w, void* y, void* part_sum, void* part_sq, int M,
                                         int N, int K, int bn, int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bn != 64 && bn != 128 && bn != 256) return static_cast<int>(cudaErrorInvalidValue);
  if (grid % ((N + bn - 1) / bn) != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* ps = static_cast<float*>(part_sum);
  auto* pq = static_cast<float*>(part_sq);
  auto s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return launch<64>(x, w, y, ps, pq, M, N, K, grid, s);
    case 128:
      return launch<128>(x, w, y, ps, pq, M, N, K, grid, s);
    default:
      return launch<256>(x, w, y, ps, pq, M, N, K, grid, s);
  }
}
