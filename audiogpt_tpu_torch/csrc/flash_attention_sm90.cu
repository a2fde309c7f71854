// Blockwise (flash) attention forward for bf16 q/k/v [B, T, H, D] on
// Hopper's warpgroup tensor cores (`wgmma`), fed by the Tensor Memory
// Accelerator (TMA) through a ring of `mbarrier`s, with one producer
// warpgroup and one to three consumer warpgroups.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_forward` of
// audiogpt_tpu/ops/flash_attention.py for bf16 inputs; the f32 entry is
// csrc/flash_attention_sm90_f32.cu, and csrc/sm90.cuh holds the barrier,
// TMA and `wgmma` helpers both share. Semantics follow `_flash_kernel`:
// scale D^-0.5, an optional key-padding mask [B, Tk] (> 0 = valid), causal
// masking aligned top-left (key j is visible to query i when j <= i), f32
// running max, sum and output accumulators, the probabilities rounded to
// bf16 before P.V (`_flash_kernel:75-77`), and 0 for a query row with no
// valid key (masked logits are -inf and never enter the sums; the exponent
// base of such a row is taken as 0).
//
// Bound on the H100: operations at the attention paths' shapes (the UNet's
// [6, 780, 8, 40] does 4*B*H*Tq*Tk*D = 4.7 GFLOP on 12 MB), but at D <= 64
// the softmax's exponentials (one MUFU op per logit, 16 a clock per SM)
// take longer than the two products at the dense bf16 rate (989 TFLOP/s),
// and a warpgroup's chain of product, softmax and product is latency-bound:
// the design keeps several such chains in flight on each SM.
//
// Design, per block of 64 * NC query rows of one (batch, head):
//  * warpgroup NC is the producer: after `setmaxnreg` hands its registers
//    to the consumers, one thread loads the block's Q once and then streams
//    the K and V tiles with TMA into a ring of kStages stages, each with a
//    "full" barrier (TMA's byte count, and with a key mask one arrival per
//    lane of the producer warp, whose 4-byte `cp.async`s bring the tile's
//    mask values: a row of B * Tk f32 has no 16-byte alignment for TMA)
//    and an "empty" one (one arrival per consumer warp).
//  * each consumer warpgroup owns 64 query rows: S = Q.K^T by `wgmma`
//    m64nBKk16 with both operands from shared memory (K-major), the online
//    softmax on the f32 accumulator fragments (row max and sum over the 4
//    lanes that share a row, base 2), then P rounded to bf16 in registers
//    is the A operand of O += P.V, a `wgmma` whose B is the V tile read
//    MN-major (the transpose bit bf16 allows): S never leaves registers.
//    The loop is software-pipelined: P.V of one tile runs on the tensor
//    cores while the softmax of the next runs on the other units.
//  * the consumer warpgroups of a block share its K and V tiles and take
//    turns (named barriers) to issue their products, so that one's softmax
//    overlaps the next one's products. How many a block has (64, 128 or 192
//    query rows) is chosen per call from the grid's waves and each count's
//    measured rate (`consumers`).
//  * tiles wholly above the diagonal (causal) are not loaded; a tile whose
//    keys the mask all drops, or which lies above a warpgroup's rows, is
//    not computed.
// The head dim is padded to DP, a multiple of the k step 16, by TMA's zero
// fill out of bounds (the box is DP wide, the tensor D): nothing is copied
// in device memory. Rows are kept in column blocks kW elements wide (64,
// 32 or 16: the widest that divides DP), each written by TMA with the
// swizzle of its width (128, 64 or 32 bytes) and read by `wgmma` through
// descriptors of the same swizzle, so D = 40 (DP = 48) and 80 take three
// and five 32-byte blocks. The ragged key tail and Q rows past Tq are zero
// filled too. TMA needs rows of a multiple of 16 bytes: D % 8 == 0 (the
// wrapper raises otherwise). Every branch around a `wgmma` is on a warp
// vote or a shuffled value, which ptxas knows to be uniform, and each
// branch waits for the groups it commits: else ptxas serializes every
// `wgmma` of the kernel (its C7514-C7518 notes, which `chip_smoke.py`'s
// build phase reports).

#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;    // query rows of a consumer warpgroup (M)
constexpr int kStages = 3;   // K/V tiles in flight

// Per padded head dim DP: the column blocks and the key tile.
template <int DP>
struct Tile {
  static constexpr int kW = DP % 64 == 0 ? 64 : DP % 32 == 0 ? 32 : 16;
  // the descriptors' layout type of that swizzle: 1 = 128 B, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kW == 64 ? 1 : kW == 32 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : kW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int kChunks = DP / kW;
  static constexpr int kBK = DP <= 96 ? 128 : 64;  // keys per tile
  // consumer warpgroups a block at most: three hold S (kBK / 2 registers),
  // P (kBK / 4) and O (DP / 2) in 160 registers a thread without spilling
  // except at DP = 80 and 96 with 128-key tiles
  static constexpr int kMaxConsumers = DP == 80 || DP == 96 ? 2 : 3;
};

// Shared memory of a block of NC consumer warpgroups, offsets from a
// 1024-byte aligned base: Q [NC][chunks][64][kW], then per stage K
// [chunks][BK][kW] and V the same, then the key mask [stages][BK] f32, then
// the barriers full[stages], empty[stages], q; and the slack of the
// alignment.
template <int DP, int NC>
struct Smem {
  static constexpr int kBK = Tile<DP>::kBK;
  static constexpr int kQBytes = NC * kRows * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;  // one of K, V
  static constexpr int kKV = kQBytes;
  static constexpr int kMask = kKV + kStages * 2 * kTileBytes;
  static constexpr int kBar = kMask + kStages * kBK * 4;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
};

// ---- operands, wgmma ------------------------------------------------------

// K-major operand (Q as A, K as B of S = Q.K^T): `rows` rows a column
// block; k step kk (head dims 16kk..16kk+15) lies in block 16kk / kW, at
// byte 2 * (16kk % kW) of its swizzled rows; 8-row groups 16 * kW bytes
// apart (the leading offset is unused at this swizzle)
template <int DP>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, int rows,
                                                int kk) {
  constexpr int kW = Tile<DP>::kW;
  return make_desc(addr + (16 * kk / kW) * rows * kW * 2 + (16 * kk % kW) * 2,
                   16, 16 * kW, Tile<DP>::kLayout);
}

// MN-major V (B of O += P.V, N = head dims): k step kk is keys
// 16kk..16kk+15, 8-key groups 16 * kW bytes apart, column blocks of kW dims
// kBK * kW * 2 bytes apart
template <int DP>
__device__ __forceinline__ uint64_t desc_v(uint32_t addr, int kk) {
  constexpr int kW = Tile<DP>::kW, kBK = Tile<DP>::kBK;
  return make_desc(addr + kk * 16 * kW * 2, kBK * kW * 2, 16 * kW,
                   Tile<DP>::kLayout);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// d (+)= a . b, m64nNk16, bf16 operands, f32 accumulators. `wgmma_ss`: A
// and B from shared memory, both K-major, d overwritten when !acc;
// `wgmma_rs`: A from registers (the m16n8k16 A fragment of each warp's 16
// rows), B MN-major, accumulating. Each accumulator register d[i] of
// thread (warp w, lane 4g + c) holds row 16w + g + 8 * ((i >> 1) & 1),
// column 8 * (i >> 2) + 2c + (i & 1).
#define WGMMA_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);


template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),
        WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),
        WGMMA_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),
        WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),
        WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56), WGMMA_D8(64),
        WGMMA_D8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WGMMA_D8

// ---- the kernel ---------------------------------------------------------

template <int DP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const float* __restrict__ kv_mask, bf16* __restrict__ out,
               int Tq, int Tk, int H, int D, float scale_log2, int causal) {
  using L = Smem<DP, NC>;
  constexpr int kW = Tile<DP>::kW, kChunks = Tile<DP>::kChunks;
  constexpr int kBK = Tile<DP>::kBK;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* mask_s =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kMask);
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;

  const int q0 = blockIdx.x * kRows * NC, h = blockIdx.y, b = blockIdx.z;
  const bool masked = kv_mask != nullptr;
  int n_tiles = (Tk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows * NC - 1) / kBK + 1);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, masked ? 33 : 1);
      mbar_init(empty + 8 * s, 4 * NC);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, shuffled from lane 0 so that ptxas knows it is the same
  // in every lane: a `wgmma` under a branch it cannot prove uniform is
  // serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NC) {
    // ---- producer: its first warp; lane 0 issues the TMA copies ----
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 128 * NC + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(base + w * kRows * DP * 2 + c * kRows * kW * 2, &tm_q,
                      qbar, c * kW, h, q0 + w * kRows, b);
    }
    const float* mb = masked ? kv_mask + (int64_t)b * Tk : nullptr;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % kStages, k0 = tile * kBK;
      mbar_wait(empty + 8 * st, ((tile / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full + 8 * st, 2 * L::kTileBytes);
        const uint32_t ks = base + L::kKV + st * 2 * L::kTileBytes;
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(ks + c * kBK * kW * 2, &tm_k, full + 8 * st, c * kW, h,
                      k0, b);
          tma_load_4d(ks + L::kTileBytes + c * kBK * kW * 2, &tm_v,
                      full + 8 * st, c * kW, h, k0, b);
        }
      }
      if (masked) {
        // the ragged tail is zero-filled (dropped)
        for (int i = lane; i < kBK; i += 32) {
          const bool in = k0 + i < Tk;
          cp_async4(base + L::kMask + (st * kBK + i) * 4,
                    mb + (in ? k0 + i : 0), in);
        }
        cp_async_arrive(full + 8 * st);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows row0 .. row0 + 63 ----
  // (the registers the producer gave up, shared by the consumers)
  setmaxnreg_inc<NC == 1 ? 232 : NC == 2 ? 240 : 160>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, c = lane % 4;  // fragment row group, column pair
  const int row0 = q0 + wg * kRows;
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;  // this thread's
  const uint32_t q_s = base + wg * kRows * DP * 2;

  float o[DP / 2], s[kBK / 2];
  uint32_t p[kBK / 16][4];  // P as the A fragments of P.V, one per k step
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  // consumer warpgroups take turns to issue their products, warpgroup 0
  // first (named barrier 1 + w is warpgroup w's turn): one's softmax then
  // runs while the next one's products hold the tensor cores
  const int next_turn = 1 + (wg + 1) % NC;
  if (NC > 1 && wg == NC - 1) named_arrive(1, 256);

  // Software pipeline: in each turn a warpgroup issues S = Q.K^T of tile j
  // and O += P.V of the last live tile before it (its P in p, its stage
  // `pend` still held), then runs the softmax of tile j while P.V runs, and
  // releases stage `pend` once P.V is done.
  int pend = -1;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kStages, k0 = tile * kBK;
    mbar_wait(full + 8 * st, (tile / kStages) & 1);
    // a tile above all this warpgroup's rows, or whose keys the mask all
    // drops, adds nothing (alpha = 1, p = 0); every warp reads the whole
    // mask tile, so the four agree
    bool live = !causal || k0 <= row0 + kRows - 1;
    if (live && masked) {
      bool any = false;
      for (int i = lane; i < kBK; i += 32)
        any |= k0 + i < Tk && mask_s[st * kBK + i] > 0.f;
      live = any;
    }
    live = __any_sync(0xffffffffu, live);
    const bool held = __any_sync(0xffffffffu, pend >= 0);
    const uint32_t ks = base + L::kKV + st * 2 * L::kTileBytes;
    const uint32_t vs =
        base + L::kKV + (held ? pend : 0) * 2 * L::kTileBytes + L::kTileBytes;

    // The turn is taken whether the tile is live or not (the last
    // warpgroup's last turn has no taker and stays open). Each branch waits
    // for what it issued itself, so that ptxas can follow the groups.
    if (NC > 1) named_sync(1 + wg, 256);
    float alpha[2] = {1.f, 1.f};
    if (live) {
      // S = Q.K^T for the warpgroup's 64 rows and the tile's kBK keys, then
      // O += P.V of the held tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<kBK>(s, desc_kmajor<DP>(q_s, kRows, kk),
                      desc_kmajor<DP>(ks, kBK, kk), kk > 0);
      wgmma_commit();
      if (held) {
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<DP>(o, p[kk], desc_v<DP>(vs, kk));
        wgmma_commit();
        if (NC > 1) named_arrive(next_turn, 256);
        wgmma_wait<1>();  // S: the older group
      } else {
        if (NC > 1) named_arrive(next_turn, 256);
        wgmma_wait<0>();
      }
      fence_regs(s);

      // mask (ragged tail, key padding, causal) and the online softmax in
      // base 2: p = 2^(s * scale * log2(e) - m), m the running max in the
      // same units (the max is taken on s: the scale is positive)
      const bool edge = masked || k0 + kBK > Tk ||
                        (causal && k0 + kBK - 1 > row0 + warp * 16);
      if (edge) {
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n) {
          // this thread's keys 8n + 2c and 8n + 2c + 1, for both its rows
          const int col = 8 * n + 2 * c;
          const float2 keep =
              masked ? *reinterpret_cast<const float2*>(mask_s + st * kBK +
                                                        col)
                     : make_float2(1.f, 1.f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + col + (e & 1), row = e & 2 ? r_hi : r_lo;
            const bool ok = key < Tk && (e & 1 ? keep.y : keep.x) > 0.f &&
                            (!causal || key <= row);
            if (!ok) s[4 * n + e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float base2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
        base2[r] = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet
        alpha[r] = fast_exp2(m_run[r] - base2[r]);
        m_run[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -base2[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += s[i];
      }
      // l is kept per lane (the row's 4 lanes are summed once at the end)
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + sum[r];
    } else {
      if (held) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs<DP>(o, p[kk], desc_v<DP>(vs, kk));
        wgmma_commit();
      }
      if (NC > 1) named_arrive(next_turn, 256);
    }
    wgmma_wait<0>();
    fence_regs(o);
    if (held) {
      // this warp is done with the held stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * pend);
      pend = -1;
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P rounded to bf16 (`_flash_kernel:76`) as the A fragments of the
      // kBK / 16 k steps: (g, keys 2c..) and (g+8, ..) of n-tile 2kk, then
      // of n-tile 2kk + 1
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      pend = st;
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
  }
  if (__any_sync(0xffffffffu, pend >= 0)) {
    const uint32_t vs =
        base + L::kKV + pend * 2 * L::kTileBytes + L::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<DP>(o, p[kk], desc_v<DP>(vs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l == 0.f ? 0.f : 1.f / l;
  }
  const int64_t rs = (int64_t)H * D;  // stride of one time step
  bf16* ob = out + (int64_t)b * Tq * rs + (int64_t)h * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = 8 * n + 2 * c;
    if (d >= D) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r_hi : r_lo;
      if (row >= Tq) continue;
      *reinterpret_cast<__nv_bfloat162*>(ob + row * rs + d) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] * inv[r],
                                o[4 * n + 2 * r + 1] * inv[r]);
    }
  }
}

// ---- host side ------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float* mask;
  void* out;
  int B, Tq, Tk, H, D;
  float scale_log2;
  int causal;
  cudaStream_t stream;
};

// the 4-D view (D, H, T, B) of a contiguous bf16 [B, T, H, D] tensor, in
// boxes of (kW, 1, rows, 1): the head dim past D and rows past T read 0
template <int DP>
bool encode_rows(CUtensorMap* map, const void* ptr, const Args& a, int T,
                 int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)a.H,
                              (cuuint64_t)T, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.D * 2,
                                 (cuuint64_t)a.H * a.D * 2,
                                 (cuuint64_t)T * a.H * a.D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Tile<DP>::kW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<DP>::kSwizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NC>
int launch(const Args& a) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const cudaError_t err = configure<Smem<DP, NC>>(flash_fwd_sm90<DP, NC>,
                                                  Smem<DP, NC>::kBytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq{}, tk{}, tv{};
  if (!encode_rows<DP>(&tq, a.q, a, a.Tq, kRows) ||
      !encode_rows<DP>(&tk, a.k, a, a.Tk, Tile<DP>::kBK) ||
      !encode_rows<DP>(&tv, a.v, a, a.Tk, Tile<DP>::kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Tq + kRows * NC - 1) / (kRows * NC), a.H, a.B);
  flash_fwd_sm90<DP, NC><<<grid, 128 * (NC + 1), Smem<DP, NC>::kBytes,
                           a.stream>>>(
      tq, tk, tv, a.mask, (bf16*)a.out, a.Tq, a.Tk, a.H, a.D, a.scale_log2,
      a.causal);
  return (int)cudaGetLastError();
}

// Consumer warpgroups a block, n (64n query rows, K and V shared by all;
// with two or three, they take turns on the tensor cores): the n whose
// grid costs the least, ceil(blocks / SMs) * 64n / rate(n), with rate(n)
// the query rows an SM computes per unit of time at that n relative to n =
// 1 (whose blocks go two to an SM). The rates were measured with
// `kernel_variants.py`'s "64-row" to "192-row blocks" at the attention
// paths' 23 shapes without a causal mask (H100); the rule picks the
// fastest of the three at each. Ties go to the larger n.
constexpr float kRate[4][3] = {
    {1.f, 1.82f, 2.17f},  // DP <= 48
    {1.f, 0.96f, 1.21f},  // DP = 64
    {1.f, 1.19f, 1.56f},  // DP = 80, 96
    {1.f, 1.19f, 1.41f},  // DP = 128, 160
};

template <int DP>
int consumers(int B, int Tq, int H) {
  const int sms = sm_count();
  if (sms == 0) return 1;
  const float* rate = kRate[DP <= 48 ? 0 : DP == 64 ? 1 : DP <= 96 ? 2 : 3];
  int best = 1;
  float best_cost = 0.f;
  for (int n = Tile<DP>::kMaxConsumers; n >= 1; --n) {
    const int64_t blocks =
        (int64_t)((Tq + kRows * n - 1) / (kRows * n)) * H * B;
    const float cost = (float)((blocks + sms - 1) / sms) * kRows * n /
                       rate[n - 1];
    if (n == Tile<DP>::kMaxConsumers || cost < best_cost)
      best = n, best_cost = cost;
  }
  return best;
}

template <int DP>
int run(const Args& a) {
  switch (consumers<DP>(a.B, a.Tq, a.H)) {
    case 3:
      return launch<DP, Tile<DP>::kMaxConsumers>(a);
    case 2:
      return launch<DP, 2>(a);
    default:
      return launch<DP, 1>(a);
  }
}

template <int DP, int NC>
int occupancy(int* block_q, int* blocks_per_sm) {
  *block_q = kRows * NC;
  const cudaError_t err = configure<Smem<DP, NC>>(flash_fwd_sm90<DP, NC>,
                                                  Smem<DP, NC>::kBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_fwd_sm90<DP, NC>, 128 * (NC + 1),
      Smem<DP, NC>::kBytes);
}

template <int DP>
int occupancy(int B, int Tq, int H, int* block_q, int* blocks_per_sm) {
  switch (consumers<DP>(B, Tq, H)) {
    case 3:
      return occupancy<DP, Tile<DP>::kMaxConsumers>(block_q, blocks_per_sm);
    case 2:
      return occupancy<DP, 2>(block_q, blocks_per_sm);
    default:
      return occupancy<DP, 1>(block_q, blocks_per_sm);
  }
}

// the head dim padded up to one of the compiled widths: F(DP) for the
// first DP >= D
template <typename F>
int dispatch(int D, F&& f) {
  if (D <= 16) return f(std::integral_constant<int, 16>());
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 48) return f(std::integral_constant<int, 48>());
  if (D <= 64) return f(std::integral_constant<int, 64>());
  if (D <= 80) return f(std::integral_constant<int, 80>());
  if (D <= 96) return f(std::integral_constant<int, 96>());
  if (D <= 128) return f(std::integral_constant<int, 128>());
  if (D <= 160) return f(std::integral_constant<int, 160>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The entry launches on the calling thread's current device, on `stream`,
// which must be a stream of that device: the wrapper
// (ops/flash_attention.py) makes the tensors' card current first. q, k, v
// and out are contiguous bf16 [B, T, H, D] with D % 8 == 0, 16-byte
// aligned; kv_mask (nullable) contiguous f32 [B, Tk].
extern "C" {

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         const void* kv_mask, void* out, int B, int Tq, int Tk,
                         int H, int D, float scale, int causal, void* stream) {
  const Args a{q, k, v, (const float*)kv_mask, out, B, Tq, Tk, H, D,
               scale * 1.4426950408889634f, causal, (cudaStream_t)stream};
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  return dispatch(D, [&](auto dp) { return run<decltype(dp)::value>(a); });
}

// the bf16 kernel's block shape for q [B, Tq, H, D] on the current device:
// query rows a block and resident blocks per SM, for the launch report
int flash_attention_bf16_occupancy(int B, int Tq, int H, int D, int* block_q,
                                   int* blocks_per_sm) {
  return dispatch(D, [&](auto dp) {
    return occupancy<decltype(dp)::value>(B, Tq, H, block_q, blocks_per_sm);
  });
}

}  // extern "C"
