// Blockwise (flash) attention forward for f32 q/k/v [B, T, H, D] on
// Hopper's warpgroup tensor cores (`wgmma` .tf32, three products per
// product), fed by the Tensor Memory Accelerator (TMA) through a ring of
// `mbarrier`s, with one producer warpgroup and one to three consumer
// warpgroups.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_forward` of
// audiogpt_tpu/ops/flash_attention.py for f32 inputs; the bf16 entry is
// csrc/flash_attention_sm90.cu, whose design this one follows, and
// csrc/sm90.cuh holds the barrier, TMA and `wgmma` helpers both share.
// Semantics follow `_flash_kernel`: scale D^-0.5, an optional key-padding
// mask [B, Tk] (> 0 = valid), causal masking aligned top-left (key j is
// visible to query i when j <= i), f32 running max, sum and output
// accumulators, and 0 for a query row with no valid key (masked logits are
// -inf and never enter the sums; the exponent base of such a row is taken
// as 0).
//
// Bound on the H100: operations. Each product runs as three TF32 products
// ("3xTF32": x = hi + lo, hi the f32 word with its low 13 mantissa bits
// cleared, which is how the tensor core reads an f32 word as TF32, and lo =
// x - hi exactly; a.b ~ lo.hi + hi.lo + hi.hi, dropping lo.lo), so the f32
// contract (1e-4 against the plain version) holds where one TF32 product
// (~2^-10 relative per operand) would not: 495 / 3 TFLOP/s. At the UNet's
// [6, 780, 8, 40] that is 4.7 GFLOP of attention on 24 MB.
//
// Design, per block of 64 * NC query rows of one (batch, head):
//  * the producer warpgroup gives its registers to the consumers
//    (`setmaxnreg`). Its warp 0 loads the block's Q once and streams the K
//    and V tiles with TMA into a ring of kStages stages, each with a "full"
//    barrier (TMA's byte count, and with a key mask one arrival per lane of
//    that warp, whose 4-byte `cp.async`s bring the tile's mask values), a
//    "ready" barrier and an "empty" one (one arrival per consumer warp).
//  * TF32 `wgmma` reads shared-memory operands K-major only (the transpose
//    bits exist for 16-bit types alone), and the hi parts need no copy (the
//    tensor core truncates), but the lo parts and V's transpose do. So once
//    a tile, for the whole block, the producer's warps 1-3 write (then
//    arrive on "ready"): V^T = hi(V) transposed, keys contiguous for each
//    head dim, in column blocks of 32 keys with the 128-byte swizzle (16
//    keys, 64 bytes, at 16-key tiles), and V_lo^T the same of V - hi(V);
//    then, over V, which is read, K_lo = K - hi(K) in K's own swizzled
//    layout. Inside each 8-key step V^T's keys run 0, 2, 4, 6, 1, 3, 5, 7:
//    logical k = c is key 2c and k = c + 4 key 2c + 1, the keys of the S
//    accumulators a thread holds, so P goes from the accumulators straight
//    into the A registers of P.V.
//  * each consumer warpgroup owns 64 query rows. S = Q_lo.K + Q.K_lo + Q.K
//    is three `wgmma` m64nBKk8 a k step, both operands from shared memory:
//    Q's hi part (written in place) and Q_lo beside it, split once (Q's
//    parts as A registers measured no faster and cost DP registers). The
//    online softmax runs on the f32 accumulator fragments (row max and sum
//    over the 4 lanes that share a row, base 2); P is split into hi and lo in
//    registers and O += P_lo.V^T + P_hi.V_lo^T + P_hi.V^T is three `wgmma`
//    m64nDPk8 a k step with A from registers. The loop is
//    software-pipelined: P.V of one tile runs on the tensor cores while the
//    softmax of the next runs on the other units; the consumer warpgroups
//    of a block share its tiles and take turns (named barriers) to issue
//    their products. How many a block has (64, 128 or 192 query rows) is
//    chosen per call from the grid's waves and each count's measured rate
//    (`consumers`).
//  * registers: the pipeline holds S, P_hi and P_lo (kBK / 2 each) and O
//    (DP / 2) at once, so tiles have at most 64 keys (the bf16 kernel's 128
//    would take 192 registers for S and P alone).
//  * shared memory: Q (and Q_lo) take 256 * NC * DP bytes each, a stage
//    (K, V then K_lo, V^T, V_lo^T) 16 * kBK * DP; the ring has as many
//    stages as the rest of the 227 KB a block may take holds, up to 4 (so
//    32-key tiles above DP = 48, 16 above 128).
//  * tiles wholly above the diagonal (causal) are not loaded; a tile whose
//    keys the mask all drops, or which lies above a warpgroup's rows, is
//    not computed.
// The head dim is padded to DP, a multiple of the k step 8, by TMA's zero
// fill out of bounds (the box is DP wide, the tensor D): nothing is copied
// in device memory. Rows are kept in column blocks kW elements wide (32,
// 16 or 8: the widest that divides DP), each written by TMA with the
// swizzle of its width (128, 64 or 32 bytes) and read through descriptors
// of the same swizzle, so D = 40 (five 32-byte blocks) and 80 (five of 64)
// need no padding. The ragged key tail and Q rows past Tq are zero filled
// too. TMA needs rows of a multiple of 16 bytes: D % 4 == 0 (the wrapper
// raises otherwise). Every branch around a `wgmma` is on a warp vote or a
// shuffled value, which ptxas knows to be uniform, and each branch waits
// for the groups it commits: else ptxas serializes every `wgmma` of the
// kernel (its C7514-C7518 notes, which `chip_smoke.py`'s build phase
// reports).

#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kRows = 64;  // query rows of a consumer warpgroup (M)
// the tile's transform by the producer's warps 1-3 while the consumers
// compute (true), or by all consumer threads together before each tile
constexpr bool kTransformByProducer = true;
// x = hi + lo with hi truncated to TF32 (the tensor core's own reading of
// K's f32 words, so K needs no hi copy) or rounded to nearest (cvt.rna;
// then K's hi is written in place too)
constexpr bool kRoundedSplit = false;
// O += P.V on `wgmma` (false) or on each warp's `mma.sync` m16n8k8
constexpr bool kPvMmaSync = false;

// Per padded head dim DP: the column blocks, the key tile and the block's
// largest number of consumer warpgroups.
template <int DP>
struct Tile {
  static constexpr int kW = DP % 32 == 0 ? 32 : DP % 16 == 0 ? 16 : 8;
  // the descriptors' layout type of that swizzle: 1 = 128 B, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kW == 32 ? 1 : kW == 16 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kW == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
               : kW == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int kChunks = DP / kW;
  static constexpr int kBK = DP <= 48 ? 64 : DP <= 128 ? 32 : 16;  // keys
  // V^T's column blocks: keys a block and their swizzle's layout type
  static constexpr int kVW = kBK >= 32 ? 32 : 16;
  static constexpr uint64_t kVLayout = kVW == 32 ? 1 : 2;
  static constexpr int kMaxConsumers = DP <= 64 ? 3 : DP <= 96 ? 2 : 1;
};

// Registers a thread after `setmaxnreg`: the producer warpgroup's and a
// consumer's, which together use what the launch gives the block (128 a
// thread at 256 and 512 threads, 168 at 384)
template <int NC>
struct Regs {
  static constexpr int kProducer = NC == 3 ? 32 : 40;
  static constexpr int kConsumer = NC == 1 ? 216 : NC == 2 ? 232 : 160;
};

// Shared memory of a block of NC consumer warpgroups, offsets from a
// 1024-byte aligned base: Q [NC][chunks][64][kW], Q_lo the same, then per
// stage K [chunks][BK][kW], V the same (K_lo
// once V is transposed), V^T [BK / kVW][DP][kVW] and V_lo^T the same, then
// the key mask [stages][BK] f32, then the barriers full[stages],
// ready[stages], empty[stages], q; and the slack of the alignment.
template <int DP, int NC>
struct Smem {
  static constexpr int kBK = Tile<DP>::kBK;
  static constexpr int kQWg = kRows * DP * 4;  // one warpgroup's Q rows
  static constexpr int kQLo = NC * kQWg;
  static constexpr int kT = kBK * DP * 4;  // one tile of K, V, ...
  static constexpr int kStage0 = 2 * NC * kQWg;
  static constexpr int kStageBytes = 4 * kT;
  static constexpr int kPerStage = kStageBytes + kBK * 4 + 3 * 8;
  // as many stages as fit beside Q, the barriers and the alignment's
  // slack, up to 4
  static constexpr int kFit = (232448 - 1024 - 8 - kStage0) / kPerStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;  // K/V tiles in flight
  static constexpr int kMask = kStage0 + kStages * kStageBytes;
  static constexpr int kBar = kMask + kStages * kBK * 4;
  static constexpr int kBytes = kBar + (3 * kStages + 1) * 8 + 1024;
  static_assert(kStages >= 2 && kBytes <= 232448,
                "no two stages in the shared memory of a block");
};

// ---- the split, the layouts ----------------------------------------------

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo: hi as the tensor core reads x (or rounded), lo the rest,
// exact (rounded to TF32 in turn with a rounded split)
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  if constexpr (kRoundedSplit) {
    hi = tf32_round(x);
    lo = tf32_round(x - hi);
  } else {
    hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
    lo = x - hi;
  }
}

__device__ __forceinline__ void split4(const float4& x, float4& hi,
                                       float4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// the TMA / `wgmma` swizzle of rows kRowBytes wide (128, 64 or 32) at a
// byte offset from a 1024-byte aligned base: the 16-byte unit's index XOR
// address bits 7-9, 7-8 or 7
template <int kRowBytes>
__device__ __forceinline__ int swizzle(int off) {
  return off ^ (((off >> 7) & (kRowBytes / 16 - 1)) << 4);
}

// byte offset of (head dim d, key position p) in V^T or V_lo^T
template <int DP>
__device__ __forceinline__ int vt_off(int d, int p) {
  constexpr int kVW = Tile<DP>::kVW;
  return swizzle<4 * kVW>((p / kVW) * DP * 4 * kVW + d * 4 * kVW +
                          (p % kVW) * 4);
}

// The tile's transform, shared by threads t = 0 .. nt - 1 (whole warps),
// which meet at named barrier `bar` between its two halves: V^T and
// V_lo^T, then K_lo over V (and K's hi in place with a rounded split). A
// lane takes one float4 of a V^T row at a time: head dim d, positions
// 4u .. 4u + 3, which hold keys key0, key0 + 2, key0 + 4, key0 + 6 of the
// 8-key step u / 2. A warp's 32 lanes take the kW head dims of one column
// block of V at 32 / kW consecutive u, so each load of theirs falls in one
// 128-byte line of V's rows, free of bank conflicts, and each 8 of their
// stores in distinct 16-byte units of V^T. At kW = 8 that line holds four
// rows whose index mod 4 differs only where the lanes of odd u / 2 read
// each pair of keys the other way round (kFlip: four selects; without, a
// two-way conflict and a register fewer, which the producer of three
// consumers, at 32 registers, cannot spare).
template <int DP, bool kFlip>
__device__ __forceinline__ void transform_tile(unsigned char* stage, int t,
                                               int nt, int bar) {
  constexpr int kW = Tile<DP>::kW, kBK = Tile<DP>::kBK, kT = kBK * DP * 4;
  constexpr int kChunks = Tile<DP>::kChunks;
  constexpr int kUs = 32 / kW;                      // u a warp takes at once
  constexpr int kJobs = kChunks * kBK / (4 * kUs);  // of 32 lanes each
  const int lane = t % 32, e = lane % kW, uu = lane / kW;
  const int flip = kFlip && kW == 8 ? uu >> 1 : 0;
  const unsigned char* v = stage + kT;
  for (int j = t / 32; j < kJobs; j += nt / 32) {
    const int blk = j % kChunks, u = j / kChunks * kUs + uu;
    const int key0 = 8 * (u / 2) + u % 2;
    const int col = blk * kBK * 4 * kW + e * 4;  // row 0 of head dim d
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      y[q] = *reinterpret_cast<const float*>(
          v + swizzle<4 * kW>(col + (key0 + 2 * (q ^ flip)) * 4 * kW));
    const float4 x = flip ? make_float4(y[1], y[0], y[3], y[2])
                          : make_float4(y[0], y[1], y[2], y[3]);
    float4 hi, lo;
    split4(x, hi, lo);
    const int off = vt_off<DP>(blk * kW + e, 4 * u);
    *reinterpret_cast<float4*>(stage + 2 * kT + off) = hi;
    *reinterpret_cast<float4*>(stage + 3 * kT + off) = lo;
  }
  named_sync(bar, nt);  // V is read: K_lo may take its place
  float4* k4 = reinterpret_cast<float4*>(stage);
  float4* klo4 = reinterpret_cast<float4*>(stage + kT);
  for (int i = t; i < kT / 16; i += nt) {
    float4 hi, lo;
    split4(k4[i], hi, lo);
    if constexpr (kRoundedSplit) k4[i] = hi;
    klo4[i] = lo;
  }
}

// K-major operand (Q or Q_lo as A, K or K_lo as B of S = Q.K^T): `rows`
// rows a column block; k step kk (head dims 8kk..8kk+7) lies in block
// 8kk / kW, at byte 4 * (8kk % kW) of its swizzled rows; 8-row groups
// 32 * kW bytes apart (the leading offset is unused at this swizzle)
template <int DP>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int rows, int kk) {
  constexpr int kW = Tile<DP>::kW;
  return make_desc(addr + (8 * kk / kW) * rows * kW * 4 + (8 * kk % kW) * 4,
                   16, 32 * kW, Tile<DP>::kLayout);
}

// V^T or V_lo^T as B of O += P.V (N = DP head dims, K-major): k step kk
// (key positions 8kk..8kk+7) in column block 8kk / kVW
template <int DP>
__device__ __forceinline__ uint64_t desc_vt(uint32_t addr, int kk) {
  constexpr int kVW = Tile<DP>::kVW;
  return make_desc(addr + (8 * kk / kVW) * DP * kVW * 4 + (8 * kk % kVW) * 4,
                   16, 32 * kVW, Tile<DP>::kVLayout);
}

[[maybe_unused]] __device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// d += a . b, m16n8k8, TF32 operands, f32 accumulators
[[maybe_unused]] __device__ __forceinline__ void mma_tf32(
    float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (+)= a . b, m64nNk8, TF32 operands, f32 accumulators, d overwritten
// when !acc; B from shared memory, K-major. `wgmma_ss`: A from shared
// memory, K-major; `wgmma_rs`: A from registers (the m16n8k8 A fragment of
// each warp's 16 rows: a0 (g, k = c), a1 (g + 8, c), a2 (g, c + 4), a3
// (g + 8, c + 4)). Each accumulator register d[i] of thread (warp w, lane
// 4g + c) holds row 16w + g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2c
// + (i & 1).
#define WGMMA_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_D8(i) WGMMA_D4(i), WGMMA_D4(i + 4)

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : WGMMA_D8(0)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : WGMMA_D4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : WGMMA_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D4(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),
        WGMMA_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),
        WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),
        WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56), WGMMA_D8(64), WGMMA_D8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef WGMMA_D8
#undef WGMMA_D4

// O += P_lo.V^T + P_hi.V_lo^T + P_hi.V^T over the tile's kBK / 8 k steps:
// `wgmma` (committed by the caller), or with kPvMmaSync each warp's
// `mma.sync` on its 16 rows, B fragments read from V^T: (k = c, n = g) and
// (k = c + 4, n = g) of n-tile j are positions 8kk + c and 8kk + c + 4 of
// row 8j + g
template <int DP>
__device__ __forceinline__ void pv(float (&o)[DP / 2],
                                   const uint32_t (&ph)[Tile<DP>::kBK / 8][4],
                                   const uint32_t (&pl)[Tile<DP>::kBK / 8][4],
                                   uint32_t vt, uint32_t vtl, int lane) {
#pragma unroll
  for (int kk = 0; kk < Tile<DP>::kBK / 8; ++kk) {
    if constexpr (kPvMmaSync) {
      const int g = lane / 4, c = lane % 4;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int o0 = vt_off<DP>(8 * j + g, 8 * kk + c);
        const int o1 = vt_off<DP>(8 * j + g, 8 * kk + c + 4);
        const uint32_t bh[2] = {lds32(vt + o0), lds32(vt + o1)};
        const uint32_t bl[2] = {lds32(vtl + o0), lds32(vtl + o1)};
        float acc[4] = {o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]};
        mma_tf32(acc, pl[kk], bh);
        mma_tf32(acc, ph[kk], bl);
        mma_tf32(acc, ph[kk], bh);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] = acc[e];
      }
    } else {
      wgmma_rs<DP>(o, pl[kk], desc_vt<DP>(vt, kk), 1);
      wgmma_rs<DP>(o, ph[kk], desc_vt<DP>(vtl, kk), 1);
      wgmma_rs<DP>(o, ph[kk], desc_vt<DP>(vt, kk), 1);
    }
  }
}

// ---- the kernel ---------------------------------------------------------

template <int DP, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), NC == 1 ? 2 : 1)
flash_fwd_sm90_f32(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ kv_mask, float* __restrict__ out,
                   int Tq, int Tk, int H, int D, float scale_log2,
                   int causal) {
  using L = Smem<DP, NC>;
  constexpr int kW = Tile<DP>::kW, kChunks = Tile<DP>::kChunks;
  constexpr int kBK = Tile<DP>::kBK, kStages = L::kStages;
  // the producer's warps 1-3, which transform the tiles
  constexpr int kXfThreads = 96;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const float* mask_s = reinterpret_cast<const float*>(sbase + L::kMask);
  const uint32_t full = base + L::kBar, ready = full + 8 * kStages;
  const uint32_t empty = ready + 8 * kStages, qbar = empty + 8 * kStages;

  const int q0 = blockIdx.x * kRows * NC, h = blockIdx.y, b = blockIdx.z;
  const bool masked = kv_mask != nullptr;
  int n_tiles = (Tk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows * NC - 1) / kBK + 1);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, masked ? 33 : 1);
      mbar_init(ready + 8 * s, kTransformByProducer ? kXfThreads : 1);
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
    setmaxnreg_dec<Regs<NC>::kProducer>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 128 * NC + 32) {
      // ---- warp 0: the loads; its lane 0 issues the TMA copies ----
      if (lane == 0) {
        mbar_expect_tx(qbar, NC * L::kQWg);
        for (int w = 0; w < NC; ++w)
          for (int c = 0; c < kChunks; ++c)
            tma_load_4d(base + w * L::kQWg + c * kRows * kW * 4, &tm_q, qbar,
                        c * kW, h, q0 + w * kRows, b);
      }
      const float* mb = masked ? kv_mask + (int64_t)b * Tk : nullptr;
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int st = tile % kStages, k0 = tile * kBK;
        mbar_wait(empty + 8 * st, ((tile / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, 2 * L::kT);
          const uint32_t ks = base + L::kStage0 + st * L::kStageBytes;
          for (int c = 0; c < kChunks; ++c) {
            tma_load_4d(ks + c * kBK * kW * 4, &tm_k, full + 8 * st, c * kW,
                        h, k0, b);
            tma_load_4d(ks + L::kT + c * kBK * kW * 4, &tm_v, full + 8 * st,
                        c * kW, h, k0, b);
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
    } else if (kTransformByProducer) {
      // ---- warps 1-3: each tile's transform, once it has landed ----
      const int t = threadIdx.x - 128 * NC - 32;
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int st = tile % kStages;
        mbar_wait(full + 8 * st, (tile / kStages) & 1);
        transform_tile<DP, (Regs<NC>::kProducer >= 40)>(
            sbase + L::kStage0 + st * L::kStageBytes, t, kXfThreads, 4);
        fence_proxy_async();
        mbar_arrive(ready + 8 * st);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows row0 .. row0 + 63 ----
  // (the registers the producer gave up, shared by the consumers)
  setmaxnreg_inc<Regs<NC>::kConsumer>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, c = lane % 4;  // fragment row group, column pair
  const int row0 = q0 + wg * kRows;
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;  // this thread's
  const uint32_t q_s = base + wg * L::kQWg;
  const uint32_t qlo_s = base + L::kQLo + wg * L::kQWg;

  // Q's hi part in place and its lo part beside it, for this warpgroup's
  // rows
  mbar_wait(qbar, 0);
  {
    float4* q4 = reinterpret_cast<float4*>(sbase + wg * L::kQWg);
    float4* qlo4 = reinterpret_cast<float4*>(sbase + L::kQLo + wg * L::kQWg);
    for (int i = t; i < L::kQWg / 16; i += 128) {
      float4 hi, lo;
      split4(q4[i], hi, lo);
      q4[i] = hi;
      qlo4[i] = lo;
    }
    fence_proxy_async();
    named_sync(6 + wg, 128);
  }

  float o[DP / 2], s[kBK / 2];
  // P's hi and lo parts as the A fragments of P.V, one per k step
  uint32_t p_hi[kBK / 8][4], p_lo[kBK / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // consumer warpgroups take turns to issue their products, warpgroup 0
  // first (named barrier 1 + w is warpgroup w's turn): one's softmax then
  // runs while the next one's products hold the tensor cores
  const int next_turn = 1 + (wg + 1) % NC;
  if (NC > 1 && wg == NC - 1) named_arrive(1, 256);

  // Software pipeline: in each turn a warpgroup issues S = Q.K^T of tile j
  // and O += P.V of the last live tile before it (its P in p_hi / p_lo, its
  // stage `pend` still held), then runs the softmax of tile j while P.V
  // runs, and releases stage `pend` once P.V is done.
  int pend = -1;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % kStages, k0 = tile * kBK;
    if constexpr (kTransformByProducer) {
      mbar_wait(ready + 8 * st, (tile / kStages) & 1);
    } else {
      mbar_wait(full + 8 * st, (tile / kStages) & 1);
      transform_tile<DP, true>(sbase + L::kStage0 + st * L::kStageBytes,
                               threadIdx.x, 128 * NC, 5);
      fence_proxy_async();
      named_sync(5, 128 * NC);
    }
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
    const uint32_t ks = base + L::kStage0 + st * L::kStageBytes;
    const uint32_t vt =
        base + L::kStage0 + (held ? pend : 0) * L::kStageBytes + 2 * L::kT;

    // The turn is taken whether the tile is live or not (the last
    // warpgroup's last turn has no taker and stays open). Each branch waits
    // for what it issued itself, so that ptxas can follow the groups.
    if (NC > 1) named_sync(1 + wg, 256);
    float alpha[2] = {1.f, 1.f};
    if (live) {
      // S = Q.K^T for the warpgroup's 64 rows and the tile's kBK keys, the
      // small terms first, then O += P.V of the held tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const uint64_t kd = desc_k<DP>(ks, kBK, kk);
        const uint64_t klo = desc_k<DP>(ks + L::kT, kBK, kk);
        wgmma_ss<kBK>(s, desc_k<DP>(qlo_s, kRows, kk), kd, kk > 0);
        wgmma_ss<kBK>(s, desc_k<DP>(q_s, kRows, kk), klo, 1);
        wgmma_ss<kBK>(s, desc_k<DP>(q_s, kRows, kk), kd, 1);
      }
      wgmma_commit();
      if (held) {
        pv<DP>(o, p_hi, p_lo, vt, vt + L::kT, lane);
        if constexpr (kPvMmaSync) {
          if (NC > 1) named_arrive(next_turn, 256);
          wgmma_wait<0>();
        } else {
          wgmma_commit();
          if (NC > 1) named_arrive(next_turn, 256);
          wgmma_wait<1>();  // S: the older group
        }
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
        pv<DP>(o, p_hi, p_lo, vt, vt + L::kT, lane);
        if constexpr (!kPvMmaSync) wgmma_commit();
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
      // P's hi and lo parts as the A fragments of the kBK / 8 k steps: k =
      // c is key 2c, k = c + 4 key 2c + 1 of the step's 8 keys (V^T's
      // order), so a0..a3 are accumulators 0, 2, 1, 3 of n-tile kk
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float hi, lo;
          split(s[4 * kk + ((r & 1) << 1) + (r >> 1)], hi, lo);
          p_hi[kk][r] = __float_as_uint(hi);
          p_lo[kk][r] = __float_as_uint(lo);
        }
      pend = st;
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
  }
  if (__any_sync(0xffffffffu, pend >= 0)) {
    const uint32_t vt =
        base + L::kStage0 + pend * L::kStageBytes + 2 * L::kT;
    wgmma_fence();
    pv<DP>(o, p_hi, p_lo, vt, vt + L::kT, lane);
    if constexpr (!kPvMmaSync) wgmma_commit();
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
  float* ob = out + (int64_t)b * Tq * rs + (int64_t)h * D;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = 8 * n + 2 * c;
    if (d >= D) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r_hi : r_lo;
      if (row >= Tq) continue;
      *reinterpret_cast<float2*>(ob + row * rs + d) =
          make_float2(o[4 * n + 2 * r] * inv[r], o[4 * n + 2 * r + 1] * inv[r]);
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

// the 4-D view (D, H, T, B) of a contiguous f32 [B, T, H, D] tensor, in
// boxes of (kW, 1, rows, 1): the head dim past D and rows past T read 0
template <int DP>
bool encode_rows(CUtensorMap* map, const void* ptr, const Args& a, int T,
                 int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)a.H,
                              (cuuint64_t)T, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.D * 4,
                                 (cuuint64_t)a.H * a.D * 4,
                                 (cuuint64_t)T * a.H * a.D * 4};
  const cuuint32_t box[4] = {(cuuint32_t)Tile<DP>::kW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<DP>::kSwizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NC>
int launch(const Args& a) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const cudaError_t err = configure<Smem<DP, NC>>(flash_fwd_sm90_f32<DP, NC>,
                                                  Smem<DP, NC>::kBytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq{}, tk{}, tv{};
  if (!encode_rows<DP>(&tq, a.q, a, a.Tq, kRows) ||
      !encode_rows<DP>(&tk, a.k, a, a.Tk, Tile<DP>::kBK) ||
      !encode_rows<DP>(&tv, a.v, a, a.Tk, Tile<DP>::kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Tq + kRows * NC - 1) / (kRows * NC), a.H, a.B);
  flash_fwd_sm90_f32<DP, NC><<<grid, 128 * (NC + 1), Smem<DP, NC>::kBytes,
                               a.stream>>>(
      tq, tk, tv, a.mask, (float*)a.out, a.Tq, a.Tk, a.H, a.D, a.scale_log2,
      a.causal);
  return (int)cudaGetLastError();
}

// Consumer warpgroups a block, n (64n query rows, K and V shared by all;
// with two or three, they take turns on the tensor cores): the n whose
// grid costs the least, ceil(blocks / SMs) * 64n / rate(n), with rate(n)
// the query rows an SM computes per unit of time at that n relative to n =
// 1, up to the head dim's most (`Tile`). Ties go to the larger n. The
// rates are those of the class's largest grid, measured with
// `kernel_variants.py`'s "64-row" to "192-row blocks" (H100:
// `t2i_self_ds1`, `asr_long_encoder`, `t2i_self_ds2`); with them the rule
// picks the fastest of the three at each of the attention paths' 21 shapes
// without a key mask or a causal one.
constexpr float kRate[3][3] = {
    {1.f, 1.53f, 1.81f},  // DP <= 48
    {1.f, 1.45f, 1.81f},  // DP = 64
    {1.f, 1.54f, 0.f},    // DP = 80 .. 160 (at most 2: `Tile`)
};

template <int DP>
int consumers(int B, int Tq, int H) {
  const int sms = sm_count();
  if (sms == 0) return 1;
  const float* rate = kRate[DP <= 48 ? 0 : DP == 64 ? 1 : 2];
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

// the block's consumer warpgroups, n, as a compile-time count no larger
// than the head dim allows
template <int DP, typename F>
int with_consumers(int n, F&& f) {
  constexpr int kMax = Tile<DP>::kMaxConsumers;
  switch (n) {
    case 3:
      return f(std::integral_constant<int, kMax>());
    case 2:
      return f(std::integral_constant<int, kMax < 2 ? kMax : 2>());
    default:
      return f(std::integral_constant<int, 1>());
  }
}

template <int DP>
int run(const Args& a) {
  return with_consumers<DP>(consumers<DP>(a.B, a.Tq, a.H), [&](auto nc) {
    return launch<DP, decltype(nc)::value>(a);
  });
}

template <int DP>
int occupancy(int B, int Tq, int H, int* block_q, int* blocks_per_sm) {
  return with_consumers<DP>(consumers<DP>(B, Tq, H), [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    *block_q = kRows * NC;
    const cudaError_t err = configure<Smem<DP, NC>>(
        flash_fwd_sm90_f32<DP, NC>, Smem<DP, NC>::kBytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, flash_fwd_sm90_f32<DP, NC>, 128 * (NC + 1),
        Smem<DP, NC>::kBytes);
  });
}

// the head dim padded up to one of the compiled widths: F(DP) for the
// first DP >= D. Nothing wider than 160 is compiled: no path of the JAX
// package runs a wider head (whisper 64, CLIP 80, UNet 40/80/160, BLIP
// 64/96).
template <typename F>
int dispatch(int D, F&& f) {
  if (D <= 8) return f(std::integral_constant<int, 8>());
  if (D <= 16) return f(std::integral_constant<int, 16>());
  if (D <= 32) return f(std::integral_constant<int, 32>());
  if (D <= 40) return f(std::integral_constant<int, 40>());
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
// and out are contiguous f32 [B, T, H, D] with D % 4 == 0, 16-byte
// aligned; kv_mask (nullable) contiguous f32 [B, Tk].
extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v,
                        const void* kv_mask, void* out, int B, int Tq, int Tk,
                        int H, int D, float scale, int causal, void* stream) {
  const Args a{q, k, v, (const float*)kv_mask, out, B, Tq, Tk, H, D,
               scale * 1.4426950408889634f, causal, (cudaStream_t)stream};
  if (D % 4 != 0) return (int)cudaErrorInvalidValue;
  return dispatch(D, [&](auto dp) { return run<decltype(dp)::value>(a); });
}

// the f32 kernel's block shape for q [B, Tq, H, D] on the current device:
// query rows a block and resident blocks per SM, for the launch report
int flash_attention_occupancy(int B, int Tq, int H, int D, int* block_q,
                              int* blocks_per_sm) {
  return dispatch(D, [&](auto dp) {
    return occupancy<decltype(dp)::value>(B, Tq, H, block_q, blocks_per_sm);
  });
}

}  // extern "C"
