// Blockwise (flash) attention forward on the tensor cores, for f32 q/k/v
// [B, T, H, D]; the bf16 entry is csrc/flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_forward` of
// audiogpt_tpu/ops/flash_attention.py for f32 inputs. Semantics follow
// `_flash_kernel`: scale D^-0.5, an optional key-padding mask [B, Tk] (> 0 =
// valid), causal masking aligned top-left (key j is visible to query i when
// j <= i), key tiles wholly above the diagonal skipped, f32 running max, sum
// and output accumulators. A query row with no valid key returns 0: masked
// logits are -inf and never enter the sums, and the exponent base of such a
// row is taken as 0.
//
// Bound on the H100: operations. At the UNet shape [6, 780, 8, 40] the two
// products do 4*B*H*Tq*Tk*D = 4.7 GFLOP on 24 MB, ~195 FLOP per byte. Both
// products run on the tensor cores with `mma.sync` m16n8k8 TF32 -> f32,
// three products per tile pair ("3xTF32": each operand x = hi + lo, and a.b
// ~ hi.hi + hi.lo + lo.hi, dropping only lo.lo), so the f32 contract (1e-4
// against the plain version) holds where one TF32 product (~2^-10 relative
// per operand) would not. The split truncates: hi = x with its low 13
// mantissa bits cleared (one LOP), lo = x - hi (exact), which the tensor
// core reads as TF32 by dropping its own low 13 bits, so each product is
// off by ~2^-20 relative (5e-6 max abs at the UNet shape). Rounding both
// halves with cvt.rna.tf32 (~2^-22) takes 0.164 ms there against 0.115
// (`kernel_variants.py`), for no need of the contract. Bound: 495/3
// TFLOP/s.
// `mma.sync` rather than `wgmma`: TF32 `wgmma` takes only K-major operands
// from shared memory, so P.V would need V transposed on its way in (which a
// 16-byte `cp.async` of a V row cannot do) and P written back to shared
// memory; `mma.sync` takes A from registers, so S = Q.K^T stays in
// registers and becomes P, the A operand of P.V, with no round trip (the
// key order inside each 8-key step is permuted to match the accumulator
// layout: logical k = c <-> key 2c, k = c + 4 <-> key 2c + 1).
//
// Design: a block of 4 warps owns 64 query rows (16 per warp, Q fragments
// held in registers for the whole pass, but see D > 128 below) and streams
// 64-key tiles of K and V
// through a two-stage shared-memory ring filled by 16-byte `cp.async`, with
// one barrier per tile, after which the copy of tile j+1 starts and overlaps
// the products of tile j. Up to 5 blocks share an SM (`Layout::kMinBlocks`),
// and tiles whose keys the mask drops entirely are skipped. The head dim is
// padded with zeros in shared memory to DP, a multiple of the MMA's k step
// 8, so D = 40, 80 or 160 work; rows are copied in 16-byte pieces, so D
// must be a multiple of 4 (the wrapper raises otherwise). Row strides in
// shared memory are padded so that every fragment load is free of bank
// conflicts. The online softmax (running max and sum per row) is computed
// on the accumulator fragments, with the row max reduced over the 4 lanes
// that share a row.
//
// D > 128 (DP = 160, the SD UNet's 1280-channel level at 8 heads): holding
// Q (20 k steps x 4 = 80 registers), the O accumulator (160 / 8 x 4 = 80)
// and the S tile (32) live together takes 192 registers before any address
// or split temporary, which ptxas can hold only by spilling at 255. So at
// DP > 128 the block copies its 64 Q rows into shared memory once, with the
// first K/V tile (64 x 168 x 4 B = 42 KB beside the ring's 2 x 85 KB: 209
// KB of the 227 KB a block may take, one block per SM), and each warp reads
// its A fragments from there at every key tile, as it reads K: 10 KB a tile
// against K's 40 KB, read with the same conflict-free stride. Nothing wider
// than 160 is compiled: no path of the JAX package runs a wider head
// (whisper 64, CLIP 80, UNet 40/80/160, BLIP 64/96).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBK = 64;           // keys per tile
constexpr int kStages = 2;        // K/V tiles in flight

// ---- copies -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src must stay legal)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- tensor-core fragments ----------------------------------------------

// x = hi + lo: hi is x truncated to TF32 (10 mantissa bits), lo the exact
// rest, which the MMA truncates to TF32 in turn
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x, one MUFU op (ex2.approx: ~2^-22 relative; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- shared-memory layout -----------------------------------------------

// Per stage: K [kBK][SK] then V [kBK][SV]; after all stages, the tile's
// key mask [kStages][kBK]. Strides (in elements) keep fragment loads
// conflict-free: K is read as float2 by (key g, dims 2c..2c+1), which needs
// SK = 8 or 24 mod 32; V as scalars at (keys 2c, 2c+1, dim g), which needs
// SV = 4 mod 8.
template <int DP>
struct Layout {
  static constexpr int kSK = DP % 16 == 0 ? DP + 8 : DP;
  static constexpr int kSV = DP + 4;
  static constexpr int kStage = kBK * (kSK + kSV);
  // at DP > 128 Q is kept in shared memory (rows read like K's)
  static constexpr bool kQSmem = DP > 128;
  static constexpr int kSQ = kSK;
  static constexpr int kQOffset =
      kStages * (kStage * (int)sizeof(float) + kBK * (int)sizeof(float));
  static constexpr int kBytes =
      kQOffset + (kQSmem ? kBQ * kSQ * (int)sizeof(float) : 0);
  // resident blocks asked of ptxas: as many as the SM's 228 KB of shared
  // memory holds (1 KB reserved per block), at most 5. Five blocks of 4
  // warps put the UNet's 624-block grid in one wave (3 would need 1.6), at
  // the price of a few spilled registers. `kernel_variants.py` measures the
  // rule against no request: at [2, 1500, 6, 64] 0.185 against 0.233 ms; at
  // the UNet shape 5 % faster without it.
  static constexpr int kFit = 233472 / (kBytes + 1024);
  static constexpr int kMinBlocks = kFit < 5 ? (kFit < 1 ? 1 : kFit) : 5;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, Layout<DP>::kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ kv_mask, float* __restrict__ out,
                 int Tq, int Tk, int H, int D, float scale_log2, int causal) {
  using L = Layout<DP>;
  constexpr int kStep = 8;                      // MMA k step (head dim)
  constexpr int kPerChunk = 4;                  // elements per 16-byte copy
  static_assert(DP % kStep == 0, "head dim pad");

  extern __shared__ __align__(16) unsigned char smem[];
  float* kv_s = reinterpret_cast<float*>(smem);
  float* mask_s = reinterpret_cast<float*>(
      smem + kStages * L::kStage * sizeof(float));
  [[maybe_unused]] float* q_s =
      reinterpret_cast<float*>(smem + L::kQOffset);  // kQSmem only

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // fragment row group, column pair
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t rs = (int64_t)H * D;      // stride of one time step
  const float* qb = q + (int64_t)b * Tq * rs + (int64_t)h * D;
  const float* kb = k + (int64_t)b * Tk * rs + (int64_t)h * D;
  const float* vb = v + (int64_t)b * Tk * rs + (int64_t)h * D;
  float* ob = out + (int64_t)b * Tq * rs + (int64_t)h * D;
  const float* mb = kv_mask ? kv_mask + (int64_t)b * Tk : nullptr;
  const int chunks = D / kPerChunk;       // 16-byte copies per row

  // the head-dim pad [D, DP) of every stage is zeroed once; no copy touches it
  const int pad = DP / kPerChunk - chunks;
  for (int i = tid; i < kStages * 2 * kBK * pad; i += kThreads) {
    const int row = i / pad, ch = chunks + i % pad;
    const int st = row / (2 * kBK), r = row % kBK;
    float* base = kv_s + st * L::kStage +
                  ((row / kBK) & 1 ? kBK * L::kSK + r * L::kSV : r * L::kSK);
    *reinterpret_cast<float4*>(base + ch * kPerChunk) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if constexpr (L::kQSmem) {
    // Q's pad, then its rows (zero-filled past Tq), in tile 0's copy group
    for (int i = tid; i < kBQ * pad; i += kThreads)
      *reinterpret_cast<float4*>(q_s + (i / pad) * L::kSQ +
                                 (chunks + i % pad) * kPerChunk) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < kBQ * chunks; i += kThreads) {
      const int r = i / chunks, ch = i - r * chunks;
      const bool in = q0 + r < Tq;
      cp_async16(q_s + r * L::kSQ + ch * kPerChunk,
                 qb + (int64_t)(in ? q0 + r : 0) * rs + ch * kPerChunk, in);
    }
  }

  auto load_tile = [&](int tile, int st) {
    const int k0 = tile * kBK;
    float* ks = kv_s + st * L::kStage;
    float* vs = ks + kBK * L::kSK;
    for (int i = tid; i < kBK * chunks; i += kThreads) {
      const int r = i / chunks, ch = i - r * chunks;
      const bool in = k0 + r < Tk;  // the ragged tail is zero-filled
      const int64_t off = (int64_t)(in ? k0 + r : 0) * rs + ch * kPerChunk;
      cp_async16(ks + r * L::kSK + ch * kPerChunk, kb + off, in);
      cp_async16(vs + r * L::kSV + ch * kPerChunk, vb + off, in);
    }
    if (mb != nullptr && tid < kBK) {
      const bool in = k0 + tid < Tk;
      cp_async4(mask_s + st * kBK + tid, mb + (in ? k0 + tid : 0), in);
    }
    cp_async_commit();
  };

  // this thread's two query rows
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;

  // Q fragments, held for the whole pass (A operand of S = Q.K^T), as f32
  // values (split into TF32 halves once per k step and tile, which keeps 20
  // fewer registers live than holding both halves); none where Q is in
  // shared memory
  constexpr int kQS = DP / kStep;
  float qa[L::kQSmem ? 1 : kQS][4];
#pragma unroll
  for (int s = 0; s < (L::kQSmem ? 0 : kQS); ++s) {
    // a0 = (g, k=c) <-> dim 2c, a2 = (g, k=c+4) <-> dim 2c+1; a1, a3 row g+8
    const int d = s * 8 + 2 * c;
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (d < D && r_lo < Tq)
      lo = *reinterpret_cast<const float2*>(qb + r_lo * rs + d);
    if (d < D && r_hi < Tq)
      hi = *reinterpret_cast<const float2*>(qb + r_hi * rs + d);
    qa[s][0] = lo.x, qa[s][1] = hi.x, qa[s][2] = lo.y, qa[s][3] = hi.y;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  int n_tiles = (Tk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);
  load_tile(0, 0);

  // One barrier per tile: after it, tile `tile` is in stage st for every
  // thread and every thread is done with tile - 1, so the copy of tile + 1
  // into the other stage starts there and overlaps this tile's products.
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1, k0 = tile * kBK;
    cp_async_wait<0>();
    // a tile whose keys the mask all drops adds nothing (alpha = 1, p = 0)
    bool any = true;
    if (mb == nullptr) {
      __syncthreads();
    } else {
      any = __syncthreads_or(tid < kBK && k0 + tid < Tk &&
                             mask_s[st * kBK + tid] > 0.f);
    }
    if (tile + 1 < n_tiles) load_tile(tile + 1, st ^ 1);
    if (!any) continue;
    const float* ks = kv_s + st * L::kStage;
    const float* vs = ks + kBK * L::kSK;

    // S = Q.K^T for this warp's 16 rows and the tile's 64 keys: s[n] is the
    // accumulator of keys 8n..8n+7 (c0, c1: row g, keys 2c, 2c+1; c2, c3:
    // row g+8)
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int t = 0; t < kQS; ++t) {
      float qf[4];
      if constexpr (L::kQSmem) {
        // the a0..a3 layout of the register path, from this warp's rows
        const float* qr = q_s + (warp * 16 + g) * L::kSQ + t * 8 + 2 * c;
        const float2 lo = *reinterpret_cast<const float2*>(qr);
        const float2 hi = *reinterpret_cast<const float2*>(qr + 8 * L::kSQ);
        qf[0] = lo.x, qf[1] = hi.x, qf[2] = lo.y, qf[3] = hi.y;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[i] = qa[t][i];
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(qf[i], ah[i], al[i]);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        // b0 = (k=c, key g) <-> dim 2c, b1 = (k=c+4, key g) <-> dim 2c+1
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (n * 8 + g) * L::kSK + t * 8 + 2 * c);
        uint32_t bh[2], bl[2];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        mma_tf32(s[n], al, bh);
        mma_tf32(s[n], ah, bl);
        mma_tf32(s[n], ah, bh);
      }
    }

    // mask (ragged tail, key padding, causal) and the online softmax in
    // base 2: p = 2^(s * scale * log2(e) - m), m the running max in the
    // same units (the max is taken on s: the scale is positive)
    const bool edge = mb != nullptr || k0 + kBK > Tk ||
                      (causal && k0 + kBK - 1 > q0 + warp * 16);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int col = n * 8 + 2 * c + (e & 1);
          const int key = k0 + col, row = e >> 1 ? r_hi : r_lo;
          const bool ok = key < Tk &&
                          (mb == nullptr || mask_s[st * kBK + col] > 0.f) &&
                          (!causal || key <= row);
          if (!ok) s[n][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i] * scale_log2);
      base[i] = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet
      alpha[i] = fast_exp2(m_run[i] - base[i]);
      m_run[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp2(fmaf(s[n][e], scale_log2, -base[e >> 1]));
        sum[e >> 1] += s[n][e];
      }
    }
    // l is kept per lane (the row's 4 lanes are summed once at the end)
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + sum[i];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // acc += P.V; P (the S accumulators) is the A operand, from registers
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      // logical k = c <-> key 8n+2c, k = c+4 <-> key 8n+2c+1
      uint32_t ah[4], al[4];
      split_tf32(s[n][0], ah[0], al[0]);
      split_tf32(s[n][2], ah[1], al[1]);
      split_tf32(s[n][1], ah[2], al[2]);
      split_tf32(s[n][3], ah[3], al[3]);
      const float* v0 = vs + (n * 8 + 2 * c) * L::kSV + g;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        uint32_t bh[2], bl[2];
        split_tf32(v0[j * 8], bh[0], bl[0]);
        split_tf32(v0[L::kSV + j * 8], bh[1], bl[1]);
        mma_tf32(acc[j], al, bh);
        mma_tf32(acc[j], ah, bl);
        mma_tf32(acc[j], ah, bh);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = l == 0.f ? 0.f : 1.f / l;
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int d = j * 8 + 2 * c;
    if (d >= D) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? r_hi : r_lo;
      if (row >= Tq) continue;
      const float o0 = acc[j][2 * i] * inv[i], o1 = acc[j][2 * i + 1] * inv[i];
      *reinterpret_cast<float2*>(ob + row * rs + d) = make_float2(o0, o1);
    }
  }
}

struct Args {
  const float *q, *k, *v;
  const float* mask;
  float* out;
  int B, Tq, Tk, H, D;
  float scale_log2;
  int causal;
  cudaStream_t stream;
  int* blocks_per_sm;  // set: report occupancy instead of launching
};

// the most devices one process configures the kernels on
constexpr int kMaxDevices = 64;

// The dynamic shared memory a launch of flash_fwd_kernel<DP> may take is
// an attribute of the kernel on one device (its context), so it is set once
// for each device the process launches on, on that device: the caller's
// current one, where the launch goes too. A process may launch from several
// threads, one per card or several on one card, so the check is an atomic
// flag and the set-up runs under a lock.
template <int DP>
cudaError_t configure(int smem) {
  static std::atomic<bool> done[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <int DP>
int run(const Args& a) {
  constexpr int smem = Layout<DP>::kBytes;
  const cudaError_t err = configure<DP>(smem);
  if (err != cudaSuccess) return (int)err;
  if (a.blocks_per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks_per_sm, flash_fwd_kernel<DP>, kThreads, smem);
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.out, a.Tq, a.Tk, a.H, a.D, a.scale_log2,
      a.causal);
  return (int)cudaGetLastError();
}

// the head dim padded up to one of the compiled widths
int dispatch(const Args& a) {
  if (a.D <= 8) return run<8>(a);
  if (a.D <= 16) return run<16>(a);
  if (a.D <= 32) return run<32>(a);
  if (a.D <= 40) return run<40>(a);
  if (a.D <= 48) return run<48>(a);
  if (a.D <= 64) return run<64>(a);
  if (a.D <= 80) return run<80>(a);
  if (a.D <= 96) return run<96>(a);
  if (a.D <= 128) return run<128>(a);
  if (a.D <= 160) return run<160>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The entry launches on the calling thread's current device, on `stream`,
// which must be a stream of that device: the wrapper
// (ops/flash_attention.py) makes the tensors' card current first.
extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v,
                        const void* kv_mask, void* out, int B, int Tq, int Tk,
                        int H, int D, float scale, int causal, void* stream) {
  return dispatch(Args{(const float*)q, (const float*)k, (const float*)v,
                       (const float*)kv_mask, (float*)out, B, Tq, Tk, H, D,
                       scale * 1.4426950408889634f, causal,
                       (cudaStream_t)stream, nullptr});
}

// resident blocks per SM of the kernel that takes head dim D, for the
// launch report (blocks and waves)
int flash_attention_occupancy(int D, int* blocks_per_sm) {
  Args a{};
  a.D = D;
  a.blocks_per_sm = blocks_per_sm;
  return dispatch(a);
}

}  // extern "C"
