// Blockwise (flash) attention forward, f32, for q/k/v [B, T, H, D].
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_forward` of
// audiogpt_tpu/ops/flash_attention.py. Semantics follow `_flash_kernel`:
// scale D^-0.5, an optional key-padding mask [B, Tk] (> 0 = valid), causal
// masking aligned top-left (key j is visible to query i when j <= i), key
// tiles wholly above the diagonal skipped, f32 accumulators. A query row
// with no valid key returns 0 (the Pallas kernel's `l == 0` guard; here the
// masked logits are -inf and never enter the sums, so the guard holds).
//
// Bound on the H100: operations. At the UNet shape [6, 780, 8, 40] the two
// products do 4*B*H*Tq*Tk*D = 4.7 GFLOP on 22 MB of q/k/v/out, ~210 FLOP
// per byte, and f32 has no tensor-core path, so the floor is the 67 TFLOP/s
// of the FMA units. The design keeps the Tq x Tk scores out of device
// memory and spends its shared-memory traffic on FMAs: a block of 128
// threads owns a 64-row query tile and streams 64-key tiles of K and V
// through shared memory (one pass over Tk, online softmax with the running
// max and sum in registers). Each thread computes a 4 x 8 register tile of
// the scores from float4 shared loads (3 loads per 32 FMAs), and a 4-row x
// (DP/8)-column tile of the output. The head dim is padded inside the tile
// to DP, a multiple of 8 (zeros add nothing to either product), so any
// D <= 128 works, D = 40 and 80 included. Tensor cores (TF32/bf16 wgmma)
// are left for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 16 row groups (ty) x 8 column groups (tx)
constexpr int kQS = kBQ + 4;    // row stride of the transposed Q tile
constexpr int kKS = kBK + 4;    // row stride of the transposed K tile
constexpr int kPS = kBK + 1;    // row stride of the probability tile

template <int DP>
constexpr int smem_floats() {
  return DP * kQS + DP * kKS + kBK * DP + kBQ * kPS + kBK;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ kv_mask,
                 float* __restrict__ out, int Tq, int Tk, int H, int D,
                 float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [DP][kQS]  q^T
  float* k_s = q_s + DP * kQS;                   // [DP][kKS]  k^T
  float* v_s = k_s + DP * kKS;                   // [kBK][DP]
  float* p_s = v_s + kBK * DP;                   // [kBQ][kPS] probabilities
  float* m_s = p_s + kBQ * kPS;                  // [kBK] key validity

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int64_t rs = (int64_t)H * D;  // stride of one time step
  const float* qb = q + (int64_t)b * Tq * rs + (int64_t)h * D;
  const float* kb = k + (int64_t)b * Tk * rs + (int64_t)h * D;
  const float* vb = v + (int64_t)b * Tk * rs + (int64_t)h * D;
  float* ob = out + (int64_t)b * Tq * rs + (int64_t)h * D;
  const float* mb = kv_mask ? kv_mask + (int64_t)b * Tk : nullptr;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    q_s[d * kQS + r] = (q0 + r < Tq && d < D) ? qb[(q0 + r) * rs + d] : 0.f;
  }

  float acc[4][DP / 8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Tk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's k_s / v_s / p_s are consumed
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int c = idx / DP, d = idx % DP;
      const bool in = k0 + c < Tk && d < D;
      k_s[d * kKS + c] = in ? kb[(k0 + c) * rs + d] : 0.f;
      v_s[c * DP + d] = in ? vb[(k0 + c) * rs + d] : 0.f;
    }
    for (int c = tid; c < kBK; c += kThreads) {
      const int kp = k0 + c;
      m_s[c] = (kp < Tk && (mb == nullptr || mb[kp] > 0.f)) ? 1.f : 0.f;
    }
    __syncthreads();

    // scores for rows ty*4+i, keys tx*8+j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_s + d * kQS + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(k_s + d * kKS + tx * 8);
      const float4 b1 =
          *reinterpret_cast<const float4*>(k_s + d * kKS + tx * 8 + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, online softmax; a row's 64 keys live on the 8 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx * 8 + j;
        const bool valid = m_s[c] > 0.f && (!causal || k0 + c <= qp);
        s[i][j] = valid ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const bool none = m_new == -INFINITY;  // no valid key yet in this row
      const float alpha = none ? 1.f : expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = none ? 0.f : expf(s[i][j] - m_new);
        p_s[(ty * 4 + i) * kPS + tx * 8 + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = alpha * l_run[i] + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc[rows ty*4+i][cols tx+8c] += p[rows][keys] @ v[keys][cols]
    const int n_keys = min(kBK, Tk - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(ty * 4 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const float vv = v_s[kk * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
    const float inv_l = l_run[i] == 0.f ? 0.f : 1.f / l_run[i];
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int d = tx + 8 * c;
      if (d < D) ob[qp * rs + d] = acc[i][c] * inv_l;
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           void* out, int B, int Tq, int Tk, int H, int D, float scale,
           int causal, cudaStream_t stream) {
  const int smem = smem_floats<DP>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const float*)kv_mask, (float*)out, Tq, Tk, H, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* kv_mask, void* out, int B,
                                   int Tq, int Tk, int H, int D, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32) return launch<32>(q, k, v, kv_mask, out, B, Tq, Tk, H, D, scale, causal, s);
  if (D <= 40) return launch<40>(q, k, v, kv_mask, out, B, Tq, Tk, H, D, scale, causal, s);
  if (D <= 48) return launch<48>(q, k, v, kv_mask, out, B, Tq, Tk, H, D, scale, causal, s);
  if (D <= 64) return launch<64>(q, k, v, kv_mask, out, B, Tq, Tk, H, D, scale, causal, s);
  if (D <= 80) return launch<80>(q, k, v, kv_mask, out, B, Tq, Tk, H, D, scale, causal, s);
  if (D <= 96) return launch<96>(q, k, v, kv_mask, out, B, Tq, Tk, H, D, scale, causal, s);
  if (D <= 128) return launch<128>(q, k, v, kv_mask, out, B, Tq, Tk, H, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
