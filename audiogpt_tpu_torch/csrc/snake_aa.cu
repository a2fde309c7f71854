// Fused anti-aliased snake for BigVGAN: up2x -> snake(beta) -> down2x.
//
// Replaces the Pallas TPU kernel `_kernel` / `snake_aa_pallas` of
// audiogpt_tpu/ops/snake_aa.py. Same polyphase math, written for the torch
// layout x [B, C, T] with T contiguous:
//
//   e[u] = sum_a up[2a]   * x[clip(u+a-3)]     (up = kaiser-sinc taps * 2)
//   o[u] = sum_a up[2a+1] * x[clip(u+a-2)]
//   s_e = snake(e), s_o = snake(o),  snake(v) = v + sin^2(alpha v) / (beta + 1e-9)
//   out[t] = sum_b dn[2b+1] * SE[t+b-2] + dn[2b] * SO[t+b-3]
//
// where SE / SO extend s_e / s_o past the global ends by the down stage's
// replicate padding of the interleaved 2x signal: positions < 0 read s_e[0],
// positions > T-1 read s_o[T-1] (audiogpt_tpu/ops/snake_aa.py:67-74).
//
// Bound on the H100: memory. Per output sample the kernel reads one input
// and writes one output (8 bytes in f32) against ~30 FMAs and two sines,
// far below the card's ~20 FLOP/byte f32 balance point. The design keeps
// the 2x intermediate out of device memory entirely: each block loads one
// row tile of x with a 6-sample halo on each side into shared memory once
// (coalesced, clamped at the row ends), computes both snake phases for the
// tile plus a 3-sample margin into shared memory, and runs the stride-2 down
// FIR from there. Device traffic is the input once (plus 12 halo samples
// per tile) and the output once. The TPU kernel's lane fold of batch into
// channels has no counterpart here: a warp runs along T, never along C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // output samples per block
constexpr int kHalo = 6;                      // input halo on each side
constexpr int kMargin = 3;                    // phase margin on each side

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_aa_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                const float* __restrict__ beta, T* __restrict__ out,
                int C, int Tlen) {
  // kaiser_sinc_filter1d(cutoff=0.25, half_width=0.3, kernel_size=12) in f32
  // (audiogpt_tpu/models/vocoder/bigvgan.py:64); the up taps are twice these
  constexpr float kDn[12] = {
      2.028966555e-03f, 9.389463812e-03f, -2.554346435e-02f, -5.765737593e-02f,
      1.285726130e-01f, 4.432097971e-01f, 4.432097971e-01f, 1.285726130e-01f,
      -5.765737593e-02f, -2.554346435e-02f, 9.389463812e-03f, 2.028966555e-03f};
  __shared__ float xs[kTile + 2 * kHalo];
  __shared__ float se[kTile + 2 * kMargin];
  __shared__ float so[kTile + 2 * kMargin];

  const int t0 = blockIdx.x * kTile;
  const int c = blockIdx.y;
  const int64_t row = (int64_t)blockIdx.z * C + c;
  const T* xr = x + row * Tlen;
  T* outr = out + row * Tlen;
  const float a = alpha[c];
  const float inv_b = 1.0f / (beta[c] + 1e-9f);

  // xs[i] = x[clip(t0 - 6 + i)]
  for (int i = threadIdx.x; i < kTile + 2 * kHalo; i += kThreads) {
    int p = min(max(t0 - kHalo + i, 0), Tlen - 1);
    xs[i] = load(xr + p);
  }
  __syncthreads();

  // phases at u = t0 - 3 + j, evaluated at uu = clip(u); past the ends the
  // down stage reads s_e[0] (left) and s_o[T-1] (right) for both phases
  for (int j = threadIdx.x; j < kTile + 2 * kMargin; j += kThreads) {
    const int u = t0 - kMargin + j;
    const int uu = min(max(u, 0), Tlen - 1);
    const float* xp = xs + (uu - t0 + kHalo);  // xp[m] = x[clip(uu + m)]
    float e = 0.f, o = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      e = fmaf(2.0f * kDn[2 * k], xp[k - 3], e);
      o = fmaf(2.0f * kDn[2 * k + 1], xp[k - 2], o);
    }
    const float sin_e = sinf(e * a), sin_o = sinf(o * a);
    const float s_e = e + inv_b * (sin_e * sin_e);
    const float s_o = o + inv_b * (sin_o * sin_o);
    se[j] = u > Tlen - 1 ? s_o : s_e;
    so[j] = u < 0 ? s_e : s_o;
  }
  __syncthreads();

  // out[t] = sum_b dn[2b+1] * SE[t+b-2] + dn[2b] * SO[t+b-3];
  // local index of SE[t+b-2] is (t - t0) + b + 1, of SO[t+b-3] is (t - t0) + b
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int t = t0 + i;
    if (t >= Tlen) break;
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      acc = fmaf(kDn[2 * b + 1], se[i + b + 1], acc);
      acc = fmaf(kDn[2 * b], so[i + b], acc);
    }
    store(outr + t, acc);
  }
}

template <typename T>
int launch(const void* x, const void* alpha, const void* beta, void* out,
           int B, int C, int Tlen, void* stream) {
  dim3 grid((Tlen + kTile - 1) / kTile, C, B);
  snake_aa_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)alpha, (const float*)beta, (T*)out, C, Tlen);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int snake_aa_f32(const void* x, const void* alpha, const void* beta,
                 void* out, int B, int C, int Tlen, void* stream) {
  return launch<float>(x, alpha, beta, out, B, C, Tlen, stream);
}

int snake_aa_bf16(const void* x, const void* alpha, const void* beta,
                  void* out, int B, int C, int Tlen, void* stream) {
  return launch<__nv_bfloat16>(x, alpha, beta, out, B, C, Tlen, stream);
}

}  // extern "C"
