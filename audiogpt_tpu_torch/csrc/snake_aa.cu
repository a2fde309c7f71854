// Fused anti-aliased snake for BigVGAN: up2x -> snake(beta) -> down2x, in
// one register-resident pass.
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
// and writes one output (8 bytes in f32, 4 in bf16) against ~45 arithmetic
// instructions, so the floor is the bytes at 3.35 TB/s; the 2x intermediate
// never leaves registers. Each lane owns a run of 8 consecutive samples of
// one row, loaded and stored as 16-byte vectors. It computes the two phase
// values of its own 8 positions once, in registers, and takes the 3 input
// samples and the 2-3 phase values on each side that its FIRs reach from
// the neighbouring lanes with warp shuffles. The two edge lanes of a warp
// store nothing: lane 0's run is the left halo and lane 31's the right halo
// of the 30 runs (240 outputs) that the warp writes, so no shared memory and
// no barrier is needed, for 2/32 of extra phase work. Rows whose length is
// not a multiple of 16 bytes, and the run that holds a row's ragged end, take
// scalar loads and stores (positions clamped to the row as the replicate
// pad does).
//
// The sine is `__sinf` after a two-constant (Cody-Waite) reduction of
// alpha*v to [-pi, pi]. The nearest multiple of 2*pi is found by adding and
// subtracting 1.5 * 2^23 (0.045 ms at stage 1 in f32 against rintf's
// 0.0475, `kernel_variants.py`); 2*pi = kTwoPiHi + kTwoPiLo with kTwoPiHi =
// 6.28125 exact in 8 bits, so k * kTwoPiHi is exact for |k| < 2^15 and the
// reduced argument carries ~1 ulp. `__sinf` is accurate to 2^-21.4
// (absolute) on [-pi, pi], so sin^2 is off by at most ~2^-20.4 and each
// snake value by ~7e-7 / beta; the down FIR (sum |dn| = 1.3) keeps the
// output within ~1e-6 / beta of the plain chain, inside the 1e-5 contract
// for beta >~ 0.1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 8;                  // outputs per lane
constexpr int kSeg = 30 * kRun;          // outputs per warp (lanes 1..30)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kRun]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kRun]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kRun]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kRun]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float snake(float v, float a, float inv_b) {
  constexpr float kInvTwoPi = 0.15915494309189535f;
  constexpr float kTwoPiHi = 6.28125f;
  constexpr float kTwoPiLo = 1.9353071795864769e-03f;
  constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
  const float arg = v * a;
  // nearest integer to arg / 2pi (for |arg / 2pi| < 2^22) on the FMA pipe:
  // adding 1.5 * 2^23 leaves no fraction bits
  const float n = (arg * kInvTwoPi + kRound) - kRound;
  const float r = fmaf(-n, kTwoPiLo, fmaf(-n, kTwoPiHi, arg));
  const float sn = __sinf(r);
  return fmaf(inv_b, sn * sn, v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_aa_kernel(const T* __restrict__ x, const float* __restrict__ alpha,
                const float* __restrict__ beta, T* __restrict__ out, int C,
                int Tlen, int n_warps, int segs_per_row, int aligned) {
  // kaiser_sinc_filter1d(cutoff=0.25, half_width=0.3, kernel_size=12) in f32
  // (audiogpt_tpu/models/vocoder/bigvgan.py:64); the up taps are twice these
  constexpr float kDn[12] = {
      2.028966555e-03f, 9.389463812e-03f, -2.554346435e-02f, -5.765737593e-02f,
      1.285726130e-01f, 4.432097971e-01f, 4.432097971e-01f, 1.285726130e-01f,
      -5.765737593e-02f, -2.554346435e-02f, 9.389463812e-03f, 2.028966555e-03f};

  // 32-bit index math (the launcher checks the warp count fits)
  const int lane = threadIdx.x & 31;
  const unsigned w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (unsigned)n_warps) return;  // whole warps: shuffles need all lanes
  const unsigned row = w / (unsigned)segs_per_row;
  const int seg = (int)(w - row * (unsigned)segs_per_row);
  const int c = (int)(row % (unsigned)C);
  const T* xr = x + (int64_t)row * Tlen;
  T* outr = out + (int64_t)row * Tlen;
  const float a = alpha[c];
  const float inv_b = __frcp_rn(beta[c] + 1e-9f);  // = 1.0f / (beta + 1e-9)
  const int p0 = seg * kSeg + (lane - 1) * kRun;  // this lane's first sample

  float xv[kRun];
  if (aligned && p0 >= 0 && p0 + kRun <= Tlen) {
    load8(xr + p0, xv);
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      xv[i] = load1(xr + min(max(p0 + i, 0), Tlen - 1));
  }

  // xw[i] = x[clip(p0 - 3 + i)], i < 14: the lane's run and 3 on each side
  float xw[kRun + 6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xw[i] = __shfl_up_sync(kFull, xv[kRun - 3 + i], 1);
    xw[kRun + 3 + i] = __shfl_down_sync(kFull, xv[i], 1);
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) xw[3 + i] = xv[i];

  // both phases at u = p0 + j
  float se[kRun], so[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    float e = 0.f, o = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      e = fmaf(2.0f * kDn[2 * k], xw[j + k], e);
      o = fmaf(2.0f * kDn[2 * k + 1], xw[j + k + 1], o);
    }
    se[j] = snake(e, a, inv_b);
    so[j] = snake(o, a, inv_b);
  }

  // sew[i] = SE[p0 - 2 + i], sow[i] = SO[p0 - 3 + i], i < 13
  float sew[kRun + 5], sow[kRun + 5];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sow[i] = __shfl_up_sync(kFull, so[kRun - 3 + i], 1);
    sew[kRun + 2 + i] = __shfl_down_sync(kFull, se[i], 1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sew[i] = __shfl_up_sync(kFull, se[kRun - 2 + i], 1);
    sow[kRun + 3 + i] = __shfl_down_sync(kFull, so[i], 1);
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) sew[2 + i] = se[i], sow[3 + i] = so[i];

  // the down stage's edge substitutions; a storing lane that reaches past
  // either end owns s_e[0] (p0 == 0) or has s_o[T-1] within sow
  if (p0 < 3) {
#pragma unroll
    for (int i = 0; i < kRun + 5; ++i) {
      if (p0 - 2 + i < 0) sew[i] = se[0];
      if (p0 - 3 + i < 0) sow[i] = se[0];
    }
  }
  if (p0 + kRun + 2 > Tlen - 1) {
    float last = 0.f;
#pragma unroll
    for (int i = 0; i < kRun + 5; ++i)
      if (p0 - 3 + i == Tlen - 1) last = sow[i];
#pragma unroll
    for (int i = 0; i < kRun + 5; ++i) {
      if (p0 - 2 + i > Tlen - 1) sew[i] = last;
      if (p0 - 3 + i > Tlen - 1) sow[i] = last;
    }
  }

  if (lane == 0 || lane == 31 || p0 >= Tlen) return;
  float y[kRun];
#pragma unroll
  for (int t = 0; t < kRun; ++t) {
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      acc = fmaf(kDn[2 * b + 1], sew[t + b], acc);
      acc = fmaf(kDn[2 * b], sow[t + b], acc);
    }
    y[t] = acc;
  }
  if (aligned && p0 + kRun <= Tlen) {
    store8(outr + p0, y);
  } else {
#pragma unroll
    for (int t = 0; t < kRun; ++t)
      if (p0 + t < Tlen) store1(outr + p0 + t, y[t]);
  }
}

template <typename T>
int launch(const void* x, const void* alpha, const void* beta, void* out,
           int B, int C, int Tlen, void* stream) {
  const int segs = (Tlen + kSeg - 1) / kSeg;
  const int64_t n_warps = (int64_t)B * C * segs;
  // 16-byte vectors need every row start aligned: T * sizeof(T) % 16 == 0
  // and both base pointers on 16 bytes
  const int aligned = (int64_t)Tlen * sizeof(T) % 16 == 0 &&
                      (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (n_warps > 0x7fffffff - kWarps) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n_warps + kWarps - 1) / kWarps);
  snake_aa_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)alpha, (const float*)beta, (T*)out, C, Tlen,
      (int)n_warps, segs, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on the calling thread's current device, on `stream`,
// which must be a stream of that device: the wrapper (ops/snake_aa.py)
// makes the tensor's card current first. The kernel takes no dynamic shared
// memory, so it needs no set-up on any device.
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
