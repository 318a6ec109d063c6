// Black-Scholes European call and put prices for Hopper (sm_90a), FP32.
//
// Replaces the Pallas TPU kernel black_scholes_pallas
// (src/repro/kernels/black_scholes/kernel.py, _bs_kernel).  For every
// option i of the flat arrays:
//   d1 = (log(spot/strike) + (rate + 0.5 vol^2) t) / (vol sqrt(t))
//   d2 = d1 - vol sqrt(t),  disc = strike exp(-rate t)
//   call = spot N(d1) - disc N(d2),  put = disc N(-d2) - spot N(-d1)
// with N(x) = 0.5 (1 + erf(x / sqrt(2))).  The (rows, 128) layout and the
// 1.0 padding of the TPU version are lane artefacts and are not kept: the
// arrays are flat, of any length.
//
// Bound on an H100: memory.  An option reads 5 floats and writes 2, 28 B,
// against some 60 flops and four transcendental calls; 2,097,152 options
// move 58.7 MB, 17.5 us at 3.35 TB/s.  Design: one thread per option, or
// per four consecutive options with 16-byte loads and stores when every
// pointer is 16-byte aligned, in one launch; a grid-stride loop covers
// any length.  The full-precision erff/logf/expf/sqrtf and IEEE division
// are used, never the __ intrinsics, so the prices stay within rtol 1e-5
// / atol 1e-3 of the plain PyTorch version.
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // a few waves over 132 SMs

__device__ __forceinline__ float ncdf(float x) {
  return 0.5f * (1.0f + erff(x / 1.4142135623730951f));
}

__device__ __forceinline__ void price(float spot, float strike, float t,
                                      float rate, float vol, float& call,
                                      float& put) {
  const float sqrt_t = sqrtf(t);
  const float d1 = (logf(spot / strike) + (rate + 0.5f * vol * vol) * t) /
                   (vol * sqrt_t);
  const float d2 = d1 - vol * sqrt_t;
  const float disc = strike * expf(-rate * t);
  call = spot * ncdf(d1) - disc * ncdf(d2);
  put = disc * ncdf(-d2) - spot * ncdf(-d1);
}

// VEC: options [0, 4 * (n / 4)) go four to a thread through float4
// loads and stores (every pointer 16-byte aligned), the rest one to a
// thread; without VEC all go one to a thread.  One launch either way.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
black_scholes_kernel(const float* __restrict__ spot,
                     const float* __restrict__ strike,
                     const float* __restrict__ t,
                     const float* __restrict__ rate,
                     const float* __restrict__ vol,
                     float* __restrict__ call, float* __restrict__ put,
                     size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t head = 0;
  if (VEC) {
    const size_t n4 = n / 4;
    for (size_t i = tid; i < n4; i += stride) {
      const float4 s = reinterpret_cast<const float4*>(spot)[i];
      const float4 k = reinterpret_cast<const float4*>(strike)[i];
      const float4 tt = reinterpret_cast<const float4*>(t)[i];
      const float4 r = reinterpret_cast<const float4*>(rate)[i];
      const float4 v = reinterpret_cast<const float4*>(vol)[i];
      float4 c, p;
      price(s.x, k.x, tt.x, r.x, v.x, c.x, p.x);
      price(s.y, k.y, tt.y, r.y, v.y, c.y, p.y);
      price(s.z, k.z, tt.z, r.z, v.z, c.z, p.z);
      price(s.w, k.w, tt.w, r.w, v.w, c.w, p.w);
      reinterpret_cast<float4*>(call)[i] = c;
      reinterpret_cast<float4*>(put)[i] = p;
    }
    head = n4 * 4;
  }
  for (size_t i = head + tid; i < n; i += stride) {
    price(spot[i], strike[i], t[i], rate[i], vol[i], call[i], put[i]);
  }
}

int blocks_for(size_t work) {
  const size_t b = (work + THREADS - 1) / THREADS;
  return static_cast<int>(b < MAX_BLOCKS ? (b ? b : 1) : MAX_BLOCKS);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// call, put = Black-Scholes(spot, strike, t, rate, vol); all (n,) f32
extern "C" int bddt_black_scholes(const float* spot, const float* strike,
                                  const float* t, const float* rate,
                                  const float* vol, float* call, float* put,
                                  long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(n);
  if (aligned16(spot) && aligned16(strike) && aligned16(t) &&
      aligned16(rate) && aligned16(vol) && aligned16(call) &&
      aligned16(put)) {
    black_scholes_kernel<true><<<blocks_for(total / 4 + total % 4), THREADS,
                                 0, s>>>(spot, strike, t, rate, vol, call,
                                         put, total);
  } else {
    black_scholes_kernel<false><<<blocks_for(total), THREADS, 0, s>>>(
        spot, strike, t, rate, vol, call, put, total);
  }
  return static_cast<int>(cudaGetLastError());
}
