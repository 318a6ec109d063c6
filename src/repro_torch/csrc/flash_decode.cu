// Flash-decode over one KV shard for Hopper (sm_90a), FP32.
//
// Replaces the Pallas TPU kernel flash_decode_pallas
// (src/repro/kernels/flash_decode/kernel.py, _decode_kernel).  One new
// token's attention over a KV shard, for q (B, Hq, D), k and v
// (B, Hkv, S, D), with G = Hq / Hkv query heads per KV head (head h reads
// KV head h / G):
//   o[b, h]   = sum_s softmax_s(scale * q[b, h] . k[b, h/G, s]) v[b, h/G, s]
//   lse[b, h] = log sum_s exp(scale * q[b, h] . k[b, h/G, s])
// the shard-normalised output and the log-sum-exp that
// ref.combine_partials merges shards with.  A row whose softmax sum is 0
// gets o = 0 and lse = -1e30, as in the TPU kernel.
//
// Bound on an H100: memory.  K and V stream past once (2 B Hkv S D 4
// bytes) against 4 flops per element, far below the ridge.  The TPU
// kernel carries the running max, sum and accumulator across a
// sequential grid axis; Hopper has none, so one block owns one (b, KV
// head) and its NW warps take interleaved chunks of U tokens, each warp
// keeping its own running max, sum and accumulator for the G query heads
// in registers (lane l holds elements [l*DPL, (l+1)*DPL) of D, loaded as
// one DPL-float vector: a warp reads a row of K or V as one contiguous
// run).  A warp loads its U rows of K and V before it computes, to keep
// loads in flight.  At the end the warps' partials merge through shared
// memory by the rule of ref.combine_partials, written on unnormalised
// sums: M = max_w m_w, L = sum_w l_w e^(m_w - M),
// o = sum_w acc_w e^(m_w - M) / L, lse = M + log L.  expf/logf, not the
// __ intrinsics.
//
// Known gap: B * Hkv blocks only.  At Mistral-NeMo-12B's decode width
// (B 4, Hkv 8) that is 32 blocks on 132 SMs; a split over S with a
// second combine pass would fill the card.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstddef>

namespace {

constexpr int U = 4;                 // tokens a warp loads per step
constexpr int MAX_GRID_Y = 65535;

template <int DPL>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&x)[DPL]) {
  if constexpr (DPL == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (DPL == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (Hkv, B), NW warps; D = 32 * DPL; G <= GMAX query heads per block.
// Dynamic shared memory: NW * G * (D + 2) floats.
template <int DPL, int GMAX, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int Hkv, int G, int S,
                    float scale) {
  constexpr int D = 32 * DPL;
  const int h = blockIdx.x;
  const size_t b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t kv_off = (b * Hkv + h) * (size_t)S * D + lane * DPL;
  k += kv_off;
  v += kv_off;
  const size_t row0 = b * Hkv * G + (size_t)h * G;   // first query head
  q += row0 * D + lane * DPL;

  float qr[GMAX][DPL], acc[GMAX][DPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      load_row<DPL>(q + (size_t)g * D, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) qr[g][i] = 0.0f;
    }
    m[g] = -CUDART_INF_F;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.0f;
  }

  const int n_chunks = (S + U - 1) / U;
  for (int c = warp; c < n_chunks; c += NW) {
    const int s0 = c * U;
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < S) {
        load_row<DPL>(k + (size_t)(s0 + u) * D, kr[u]);
        load_row<DPL>(v + (size_t)(s0 + u) * D, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kr[u][i] = vr[u][i] = 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float s[U];
        float cmax = -CUDART_INF_F;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = 0.0f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) dot += qr[g][i] * kr[u][i];
          dot = warp_sum(dot) * scale;
          s[u] = (s0 + u < S) ? dot : -CUDART_INF_F;
          cmax = fmaxf(cmax, s[u]);
        }
        // s0 < S, so cmax is finite and m_new is too; the first chunk
        // scales the empty state by expf(-inf) = 0
        const float m_new = fmaxf(m[g], cmax);
        const float alpha = expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = expf(s[u] - m_new);     // 0 past the end of S
          l[g] += p;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] += p * vr[u][i];
        }
        m[g] = m_new;
      }
    }
  }

  // merge the NW warp partials (a warp with no chunk has m = -inf, l = 0)
  extern __shared__ float smem[];
  float* acc_s = smem;                       // [NW][G][D]
  float* m_s = acc_s + (size_t)NW * G * D;   // [NW][G]
  float* l_s = m_s + NW * G;                 // [NW][G]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc_s[((size_t)warp * G + g) * D + lane * DPL + i] = acc[g][i];
      if (lane == 0) {
        m_s[warp * G + g] = m[g];
        l_s[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  float* ob = o + row0 * D;
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float big = -CUDART_INF_F;
    for (int w = 0; w < NW; ++w) big = fmaxf(big, m_s[w * G + g]);
    float sum = 0.0f, num = 0.0f;
    for (int w = 0; w < NW; ++w) {
      const float mw = m_s[w * G + g];
      if (mw == -CUDART_INF_F) continue;      // an empty warp
      const float e = expf(mw - big);
      sum += l_s[w * G + g] * e;
      num += acc_s[((size_t)w * G + g) * D + d] * e;
    }
    ob[(size_t)g * D + d] = sum == 0.0f ? 0.0f : num / sum;
    if (d == 0) lse[row0 + g] = sum == 0.0f ? -1e30f : big + logf(sum);
  }
}

template <int DPL, int GMAX>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int Hkv, int G, int S, float scale,
           cudaStream_t stream) {
  constexpr int NW = GMAX >= 8 ? 8 : 16;
  constexpr int D = 32 * DPL;
  const size_t smem = sizeof(float) * (size_t)NW * G * (D + 2);
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int nb = (B - b0) < MAX_GRID_Y ? (B - b0) : MAX_GRID_Y;
    const size_t qo = (size_t)b0 * Hkv * G;
    flash_decode_kernel<DPL, GMAX, NW>
        <<<dim3(Hkv, nb), NW * 32, smem, stream>>>(
            q + qo * D, k + (size_t)b0 * Hkv * S * D,
            v + (size_t)b0 * Hkv * S * D, o + qo * D, lse + qo, Hkv, G, S,
            scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <int DPL>
int launch_g(const float* q, const float* k, const float* v, float* o,
             float* lse, int B, int Hkv, int G, int S, float scale,
             cudaStream_t stream) {
  if (G <= 1) return launch<DPL, 1>(q, k, v, o, lse, B, Hkv, G, S, scale, stream);
  if (G <= 2) return launch<DPL, 2>(q, k, v, o, lse, B, Hkv, G, S, scale, stream);
  if (G <= 4) return launch<DPL, 4>(q, k, v, o, lse, B, Hkv, G, S, scale, stream);
  if (G <= 8) return launch<DPL, 8>(q, k, v, o, lse, B, Hkv, G, S, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// o (B,Hq,D), lse (B,Hq) = one-token attention of q (B,Hq,D) over
// k, v (B,Hkv,S,D); all f32, contiguous, 16-byte aligned.  D in
// {32, 64, 128}, Hq = G * Hkv with G <= 8, S >= 1.
extern "C" int bddt_flash_decode(const float* q, const float* k,
                                 const float* v, float* o, float* lse,
                                 int B, int Hq, int Hkv, int S, int D,
                                 float scale, void* stream) {
  if (B < 1 || Hkv < 1 || S < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_g<1>(q, k, v, o, lse, B, Hkv, G, S, scale, s);
    case 64: return launch_g<2>(q, k, v, o, lse, B, Hkv, G, S, scale, s);
    case 128: return launch_g<4>(q, k, v, o, lse, B, Hkv, G, S, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
