// Blocked causal or full attention with an online softmax, for Hopper
// (sm_90a), bf16 or f32 operands, f32 arithmetic.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, _flash_kernel).  For q
// (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), G = Hq / Hkv query heads per
// KV head (head h reads KV head h / G) and kv_offset = Skv - Sq:
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/G, j])
//                v[b, h/G, j]
// over the keys j <= i + kv_offset when causal, all keys otherwise, in
// q's dtype.  Operands are widened to f32 before both products, and the
// probabilities are not rounded before p.V.
//
// The TPU kernel's semantics for a query row that sees no key (causal,
// Sq > Skv) are kept.  It runs whole (bq, bk) blocks, masks with the
// finite -1e30 and skips the key blocks past its query block's last row,
// so such a row averages V over the key blocks its query block ran,
// [0, (floor((floor(i / bq) bq + bq - 1 + kv_offset) / bk) + 1) bk)
// capped at Skv, or gives 0 when that range is empty.  The caller's bq
// and bk decide only that range; this kernel tiles as it likes.  Each row
// keeps two limits: keys below `vis` score for real, keys below `lim`
// (lim > vis only for a row that sees no key) score -1e30, and the
// others are left out (-inf, so they add exactly 0).
//
// Bound on an H100: operations at the prefill shapes.  4 D flops per
// visible (query, key) pair; at q (4, 32, 1024, 128) causal that is 34.4
// GFLOP, 0.035 ms at the tensor cores' 989 TFLOP/s for bf16 operands,
// above the 0.025 ms that its 83.9 MB take at 3.35 TB/s.
//
// Design.  The TPU kernel carries its running max, sum and accumulator
// across a sequential grid axis over key blocks; Hopper has none, so one
// block of 256 threads owns a (batch, KV head, query tile) and loops over
// the key tiles itself.  Its 64 rows are ROWS / G query positions times
// the G query heads of that KV head, so each K and V tile is read once
// for the whole group, as the Pallas index map h // group does.  The
// tile of 64 keys is staged through dynamic shared memory as f32 (row
// stride D + 4: float4-aligned, and the 16 key rows a half-warp reads
// fall on distinct banks).  Thread (ty, tx) scores rows ty + 16 i against
// keys tx + 16 j (i, j < 4) with FP32 FFMA, the 16 threads of a row agree
// on its running max through shuffles, keep partial sums, and accumulate
// p.V for their rows' D / 16 output columns in registers; the
// probabilities pass through shared memory (over the K tile once the
// scores are taken, when it fits).  Key tiles past the block's largest
// limit are not visited.
//
// Known gap: FP32 FFMA, no tensor cores.  At the prefill shape the
// products run at the FP32 rate, one to two orders above the bf16 bound;
// wgmma with TMA-fed tiles is the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int ROWS = 64;       // query rows per block: positions x heads
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int PLD = BK + 4;    // probability row stride (floats)
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
struct Layout {
  static constexpr int LD = D + 4;                       // K, V, Q rows
  static constexpr int VW = D >= 64 ? 4 : 2;             // columns a group
  static constexpr int NJ = D / (16 * VW);               // groups a thread
  static constexpr bool P_IN_K = ROWS * PLD <= BK * LD;  // P over the K tile
  static constexpr size_t FLOATS =
      (size_t)(ROWS + 2 * BK) * LD + (P_IN_K ? 0 : ROWS * PLD);
};

// grid (ceil(Sq / (ROWS / G)), Hkv, B), THREADS threads, dynamic shared
// memory Layout<D>::FLOATS floats.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Skv, int causal, int bq, int bk,
                       float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD, VW = L::VW, NJ = L::NJ;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [ROWS][LD]
  float* Ks = Qs + ROWS * LD;                    // [BK][LD]
  float* Vs = Ks + BK * LD;                      // [BK][LD]
  float* Ps = L::P_IN_K ? Ks : Vs + BK * LD;     // [ROWS][PLD]
  __shared__ int lim_max;

  const int G = Hq / Hkv;
  const int per = ROWS / G;                      // query positions a block
  const int q0 = blockIdx.x * per;
  const int hk = blockIdx.y;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kv_off = Skv - Sq;
  const T* kb = k + (b * Hkv + hk) * (size_t)Skv * D;
  const T* vb = v + (b * Hkv + hk) * (size_t)Skv * D;

  if (tid == 0) lim_max = 0;

  // stage the block's query rows: row r is position q0 + r / G of head
  // hk * G + r % G; rows past Sq or past G * per are zero and see no key
  for (int idx = tid; idx < ROWS * (D / 4); idx += THREADS) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const int qpos = q0 + r / G;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < G * per && qpos < Sq) {
      const size_t h = (size_t)hk * G + r % G;
      x = load4(q + ((b * Hq + h) * Sq + qpos) * D + c);
    }
    *reinterpret_cast<float4*>(Qs + r * LD + c) = x;
  }

  // each of the thread's rows: keys [0, vis) score, [vis, lim) mask to
  // -1e30, the rest are left out
  int vis[4], lim[4];
  float m[4], l[4], acc[4][NJ * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r / G;
    if (r >= G * per || qpos >= Sq) {
      vis[i] = lim[i] = 0;
    } else if (!causal) {
      vis[i] = lim[i] = Skv;
    } else {
      const int last = qpos + kv_off;              // last visible key
      vis[i] = last < 0 ? 0 : (last + 1 < Skv ? last + 1 : Skv);
      if (vis[i] > 0) {
        lim[i] = vis[i];
      } else {
        const int last_q = (qpos / bq) * bq + bq - 1 + kv_off;
        const int ran = last_q < 0 ? 0 : (last_q / bk + 1) * bk;
        lim[i] = ran < Skv ? ran : Skv;
      }
    }
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ * VW; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();                                 // lim_max = 0 seen
  atomicMax(&lim_max, max(max(lim[0], lim[1]), max(lim[2], lim[3])));
  __syncthreads();
  const int n_tiles = (lim_max + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    for (int idx = tid; idx < BK * (D / 4); idx += THREADS) {
      const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Skv) {
        kx = load4(kb + (size_t)(k0 + r) * D + c);
        vx = load4(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(Ks + r * LD + c) = kx;
      *reinterpret_cast<float4*>(Vs + r * LD + c) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], kk[j], s[i][j]);
    }

    // online softmax: the 16 threads of a row (lanes of one half-warp)
    // agree on its max; each keeps its own partial sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float x = s[i][j] * scale;
        s[i][j] = key < vis[i] ? x : (key < lim[i] ? MASKED : -CUDART_INF_F);
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // m starts at -1e30, so m_new is finite and every exp below is too
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NJ * VW; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    if (L::P_IN_K) __syncthreads();                // scores read K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = s[i][j];
    __syncthreads();

    for (int c = 0; c < BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PLD + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (c + e) * LD + VW * tx;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          float vv[VW];
          if constexpr (VW == 4) {
            const float4 t4 =
                *reinterpret_cast<const float4*>(vrow + 16 * VW * jj);
            vv[0] = t4.x; vv[1] = t4.y; vv[2] = t4.z; vv[3] = t4.w;
          } else {
            const float2 t2 =
                *reinterpret_cast<const float2*>(vrow + 16 * VW * jj);
            vv[0] = t2.x; vv[1] = t2.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y
                           : e == 2 ? p[i].z : p[i].w;
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[i][jj * VW + w] = fmaf(pe, vv[w], acc[i][jj * VW + w]);
          }
        }
      }
    }
    __syncthreads();                               // before the next tile
  }

  // the row's sum over its 16 threads; a row that ran no key gives 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int r = ty + 16 * i;
    const int qpos = q0 + r / G;
    if (r >= G * per || qpos >= Sq) continue;
    const float denom = lt == 0.f ? 1.f : lt;
    const size_t h = (size_t)hk * G + r % G;
    T* orow = o + ((b * Hq + h) * Sq + qpos) * D + VW * tx;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int w = 0; w < VW; ++w)
        store1(orow + 16 * VW * jj + w, acc[i][jj * VW + w] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int causal, int bq, int bk,
           float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = ROWS / (Hq / Hkv);
  const dim3 grid((Sq + per - 1) / per, Hkv, B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      bq, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, int causal, int bq,
             int bk, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, bq, bk,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, bq, bk,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, bq, bk,
                            scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// o (B, Hq, Sq, D) = attention of q (B, Hq, Sq, D) over k, v
// (B, Hkv, Skv, D); all of one dtype (bf16 when bf16 != 0, else f32),
// contiguous, 16-byte aligned.  D in {32, 64, 128}; Hq = G * Hkv with
// G <= 64; B and Hkv <= 65535; bq and bk the TPU kernel's block sizes
// (already min'd with Sq and Skv).
extern "C" int bddt_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    int causal, int bq, int bk, int bf16,
                                    float scale, void* stream) {
  if (B < 1 || Hkv < 1 || Sq < 1 || Skv < 1 || bq < 1 || bk < 1 ||
      Hq % Hkv != 0 || Hq / Hkv > ROWS || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                   causal, bq, bk, scale, s);
  return launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, bq, bk,
                         scale, s);
}
