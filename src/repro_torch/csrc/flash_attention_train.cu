// Training attention for Hopper (sm_90a): a forward kernel that also writes
// each query row's log-sum-exp, and a deterministic backward of three
// kernels (a rowsum prepass, dQ, and dK with dV), bf16 operands on wgmma
// fed by TMA, with no atomics.
//
// Replaces no TPU kernel.  The JAX package trains through
// chunked_attention (src/repro/kernels/flash_attention/ops.py), a lax.scan
// over query and key chunks that XLA fuses; the port ran the same loop in
// torch, f32 products and some six elementwise passes over every f32 score
// block, run three times under its nested checkpoints, and K and V copied
// G times.  These kernels compute the same online-softmax mathematics in
// one pass over the tiles a row can see.
//
// For q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), G = Hq / Hkv (head h reads
// KV head h / G) and kv_offset = Skv - Sq, the scores are
// x[i, j] = scale * log2(e) * q[i] . k[j] over the keys j <= i + kv_offset
// when causal (every row sees a key: causal needs Sq <= Skv), all keys
// otherwise, and
//   lse[i] = log2 sum_j 2^x[i, j],  P = 2^(x - lse),  o = P v,
//   delta[i] = sum_d do[i, d] o[i, d],  dS = P * (do v^T - delta),
//   dq = scale dS k,  dk = scale dS^T q,  dv = P^T do
// (lse in base 2; dk and dv summed over the G query heads of a KV head).
//
// Bound on an H100 (SXM, 700 W): operations.  One causal Q.K^T over a
// training step is F1 = B Hq D S^2 flops a layer; the forward takes 3 F1
// (P.V split in two), dK/dV 6 F1 and dQ 4 F1, against the tensor cores'
// 989 TFLOP/s for bf16 operands.  The backward's mathematics needs 8 F1:
// S and dP are computed in both of its kernels, so that neither adds into
// the other's output.  What is read and written (q, k, v, o,
// do, the gradients, lse and delta) is some 10 B H S D bytes, three orders
// under the operations at S 4,096.
//
// Precision is the chunked path's, not the prefill kernel's.  The chunked
// path holds P and dS in f32; every product with one of them as an operand
// (P.V, P^T.dO, dS.K, dS^T.Q) takes it as a pair hi + lo of bf16 values,
// two wgmmas into one f32 accumulator, which leaves some 2^-17 of each
// value, far under the bf16 rounding of o and of the gradients.  Q.K^T and
// dO.V^T have bf16 operands and take one wgmma each, exact products summed
// in f32.  Rounding P to bf16 once, as the prefill kernel does, would move
// the output by up to 2^-9 of max |v|.  For the same reason delta reads o
// as the forward computed it in f32 (o32, which the forward writes beside
// the bf16 o when a backward will follow): from the bf16 o, delta would
// move dq by up to 2^-9 of delta times the mean key.
//
// Layout.  Every tile is 64 rows by D columns of bf16, copied by TMA into
// 128-byte swizzled chunks of 64 columns (64-byte at D 32).  A query tile's
// 64 rows are all G query heads of a KV head times 64 / G positions, as in
// the prefill kernel, so one K or V tile serves the whole group and a
// key tile's gradient sums the group's heads inside the block.  One
// consumer warpgroup (128 threads, the 64 rows of one wgmma) computes; one
// producer thread keeps a two-stage ring of the streamed tiles in flight.
//   attn_train_fwd_kernel: a block owns (query tile, KV head, batch), streams
//     K and V tiles up to the last key its rows see (later tiles are
//     skipped: exact, a wholly masked tile gives p = 0 and alpha = 1), and
//     writes o in bf16, lse in f32 and, when asked, o32.
//   attn_train_delta_kernel: delta = rowsum(do * o32) in f32, D / 8 lanes
//     a row.
//   attn_train_dq_kernel: a block owns a query tile as the forward does and
//     streams K and V tiles; S = Q K^T and dP = dO V^T (one wgmma each), P
//     from lse, dS, and dQ += dS K.
//   attn_train_dkdv_kernel: a block owns (key tile, KV head, batch) and
//     streams the query tiles (Q and dO) that reach it; it computes the
//     transposed scores S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
//     sit in registers as the A operands of dV += P^T dO and dK += dS^T Q.
//     Each block writes its own rows of dK and dV once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int ROWS = 64;        // rows of every tile (query rows or keys)
constexpr int STAGES = 2;       // depth of the ring of streamed tiles
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int SW = D < 64 ? D : 64;          // elements a chunk row
  static constexpr int ROW_BYTES = 2 * SW;            // 64 or 128
  static constexpr int NC = D / SW;                   // column chunks
  static constexpr uint32_t SWIZZLE = SW == 64 ? 1 : 2;   // 128 B, 64 B
  static constexpr int SBO = 8 * ROW_BYTES;           // next 8 rows
  static constexpr int CHUNK = ROWS * ROW_BYTES;
  static constexpr int TILE = NC * CHUNK;             // 64 x D bf16
};

// 1024-byte aligned start of the dynamic shared memory (swizzle atoms)
__device__ __forceinline__ uint8_t* aligned(uint8_t* raw) {
  return raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// keys [0, vis) that query position pos sees
__device__ __forceinline__ int visible(int pos, int Sq, int Skv,
                                       int causal) {
  if (pos >= Sq) return 0;
  if (!causal) return Skv;
  const int v = pos + (Skv - Sq) + 1;
  return v < Skv ? v : Skv;
}

// Zero the rows [filled, 64) of a query tile, which no TMA box writes
// (G does not divide 64); wgmma reads them through the async proxy.
template <int D>
__device__ __forceinline__ void zero_unfilled(uint8_t* tile, int filled,
                                              int tid) {
  using T = Tiles<D>;
  const int from = filled * T::ROW_BYTES / 16;    // 16-byte units a chunk
  for (int i = tid; i < T::TILE / 16; i += THREADS)
    if (i % (T::CHUNK / 16) >= from)
      reinterpret_cast<uint4*>(tile)[i] = make_uint4(0, 0, 0, 0);
}

// One K-major step (chunk c, k-slice kk) of a 64-row tile.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int c, int kk) {
  using T = Tiles<D>;
  return hopper::make_desc(tile + c * T::CHUNK + 32 * kk, 16, T::SBO,
                           T::SWIZZLE);
}

// Rows [16 kk, 16 kk + 16) of a 64 x D tile as an MN-major B operand.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  using T = Tiles<D>;
  return hopper::make_desc(tile + 16 * kk * T::ROW_BYTES, T::CHUNK, T::SBO,
                           T::SWIZZLE);
}

// s (64 x 64) = A tile . B tile^T over D; both tiles K-major.  Starts the
// wgmmas only: the caller fences, commits and waits.
template <int D>
__device__ __forceinline__ void mma_abt(float (&s)[32], uint32_t a,
                                          uint32_t b) {
  using T = Tiles<D>;
#pragma unroll
  for (int c = 0; c < T::NC; ++c)
#pragma unroll
    for (int kk = 0; kk < T::SW / 16; ++kk)
      hopper::Wgmma<64>::ss(s, kmajor<D>(a, c, kk), kmajor<D>(b, c, kk),
                            c + kk);
}

// acc (64 x D) += (hi + lo) (64 x 64, registers) . B tile (64 x D).
template <int D>
__device__ __forceinline__ void mma_split(float (&acc)[D / 2],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::Wgmma<D>::rs(acc, hi[kk], mnmajor<D>(b, kk));
    hopper::Wgmma<D>::rs(acc, lo[kk], mnmajor<D>(b, kk));
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// A 64 x 64 accumulator as the register A operand of four m64nNk16
// wgmmas (f[kk] covers columns [16 kk, 16 kk + 16)), split into bf16
// hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i / 8][(i % 8) / 2] = bits(h);
    lo[i / 8][(i % 8) / 2] =
        bits(__floats2bfloat162_rn(x[i] - hf.x, x[i + 1] - hf.y));
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Accumulator element i of thread (warp w, lane) in a 64 x N wgmma
// fragment: row 16 w + lane / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (lane % 4) + (i & 1).

// Write rows r0 and r0 + 8 of a 64 x D accumulator, times `mul`, as bf16
// rows of `out` (row pointers, null where the row is not written).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul,
                                           __nv_bfloat16* const (&row)[2],
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row[h] + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul,
                                acc[4 * j + 2 * h + 1] * mul);
  }
}

// ------------------------------------------------------------- forward
// grid (ceil(Sq / per), Hkv, B) with per = 64 / G, THREADS threads, dynamic
// shared memory fwd_smem<D>().  Row r of a block is head hk G + r / per at
// position q0 + r % per (the order of the Q box (D, per, G)).
template <int D>
constexpr size_t fwd_smem() {
  return 1024 + (1 + 2 * STAGES) * Tiles<D>::TILE;
}

template <int D>
__global__ void __launch_bounds__(THREADS, D < 128 ? 2 : 1)
attn_train_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ o32, float* __restrict__ lse,
                      int Hq, int Hkv, int Sq,
                      int Skv, int causal, float scale_log2) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, full[STAGES], empty[STAGES];
  uint8_t* const Qs = aligned(smem_raw);
  uint8_t* const KVs = Qs + T::TILE;      // stage s: K, then V

  const int G = Hq / Hkv, per = ROWS / G;
  // the last query tiles, which see the most keys when causal, go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * per;
  const int hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int last = (q0 + per < Sq ? q0 + per : Sq) - 1;
  const int n_tiles = (visible(last, Sq, Skv, causal) + ROWS - 1) / ROWS;

  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  zero_unfilled<D>(Qs, G * per, tid);
  hopper::fence_proxy_async();
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      hopper::mbar_expect_tx(&q_full, T::NC * T::ROW_BYTES * per * G);
      for (int c = 0; c < T::NC; ++c)
        hopper::tma_load_3d(Qs + c * T::CHUNK, &qmap, &q_full, c * T::SW,
                            q0, b * Hq + hk * G);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * T::TILE);
        uint8_t* const Ks = KVs + 2 * s * T::TILE;
        for (int c = 0; c < T::NC; ++c) {
          hopper::tma_load_3d(Ks + c * T::CHUNK, &kmap, &full[s], c * T::SW,
                              t * ROWS, b * Hkv + hk);
          hopper::tma_load_3d(Ks + T::TILE + c * T::CHUNK, &vmap, &full[s],
                              c * T::SW, t * ROWS, b * Hkv + hk);
        }
      }
    }
    return;
  }

  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  int vis[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    vis[h] = r < G * per ? visible(q0 + r % per, Sq, Skv, causal) : 0;
    m[h] = MASKED;
    l[h] = 0.f;
  }
  float acc[D / 2];
  zero(acc);

  const uint32_t q_addr = hopper::smem_u32(Qs);
  hopper::mbar_wait(&q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t k_addr = hopper::smem_u32(KVs + 2 * s * T::TILE);
    const uint32_t v_addr = k_addr + T::TILE;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);

    float sc[32];
    zero(sc);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
    mma_abt<D>(sc, q_addr, k_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // online softmax in log2 units; m starts at -1e30, so m_new is finite
    // and every exp2 below is too; a masked key scores -inf and adds 0
    const int k0 = t * ROWS;
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int key = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
      sc[i] = key < vis[h] ? sc[i] * scale_log2 : -CUDART_INF_F;
      mt[h] = fmaxf(mt[h], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = exp2f(sc[i] - m[h]);
      l[h] += sc[i];
    }
    uint32_t hi[4][4], lo[4][4];
    split_frags(sc, hi, lo);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    mma_split<D>(acc, hi, lo, v_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);      // both products have read stage s
  }

  // each row's sum over its four lanes; every row that holds a query sees
  // a key, so l >= 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + 8 * h;
    const int pos = q0 + r % per;
    if (r >= G * per || pos >= Sq) continue;
    const size_t at = ((size_t)b * Hq + hk * G + r / per) * Sq + pos;
    if (lane % 4 == 0) lse[at] = m[h] + log2f(l[h]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x = acc[4 * j + 2 * h] / l[h];
      const float y = acc[4 * j + 2 * h + 1] / l[h];
      const size_t col = at * D + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(o + col) =
          __floats2bfloat162_rn(x, y);
      if (o32 != nullptr)
        *reinterpret_cast<float2*>(o32 + col) = make_float2(x, y);
    }
  }
}

// --------------------------------------------------------------- delta
// delta[row] = sum_d do[row, d] o32[row, d] in f32 over `rows` rows of D
// values (do bf16, o32 f32); D / 8 lanes a row, 8 values each.
__global__ void __launch_bounds__(256)
attn_train_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ o32,
                        float* __restrict__ delta, size_t rows, int D) {
  const int lanes = D / 8;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t r = t / lanes;
  const int part = static_cast<int>(t % lanes);
  float sum = 0.f;
  if (r < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + r * D + 8 * part);
    const float4* c = reinterpret_cast<const float4*>(o32 + r * D + 8 * part);
    const float4 c0 = c[0], c1 = c[1];
    const float y[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]);
      sum = fmaf(x.x, y[2 * j], sum);
      sum = fmaf(x.y, y[2 * j + 1], sum);
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (r < rows && part == 0) delta[r] = sum;
}

// ------------------------------------------------------------------ dQ
// grid and rows as the forward's; dynamic shared memory dq_smem<D>().
template <int D>
constexpr size_t dq_smem() {
  return 1024 + (2 + 2 * STAGES) * Tiles<D>::TILE;
}

template <int D>
__global__ void __launch_bounds__(THREADS, D < 128 ? 2 : 1)
attn_train_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dmap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Sq,
                     int Skv, int causal, float scale_log2, float scale) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, full[STAGES], empty[STAGES];
  uint8_t* const Qs = aligned(smem_raw);
  uint8_t* const dOs = Qs + T::TILE;
  uint8_t* const KVs = dOs + T::TILE;     // stage s: K, then V

  const int G = Hq / Hkv, per = ROWS / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * per;
  const int hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int last = (q0 + per < Sq ? q0 + per : Sq) - 1;
  const int n_tiles = (visible(last, Sq, Skv, causal) + ROWS - 1) / ROWS;

  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  zero_unfilled<D>(Qs, G * per, tid);
  zero_unfilled<D>(dOs, G * per, tid);
  hopper::fence_proxy_async();
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      hopper::mbar_expect_tx(&q_full, 2 * T::NC * T::ROW_BYTES * per * G);
      for (int c = 0; c < T::NC; ++c) {
        hopper::tma_load_3d(Qs + c * T::CHUNK, &qmap, &q_full, c * T::SW,
                            q0, b * Hq + hk * G);
        hopper::tma_load_3d(dOs + c * T::CHUNK, &dmap, &q_full, c * T::SW,
                            q0, b * Hq + hk * G);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * T::TILE);
        uint8_t* const Ks = KVs + 2 * s * T::TILE;
        for (int c = 0; c < T::NC; ++c) {
          hopper::tma_load_3d(Ks + c * T::CHUNK, &kmap, &full[s], c * T::SW,
                              t * ROWS, b * Hkv + hk);
          hopper::tma_load_3d(Ks + T::TILE + c * T::CHUNK, &vmap, &full[s],
                              c * T::SW, t * ROWS, b * Hkv + hk);
        }
      }
    }
    return;
  }

  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  int vis[2];
  float lse_r[2], dlt[2];
  __nv_bfloat16* row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int pos = q0 + r % per;
    vis[h] = 0;
    lse_r[h] = dlt[h] = 0.f;
    row[h] = nullptr;
    if (r < G * per && pos < Sq) {
      const size_t at = ((size_t)b * Hq + hk * G + r / per) * Sq + pos;
      vis[h] = visible(pos, Sq, Skv, causal);
      lse_r[h] = lse[at];
      dlt[h] = delta[at];
      row[h] = dq + at * D;
    }
  }
  float acc[D / 2];
  zero(acc);

  const uint32_t q_addr = hopper::smem_u32(Qs);
  const uint32_t do_addr = hopper::smem_u32(dOs);
  hopper::mbar_wait(&q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t k_addr = hopper::smem_u32(KVs + 2 * s * T::TILE);
    const uint32_t v_addr = k_addr + T::TILE;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);

    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    mma_abt<D>(sc, q_addr, k_addr);
    mma_abt<D>(dp, do_addr, v_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // dS = P (dP - delta), P = 2^(x - lse) on the visible keys, 0 elsewhere
    const int k0 = t * ROWS;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int key = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
      const float p =
          key < vis[h] ? exp2f(sc[i] * scale_log2 - lse_r[h]) : 0.f;
      sc[i] = p * (dp[i] - dlt[h]);
    }
    uint32_t hi[4][4], lo[4][4];
    split_frags(sc, hi, lo);

    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    mma_split<D>(acc, hi, lo, k_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
  }
  store_rows<D>(acc, scale, row, lane);
}

// --------------------------------------------------------------- dK, dV
// grid (ceil(Skv / 64), Hkv, B), THREADS threads, dynamic shared memory
// dkdv_smem<D>().  Row r of a block is key k0 + r; column c of a query
// tile is head hk G + c / per at position q0 + c % per.
template <int D>
constexpr size_t dkdv_smem() {
  return 1024 + (2 + 2 * STAGES) * Tiles<D>::TILE;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_train_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap dmap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int Hq, int Hkv,
                       int Sq, int Skv, int causal, float scale_log2,
                       float scale) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t kv_full, full[STAGES], empty[STAGES];
  // each query tile's columns, double-buffered by the tile's parity: lse
  // (+inf where the column holds no query), delta, position
  __shared__ float col_lse[2][ROWS], col_dlt[2][ROWS];
  __shared__ int col_pos[2][ROWS];
  uint8_t* const Ks = aligned(smem_raw);
  uint8_t* const Vs = Ks + T::TILE;
  uint8_t* const QDs = Vs + T::TILE;      // stage s: Q, then dO

  const int G = Hq / Hkv, per = ROWS / G;
  const int k0 = blockIdx.x * ROWS;
  const int hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int kv_off = Skv - Sq;
  // the query tiles that reach the key tile: from the first position that
  // sees key k0 when causal
  const int first = causal ? (k0 - kv_off > 0 ? k0 - kv_off : 0) / per : 0;
  const int n_tiles = (Sq + per - 1) / per - first;

  if (tid == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  for (int s = 0; s < 2 * STAGES; ++s)
    zero_unfilled<D>(QDs + s * T::TILE, G * per, tid);
  hopper::fence_proxy_async();
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      hopper::mbar_expect_tx(&kv_full, 2 * T::TILE);
      for (int c = 0; c < T::NC; ++c) {
        hopper::tma_load_3d(Ks + c * T::CHUNK, &kmap, &kv_full, c * T::SW,
                            k0, b * Hkv + hk);
        hopper::tma_load_3d(Vs + c * T::CHUNK, &vmap, &kv_full, c * T::SW,
                            k0, b * Hkv + hk);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(&full[s], 2 * T::NC * T::ROW_BYTES * per * G);
        uint8_t* const Qt = QDs + 2 * s * T::TILE;
        for (int c = 0; c < T::NC; ++c) {
          hopper::tma_load_3d(Qt + c * T::CHUNK, &qmap, &full[s], c * T::SW,
                              (first + t) * per, b * Hq + hk * G);
          hopper::tma_load_3d(Qt + T::TILE + c * T::CHUNK, &dmap, &full[s],
                              c * T::SW, (first + t) * per, b * Hq + hk * G);
        }
      }
    }
    return;
  }

  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  int key[2];
  key[0] = k0 + r0;
  key[1] = k0 + r0 + 8;
  // the column this thread fills in each tile's table (threads < 64)
  const bool col_real = tid < G * per;
  const size_t col_head = (size_t)b * Hq + hk * G + (col_real ? tid / per : 0);
  const int col_off = col_real ? tid % per : 0;

  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  const uint32_t k_addr = hopper::smem_u32(Ks);
  const uint32_t v_addr = hopper::smem_u32(Vs);
  hopper::mbar_wait(&kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, buf = t & 1;
    const int q0 = (first + t) * per;
    if (tid < ROWS) {
      const int pos = q0 + col_off;
      const bool real = col_real && pos < Sq;
      const size_t at = col_head * Sq + pos;
      col_lse[buf][tid] = real ? lse[at] : CUDART_INF_F;
      col_dlt[buf][tid] = real ? delta[at] : 0.f;
      col_pos[buf][tid] = pos;
    }
    const uint32_t q_addr = hopper::smem_u32(QDs + 2 * s * T::TILE);
    const uint32_t do_addr = q_addr + T::TILE;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);

    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
    mma_abt<D>(st, k_addr, q_addr);       // S^T = K Q^T
    mma_abt<D>(dpt, v_addr, do_addr);     // dP^T = V dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    consumer_sync();                        // the tile's columns are in

    // P^T and dS^T = P^T (dP^T - delta) on the visible pairs, 0 elsewhere
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + e;
        const float lc = col_lse[buf][c], dc = col_dlt[buf][c];
        const int last = col_pos[buf][c] + kv_off;   // its last key
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool seen = lc != CUDART_INF_F && key[h] < Skv &&
                            (!causal || key[h] <= last);
          const float p = seen ? exp2f(st[i] * scale_log2 - lc) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - dc);
        }
      }
    uint32_t phi[4][4], plo[4][4], shi[4][4], slo[4][4];
    split_frags(st, phi, plo);
    split_frags(dpt, shi, slo);

    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
    mma_split<D>(dv_acc, phi, plo, do_addr);   // dV += P^T dO
    mma_split<D>(dk_acc, shi, slo, q_addr);    // dK += dS^T Q
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* krow[2];
  __nv_bfloat16* vrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = ((size_t)b * Hkv + hk) * Skv + key[h];
    krow[h] = key[h] < Skv ? dk + at * D : nullptr;
    vrow[h] = key[h] < Skv ? dv + at * D : nullptr;
  }
  store_rows<D>(dk_acc, scale, krow, lane);
  store_rows<D>(dv_acc, 1.f, vrow, lane);
}

// ----------------------------------------------------------------- host
// The tensor maps of a (B*H, S, D) bf16 tensor: boxes of (SW, rows, heads).
template <int D>
int encode(CUtensorMap* map, const void* base, int S, uint64_t BH, int rows,
           int heads) {
  using T = Tiles<D>;
  return hopper::encode_bf16_3d(
      map, base, D, S, BH, T::SW, rows, heads,
      T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* o32, void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
               int causal, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv, per = ROWS / G;
  // a runtime call first: it binds the device's primary context to this
  // thread, which the driver's encoder needs (autograd's worker thread
  // may have made no runtime call before the backward reaches here)
  const cudaError_t err = allow_smem(attn_train_fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm;
  int rc = encode<D>(&qm, q, Sq, (uint64_t)B * Hq, per, G);
  if (rc == 0) rc = encode<D>(&km, k, Skv, (uint64_t)B * Hkv, ROWS, 1);
  if (rc == 0) rc = encode<D>(&vm, v, Skv, (uint64_t)B * Hkv, ROWS, 1);
  if (rc != 0) return rc;
  const dim3 grid((Sq + per - 1) / per, Hkv, B);
  attn_train_fwd_kernel<D><<<grid, THREADS, fwd_smem<D>(), stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(o32),
      static_cast<float*>(lse), Hq, Hkv, Sq, Skv, causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o32,
               const void* lse, const void* dout, void* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
               int causal, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv, per = ROWS / G;
  // the runtime calls before the encoder, as in launch_fwd
  cudaError_t err = allow_smem(attn_train_dq_kernel<D>, dq_smem<D>());
  if (err == cudaSuccess)
    err = allow_smem(attn_train_dkdv_kernel<D>, dkdv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap qm, km, vm, dm;
  int rc = encode<D>(&qm, q, Sq, (uint64_t)B * Hq, per, G);
  if (rc == 0) rc = encode<D>(&dm, dout, Sq, (uint64_t)B * Hq, per, G);
  if (rc == 0) rc = encode<D>(&km, k, Skv, (uint64_t)B * Hkv, ROWS, 1);
  if (rc == 0) rc = encode<D>(&vm, v, Skv, (uint64_t)B * Hkv, ROWS, 1);
  if (rc != 0) return rc;

  const size_t rows = (size_t)B * Hq * Sq;
  const size_t threads = rows * (D / 8);
  attn_train_delta_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                            stream>>>(
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(o32), static_cast<float*>(delta), rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale_log2 = scale * LOG2E;
  const dim3 qgrid((Sq + per - 1) / per, Hkv, B);
  attn_train_dq_kernel<D><<<qgrid, THREADS, dq_smem<D>(), stream>>>(
      qm, km, vm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), Hq,
      Hkv, Sq, Skv, causal, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 kgrid((Skv + ROWS - 1) / ROWS, Hkv, B);
  attn_train_dkdv_kernel<D><<<kgrid, THREADS, dkdv_smem<D>(), stream>>>(
      qm, km, vm, dm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Hq, Hkv, Sq, Skv, causal, scale_log2,
      scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid_args(int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal) {
  return B >= 1 && Hkv >= 1 && Sq >= 1 && Skv >= 1 && Hq % Hkv == 0 &&
         Hq / Hkv <= ROWS && B <= 65535 && Hkv <= 65535 &&
         (!causal || Sq <= Skv) && (D == 32 || D == 64 || D == 128);
}

}  // namespace

// o (B, Hq, Sq, D) bf16 and lse (B, Hq, Sq) f32 (base 2, of the scores
// times scale log2 e) of q (B, Hq, Sq, D) over k, v (B, Hkv, Skv, D), and,
// where o32 is not null, o in f32 there (B, Hq, Sq, D); all contiguous and
// 16-byte aligned.  D in {32, 64, 128}; Hq = G Hkv with G <= 64; causal
// needs Sq <= Skv; B and Hkv <= 65535.  Returns 0, a cudaError_t, or
// hopper::kNoEncoder / hopper::kEncodeFailed.
extern "C" int bddt_attn_train_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* o32,
                                   void* lse, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, int causal, float scale,
                                   void* stream) {
  if (!valid_args(B, Hq, Hkv, Sq, Skv, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32)
    return launch_fwd<32>(q, k, v, o, o32, lse, B, Hq, Hkv, Sq, Skv, causal,
                          scale, st);
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, o32, lse, B, Hq, Hkv, Sq, Skv, causal,
                          scale, st);
  return launch_fwd<128>(q, k, v, o, o32, lse, B, Hq, Hkv, Sq, Skv, causal,
                         scale, st);
}

// dq (like q), dk and dv (like k) in bf16 from the forward's q, k, v, o32
// and lse and the output's gradient dout (like q, bf16); delta (B, Hq, Sq)
// f32 is scratch.  Three launches on `stream`: delta, dQ, dK/dV.  The same
// contract and returns as bddt_attn_train_fwd.
extern "C" int bddt_attn_train_bwd(const void* q, const void* k,
                                   const void* v, const void* o32,
                                   const void* lse, const void* dout,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Hq, int Hkv, int Sq, int Skv,
                                   int D, int causal, float scale,
                                   void* stream) {
  if (!valid_args(B, Hq, Hkv, Sq, Skv, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32)
    return launch_bwd<32>(q, k, v, o32, lse, dout, delta, dq, dk, dv, B, Hq,
                          Hkv, Sq, Skv, causal, scale, st);
  if (D == 64)
    return launch_bwd<64>(q, k, v, o32, lse, dout, delta, dq, dk, dv, B, Hq,
                          Hkv, Sq, Skv, causal, scale, st);
  return launch_bwd<128>(q, k, v, o32, lse, dout, delta, dq, dk, dv, B, Hq,
                         Hkv, Sq, Skv, causal, scale, st);
}
