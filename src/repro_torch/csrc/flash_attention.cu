// Blocked causal or full attention with an online softmax, for Hopper
// (sm_90a): a wgmma kernel fed by TMA for bf16 operands, an FP32 FFMA
// kernel for f32 ones.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, _flash_kernel).  For q
// (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), G = Hq / Hkv query heads per
// KV head (head h reads KV head h / G) and kv_offset = Skv - Sq:
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h/G, j])
//                v[b, h/G, j]
// over the keys j <= i + kv_offset when causal, all keys otherwise, in
// q's dtype; running max, sum and accumulator in f32.
//
// The TPU kernel's semantics for a query row that sees no key (causal,
// Sq > Skv) are kept.  It runs whole (bq, bk) blocks, masks with the
// finite -1e30 and skips the key blocks past its query block's last row,
// so such a row averages V over the key blocks its query block ran,
// [0, (floor((floor(i / bq) bq + bq - 1 + kv_offset) / bk) + 1) bk)
// capped at Skv, or gives 0 when that range is empty.  The caller's bq
// and bk decide only that range; these kernels tile as they like.  Each
// row keeps two limits (row_limits): keys below `vis` score for real,
// keys below `lim` (lim > vis only for a row that sees no key) score
// -1e30, and the others are left out (-inf, so they add exactly 0).
//
// Bound on an H100 (SXM, 700 W): operations at the prefill shapes.  4 D
// flops per visible (query, key) pair; at q (4, 32, 1024, 128) causal
// that is 34.4 GFLOP, 0.035 ms at the tensor cores' 989 TFLOP/s for bf16
// operands, above the 0.025 ms that its 83.9 MB take at 3.35 TB/s.
//
// Both kernels: the TPU kernel carries its running max, sum and
// accumulator across a sequential grid axis over key blocks; Hopper has
// none, so one block owns a (batch, KV head, query tile) and loops over
// the key tiles itself.  Its 64 query rows are all G query heads of that
// KV head times 64 / G positions, so each K and V tile is read once for
// the whole group, as the Pallas index map h // group does (a split per
// head would read each tile G times from L2 for the same work).  Key
// tiles past the block's largest limit are not visited.
//
// bf16 (flash_attention_bf16_kernel).  One consumer warpgroup (128
// threads, the 64 rows of one wgmma) and one producer warp.  One thread
// of the producer warp loads the Q tile once and streams 64-key K and V
// tiles through a ring of two stages with TMA (cp.async.bulk.tensor, 3-D
// tensor maps over (B*H, S, D), 128-byte swizzle, 64-byte at D 32, zero
// fill past Sq and Skv), each stage completing on an mbarrier; the
// consumers release a stage on a second mbarrier once both products have
// read it, so the next tiles load while this one computes.  S = Q K^T is
// wgmma m64n64k16 with both operands in shared memory, K-major (the
// natural layout of q and k).  The online softmax runs on the
// accumulator fragments: a row lives on four lanes, which agree on its
// max by two shuffles; exp2 with scale * log2(e) folded in; masks only on
// tiles that some valid row does not see whole.  P is rounded to bf16 in
// registers and is the register A operand of O += P V, wgmma m64nDk16,
// with V read from shared memory in its MN-major (transposed) form.  The
// last query tiles, the longest when causal, are launched first.
// Numerics: rounding P to bf16 is the one step the f32 reference does
// not take, at most 2^-9 relative per probability; with the rows' sums
// taken from the unrounded P, the output moves by at most 2^-9 of the
// largest |v| (9e-3 for unit-normal V at the prefill shape, where
// max |v| is about 4.5; the errors of a row average out to some 1e-3),
// inside the bf16 tolerance of 2e-2.
//
// f32 (flash_attention_f32_kernel).  256 threads; the tile of 64 keys is
// staged through dynamic shared memory (row stride D + 4: float4-aligned,
// and the 16 key rows a half-warp reads fall on distinct banks).  Thread
// (ty, tx) scores rows ty + 16 i against keys tx + 16 j (i, j < 4) with
// FP32 FFMA, the 16 threads of a row agree on its running max through
// shuffles, keep partial sums, and accumulate p.V for their rows' D / 16
// output columns in registers; the probabilities pass through shared
// memory (over the K tile once the scores are taken, when it fits).  TF32
// would miss the f32 tolerance of 2e-5, so f32 stays off the tensor
// cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int ROWS = 64;       // query rows per block: heads x positions
constexpr int BK = 64;         // keys per tile
constexpr float MASKED = -1e30f;

// Keys [0, vis) of query position qpos score, [vis, lim) mask to -1e30,
// the rest are left out.
__device__ __forceinline__ void row_limits(int qpos, int Sq, int Skv,
                                           int causal, int bq, int bk,
                                           int& vis, int& lim) {
  if (qpos >= Sq) {
    vis = lim = 0;
  } else if (!causal) {
    vis = lim = Skv;
  } else {
    const int kv_off = Skv - Sq;
    const int last = qpos + kv_off;              // last visible key
    vis = last < 0 ? 0 : (last + 1 < Skv ? last + 1 : Skv);
    if (vis > 0) {
      lim = vis;
    } else {
      const int last_q = (qpos / bq) * bq + bq - 1 + kv_off;
      const int ran = last_q < 0 ? 0 : (last_q / bk + 1) * bk;
      lim = ran < Skv ? ran : Skv;
    }
  }
}

// ------------------------------------------------------------------ bf16
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int CONSUMERS = 128;            // one warpgroup: 64 rows
constexpr int BF16_THREADS = CONSUMERS + 32;   // + the producer warp

template <int D>
struct Bf16Layout {
  static constexpr int SW = D < 64 ? D : 64;         // elements a row
  static constexpr int ROW_BYTES = 2 * SW;           // 64 or 128
  static constexpr int NC = D / SW;                  // column chunks
  static constexpr uint32_t SWIZZLE = SW == 64 ? 1 : 2;   // 128 B, 64 B
  static constexpr int SBO = 8 * ROW_BYTES;          // next 8 rows
  static constexpr int Q_CHUNK = ROWS * ROW_BYTES;
  static constexpr int KV_CHUNK = BK * ROW_BYTES;
  static constexpr int Q_BYTES = NC * Q_CHUNK;
  static constexpr int KV_BYTES = NC * KV_CHUNK;     // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;   // K then V
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;
};

// grid (ceil(Sq / (ROWS / G)), Hkv, B), BF16_THREADS threads, dynamic
// shared memory Bf16Layout<D>::SMEM bytes.  Row r of the block is head
// hk * G + r / per at position q0 + r % per (per = ROWS / G), the order of
// the Q box (D, per, G); rows from G * per on are zero and see no key.
template <int D>
__global__ void __launch_bounds__(BF16_THREADS, 2)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                            int Sq, int Skv, int causal, int bq, int bk,
                            float scale_log2) {
  using L = Bf16Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, full[STAGES], empty[STAGES];
  __shared__ int lim_max, vis_min;
  // swizzle atoms need 1024-byte alignment
  uint8_t* const Qs =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const KVs = Qs + L::Q_BYTES;

  const int G = Hq / Hkv;
  const int per = ROWS / G;
  // the last query tiles, which see the most keys when causal, go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * per;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
    lim_max = 0;
    vis_min = Skv;
  }
  // zero the rows no Q box fills; wgmma reads them through the async proxy
  const int filled = G * per * L::ROW_BYTES / 16;   // 16-byte units a chunk
  for (int i = tid; i < L::Q_BYTES / 16; i += BF16_THREADS)
    if (i % (L::Q_CHUNK / 16) >= filled)
      reinterpret_cast<uint4*>(Qs)[i] = make_uint4(0, 0, 0, 0);
  hopper::fence_proxy_async();
  __syncthreads();
  if (tid < ROWS) {
    int vis, lim;
    const bool valid = tid < G * per;
    row_limits(valid ? q0 + tid % per : Sq, Sq, Skv, causal, bq, bk, vis,
               lim);
    atomicMax(&lim_max, lim);
    if (valid && q0 + tid % per < Sq) atomicMin(&vis_min, vis);
  }
  __syncthreads();
  const int n_tiles = (lim_max + BK - 1) / BK;
  const int all_see = vis_min;        // keys every valid row sees

  if (tid >= CONSUMERS) {
    // producer: one thread starts every copy
    if (tid == CONSUMERS) {
      hopper::mbar_expect_tx(&q_full, L::NC * L::ROW_BYTES * per * G);
      for (int c = 0; c < L::NC; ++c)
        hopper::tma_load_3d(Qs + c * L::Q_CHUNK, &qmap, &q_full, c * L::SW,
                            q0, b * Hq + hk * G);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        hopper::mbar_expect_tx(&full[s], L::STAGE_BYTES);
        uint8_t* const Ks = KVs + s * L::STAGE_BYTES;
        for (int c = 0; c < L::NC; ++c) {
          hopper::tma_load_3d(Ks + c * L::KV_CHUNK, &kmap, &full[s],
                              c * L::SW, t * BK, b * Hkv + hk);
          hopper::tma_load_3d(Ks + L::KV_BYTES + c * L::KV_CHUNK, &vmap,
                              &full[s], c * L::SW, t * BK, b * Hkv + hk);
        }
      }
    }
    return;
  }

  // consumers: thread (warp w, lane) holds rows r0 = 16 w + lane / 4 and
  // r0 + 8; accumulator element i is row r0 + 8 ((i >> 1) & 1), column
  // 8 (i >> 2) + 2 (lane % 4) + (i & 1)
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  int vis[2], lim[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    row_limits(r < G * per ? q0 + r % per : Sq, Sq, Skv, causal, bq, bk,
               vis[h], lim[h]);
    m[h] = MASKED;
    l[h] = 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const uint32_t q_addr = hopper::smem_u32(Qs);
  hopper::mbar_wait(&q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t k_addr = hopper::smem_u32(KVs + s * L::STAGE_BYTES);
    const uint32_t v_addr = k_addr + L::KV_BYTES;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);

    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < L::NC; ++c)
#pragma unroll
      for (int kk = 0; kk < L::SW / 16; ++kk)
        hopper::Wgmma<BK>::ss(
            sc,
            hopper::make_desc(q_addr + c * L::Q_CHUNK + 32 * kk, 16, L::SBO,
                              L::SWIZZLE),
            hopper::make_desc(k_addr + c * L::KV_CHUNK + 32 * kk, 16, L::SBO,
                              L::SWIZZLE),
            c + kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // online softmax in log2 units; m starts at -1e30, so m_new is finite
    // and every exp2 below is too
    const int k0 = t * BK;
    const bool whole = k0 + BK <= all_see;
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float x = sc[i] * scale_log2;
      if (!whole) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        x = key < vis[h] ? x : (key < lim[h] ? MASKED : -CUDART_INF_F);
      }
      sc[i] = x;
      mt[h] = fmaxf(mt[h], x);
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
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - m[h]), p1 = exp2f(sc[i + 1] - m[h]);
      l[h] += p0 + p1;
      const __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
      pf[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&pp);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::Wgmma<D>::rs(
          acc, pf[kk],
          hopper::make_desc(v_addr + 16 * kk * L::ROW_BYTES, L::KV_CHUNK,
                            L::SBO, L::SWIZZLE));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);      // both products have read stage s
  }

  // each row's sum over its four lanes; a row that ran no key gives 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int qpos = q0 + r % per;
    if (r >= G * per || qpos >= Sq) continue;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* orow =
        o + (((size_t)b * Hq + hk * G + r / per) * Sq + qpos) * D +
        2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / denom,
                                acc[4 * j + 2 * h + 1] / denom);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int Sq, int Skv, int causal, int bq, int bk,
                float scale, cudaStream_t stream) {
  using L = Bf16Layout<D>;
  const int G = Hq / Hkv, per = ROWS / G;
  const CUtensorMapSwizzle sw =
      L::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap qm, km, vm;
  int rc = hopper::encode_bf16_3d(&qm, q, D, Sq, (uint64_t)B * Hq, L::SW, per,
                                  G, sw);
  if (rc == 0)
    rc = hopper::encode_bf16_3d(&km, k, D, Skv, (uint64_t)B * Hkv, L::SW, BK,
                                1, sw);
  if (rc == 0)
    rc = hopper::encode_bf16_3d(&vm, v, D, Skv, (uint64_t)B * Hkv, L::SW, BK,
                                1, sw);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + per - 1) / per, Hkv, B);
  flash_attention_bf16_kernel<D><<<grid, BF16_THREADS, L::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, causal,
      bq, bk, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- f32
constexpr int THREADS = 256;   // 16 x 16
constexpr int PLD = BK + 4;    // probability row stride (floats)

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
// memory Layout<D>::FLOATS floats.  Row r of the block is position
// q0 + r / G of head hk * G + r % G.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int Hq, int Hkv, int Sq, int Skv, int causal,
                           int bq, int bk, float scale) {
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
  const float* kb = k + (b * Hkv + hk) * (size_t)Skv * D;
  const float* vb = v + (b * Hkv + hk) * (size_t)Skv * D;

  if (tid == 0) lim_max = 0;

  // stage the block's query rows: rows past Sq or past G * per are zero
  // and see no key
  for (int idx = tid; idx < ROWS * (D / 4); idx += THREADS) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const int qpos = q0 + r / G;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < G * per && qpos < Sq) {
      const size_t h = (size_t)hk * G + r % G;
      x = *reinterpret_cast<const float4*>(q + ((b * Hq + h) * Sq + qpos) *
                                                   D + c);
    }
    *reinterpret_cast<float4*>(Qs + r * LD + c) = x;
  }

  int vis[4], lim[4];
  float m[4], l[4], acc[4][NJ * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    row_limits(r < G * per ? q0 + r / G : Sq, Sq, Skv, causal, bq, bk,
               vis[i], lim[i]);
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
        kx = *reinterpret_cast<const float4*>(kb + (size_t)(k0 + r) * D + c);
        vx = *reinterpret_cast<const float4*>(vb + (size_t)(k0 + r) * D + c);
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
    float* orow = o + ((b * Hq + h) * Sq + qpos) * D + VW * tx;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int w = 0; w < VW; ++w)
        orow[16 * VW * jj + w] = acc[i][jj * VW + w] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Skv, int causal, int bq, int bk,
               float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = ROWS / (Hq / Hkv);
  const dim3 grid((Sq + per - 1) / per, Hkv, B);
  flash_attention_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Sq, Skv,
      causal, bq, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, void*, int, int,
                       int, int, int, int, int, int, float, cudaStream_t);

bool valid_args(int B, int Hq, int Hkv, int Sq, int Skv, int bq, int bk) {
  return B >= 1 && Hkv >= 1 && Sq >= 1 && Skv >= 1 && bq >= 1 && bk >= 1 &&
         Hq % Hkv == 0 && Hq / Hkv <= ROWS && B <= 65535 && Hkv <= 65535;
}

int dispatch(Launch d32, Launch d64, Launch d128, const void* q,
             const void* k, const void* v, void* o, int B, int Hq, int Hkv,
             int Sq, int Skv, int D, int causal, int bq, int bk, float scale,
             void* stream) {
  if (!valid_args(B, Hq, Hkv, Sq, Skv, bq, bk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch fn = D == 32 ? d32 : D == 64 ? d64 : D == 128 ? d128 : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, bq, bk, scale,
            static_cast<cudaStream_t>(stream));
}

}  // namespace

// o (B, Hq, Sq, D) = attention of q (B, Hq, Sq, D) over k, v
// (B, Hkv, Skv, D); all contiguous and 16-byte aligned, of the entry's
// dtype.  D in {32, 64, 128}; Hq = G * Hkv with G <= 64; B and Hkv <=
// 65535; bq and bk the TPU kernel's block sizes (already min'd with Sq and
// Skv).  Returns 0, a cudaError_t, or (bf16) hopper::kNoEncoder /
// hopper::kEncodeFailed when a TMA tensor map cannot be made.
extern "C" int bddt_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int Hq, int Hkv, int Sq, int Skv,
                                         int D, int causal, int bq, int bk,
                                         float scale, void* stream) {
  return dispatch(launch_bf16<32>, launch_bf16<64>, launch_bf16<128>, q, k,
                  v, o, B, Hq, Hkv, Sq, Skv, D, causal, bq, bk, scale,
                  stream);
}

extern "C" int bddt_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, int B,
                                        int Hq, int Hkv, int Sq, int Skv,
                                        int D, int causal, int bq, int bk,
                                        float scale, void* stream) {
  return dispatch(launch_f32<32>, launch_f32<64>, launch_f32<128>, q, k, v,
                  o, B, Hq, Hkv, Sq, Skv, D, causal, bq, bk, scale, stream);
}
