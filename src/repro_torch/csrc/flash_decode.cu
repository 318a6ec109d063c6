// Flash-decode over one KV shard for Hopper (sm_90a): q, o and lse in
// FP32, K and V in FP32 or bf16, all arithmetic in FP32.
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
// K and V in bf16: the TPU kernel casts each K/V block to f32 before it
// computes, so bf16 K/V work there.  Here the kernel is a template on the
// K/V element type T.  The cp.async rings hold T as it lies in global
// memory, and each element is converted to f32 where it is used (the q.k
// loads and the P.V rows), so a bf16 ring takes half the shared memory
// of an f32 one and the pipeline stays one of 16-byte asynchronous
// copies.
//
// Bound on an H100: memory.  K and V stream past once (2 B Hkv S D 4
// bytes) against 4 flops per element, far below the ridge.  The TPU
// kernel carries the running max, sum and accumulator across a
// sequential grid axis; Hopper has none, and one block per (b, KV head)
// leaves most of the card idle (4 x 8 blocks on 132 SMs at
// Mistral-NeMo-12B's decode width).  So S is split across a thread-block
// cluster:
//
//   * Grid (CS, Hkv, B), clusters of CS = 16 blocks (the non-portable
//     size, allowed at launch), one cluster per (b, KV head).  Block r
//     takes the contiguous keys [r R, min(S, (r + 1) R)); the caller
//     chooses R (kernels/flash_decode/kernel.py::split: ceil(S / CS)
//     rounded up to KB = 32) and the launch refuses an R that leaves keys
//     out.  A block whose range is empty adds nothing.  At the serve path's shape (S 512) each block has 32 keys,
//     one per lane of a warp-stage; 16 blocks rather than 8 halve the
//     chain each warp runs, and at the decode width (512 blocks of 2,048
//     keys) smaller blocks shorten the tail of the last wave.
//   * Inside a block, NW = 4 warps.  Block stage j is the KB keys from
//     r R + j KB; warp w takes its KW = 8 of them and streams them
//     through its own ring of NST = 3 shared-memory stages (16-byte
//     cp.async copies of K and V rows in T, zero fill past the range), so two
//     stages are in flight while one is computed, and the warp needs no
//     barrier but __syncwarp.
//   * q.k without a shuffle reduction per dot product: lane (key l % KW,
//     part l / KW) sums its part of D for every head (q read from shared
//     memory as broadcasts), and two shuffles add the parts.  The loops
//     run all GMAX heads, those past G on zero rows of q, so they hold no
//     branch and the heads' chains interleave.  Each warp keeps its own
//     running max, sum and accumulator (lane l owns elements
//     [l DPL, (l + 1) DPL) of D in P.V; p of key t comes from lane t by a
//     shuffle).
//   * The warps' partials merge in shared memory into the block's, and the
//     blocks' partials merge on rank 0 through distributed shared memory
//     (every rank's m, l and acc read in one round after cluster.sync),
//     which writes o and lse: no global workspace, no counter and no
//     second launch.  Both merges apply the rule of ref.combine_partials
//     on unnormalised sums: M = max_i m_i, L = sum_i l_i e^(m_i - M),
//     o = sum_i acc_i e^(m_i - M) / L, lse = M + log L, a part with
//     m_i = -inf (no key) weighing 0.  expf/logf, not the __ intrinsics.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstddef>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CS = 16;               // blocks per cluster: the split of S
constexpr int NW = 4;                // warps per block
constexpr int KW = 8;                // keys a warp takes per stage
constexpr int KB = NW * KW;          // keys a block takes per stage
constexpr int NST = 3;               // stages in each warp's ring
constexpr int MAX_GRID_Z = 65535;

template <int D, typename T>
struct Layout {
  static constexpr int EPC = 16 / sizeof(T);  // elements of one 16-B copy
  static constexpr int LD = D + EPC;          // row stride (elements):
                                              // rows 16-B aligned, and the
                                              // 8 keys one quarter-warp
                                              // reads at one column on
                                              // distinct banks
  static constexpr int STAGE = 2 * KW * LD;   // KW rows of K, then of V
  static constexpr int RING = NST * STAGE;    // one warp's ring
  // a warp's ring holds its partial (acc [G][D], m [G], l [G] in f32)
  // once its keys are done, for every G up to 8
  static_assert(sizeof(T) * RING >= sizeof(float) * (8 * D + 16),
                "the ring cannot hold a warp's partial");
  static_assert((sizeof(T) * RING) % 16 == 0, "rings stay 16-B aligned");
};

// dynamic shared memory: q [GMAX][D] f32 (zero past G) | NW rings of T |
// the block's partial (acc [G][D], m [G], l [G]) in f32
template <int D, int GMAX, typename T>
size_t smem_bytes(int G) {
  return sizeof(float) * ((size_t)GMAX * D + (size_t)G * (D + 2)) +
         sizeof(T) * (size_t)NW * Layout<D, T>::RING;
}

// 4 consecutive elements from shared memory as f32 (p 4-element aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int DPL, typename T>
__device__ __forceinline__ void load_row(const T* p, float (&x)[DPL]) {
  if constexpr (DPL == 4) {
    const float4 t = load4(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (DPL == 2) {
    const float2 t = load2(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = load1(p);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (CS, Hkv, B), clusters (CS, 1, 1), NW * 32 threads,
// smem_bytes<D, GMAX, T>(G) of dynamic shared memory; G <= GMAX query
// heads per KV head.  The inner loops run all GMAX heads, the ones past G
// on zero rows of q, so that they hold no branch.
template <int D, int GMAX, typename T>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(NW * 32)
flash_decode_split_kernel(const float* __restrict__ q,
                          const T* __restrict__ k,
                          const T* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int Hkv, int G, int S,
                          int range, float scale) {
  using L = Layout<D, T>;
  constexpr int EPC = L::EPC;
  constexpr int DPL = D / 32;        // elements of D a lane owns in P.V
  constexpr int DQ = D / (32 / KW);  // elements of D a lane reads in q.k
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;       // the cluster spans grid x
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);     // [GMAX][D]
  T* const rings = reinterpret_cast<T*>(q_s + (size_t)GMAX * D);  // [NW][RING]
  float* const bpart =                                     // the block's
      reinterpret_cast<float*>(rings + (size_t)NW * L::RING);
  T* const wring = rings + (size_t)warp * L::RING;
  // warp w's partial, in its ring once its keys are done
  auto wpart = [&](int w) {
    return reinterpret_cast<float*>(rings + (size_t)w * L::RING);
  };

  const size_t kv0 = (b * Hkv + h) * (size_t)S * D;
  k += kv0;
  v += kv0;
  const size_t row0 = (b * Hkv + h) * (size_t)G;   // first query head
  const int s_lo = min(S, rank * range), s_hi = min(S, s_lo + range);
  const int n_st = (s_hi - s_lo + KB - 1) / KB;    // this block's stages

  // this warp's KW keys of block stage j into its ring; rows past the
  // range read as zero
  auto load = [&](int j) {
    T* st = wring + (j % NST) * L::STAGE;
    const int key0 = s_lo + j * KB + warp * KW;
    for (int e = lane; e < 2 * KW * (D / EPC); e += 32) {
      const int row = e / (D / EPC), c = (e % (D / EPC)) * EPC;  // K, V
      const int key = key0 + row % KW;
      const bool in = key < s_hi;
      const T* src = (row < KW ? k : v) + (size_t)key * D + c;
      hopper::cp_async16(st + row * L::LD + c, in ? src : k, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < n_st) load(j);
    hopper::cp_async_commit();
  }
  for (int e = threadIdx.x; e < GMAX * D; e += NW * 32)
    q_s[e] = e < G * D ? q[row0 * D + e] : 0.0f;
  __syncthreads();

  float acc[GMAX][DPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.0f;
  }
  const int kk = lane % KW;          // the key this lane scores
  const int part = lane / KW;        // and the part of D it reads

  for (int j = 0; j < n_st; ++j) {
    hopper::cp_async_wait<NST - 2>();       // stage j has landed
    __syncwarp();                           // ... for every lane, and
                                            // stage j - 1 is read
    if (j + NST - 1 < n_st) load(j + NST - 1);
    hopper::cp_async_commit();
    const int key0 = s_lo + j * KB + warp * KW;
    const int nk = min(KW, s_hi - key0);    // keys of this chunk
    if (nk <= 0) continue;                  // warp-uniform
    const T* ks = wring + (j % NST) * L::STAGE;
    const T* vs = ks + KW * L::LD;

    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.0f;
    const T* kr = ks + kk * L::LD + part * DQ;
    const float* qr = q_s + part * DQ;
#pragma unroll
    for (int c = 0; c < DQ; c += 4) {
      const float4 k4 = load4(kr + c);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float4 q4 = *reinterpret_cast<const float4*>(qr + g * D + c);
        s[g] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
      }
    }
    const bool valid = kk < nk;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float x = s[g];
#pragma unroll
      for (int off = KW; off < 32; off <<= 1)       // add the parts of D
        x += __shfl_xor_sync(0xffffffffu, x, off);
      x = valid ? x * scale : -CUDART_INF_F;
      float cmax = x;
#pragma unroll
      for (int off = 1; off < KW; off <<= 1)        // max over the keys
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      // key0 < s_hi, so cmax is finite and m_new is too; the first
      // chunk scales the empty state by expf(-inf) = 0
      const float m_new = fmaxf(m[g], cmax);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(x - m_new);          // 0 past the range
      l[g] = l[g] * alpha + (part == 0 ? p : 0.0f);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
      m[g] = m_new;
      s[g] = p;
    }
    // P.V; rows past the range are zero and their p is 0
#pragma unroll
    for (int t = 0; t < KW; ++t) {
      float vr[DPL];
      load_row<DPL>(vs + t * L::LD + lane * DPL, vr);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float pt = __shfl_sync(0xffffffffu, s[g], t);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += pt * vr[i];
      }
    }
  }

  // the warp's partial into its own ring (acc [G][D], m [G], l [G])
  hopper::cp_async_wait<0>();
  __syncwarp();
  float* const w_acc = wpart(warp);
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const float lsum = warp_sum(l[g]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) w_acc[g * D + lane * DPL + i] = acc[g][i];
      if (lane == 0) {
        w_acc[G * D + g] = m[g];
        w_acc[G * D + G + g] = lsum;
      }
    }
  }
  __syncthreads();

  // the block's partial from its warps' (a warp with no key has m = -inf)
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int g = idx / D;
    float big = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < NW; ++w) big = fmaxf(big, wpart(w)[G * D + g]);
    float sum = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* wp = wpart(w);
      const float mw = wp[G * D + g];
      const float e = mw == -CUDART_INF_F ? 0.0f : expf(mw - big);
      sum += wp[G * D + G + g] * e;
      num += wp[idx] * e;
    }
    bpart[idx] = num;
    if (idx % D == 0) {
      bpart[G * D + g] = big;
      bpart[G * D + G + g] = sum;
    }
  }
  cluster.sync();      // every block's partial is written and visible

  if (rank == 0) {
    float* ob = o + row0 * D;
    for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
      const int g = idx / D;
      // every rank's m, l and acc in one round of loads
      float mr[CS], lr[CS], ar[CS];
#pragma unroll
      for (int r = 0; r < CS; ++r) {
        const float* rp = cluster.map_shared_rank(bpart, r);
        mr[r] = rp[G * D + g];
        lr[r] = rp[G * D + G + g];
        ar[r] = rp[idx];
      }
      float big = -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < CS; ++r) big = fmaxf(big, mr[r]);
      float sum = 0.0f, num = 0.0f;
#pragma unroll
      for (int r = 0; r < CS; ++r) {       // a block with no key adds 0
        const float e = mr[r] == -CUDART_INF_F ? 0.0f : expf(mr[r] - big);
        sum += lr[r] * e;
        num += ar[r] * e;
      }
      ob[idx] = sum == 0.0f ? 0.0f : num / sum;
      if (idx % D == 0) lse[row0 + g] = sum == 0.0f ? -1e30f : big + logf(sum);
    }
  }
  cluster.sync();      // rank 0 has read every block's shared memory
}

// The kernel's launch attributes, set once per device: the dynamic shared
// memory of its largest group and a cluster above the portable size.
template <int D, int GMAX, typename T>
cudaError_t prepare() {
  static std::atomic<unsigned long long> done{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_decode_split_kernel<D, GMAX, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<D, GMAX, T>(GMAX));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_decode_split_kernel<D, GMAX, T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int D, int GMAX, typename T>
int launch(const float* q, const T* k, const T* v, float* o, float* lse,
           int B, int Hkv, int G, int S, int range, float scale,
           cudaStream_t stream) {
  cudaError_t err = prepare<D, GMAX, T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes<D, GMAX, T>(G);
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Z) {
    const int nb = (B - b0) < MAX_GRID_Z ? (B - b0) : MAX_GRID_Z;
    const size_t qo = (size_t)b0 * Hkv * G;
    flash_decode_split_kernel<D, GMAX, T>
        <<<dim3(CS, Hkv, nb), NW * 32, smem, stream>>>(
            q + qo * D, k + (size_t)b0 * Hkv * S * D,
            v + (size_t)b0 * Hkv * S * D, o + qo * D, lse + qo, Hkv, G, S,
            range, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// dynamic shared memory of a block and the clusters the card holds at
// once, for G query heads per KV head
template <int D, int GMAX, typename T>
int describe(int G, int* smem, int* resident) {
  *smem = (int)smem_bytes<D, GMAX, T>(G);
  cudaError_t err = prepare<D, GMAX, T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CS, 1, 1);
  config.blockDim = dim3(NW * 32, 1, 1);
  config.dynamicSmemBytes = *smem;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      resident, (const void*)flash_decode_split_kernel<D, GMAX, T>,
      &config));
}

template <int D_, int GMAX_>
struct Variant {
  static constexpr int D = D_, GMAX = GMAX_;
};

// f(Variant<D, GMAX>{}) for the instantiation that serves head dim D and G
// query heads per KV head (GMAX the least of 1, 2, 4, 8 that holds G)
template <int D, typename F>
int with_group(int G, F f) {
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (G <= 1) return f(Variant<D, 1>{});
  if (G <= 2) return f(Variant<D, 2>{});
  if (G <= 4) return f(Variant<D, 4>{});
  if (G <= 8) return f(Variant<D, 8>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int with_variant(int D, int G, F f) {
  switch (D) {
    case 32: return with_group<32>(G, f);
    case 64: return with_group<64>(G, f);
    case 128: return with_group<128>(G, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// o (B,Hq,D), lse (B,Hq) = one-token attention of q (B,Hq,D) over
// k, v (B,Hkv,S,D) of element type T; q, o and lse f32; all contiguous,
// 16-byte aligned.  D in {32, 64, 128}, Hq = G * Hkv with G <= 8, S >= 1;
// block r of a cluster takes keys [r range, (r + 1) range), and CS * range
// must cover S.
template <typename T>
int entry(const float* q, const T* k, const T* v, float* o, float* lse,
          int B, int Hq, int Hkv, int S, int D, int range, float scale,
          void* stream) {
  if (B < 1 || Hkv < 1 || S < 1 || Hq % Hkv != 0 || range < 1 ||
      (long long)CS * range < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_variant(D, G, [&](auto var) {
    using V = decltype(var);
    return launch<V::D, V::GMAX, T>(q, k, v, o, lse, B, Hkv, G, S, range,
                                    scale, s);
  });
}

}  // namespace

// K and V in f32
extern "C" int bddt_flash_decode(const float* q, const float* k,
                                 const float* v, float* o, float* lse,
                                 int B, int Hq, int Hkv, int S, int D,
                                 int range, float scale, void* stream) {
  return entry<float>(q, k, v, o, lse, B, Hq, Hkv, S, D, range, scale,
                      stream);
}

// K and V in bf16, converted to f32 where they are used
extern "C" int bddt_flash_decode_bf16(const float* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, float* o,
                                      float* lse, int B, int Hq, int Hkv,
                                      int S, int D, int range, float scale,
                                      void* stream) {
  return entry<__nv_bfloat16>(q, k, v, o, lse, B, Hq, Hkv, S, D, range,
                              scale, stream);
}

// The dynamic shared memory of a block and the clusters the card holds at
// once, for G query heads per KV head at head dim D with K and V of
// kv_bytes bytes an element (4: f32, 2: bf16); 0 on success
extern "C" int bddt_flash_decode_describe(int G, int D, int kv_bytes,
                                          int* smem, int* resident) {
  if (kv_bytes != 4 && kv_bytes != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_variant(D, G, [&](auto var) {
    using V = decltype(var);
    return kv_bytes == 4
               ? describe<V::D, V::GMAX, float>(G, smem, resident)
               : describe<V::D, V::GMAX, __nv_bfloat16>(G, smem, resident);
  });
}
