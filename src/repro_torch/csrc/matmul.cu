// Batched tile GEMM and Cholesky tile update for Hopper (sm_90a), f32.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * matmul_pallas      (src/repro/kernels/matmul/kernel.py, _mm_kernel):
//       out[t] = c[t] + a[t] @ b[t]          a (M,K), b (K,N), c (M,N)
//   * tile_update_pallas (src/repro/kernels/matmul/kernel.py, _update_kernel):
//       out[t] = c[t] - a[t] @ b[t]^T        a (M,K), b (N,K), c (M,N)
// batched over a leading task axis t: one launch serves a whole wave group,
// the task axis the grid's outermost (z) axis.
//
// GEMM (tile_gemm_kernel).  Bound on an H100 (SXM, 700 W) at the matmul
// app's wave (256 tasks of 64^3): 16.8 MB, about 5 us at 3.35 TB/s,
// against 134 MFLOP, about 2 us at 67 TFLOP/s FP32: memory-bound.  Each
// block stages 64x16 slices of A and B in shared memory over a K loop and
// each of its 256 threads keeps a 4x4 register tile, so every operand
// element is read from device memory once per 64-wide output tile.
// Products use FP32 FFMA, never plain TF32: TF32 keeps about three decimal
// digits and misses the 1e-4 tolerance of the reference.  The product is
// accumulated from zero and combined with c in the epilogue, the
// reference's order (c + (a @ b)).
//
// Tile update (tile_update_3xtf32_kernel).  Bound at the Cholesky app's
// largest wave (120 tasks of 128^3): 31.5 MB, 9.4 us at 3.35 TB/s, against
// three tf32 products of 503 MFLOP each, about 3 us at 495 TFLOP/s:
// memory-bound, so the design's job is to keep loads in flight.  One block
// of 256 threads owns a 64x128 output tile of one task (240 blocks at that
// wave, enough for 132 SMs at two blocks each, where 128x128 tiles would
// give 120 blocks and leave 12 SMs idle).  32-deep slices of a and b stream
// through a ring of three shared-memory stages with cp.async (16-byte
// copies when K is a multiple of 4, else 4-byte ones; zero fill past K, M
// and N), so two slices load while one is multiplied.  Products run on the
// tensor cores as 3xTF32: each operand splits into hi = tf32(x) and
// lo = tf32(x - hi), and mma.sync m16n8k8 accumulates a_lo b_hi + a_hi
// b_lo + a_hi b_hi in f32 (the a_lo b_lo term, 2^-22 relative, is left
// out).  Each product is then exact to some 2^-21 relative, near f32's
// 2^-24, where plain TF32 gives 2^-11; at K 128 with unit-normal operands
// that is some 1e-5 absolute against the 1e-4 tolerance.  The epilogue
// subtracts from c.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output cols per block
constexpr int BK = 16;       // depth of one shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int MAX_GRID_Z = 65535;

template <bool TRANS_B, bool SUBTRACT>
__global__ void __launch_bounds__(THREADS)
tile_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ out,
                 int M, int N, int K) {
  // As[k][m] and Bs[k][n]: k-major so the inner product reads rows; the
  // +1 pad spreads the transposing stores of A (and of B^T) over banks
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const size_t t = blockIdx.z;
  a += t * (size_t)M * K;
  b += t * (size_t)K * N;
  c += t * (size_t)M * N;
  out += t * (size_t)M * N;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16;   // output cols tx + 16 j
  const int ty = threadIdx.x / 16;   // output rows ty + 16 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A slice (BM x BK): consecutive threads read consecutive k of a row
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int m = e / BK, k = e % BK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : 0.0f;
    }
    if (TRANS_B) {
      // b is (N, K): B^T slice read row by row of b, like A
      for (int e = threadIdx.x; e < BN * BK; e += THREADS) {
        const int n = e / BK, k = e % BK;
        const int gn = col0 + n, gk = k0 + k;
        Bs[k][n] = (gn < N && gk < K) ? b[(size_t)gn * K + gk] : 0.0f;
      }
    } else {
      // b is (K, N): consecutive threads read consecutive n
      for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
        const int k = e / BN, n = e % BN;
        const int gk = k0 + k, gn = col0 + n;
        Bs[k][n] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      out[o] = SUBTRACT ? c[o] - acc[i][j] : c[o] + acc[i][j];
    }
  }
}

template <bool TRANS_B, bool SUBTRACT>
int launch(const float* a, const float* b, const float* c, float* out,
           int n, int M, int N, int K, void* stream) {
  const dim3 block(THREADS);
  const size_t sa = (size_t)M * K, sb = (size_t)K * N, sc = (size_t)M * N;
  // the task axis is grid z, capped at 65,535 per launch by CUDA
  for (int t0 = 0; t0 < n; t0 += MAX_GRID_Z) {
    const int nt = (n - t0) < MAX_GRID_Z ? (n - t0) : MAX_GRID_Z;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nt);
    tile_gemm_kernel<TRANS_B, SUBTRACT>
        <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            a + t0 * sa, b + t0 * sb, c + t0 * sc, out + t0 * sc, M, N, K);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ 3xTF32 tile update
constexpr int UM = 64;           // output rows per block
constexpr int UN = 128;          // output cols per block
constexpr int UK = 32;           // depth of one stage
constexpr int ULD = UK + 4;      // shared row stride (floats): the 8 rows
                                 // and 4 columns a fragment reads hit
                                 // distinct banks; rows stay 16-B aligned
constexpr int USTAGES = 3;
constexpr int UTHREADS = 256;    // 8 warps, 2 x 4, each 32 x 32 outputs
constexpr size_t USTAGE_FLOATS = (size_t)(UM + UN) * ULD;
constexpr size_t USMEM = USTAGES * USTAGE_FLOATS * sizeof(float);

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = hopper::to_tf32(x);
  lo = hopper::to_tf32(x - __uint_as_float(hi));
}

// one UK-deep slice of a (rows of M) or b (rows of N) into shared memory,
// zero past the matrix
template <bool VEC, int ROWS>
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int rows, int K, int r0, int k0) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < ROWS * (UK / 4); e += UTHREADS) {
      const int r = e / (UK / 4), kc = (e % (UK / 4)) * 4;
      const bool in = r0 + r < rows && k0 + kc < K;
      hopper::cp_async16(dst + r * ULD + kc,
                         in ? src + (size_t)(r0 + r) * K + k0 + kc : src,
                         in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * UK; e += UTHREADS) {
      const int r = e / UK, kc = e % UK;
      const bool in = r0 + r < rows && k0 + kc < K;
      hopper::cp_async4(dst + r * ULD + kc,
                        in ? src + (size_t)(r0 + r) * K + k0 + kc : src,
                        in ? 4 : 0);
    }
  }
}

// grid (ceil(N / UN), ceil(M / UM), tasks), UTHREADS threads, USMEM bytes
// of dynamic shared memory
template <bool VEC>
__global__ void __launch_bounds__(UTHREADS, 2)
tile_update_3xtf32_kernel(const float* __restrict__ c,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          float* __restrict__ out, int M, int N, int K) {
  extern __shared__ float4 usmem4[];
  float* const smem = reinterpret_cast<float*>(usmem4);
  const size_t t = blockIdx.z;
  a += t * (size_t)M * K;
  b += t * (size_t)N * K;
  c += t * (size_t)M * N;
  out += t * (size_t)M * N;
  const int row0 = blockIdx.y * UM, col0 = blockIdx.x * UN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;   // warp's corner
  const int g = lane / 4, q = lane % 4;                    // fragment coords

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = (K + UK - 1) / UK;
  auto stage = [&](int s) { return smem + s * USTAGE_FLOATS; };
  auto load = [&](int kt) {
    float* st = stage(kt % USTAGES);
    load_slice<VEC, UM>(st, a, M, K, row0, kt * UK);
    load_slice<VEC, UN>(st + UM * ULD, b, N, K, col0, kt * UK);
  };
#pragma unroll
  for (int kt = 0; kt < USTAGES - 1; ++kt) {
    if (kt < n_k) load(kt);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    hopper::cp_async_wait<USTAGES - 2>();   // slice kt has landed
    __syncthreads();                        // ... for every thread, and
                                            // slice kt - 1 is read
    if (kt + USTAGES - 1 < n_k) load(kt + USTAGES - 1);
    hopper::cp_async_commit();
    const float* As = stage(kt % USTAGES);
    const float* Bs = As + UM * ULD;
#pragma unroll
    for (int ks = 0; ks < UK; ks += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* ar = As + (wm + 16 * i + g) * ULD + ks + q;
        split_tf32(ar[0], ahi[i][0], alo[i][0]);
        split_tf32(ar[8 * ULD], ahi[i][1], alo[i][1]);
        split_tf32(ar[4], ahi[i][2], alo[i][2]);
        split_tf32(ar[8 * ULD + 4], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* br = Bs + (wn + 8 * j + g) * ULD + ks + q;
        split_tf32(br[0], bhi[j][0], blo[j][0]);
        split_tf32(br[4], bhi[j][1], blo[j][1]);
      }
      // the small terms first
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hopper::mma_tf32(acc[i][j], alo[i], bhi[j]);
          hopper::mma_tf32(acc[i][j], ahi[i], blo[j]);
          hopper::mma_tf32(acc[i][j], ahi[i], bhi[j]);
        }
    }
  }

  // accumulator e of (i, j): row g + 8 (e >> 1), column 2 q + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gm = row0 + wm + 16 * i + g + 8 * (e >> 1);
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = col0 + wn + 8 * j + 2 * q + (e & 1);
        if (gn >= N) continue;
        const size_t o = (size_t)gm * N + gn;
        out[o] = c[o] - acc[i][j][e];
      }
    }
}

template <bool VEC>
int launch_update(const float* c, const float* a, const float* b,
                  float* out, int n, int M, int N, int K, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tile_update_3xtf32_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)USMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t sa = (size_t)M * K, sb = (size_t)N * K, sc = (size_t)M * N;
  for (int t0 = 0; t0 < n; t0 += MAX_GRID_Z) {
    const int nt = (n - t0) < MAX_GRID_Z ? (n - t0) : MAX_GRID_Z;
    const dim3 grid((N + UN - 1) / UN, (M + UM - 1) / UM, nt);
    tile_update_3xtf32_kernel<VEC>
        <<<grid, UTHREADS, USMEM, static_cast<cudaStream_t>(stream)>>>(
            c + t0 * sc, a + t0 * sa, b + t0 * sb, out + t0 * sc, M, N, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[t] = c[t] + a[t] @ b[t]; a (n,M,K), b (n,K,N), c/out (n,M,N)
extern "C" int bddt_matmul_batched(const float* a, const float* b,
                                   const float* c, float* out, int n, int M,
                                   int N, int K, void* stream) {
  return launch<false, false>(a, b, c, out, n, M, N, K, stream);
}

// out[t] = c[t] - a[t] @ b[t]^T; a (n,M,K), b (n,N,K), c/out (n,M,N); 16-byte
// copies when every row of a and b starts 16-byte aligned
extern "C" int bddt_tile_update_batched(const float* c, const float* a,
                                        const float* b, float* out, int n,
                                        int M, int N, int K, void* stream) {
  const bool vec = K % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  return vec ? launch_update<true>(c, a, b, out, n, M, N, K, stream)
             : launch_update<false>(c, a, b, out, n, M, N, K, stream);
}
