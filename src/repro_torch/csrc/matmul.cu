// Batched tile GEMM and Cholesky tile update for Hopper (sm_90a), FP32.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * matmul_pallas      (src/repro/kernels/matmul/kernel.py, _mm_kernel):
//       out[t] = c[t] + a[t] @ b[t]          a (M,K), b (K,N), c (M,N)
//   * tile_update_pallas (src/repro/kernels/matmul/kernel.py, _update_kernel):
//       out[t] = c[t] - a[t] @ b[t]^T        a (M,K), b (N,K), c (M,N)
// batched over a leading task axis t: one launch serves a whole wave group,
// grid (N/64, M/64, n_tasks), the task axis outermost.
//
// Bound on an H100 at the apps' shapes: the gemm wave (256 tasks of 64^3)
// moves 4 x 16 KiB per task, 16.8 MB, about 5 us at 3.35 TB/s, against
// 134 MFLOP, about 2 us at 67 TFLOP/s FP32: memory-bound.  The Cholesky
// update moves 256 KiB per 128^3 task against 4.2 MFLOP: 78 ns of memory
// against 63 ns of FP32 arithmetic, memory-bound too, near the ridge.
// Design: each block stages 64x16 slices of A and B
// in shared memory over a K loop and each of its 256 threads keeps a 4x4
// register tile, so every operand element is read from device memory once
// per 64-wide output tile.  Products use FP32 FFMA, never TF32: TF32 keeps
// about three decimal digits and misses the 1e-4 tolerance of the
// reference.  The product is accumulated from zero and combined with c in
// the epilogue, the reference's order (c + (a @ b)).  wgmma/TMA are for a
// later change; this one is simple and exact to FP32 rounding.
#include <cuda_runtime.h>
#include <cstddef>

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

}  // namespace

// out[t] = c[t] + a[t] @ b[t]; a (n,M,K), b (n,K,N), c/out (n,M,N)
extern "C" int bddt_matmul_batched(const float* a, const float* b,
                                   const float* c, float* out, int n, int M,
                                   int N, int K, void* stream) {
  return launch<false, false>(a, b, c, out, n, M, N, K, stream);
}

// out[t] = c[t] - a[t] @ b[t]^T; a (n,M,K), b (n,N,K), c/out (n,M,N)
extern "C" int bddt_tile_update_batched(const float* c, const float* a,
                                        const float* b, float* out, int n,
                                        int M, int N, int K, void* stream) {
  return launch<true, true>(a, b, c, out, n, M, N, K, stream);
}
