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
// Both are memory-bound on an H100 (SXM, 700 W): the matmul app's wave
// (256 tasks of 64^3) moves 16.8 MB, 5.0 us at 3.35 TB/s, and the Cholesky
// app's largest update wave (120 tasks of 128^3) 31.5 MB, 9.4 us, against
// three tf32 products of 0.13 and 0.50 GFLOP, well under 2 us at
// 495 TFLOP/s.  So the design's job is to keep loads in flight.  One body,
// tile_mma_3xtf32, serves both kernels; what differs is a template
// parameter (Op):
//
//   * Products on the tensor cores as 3xTF32: each operand splits into
//     hi = tf32(x) and lo = tf32(x - hi), and mma.sync m16n8k8 accumulates
//     a_lo b_hi + a_hi b_lo + a_hi b_hi in f32 (the a_lo b_lo term, 2^-22
//     relative, is left out).  Each product is then exact to some 2^-21
//     relative, near f32's 2^-24, where plain TF32 gives 2^-11 and misses
//     the reference's 1e-4 at K 64 and K 128.  Every warp owns a 32x32
//     output tile.
//   * 32-deep slices of a and b stream through a ring of three
//     shared-memory stages with cp.async (16-byte copies when rows are
//     16-byte aligned, else 4-byte ones; zero fill past M, N and K).  The
//     prologue issues two slices before the first product, so at K <= 64
//     (the matmul app's tiles) every operand byte is in flight at once.
//   * a is staged [m][k] with a row stride of 36 floats, so the 8 rows and
//     4 columns an A fragment reads fall on distinct banks.  The tile
//     update stages b (N,K) the same way.  The GEMM reads b in its own
//     (K,N) layout, staged [k][n] with a row stride of N_tile + 8 floats:
//     a B fragment reads B[k0+q][n0+g] and B[k0+q+4][n0+g], which then fall
//     on bank 8q + g, all distinct; its 16-byte copies run along n.
//   * GEMM (Op::kGemm): tiles of 64x64 outputs per block of 4 warps (256
//     blocks at the app's wave; 32x64 tiles, 512 blocks, measured slower
//     on the H100, PERF.md section 6).  c's fragments are read into registers right after the
//     prologue, so their round trip overlaps the operands'.  The product
//     is accumulated from zero and c added in the epilogue, the
//     reference's order (c + (a @ b)); each thread stores its two adjacent
//     columns as one float2.
//   * Tile update (Op::kUpdate): 64x128 outputs per block of 8 warps (240
//     blocks at the Cholesky wave, two an SM, where 128x128 tiles would
//     leave 12 SMs idle); c is read in the epilogue, which subtracts.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int MAX_GRID_Z = 65535;
constexpr int UK = 32;           // depth of one stage
constexpr int ALD = UK + 4;      // row stride (floats) of a [row][k] slice:
                                 // the 8 rows and 4 columns a fragment
                                 // reads hit distinct banks; rows stay
                                 // 16-B aligned
constexpr int STAGES = 3;

enum class Op { kGemm, kUpdate };

template <Op OP, int BM, int BN>
struct Tile {
  static constexpr int WARPS_N = BN / 32;
  static constexpr int THREADS = (BM / 32) * WARPS_N * 32;
  // b's slice: [k][n] (row stride BN + 8) for the GEMM, [n][k] for the update
  static constexpr int BLD = OP == Op::kGemm ? BN + 8 : ALD;
  static constexpr int A_FLOATS = BM * ALD;
  static constexpr int B_FLOATS = OP == Op::kGemm ? UK * BLD : BN * ALD;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr size_t SMEM = STAGES * STAGE_FLOATS * sizeof(float);
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = hopper::to_tf32(x);
  lo = hopper::to_tf32(x - __uint_as_float(hi));
}

// rows [r0, r0 + ROWS) x depth [k0, k0 + UK) of a row-major (rows, K)
// matrix into dst[r][k] (row stride ALD), zero past the matrix
template <bool VEC, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int K, int r0, int k0) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < ROWS * (UK / 4); e += THREADS) {
      const int r = e / (UK / 4), kc = (e % (UK / 4)) * 4;
      const bool in = r0 + r < rows && k0 + kc < K;
      hopper::cp_async16(dst + r * ALD + kc,
                         in ? src + (size_t)(r0 + r) * K + k0 + kc : src,
                         in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * UK; e += THREADS) {
      const int r = e / UK, kc = e % UK;
      const bool in = r0 + r < rows && k0 + kc < K;
      hopper::cp_async4(dst + r * ALD + kc,
                        in ? src + (size_t)(r0 + r) * K + k0 + kc : src,
                        in ? 4 : 0);
    }
  }
}

// depth [k0, k0 + UK) x columns [c0, c0 + COLS) of a row-major (K, N)
// matrix into dst[k][n] (row stride LD), zero past the matrix
template <bool VEC, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_cols(float* dst, const float* src,
                                          int K, int N, int k0, int c0) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < UK * (COLS / 4); e += THREADS) {
      const int k = e / (COLS / 4), nc = (e % (COLS / 4)) * 4;
      const bool in = k0 + k < K && c0 + nc < N;
      hopper::cp_async16(dst + k * LD + nc,
                         in ? src + (size_t)(k0 + k) * N + c0 + nc : src,
                         in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < UK * COLS; e += THREADS) {
      const int k = e / COLS, nc = e % COLS;
      const bool in = k0 + k < K && c0 + nc < N;
      hopper::cp_async4(dst + k * LD + nc,
                        in ? src + (size_t)(k0 + k) * N + c0 + nc : src,
                        in ? 4 : 0);
    }
  }
}

// The shared body.  grid (ceil(N / BN), ceil(M / BM), tasks),
// Tile::THREADS threads, Tile::SMEM bytes of dynamic shared memory.  VEC:
// 16-byte copies (and float2 accesses of c and out in the GEMM).
template <Op OP, int BM, int BN, bool VEC>
__device__ __forceinline__ void tile_mma_3xtf32(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, float* __restrict__ out, int M, int N,
    int K) {
  using T = Tile<OP, BM, BN>;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const size_t t = blockIdx.z;
  a += t * (size_t)M * K;
  b += t * (size_t)K * N;
  c += t * (size_t)M * N;
  out += t * (size_t)M * N;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / T::WARPS_N) * 32, wn = (warp % T::WARPS_N) * 32;
  const int g = lane / 4, q = lane % 4;                    // fragment coords

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = (K + UK - 1) / UK;
  auto stage = [&](int s) { return smem + s * T::STAGE_FLOATS; };
  auto load = [&](int kt) {
    float* st = stage(kt % STAGES);
    load_rows<VEC, BM, T::THREADS>(st, a, M, K, row0, kt * UK);
    if constexpr (OP == Op::kGemm)
      load_cols<VEC, BN, T::BLD, T::THREADS>(st + T::A_FLOATS, b, K, N,
                                             kt * UK, col0);
    else
      load_rows<VEC, BN, T::THREADS>(st + T::A_FLOATS, b, N, K, col0,
                                     kt * UK);
  };
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < n_k) load(kt);
    hopper::cp_async_commit();
  }

  // accumulator e of (i, j): row g + 8 (e >> 1), column 2 q + (e & 1)
  auto row_of = [&](int i, int e) { return row0 + wm + 16 * i + g + 8 * (e >> 1); };
  auto col_of = [&](int j, int e) { return col0 + wn + 8 * j + 2 * q + (e & 1); };

  // the GEMM's c, in fragment layout, read while the operands are in flight
  float cf[2][4][4];
  if constexpr (OP == Op::kGemm) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int gm = row_of(i, e), gn = col_of(j, e);
          if constexpr (VEC) {      // N % 4 == 0: both columns or neither
            float2 x = make_float2(0.f, 0.f);
            if (gm < M && gn < N)
              x = *reinterpret_cast<const float2*>(c + (size_t)gm * N + gn);
            cf[i][j][e] = x.x;
            cf[i][j][e + 1] = x.y;
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u)
              cf[i][j][e + u] = gm < M && gn + u < N
                                    ? c[(size_t)gm * N + gn + u] : 0.f;
          }
        }
  }

  for (int kt = 0; kt < n_k; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();    // slice kt has landed
    __syncthreads();                        // ... for every thread, and
                                            // slice kt - 1 is read
    if (kt + STAGES - 1 < n_k) load(kt + STAGES - 1);
    hopper::cp_async_commit();
    const float* As = stage(kt % STAGES);
    const float* Bs = As + T::A_FLOATS;
#pragma unroll
    for (int ks = 0; ks < UK; ks += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* ar = As + (wm + 16 * i + g) * ALD + ks + q;
        split_tf32(ar[0], ahi[i][0], alo[i][0]);
        split_tf32(ar[8 * ALD], ahi[i][1], alo[i][1]);
        split_tf32(ar[4], ahi[i][2], alo[i][2]);
        split_tf32(ar[8 * ALD + 4], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (OP == Op::kGemm) {    // B[k][n]: rows q and q + 4
          const float* br = Bs + (ks + q) * T::BLD + wn + 8 * j + g;
          split_tf32(br[0], bhi[j][0], blo[j][0]);
          split_tf32(br[4 * T::BLD], bhi[j][1], blo[j][1]);
        } else {                            // B^T[n][k]: columns q and q + 4
          const float* br = Bs + (wn + 8 * j + g) * ALD + ks + q;
          split_tf32(br[0], bhi[j][0], blo[j][0]);
          split_tf32(br[4], bhi[j][1], blo[j][1]);
        }
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

  if constexpr (OP == Op::kGemm) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int gm = row_of(i, e), gn = col_of(j, e);
          if (gm >= M) continue;
          const size_t o = (size_t)gm * N + gn;
          if constexpr (VEC) {
            if (gn < N)
              *reinterpret_cast<float2*>(out + o) = make_float2(
                  cf[i][j][e] + acc[i][j][e],
                  cf[i][j][e + 1] + acc[i][j][e + 1]);
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u)
              if (gn + u < N) out[o + u] = cf[i][j][e + u] + acc[i][j][e + u];
          }
        }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = row_of(i, e);
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gn = col_of(j, e);
          if (gn >= N) continue;
          const size_t o = (size_t)gm * N + gn;
          out[o] = c[o] - acc[i][j][e];
        }
      }
  }
}

constexpr int GEMM_BM = 64, GEMM_BN = 64;
constexpr int UPDATE_BM = 64, UPDATE_BN = 128;

template <bool VEC>
__global__ void __launch_bounds__(Tile<Op::kGemm, GEMM_BM, GEMM_BN>::THREADS,
                                  2)
tile_gemm_3xtf32_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ c,
                        float* __restrict__ out, int M, int N, int K) {
  tile_mma_3xtf32<Op::kGemm, GEMM_BM, GEMM_BN, VEC>(a, b, c, out, M, N, K);
}

template <bool VEC>
__global__ void __launch_bounds__(
    Tile<Op::kUpdate, UPDATE_BM, UPDATE_BN>::THREADS, 2)
tile_update_3xtf32_kernel(const float* __restrict__ c,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          float* __restrict__ out, int M, int N, int K) {
  tile_mma_3xtf32<Op::kUpdate, UPDATE_BM, UPDATE_BN, VEC>(a, b, c, out, M,
                                                          N, K);
}

// One launch per MAX_GRID_Z tasks of `kernel(x, y, z, out, M, N, K)`,
// whose inputs hold sx, sy and sz floats a task.
template <typename Kernel>
int launch_batched(Kernel kernel, int threads, size_t smem, int bm, int bn,
                   const float* x, size_t sx, const float* y, size_t sy,
                   const float* z, size_t sz, float* out, int n, int M,
                   int N, int K, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t so = (size_t)M * N;
  for (int t0 = 0; t0 < n; t0 += MAX_GRID_Z) {
    const int nt = (n - t0) < MAX_GRID_Z ? (n - t0) : MAX_GRID_Z;
    const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm, nt);
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        x + t0 * sx, y + t0 * sy, z + t0 * sz, out + t0 * so, M, N, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_gemm(const float* a, const float* b, const float* c, float* out,
                int n, int M, int N, int K, void* stream) {
  using T = Tile<Op::kGemm, GEMM_BM, GEMM_BN>;
  return launch_batched(tile_gemm_3xtf32_kernel<VEC>, T::THREADS, T::SMEM,
                        GEMM_BM, GEMM_BN, a, (size_t)M * K, b,
                        (size_t)K * N, c, (size_t)M * N, out, n, M, N, K,
                        stream);
}

template <bool VEC>
int launch_update(const float* c, const float* a, const float* b,
                  float* out, int n, int M, int N, int K, void* stream) {
  using T = Tile<Op::kUpdate, UPDATE_BM, UPDATE_BN>;
  return launch_batched(tile_update_3xtf32_kernel<VEC>, T::THREADS, T::SMEM,
                        UPDATE_BM, UPDATE_BN, c, (size_t)M * N, a,
                        (size_t)M * K, b, (size_t)N * K, out, n, M, N, K,
                        stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// out[t] = c[t] + a[t] @ b[t]; a (n,M,K), b (n,K,N), c/out (n,M,N); 16-byte
// copies when K and N are multiples of 4 and every pointer is 16-byte
// aligned
extern "C" int bddt_matmul_batched(const float* a, const float* b,
                                   const float* c, float* out, int n, int M,
                                   int N, int K, void* stream) {
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(c) && aligned16(out);
  return vec ? launch_gemm<true>(a, b, c, out, n, M, N, K, stream)
             : launch_gemm<false>(a, b, c, out, n, M, N, K, stream);
}

// out[t] = c[t] - a[t] @ b[t]^T; a (n,M,K), b (n,N,K), c/out (n,M,N); 16-byte
// copies when every row of a and b starts 16-byte aligned
extern "C" int bddt_tile_update_batched(const float* c, const float* a,
                                        const float* b, float* out, int n,
                                        int M, int N, int K, void* stream) {
  const bool vec = K % 4 == 0 && aligned16(a) && aligned16(b);
  return vec ? launch_update<true>(c, a, b, out, n, M, N, K, stream)
             : launch_update<false>(c, a, b, out, n, M, N, K, stream);
}
