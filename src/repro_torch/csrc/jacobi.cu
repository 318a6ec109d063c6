// Batched Jacobi halo stencil for Hopper (sm_90a), FP32.
//
// Replaces the Pallas TPU kernel jacobi_step_pallas
// (src/repro/kernels/jacobi/kernel.py, _jacobi_kernel) on the path where
// the jacobi app runs it: one 5-point sweep of a task's halo region
// followed by the slice of the task's own tile.  For task t, with halo
// (H, W), tile (TH, TW) and offsets r0[t], c0[t] (clamped so the tile
// fits, as jax.lax.dynamic_slice clamps):
//   out[t][i][j] = halo[t][r][c]                         on the halo's
//                  outer rows and columns (fixed, Dirichlet), else
//                  0.25 * (halo[r-1][c] + halo[r+1][c] + halo[r][c-1]
//                          + halo[r][c+1])
// with r = r0 + i, c = c0 + j.  The sum runs in the reference's order
// (up + down + left + right) and no FMA can contract it.
//
// Bound on an H100: memory.  A task reads its (TH+2) x (TW+2) window and
// writes TH x TW, about 2 MiB per 512^2 tile, against 4 flops a point.
// Design: only the window is read, never the whole halo (the sweep of
// the rest of the halo is discarded by the slice); a 32-wide warp reads 32
// consecutive floats of a row, and the four neighbours of a point come
// from the same rows the warp's neighbours read, so they are served by L1.
// One launch covers a whole wave group: grid (TW/32, TH/32, n_tasks).
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int TILE = 32;      // output tile edge per block
constexpr int ROWS = 8;       // block is 32 x 8 threads, 4 rows each
constexpr int MAX_GRID_Z = 65535;

__global__ void __launch_bounds__(TILE * ROWS)
jacobi_halo_kernel(const float* __restrict__ halo,
                   const long long* __restrict__ r0s,
                   const long long* __restrict__ c0s,
                   float* __restrict__ out, int H, int W, int TH, int TW) {
  const size_t t = blockIdx.z;
  halo += t * (size_t)H * W;
  out += t * (size_t)TH * TW;
  // dynamic_slice semantics: the start is clamped so the tile fits
  long long r0 = r0s[t], c0 = c0s[t];
  r0 = r0 < 0 ? 0 : (r0 > H - TH ? H - TH : r0);
  c0 = c0 < 0 ? 0 : (c0 > W - TW ? W - TW : c0);

  const int j = static_cast<int>(blockIdx.x) * TILE + threadIdx.x;
  if (j >= TW) return;
  const int c = static_cast<int>(c0) + j;
  const int i0 = static_cast<int>(blockIdx.y) * TILE;
  const int i_end = min(TH, i0 + TILE);
  for (int i = i0 + static_cast<int>(threadIdx.y); i < i_end; i += ROWS) {
    const int r = static_cast<int>(r0) + i;
    const size_t p = (size_t)r * W + c;
    float v;
    if (r == 0 || r == H - 1 || c == 0 || c == W - 1) {
      v = halo[p];
    } else {
      const float up = halo[p - W], down = halo[p + W];
      const float left = halo[p - 1], right = halo[p + 1];
      v = 0.25f * (((up + down) + left) + right);
    }
    out[(size_t)i * TW + j] = v;
  }
}

}  // namespace

// out[t] = slice(jacobi_step(halo[t]), (r0[t], c0[t]), (TH, TW));
// halo (n,H,W) f32, r0/c0 (n,) int64 on the device, out (n,TH,TW) f32
extern "C" int bddt_jacobi_halo_batched(const float* halo,
                                        const long long* r0,
                                        const long long* c0, float* out,
                                        int n, int H, int W, int TH, int TW,
                                        void* stream) {
  const dim3 block(TILE, ROWS);
  for (int t0 = 0; t0 < n; t0 += MAX_GRID_Z) {
    const int nt = (n - t0) < MAX_GRID_Z ? (n - t0) : MAX_GRID_Z;
    const dim3 grid((TW + TILE - 1) / TILE, (TH + TILE - 1) / TILE, nt);
    jacobi_halo_kernel<<<grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        halo + (size_t)t0 * H * W, r0 + t0, c0 + t0,
        out + (size_t)t0 * TH * TW, H, W, TH, TW);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
