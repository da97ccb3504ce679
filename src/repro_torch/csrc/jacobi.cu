// Hopper (sm_90a) kernels for the six-point Jacobi sweep (paper §1.4).
//
//   jacobi_sweep_kernel     replaces the Pallas kernel `_jacobi_kernel`
//                           (repro/kernels/jacobi/kernel.py, reached through
//                           jacobi_sweep_pallas): one sweep.
//   jacobi_two_step_kernel  replaces `_temporal_kernel`
//                           (repro/kernels/jacobi/temporal.py, reached through
//                           jacobi_two_step_pallas): two sweeps in one pass
//                           over device memory (the paper's §4 outlook).
//
// Bound: bytes.  A sweep does 6 flops per site and must read each f32 site
// once and write it once, 8 B/site: at the paper's 2400x600x600 lattice that
// is 6.91 GB, 2.06 ms at the H100's 3.35 TB/s, against 0.08 ms of f32 math
// at 67 TFLOP/s.  The two-step kernel does both sweeps in that one pass, so
// its bound is the same 2.06 ms.
//
// Design.  The TPU kernels keep a (di, dj) tile with the whole k extent in
// VMEM; at the paper's block that is 345 KB (470 KB for the two-step halo),
// more than the 227 KB of shared memory a block can have.  Here instead a
// block covers a (j, k) tile, k across the 32 lanes of a warp (coalesced
// 128-byte rows), and marches along i (2.5-D blocking).  Each thread keeps
// its own column's i-1, i, i+1 values in registers (a register queue, with
// the next row prefetched one plane ahead), so the i neighbours cost no
// extra traffic; the current plane's tile plus a 1-deep j/k halo sits in
// shared memory for the j and k neighbours.  Each site is read from device
// memory about once (the halo columns of neighbouring tiles, and the two
// extra planes at each end of a block's i range, mostly hit L2) and written
// once.  Making this fast (TMA, wider tiles, more work per thread) is left to
// later work; this version is right and simple first.
//
// Both kernels sum the six neighbours in the reference's order
// (i-1, i+1, j-1, j+1, k-1, k+1) and then multiply by c, so they match the
// plain version up to nothing but the compiler's rounding of the same ops.
// Sites outside the lattice are zero (Dirichlet).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int K1_TK = 32;    // threads along k: one warp, one 128-byte row
constexpr int K1_TJ = 8;     // threads along j
constexpr int K1_ROWS = 32;  // output rows one block marches along i

constexpr int K2_TK = 32;    // threads along k; the step-1 region, 1-ring included
constexpr int K2_TJ = 16;    // threads along j; outputs (K2_TJ-2) x (K2_TK-2)
constexpr int K2_ROWS = 32;  // output rows one block marches along i

struct Lattice {
  const float* f;
  int ni, nj, nk;

  // f(i, j, k), zero outside the lattice
  __device__ __forceinline__ float at(int i, int j, int k) const {
    if (i < 0 || i >= ni || j < 0 || j >= nj || k < 0 || k >= nk) return 0.f;
    return __ldg(f + ((size_t)i * nj + j) * nk + k);
  }
};

// Output row r (0 <= r < nrows) is the sweep of input row row0 + r; it is
// written to out[r].  row0 = 0, nrows = ni is the whole-lattice sweep; a row
// range lets a caller sweep the interior of a halo-padded slab straight into
// its place in a larger lattice.
__global__ void __launch_bounds__(K1_TK * K1_TJ)
jacobi_sweep_kernel(Lattice in, float* __restrict__ out, int row0, int nrows,
                    float c) {
  __shared__ float plane[K1_TJ + 2][K1_TK + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k = blockIdx.x * K1_TK + tx;
  const int j = blockIdx.y * K1_TJ + ty;
  const int r_begin = blockIdx.z * K1_ROWS;
  const int r_end = min(r_begin + K1_ROWS, nrows);
  const bool stores = j < in.nj && k < in.nk;

  int i = row0 + r_begin;  // input row of output row r
  float below = in.at(i - 1, j, k);
  float cur = in.at(i, j, k);
  float above = in.at(i + 1, j, k);
  for (int r = r_begin; r < r_end; ++r, ++i) {
    const float ahead = in.at(i + 2, j, k);  // in flight during this plane
    plane[ty + 1][tx + 1] = cur;
    if (ty == 0) plane[0][tx + 1] = in.at(i, j - 1, k);
    if (ty == K1_TJ - 1) plane[K1_TJ + 1][tx + 1] = in.at(i, j + 1, k);
    if (tx == 0) plane[ty + 1][0] = in.at(i, j, k - 1);
    if (tx == K1_TK - 1) plane[ty + 1][K1_TK + 1] = in.at(i, j, k + 1);
    __syncthreads();
    if (stores) {
      float s = below + above;       // i-1, i+1
      s += plane[ty][tx + 1];        // j-1
      s += plane[ty + 2][tx + 1];    // j+1
      s += plane[ty + 1][tx];        // k-1
      s += plane[ty + 1][tx + 2];    // k+1
      out[((size_t)r * in.nj + j) * in.nk + k] = c * s;
    }
    __syncthreads();
    below = cur;
    cur = above;
    above = ahead;
  }
}

// Two sweeps per pass.  The block's threads cover a (K2_TJ, K2_TK) region:
// its inner (K2_TJ-2, K2_TK-2) sites are the outputs, and the 1-ring around
// them is where step 1 must also be known.  Marching along i, plane p of
// step 1 is computed from f planes p-1..p+1, and output row p-1 of step 2
// from step-1 planes p-2..p, so step 2 lags step 1 by one plane.  Each
// block recomputes step 1 on its ring and on one plane beyond each end of
// its i range; nothing crosses between blocks.
__global__ void __launch_bounds__(K2_TK * K2_TJ)
jacobi_two_step_kernel(Lattice in, float* __restrict__ out, float c) {
  __shared__ float fplane[K2_TJ + 2][K2_TK + 2];  // f on plane p, region + ring
  __shared__ float tplane[K2_TJ][K2_TK];          // step 1 on plane p-1
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k = blockIdx.x * (K2_TK - 2) + tx - 1;
  const int j = blockIdx.y * (K2_TJ - 2) + ty - 1;
  const bool inside = j >= 0 && j < in.nj && k >= 0 && k < in.nk;
  const bool stores = inside && tx >= 1 && tx <= K2_TK - 2 && ty >= 1 &&
                      ty <= K2_TJ - 2;
  const int a = blockIdx.z * K2_ROWS;
  const int b = min(a + K2_ROWS, in.ni);

  float f_below = in.at(a - 2, j, k);
  float f_cur = in.at(a - 1, j, k);
  float f_above = in.at(a, j, k);
  float t_prev2 = 0.f, t_prev = 0.f;  // this column's step 1 on p-2, p-1
  for (int p = a - 1; p <= b; ++p) {
    const float f_ahead = in.at(p + 2, j, k);
    fplane[ty + 1][tx + 1] = f_cur;
    if (ty == 0) fplane[0][tx + 1] = in.at(p, j - 1, k);
    if (ty == K2_TJ - 1) fplane[K2_TJ + 1][tx + 1] = in.at(p, j + 1, k);
    if (tx == 0) fplane[ty + 1][0] = in.at(p, j, k - 1);
    if (tx == K2_TK - 1) fplane[ty + 1][K2_TK + 1] = in.at(p, j, k + 1);
    __syncthreads();
    float s = f_below + f_above;
    s += fplane[ty][tx + 1];
    s += fplane[ty + 2][tx + 1];
    s += fplane[ty + 1][tx];
    s += fplane[ty + 1][tx + 2];
    // Dirichlet holds at every step: step-1 values outside the lattice are
    // zero before they feed step 2 (the TPU kernel's re-zeroed ring).
    const float t = (inside && p >= 0 && p < in.ni) ? c * s : 0.f;
    tplane[ty][tx] = t_prev;
    __syncthreads();
    if (stores && p - 1 >= a) {
      float s2 = t_prev2 + t;        // i-1, i+1
      s2 += tplane[ty - 1][tx];      // j-1
      s2 += tplane[ty + 1][tx];      // j+1
      s2 += tplane[ty][tx - 1];      // k-1
      s2 += tplane[ty][tx + 1];      // k+1
      out[((size_t)(p - 1) * in.nj + j) * in.nk + k] = c * s2;
    }
    t_prev2 = t_prev;
    t_prev = t;
    f_below = f_cur;
    f_cur = f_above;
    f_above = f_ahead;
  }
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One sweep of the (ni, nj, nk) lattice f, rows [row0, row0 + nrows), into
// out (nrows, nj, nk).  Both contiguous f32 on the device; launches on
// `stream` and returns the launch's cudaError_t.
int jacobi_sweep_launch(const float* f, float* out, int ni, int nj, int nk,
                        int row0, int nrows, float c, void* stream) {
  const dim3 block(K1_TK, K1_TJ);
  const dim3 grid(cdiv(nk, K1_TK), cdiv(nj, K1_TJ), cdiv(nrows, K1_ROWS));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  jacobi_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      Lattice{f, ni, nj, nk}, out, row0, nrows, c);
  return (int)cudaGetLastError();
}

// Two sweeps of the (ni, nj, nk) lattice f into out (same shape).
int jacobi_two_step_launch(const float* f, float* out, int ni, int nj, int nk,
                           float c, void* stream) {
  const dim3 block(K2_TK, K2_TJ);
  const dim3 grid(cdiv(nk, K2_TK - 2), cdiv(nj, K2_TJ - 2), cdiv(ni, K2_ROWS));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  jacobi_two_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      Lattice{f, ni, nj, nk}, out, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
