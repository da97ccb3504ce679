// Hopper (sm_90a) kernel for the RG-LRU linear recurrence, per channel:
//
//   h_t = a_t h_{t-1} + b_t,
//
// from a given initial state h0 (zero when none is passed), returning every
// h_t.  a, b, h0 and h are f32.
//
//   rglru_kernel  replaces the Pallas kernel `_rglru_kernel`
//                 (repro/kernels/rglru/kernel.py, reached through
//                 rglru_scan_pallas).  Same function, plus a carried-in
//                 state.  Each step is rounded as the plain loop
//                 (rglru_scan_ref, two eager ops) rounds it: the product
//                 a_t h_{t-1} once, then the sum once.  __fmul_rn and
//                 __fadd_rn keep nvcc from contracting the pair into one
//                 FMA, so the kernel equals the plain loop bit for bit.
//
// What bounds it on an H100.  Bytes: per (b, t, w) element a and b are read
// once and h written once, 12 B, plus h0 read once; the work is 2 flops per
// element.  At recurrentgemma-9b's width W = 4096 and a 1024-token prefill
// that is 50.3 MB, 15.0 us at 3.35 TB/s.  A decode step (T = 1) moves 64 KB,
// 0.02 us: far below a launch, so decode is launch-bound.
//
// Design.  The TPU kernel walks a sequential grid axis of time chunks and
// carries the (W,) state in VMEM scratch from one chunk to the next.  Blocks
// on the card run in no order, so here one thread owns one (batch, channel)
// column and walks all of time itself, h in a register; neighbouring threads
// own neighbouring channels, so every load and store of a warp is 128
// contiguous bytes.  The loads of a and b do not depend on h: a thread keeps
// the next RUN steps' loads in flight while it computes the current run, so
// their latency overlaps the dependent chain.  Any T is taken: the TPU
// kernel's T % chunk rule is the wrapper's contract only.  At B = 1 only
// W / 128 blocks are busy (32 at W = 4096), far from filling 132 SMs; a
// two-pass chunked scan over T (chunk-local scans, then the carries) is
// later work: this version is right and simple first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int RUN = 16;        // steps whose loads are in flight at once

// Steps t0 .. t0 + RUN - 1 of one column into registers, zero past t.
__device__ __forceinline__ void fetch_run(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          long long col, int w, int t0, int t,
                                          float (&ra)[RUN], float (&rb)[RUN]) {
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const bool in = t0 + i < t;
    const long long off = col + (long long)(t0 + i) * w;
    ra[i] = in ? __ldg(a + off) : 0.f;
    rb[i] = in ? __ldg(b + off) : 0.f;
  }
}

// Grid: (ceil(W / THREADS), B).  Thread x of block (bx, by) owns channel
// bx * THREADS + x of batch row by.
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ out, int t, int w) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= w) return;
  const long long row = blockIdx.y;
  const long long col = row * t * w + c;     // (row, 0, c)
  float h = h0 ? h0[row * w + c] : 0.f;

  float ca[RUN], cb[RUN];
  fetch_run(a, b, col, w, 0, t, ca, cb);
  for (int t0 = 0; t0 < t; t0 += RUN) {
    float na[RUN], nb[RUN];
    fetch_run(a, b, col, w, t0 + RUN, t, na, nb);   // in flight during this run
    const int n = min(RUN, t - t0);
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      if (i < n) {
        h = __fadd_rn(__fmul_rn(ca[i], h), cb[i]);
        out[col + (long long)(t0 + i) * w] = h;
      }
    }
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      ca[i] = na[i];
      cb[i] = nb[i];
    }
  }
}

}  // namespace

extern "C" {

// All tensors f32 and contiguous: a, b, out (B, T, W); h0 (B, W) or null
// (zero state).  Returns the launch's cudaError_t.
int rglru_launch(const float* a, const float* b, const float* h0, float* out,
                 int batch, int t, int w, void* stream) {
  if (batch <= 0 || batch > 65535 || t <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((w + THREADS - 1) / THREADS, batch);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, out, t, w);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
