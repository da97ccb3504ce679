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
// Design: a pipelined walk that fills the card.  The TPU kernel walks a
// sequential grid axis of time chunks and carries the (W,) state in VMEM.
// Here each channel still walks all of time in order, in one thread, so
// every step is rounded as in the plain loop; what changes is how the bytes
// arrive.  A block is one warp owning a strip of 32 channels of one batch
// row (128 strips at W = 4096 and B 1, for 132 SMs).  a and b come in
// stages of S steps x 32 channels (128-byte rows) through a ring of STAGES
// shared-memory slots filled by cp.async (16 B a copy where W is a multiple
// of 4, else 4 B); STAGES - 1 stages, 32 KB, are in flight while the warp
// walks the current one.  That covers the card's rate over its latency
// (3.35 TB/s x about 1 us, over 132 SMs: 25 KB an SM).  A channel's
// dependent chain at T = 1024 is 1024 rounded multiply-add pairs, a few
// microseconds, under the byte bound, so time is not split.  Each step's
// 32 results go out as one 128-byte store.  Any T is taken: the TPU
// kernel's T % chunk rule is the wrapper's contract only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 32;    // channels per block (one warp)
constexpr int S = 32;        // steps per stage
constexpr int STAGES = 5;    // ring slots

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Grid: (ceil(W / STRIP), B).  Lane x of block (bx, by) owns channel
// bx * STRIP + x of batch row by.  VEC floats per copy: 4 or 1.
template <int VEC>
__global__ void __launch_bounds__(STRIP)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ out, int t, int w) {
  __shared__ __align__(16) float sa[STAGES][S][STRIP];
  __shared__ __align__(16) float sb[STAGES][S][STRIP];
  constexpr int PER_ROW = STRIP / VEC;     // copies per row of a stage
  constexpr int ROWS = 32 / PER_ROW;       // rows per pass of the warp
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * STRIP, c = c0 + lane;
  const long long row = blockIdx.y;
  const long long base = row * t * w + c0;   // (row, 0, c0)
  const int stages = (t + S - 1) / S;
  const int q = lane % PER_ROW, ch = c0 + q * VEC;

  // stage st (steps st·S .. st·S + S - 1) into slot st % STAGES; a group is
  // committed even when empty, so the count of groups stays regular
  auto issue = [&](int st) {
    const int slot = st % STAGES, t0 = st * S;
    if (ch < w) {
      for (int s = lane / PER_ROW; s < S && t0 + s < t; s += ROWS) {
        const long long off = base + (long long)(t0 + s) * w + q * VEC;
        if (VEC == 4) {
          cp_async16(&sa[slot][s][q * VEC], a + off);
          cp_async16(&sb[slot][s][q * VEC], b + off);
        } else {
          cp_async4(&sa[slot][s][q * VEC], a + off);
          cp_async4(&sb[slot][s][q * VEC], b + off);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) issue(st);
  float h = h0 != nullptr && c < w ? h0[row * w + c] : 0.f;
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<STAGES - 2>();   // this lane's copies of stage st have landed
    __syncwarp();                  // every lane's, and slot (st - 1) is consumed
    issue(st + STAGES - 1);        // into the slot stage st - 1 left
    const int slot = st % STAGES, t0 = st * S, n = min(S, t - t0);
    if (c < w) {
      float* o = out + base + (long long)t0 * w + lane;
      if (n == S) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          h = __fadd_rn(__fmul_rn(sa[slot][s][lane], h), sb[slot][s][lane]);
          o[(long long)s * w] = h;
        }
      } else {
        for (int s = 0; s < n; ++s) {
          h = __fadd_rn(__fmul_rn(sa[slot][s][lane], h), sb[slot][s][lane]);
          o[(long long)s * w] = h;
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

// All tensors f32 and contiguous: a, b, out (B, T, W); h0 (B, W) or null
// (zero state).  Returns the launch's cudaError_t.
int rglru_launch(const float* a, const float* b, const float* h0, float* out,
                 int batch, int t, int w, void* stream) {
  if (batch <= 0 || batch > 65535 || t <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((w + STRIP - 1) / STRIP, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec)
    rglru_kernel<4><<<grid, STRIP, 0, s>>>(a, b, h0, out, t, w);
  else
    rglru_kernel<1><<<grid, STRIP, 0, s>>>(a, b, h0, out, t, w);
  return (int)cudaGetLastError();
}

// Steps per shared-memory stage (the tests cross its boundaries).
int rglru_stage_steps() { return S; }

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
