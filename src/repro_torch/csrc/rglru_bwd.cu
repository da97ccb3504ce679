// Hopper (sm_90a) backward of the RG-LRU linear recurrence (K5), per channel:
// for h_t = a_t h_{t-1} + b_t from h0 and the gradient dh of every h_t,
//
//   g_t = dh_t + a_{t+1} g_{t+1}   (g_{T-1} = dh_{T-1}),
//   db_t = g_t,   da_t = g_t h_{t-1}   (h_{-1} = h0, or 0),   dh0 = a_0 g_0.
//
//   rglru_bwd_kernel  is the gradient of rglru_kernel (rglru.cu), which
//       replaces the Pallas kernel `_rglru_kernel`
//       (repro/kernels/rglru/kernel.py).  The JAX package writes no
//       backward kernel: its trainer differentiates its scans with
//       jax.grad, and this is that gradient.  Each product and sum is
//       rounded once (__fmul_rn, __fadd_rn: nvcc may not contract them into
//       an FMA), the two terms autograd adds at each step of the plain
//       loop, so the result equals rglru_scan_bwd_ref and autograd through
//       rglru_scan_ref bit for bit (a sum or a product of two terms is the
//       same in either order).
//
// What bounds it on an H100.  Bytes: per (b, t, w) element a, h and dh are
// read once and da and db written once, 20 B, all f32; 3 flops an element.
// At recurrentgemma-9b's width W = 4096 and B 1, T 1024 that is 83.9 MB,
// 25.0 us at 3.35 TB/s.
//
// Design: the forward's, walked from the end.  A block is one warp owning
// a strip of 32 channels of one batch row; each channel's chain walks all
// of time in one thread, last step first.  a_{t+1}, dh_t and h_{t-1} of a
// stage of S steps arrive by cp.async (16 B a copy where W is a multiple of
// 4, else 4 B) in a ring of STAGES shared-memory slots, the stages walked
// from the last; STAGES - 1 of them (36 KB) are in flight while the warp
// walks the current one.  The shifted rows are whole rows of the same
// channels, so the copies stay aligned; a_T and h_{-1} are not copied
// (the last step takes g = dh, the first reads h0 from a register).
// da and db go out as one 128-byte store each per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 32;    // channels per block (one warp)
constexpr int S = 32;        // steps per stage
constexpr int STAGES = 4;    // ring slots
constexpr int SMEM = 3 * STAGES * S * STRIP * 4;   // 48 KB: a, dh, h

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
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ dh, const float* __restrict__ h0,
                 float* __restrict__ da, float* __restrict__ db, float* __restrict__ dh0,
                 int t, int w) {
  extern __shared__ __align__(16) float smem[];
  float (*sa)[S][STRIP] = reinterpret_cast<float (*)[S][STRIP]>(smem);   // a_{t+1}
  float (*sd)[S][STRIP] = sa + STAGES;                                    // dh_t
  float (*sh)[S][STRIP] = sd + STAGES;                                    // h_{t-1}
  constexpr int PER_ROW = STRIP / VEC;     // copies per row of a stage
  constexpr int ROWS = 32 / PER_ROW;       // rows per pass of the warp
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * STRIP, c = c0 + lane;
  const long long row = blockIdx.y;
  const long long base = row * t * w + c0;   // (row, 0, c0)
  const int stages = (t + S - 1) / S;
  const int q = lane % PER_ROW, ch = c0 + q * VEC;

  auto copy = [&](float* dst, const float* src) {
    if (VEC == 4) cp_async16(dst, src);
    else cp_async4(dst, src);
  };
  // the k-th stage walked (stage stages - 1 - k, steps t0 .. t0 + S - 1)
  // into slot k % STAGES; a group is committed even when empty
  auto issue = [&](int k) {
    const int slot = k % STAGES, st = stages - 1 - k;
    if (st >= 0 && ch < w) {
      const int t0 = st * S;
      for (int s = lane / PER_ROW; s < S && t0 + s < t; s += ROWS) {
        const int tt = t0 + s;
        const long long off = base + (long long)tt * w + q * VEC;
        copy(&sd[slot][s][q * VEC], dh + off);
        if (tt + 1 < t) copy(&sa[slot][s][q * VEC], a + off + w);
        if (tt >= 1) copy(&sh[slot][s][q * VEC], h + off - w);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  const float hinit = h0 != nullptr && c < w ? h0[row * w + c] : 0.f;
  float g = 0.f;
  for (int k = 0; k < stages; ++k) {
    cp_async_wait<STAGES - 2>();   // this lane's copies of stage k have landed
    __syncwarp();                  // every lane's, and slot (k - 1) is consumed
    issue(k + STAGES - 1);         // into the slot stage k - 1 left
    const int slot = k % STAGES, t0 = (stages - 1 - k) * S, n = min(S, t - t0);
    if (c < w) {
      float* pa = da + base + lane;
      float* pb = db + base + lane;
      auto step = [&](int s) {
        const int tt = t0 + s;
        const float d = sd[slot][s][lane];
        g = tt == t - 1 ? d : __fadd_rn(d, __fmul_rn(sa[slot][s][lane], g));
        const float hp = tt == 0 ? hinit : sh[slot][s][lane];
        pa[(long long)tt * w] = __fmul_rn(g, hp);
        pb[(long long)tt * w] = g;
      };
      if (n == S) {
#pragma unroll
        for (int s = S - 1; s >= 0; --s) step(s);
      } else {
        for (int s = n - 1; s >= 0; --s) step(s);
      }
    }
  }
  cp_async_wait<0>();
  if (dh0 != nullptr && c < w) dh0[row * w + c] = __fmul_rn(a[base + lane], g);
}

}  // namespace

extern "C" {

// All tensors f32 and contiguous: a, h (the forward's result), dh, da, db
// (B, T, W); h0 and dh0 (B, W) or null (zero state, no gradient).  Returns
// the launch's cudaError_t.
int rglru_bwd_launch(const float* a, const float* h, const float* dh, const float* h0,
                     float* da, float* db, float* dh0, int batch, int t, int w,
                     void* stream) {
  if (batch <= 0 || batch > 65535 || t <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((w + STRIP - 1) / STRIP, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dh) % 16 == 0;
  if (vec)
    rglru_bwd_kernel<4><<<grid, STRIP, SMEM, s>>>(a, h, dh, h0, da, db, dh0, t, w);
  else
    rglru_bwd_kernel<1><<<grid, STRIP, SMEM, s>>>(a, h, dh, h0, da, db, dh0, t, w);
  return (int)cudaGetLastError();
}

// Steps per shared-memory stage (the tests cross its boundaries).
int rglru_bwd_stage_steps() { return S; }

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
