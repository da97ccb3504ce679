// Hopper (sm_90a) kernel for the RWKV-6 WKV recurrence, per (batch, head):
//
//   o_t = (S + diag(u) k_t v_tᵀ)ᵀ r_t,    S ← diag(w_t) S + k_t v_tᵀ,
//
// from a given initial state S0 (zero when none is passed), returning every
// o_t and the final state.
//
//   wkv6_kernel  replaces the Pallas kernel `_wkv_kernel`
//                (repro/kernels/rwkv6/kernel.py, reached through wkv6_pallas).
//                Same function, plus a carried-in state: r, k, v in f32 or
//                bf16 (the model hands over bf16-rounded values), w, u, the
//                state and o in f32, f32 arithmetic throughout.
//
// What bounds it on an H100.  Per (batch, step, head, i, j) the recurrence
// needs 5 flops: a multiply-add for o_j += r_i S_ij and a multiply plus a
// multiply-add for S_ij ← w_i S_ij + k_i v_j (the bonus term u folds into one
// dot product per step and head).  At rwkv6-3b's 40 heads of 64 and a
// 1024-token prefill that is 0.84 GFLOP, 12.5 us at 67 TFLOP/s of f32, against
// 38.0 MB of bytes (r, k, v in bf16, w and o in f32, the state read and
// written once), 11.3 us at 3.35 TB/s: about balanced.  A decode step
// (T = 1) is the state read and written, 1.3 MB, 0.39 us: far below a
// launch, so decode is launch-bound.
//
// Design.  The TPU kernel keeps the hd x hd state in VMEM scratch across a
// sequential grid axis over time chunks.  Blocks on the card run in no
// order, so here one block owns a (batch, head) pair and a tile of state
// columns and loops over time itself.  Columns of S are independent:
// S[:, j] ← w ⊙ S[:, j] + k v_j and o_j = Σ_i r_i (S[i, j] + u_i k_i v_j).
// So one thread owns one column j and keeps its hd f32 values in registers
// for the whole sequence, and no reduction crosses threads.  Each thread sums
// over i in order, s_eff first, then its product with r_i.  A block of up to
// 32 threads (one warp, one column each) stages the r, k and w rows (shared
// by all its columns) and its own v columns for a run of TS steps in shared
// memory with coalesced loads, then walks the run; o_j is stored per step,
// 32 consecutive floats per warp.  The state is read once at the start and
// written once at the end; the two pointers may be the same tensor (the
// model updates its cache in place), since each thread reads its own column
// before it writes it.  Any T is taken: the TPU kernel's T % chunk rule is
// the wrapper's contract only.  The chunked matmul form on tensor cores is
// later work: this version is right and simple first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TS = 32;   // time steps staged in shared memory per run

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;    // (H, hd)
  const float* s0;   // (B, H, hd, hd) or null (zero state)
  float* o;          // (B, T, H, hd)
  float* st;         // (B, H, hd, hd), may equal s0
  int t, h;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD < 32 ? HD : 32)
wkv6_kernel(Args a) {
  constexpr int COLS = HD < 32 ? HD : 32;   // state columns (threads) per block
  __shared__ float sr[TS * HD], sk[TS * HD], sw[TS * HD];
  __shared__ float sv[TS * COLS];
  __shared__ float su[HD];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                 // b * H + h
  const int h = bh % a.h;
  const long long b = bh / a.h;
  const int col0 = blockIdx.y * COLS;
  const int j = col0 + tid;
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  float s[HD];
  const long long sbase = (long long)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = a.s0 ? a.s0[sbase + (long long)i * HD] : 0.f;
  for (int i = tid; i < HD; i += COLS) su[i] = a.u[h * HD + i];

  for (int t0 = 0; t0 < a.t; t0 += TS) {
    const int n = min(TS, a.t - t0);
    __syncthreads();               // the previous run is consumed (and su written)
    for (int idx = tid; idx < n * HD; idx += COLS) {
      const int step = idx / HD, i = idx % HD;
      const long long off = ((b * a.t + t0 + step) * a.h + h) * HD + i;
      sr[idx] = load_f(r + off);
      sk[idx] = load_f(k + off);
      sw[idx] = a.w[off];
    }
    for (int idx = tid; idx < n * COLS; idx += COLS) {
      const int step = idx / COLS, c = idx % COLS;
      sv[idx] = load_f(v + ((b * a.t + t0 + step) * a.h + h) * HD + col0 + c);
    }
    __syncthreads();
    for (int step = 0; step < n; ++step) {
      const float vj = sv[step * COLS + tid];
      const float* rr = sr + step * HD;
      const float* kk = sk + step * HD;
      const float* ww = sw + step * HD;
      float o = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = kk[i] * vj;
        const float s_eff = s[i] + su[i] * kv;
        o += rr[i] * s_eff;
        s[i] = ww[i] * s[i] + kv;
      }
      a.o[((b * a.t + t0 + step) * a.h + h) * HD + j] = o;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) a.st[sbase + (long long)i * HD] = s[i];
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  constexpr int COLS = HD < 32 ? HD : 32;
  dim3 grid(bh, HD / COLS);
  wkv6_kernel<T, HD><<<grid, COLS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, int bh, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(a, bh, stream);
    case 16: return launch<T, 16>(a, bh, stream);
    case 32: return launch<T, 32>(a, bh, stream);
    case 64: return launch<T, 64>(a, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of r, k, v: 0 float32, 1 bfloat16; w, u, s0, o and st are float32.
// All tensors contiguous: r, k, v, w, o (B, T, H, hd); u (H, hd); s0 and st
// (B, H, hd, hd).  s0 may be null (zero state) and may equal st.
// Returns the launch's cudaError_t.
int wkv6_launch(int dtype, const void* r, const void* k, const void* v,
                const float* w, const float* u, const float* s0, float* o,
                float* st, int batch, int t, int h, int hd, void* stream) {
  if (batch <= 0 || t <= 0 || h <= 0 || (long long)batch * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = u; a.s0 = s0; a.o = o; a.st = st;
  a.t = t; a.h = h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_hd<float>(hd, a, batch * h, s)
                  : dtype == 1 ? dispatch_hd<__nv_bfloat16>(hd, a, batch * h, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
