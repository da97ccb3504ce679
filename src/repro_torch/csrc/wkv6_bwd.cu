// Hopper (sm_90a) backward of the RWKV-6 WKV recurrence (K4), per (batch,
// head), for the forward
//
//   o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ r_t,    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
//
// from S_{-1} = s0 (zero when none is passed), the gradients do_t of every
// o_t and dsT of the final state (zero when none).  With G_t the gradient
// of S_t (G_{T-1} = dsT), walking t down:
//
//   dr_t = S_{t-1} do_t + u ⊙ k_t (v_t·do_t)
//   dk_t = G_t v_t + u ⊙ r_t (v_t·do_t)
//   dv_t = G_tᵀ k_t + (Σ_i r_i u_i k_i) do_t
//   dw_t = rowsum(G_t ⊙ S_{t-1})
//   du   = Σ_{b,t} r_t ⊙ k_t (v_t·do_t)
//   G_{t-1} = diag(w_t) G_t + r_t do_tᵀ,        ds0 = G before step 0.
//
//   wkv6_bwd_kernel and wkv6_bwd_finish_kernel are the gradient of
//       wkv6_kernel / wkv6_carry_kernel / wkv6_fix_kernel (wkv6.cu), which
//       replace the Pallas kernel `_wkv_kernel` (repro/kernels/rwkv6/
//       kernel.py).  The JAX package writes no backward kernel: its trainer
//       differentiates its jnp scan with jax.grad, and this is that
//       gradient (wkv6_bwd_ref is the plain version).  r, k, v in f32 or
//       bf16, w, u, the states, do and every sum in f32; dr, dk, dv leave
//       in r's dtype, dw, du and ds0 in f32.
//
// What bounds it on an H100.  Operations: per (b, t, h, i, j) the state's
// recompute (a multiply and a multiply-add, 3 flops), G's update (3), and
// one multiply-add each for dr, dk, dw and dv (8): 14 flops.  At rwkv6-3b's
// 40 heads of 64 and B 1, T 1024 that is 2.35 GFLOP, 35.1 us at 67 TFLOP/s
// of f32; its bytes (r, k, v, dr, dk, dv in bf16, w, do, dw in f32, 24 B a
// (b, t, h, i)) are 63 MB, 18.8 us at 3.35 TB/s.
//
// Design: simple and right first (a later PR makes it fast).
//   * S_{t-1} is never recovered by dividing by w_t: w = exp(-exp(decay))
//     reaches 1e-30 and below at trained decays.  The kernel walks time
//     forward once from s0 and writes the state at the start of every
//     sub-chunk of SUB steps to a workspace (checkpoints); then it walks
//     the sub-chunks from the last, recomputes each one's SUB states
//     forward from its checkpoint into registers, and walks them backward
//     with G.  K4's forward is untouched: its bits and launches stay.
//   * S and G evolve element by element (S_t[i, j] depends only on
//     S_{t-1}[i, j]), so a block takes one (b, h) and a tile of RT rows,
//     all hd columns: lane x of warp y holds row x of the tile and columns
//     8 y .. 8 y + 7 of S, G and the sub-chunk's states.  The sums over
//     columns (dr, dk, dw) go through shared memory per warp and are added
//     in warp order; dv's sum over the rows of a warp is a reduce-scatter
//     of shuffles, and over the row tiles (two at hd 64) a second kernel
//     adds the tiles' f32 partials in order, and du's over the batch.  No
//     float atomics: a repeat gives the same bits.
//   * A sub-chunk's r, k, w, v, do are staged in shared memory as f32, with
//     each step's v·do and Σ r u k.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SUB = 16;   // steps per sub-chunk (checkpoint spacing)
constexpr int CJ = 8;     // columns a thread holds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;     // (H, hd)
  const float* s0;    // (B, H, hd, hd) or null
  const float* dout;  // (B, T, H, hd)
  const float* dsT;   // (B, H, hd, hd) or null
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* du;          // (H, hd)
  float* ds0;         // (B, H, hd, hd)
  float* ckpt;        // (B·H, nsc, hd, hd)
  float* dvp;         // (tiles, B, T, H, hd) dv partials
  float* dup;         // (B, H, hd) du partials
  int b, t, h, nsc;
};

template <int HD>
struct Geo {
  static constexpr int RT = HD < 32 ? HD : 32;      // rows per block (one a lane)
  static constexpr int TILES = HD / RT;             // row tiles
  static constexpr int WARPS = HD / CJ;             // column groups
  static constexpr int THREADS = 32 * WARPS;
  // staged r, k, w, v, do (f32), v·do and Σ r u k per step, then the
  // per-warp column sums of dr, dk, dw
  static constexpr int SMEM = 4 * (5 * SUB * HD + 2 * SUB + 3 * SUB * WARPS * 32);
};

// Grid (B·H, TILES).  See the note above.
template <typename T, int HD>
__global__ void __launch_bounds__(Geo<HD>::THREADS, 1) wkv6_bwd_kernel(Args a) {
  using G = Geo<HD>;
  constexpr int RT = G::RT, WARPS = G::WARPS, THREADS = G::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                   // [SUB][HD]
  float* sk = sr + SUB * HD;
  float* sw = sk + SUB * HD;
  float* sv = sw + SUB * HD;
  float* sdo = sv + SUB * HD;
  float* svdo = sdo + SUB * HD;       // [SUB]
  float* sruk = svdo + SUB;           // [SUB]
  float* red = sruk + SUB;            // [3][SUB][WARPS][32]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, tile = blockIdx.y;
  const int h = bh % a.h;
  const long long b = bh / a.h;
  const int i = tile * RT + lane;          // this lane's row
  const bool row_ok = lane < RT;
  const int j0 = warp * CJ;                // this warp's first column
  const long long stride = (long long)a.h * HD;
  auto at = [&](int t) { return ((b * a.t + t) * a.h + h) * HD; };   // (b, t, h, 0)
  const long long head = (long long)bh * HD * HD;
  const float ui = row_ok ? a.u[h * HD + i] : 0.f;

  // stage steps t0 .. t0 + n - 1 of the named inputs as f32
  auto stage = [&](int t0, int n, bool with_r) {
    for (int e = tid; e < SUB * HD; e += THREADS) {
      const int s = e / HD, x = e % HD;
      if (s >= n) continue;
      const long long off = at(t0 + s) + x;
      if (with_r) {
        sr[e] = ld(static_cast<const T*>(a.r) + off);
        sdo[e] = a.dout[off];
      }
      sk[e] = ld(static_cast<const T*>(a.k) + off);
      sw[e] = a.w[off];
      sv[e] = ld(static_cast<const T*>(a.v) + off);
    }
  };
  auto load8 = [&](const float* p, float (&x)[CJ]) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  };
  auto store8 = [&](float* p, const float (&x)[CJ]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
  };

  // -- pass 1: forward from s0, a checkpoint at every sub-chunk's start --
  float S[CJ];
  if (row_ok && a.s0) load8(a.s0 + head + (long long)i * HD + j0, S);
  else
#pragma unroll
    for (int c = 0; c < CJ; ++c) S[c] = 0.f;
  for (int sc = 0; sc < a.nsc; ++sc) {
    const int t0 = sc * SUB, n = min(SUB, a.t - t0);
    if (row_ok) store8(a.ckpt + (head * a.nsc) + ((long long)sc * HD + i) * HD + j0, S);
    if (sc == a.nsc - 1) break;              // the last sub-chunk's end is not needed
    __syncthreads();
    stage(t0, n, false);
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float wi = row_ok ? sw[s * HD + i] : 0.f, ki = row_ok ? sk[s * HD + i] : 0.f;
      float vj[CJ];
      load8(sv + s * HD + j0, vj);
#pragma unroll
      for (int c = 0; c < CJ; ++c) S[c] = fmaf(wi, S[c], ki * vj[c]);
    }
  }

  // -- pass 2: the sub-chunks from the last, each recomputed then walked back
  float g[CJ];
  if (row_ok && a.dsT) load8(a.dsT + head + (long long)i * HD + j0, g);
  else
#pragma unroll
    for (int c = 0; c < CJ; ++c) g[c] = 0.f;
  float du_acc = 0.f;
  float* dvp = a.dvp + (long long)tile * a.b * a.t * stride;
  for (int sc = a.nsc - 1; sc >= 0; --sc) {
    const int t0 = sc * SUB, n = min(SUB, a.t - t0);
    __syncthreads();                       // the previous sub-chunk's stage is read
    stage(t0, n, true);
    __syncthreads();
    for (int s = warp; s < n; s += WARPS) {  // v·do and Σ r u k of each step
      float vdo = 0.f, ruk = 0.f;
      for (int x = lane; x < HD; x += 32) {
        vdo = fmaf(sv[s * HD + x], sdo[s * HD + x], vdo);
        ruk = fmaf(sr[s * HD + x] * a.u[h * HD + x], sk[s * HD + x], ruk);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        vdo += __shfl_xor_sync(FULL, vdo, off);
        ruk += __shfl_xor_sync(FULL, ruk, off);
      }
      if (lane == 0) {
        svdo[s] = vdo;
        sruk[s] = ruk;
      }
    }
    __syncthreads();

    // the sub-chunk's states S_{t-1}, t = t0 .. t0 + n - 1
    float sp[SUB][CJ];
    if (row_ok) load8(a.ckpt + (head * a.nsc) + ((long long)sc * HD + i) * HD + j0, S);
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
#pragma unroll
      for (int c = 0; c < CJ; ++c) sp[s][c] = S[c];
      if (s < n) {
        const float wi = row_ok ? sw[s * HD + i] : 0.f, ki = row_ok ? sk[s * HD + i] : 0.f;
        float vj[CJ];
        load8(sv + s * HD + j0, vj);
#pragma unroll
        for (int c = 0; c < CJ; ++c) S[c] = fmaf(wi, S[c], ki * vj[c]);
      }
    }

#pragma unroll
    for (int s = SUB - 1; s >= 0; --s) {
      if (s < n) {
        const float ri = row_ok ? sr[s * HD + i] : 0.f;
        const float ki = row_ok ? sk[s * HD + i] : 0.f;
        const float wi = row_ok ? sw[s * HD + i] : 0.f;
        float vj[CJ], dj[CJ], p[CJ];
        load8(sv + s * HD + j0, vj);
        load8(sdo + s * HD + j0, dj);
        float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
        for (int c = 0; c < CJ; ++c) {
          pr = fmaf(sp[s][c], dj[c], pr);
          pk = fmaf(g[c], vj[c], pk);
          pw = fmaf(g[c], sp[s][c], pw);
          p[c] = g[c] * ki;
          g[c] = fmaf(wi, g[c], ri * dj[c]);
        }
        float* rs = red + (s * WARPS + warp) * 32 + lane;
        rs[0] = pr;
        rs[SUB * WARPS * 32] = pk;
        rs[2 * SUB * WARPS * 32] = pw;
        // dv: the warp's 32 rows summed by a reduce-scatter of the 8 columns
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool up = lane & 16;
          const float keep = up ? p[x + 4] : p[x], send = up ? p[x] : p[x + 4];
          p[x] = keep + __shfl_xor_sync(FULL, send, 16);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const bool up = lane & 8;
          const float keep = up ? p[x + 2] : p[x], send = up ? p[x] : p[x + 2];
          p[x] = keep + __shfl_xor_sync(FULL, send, 8);
        }
        {
          const bool up = lane & 4;
          const float keep = up ? p[1] : p[0], send = up ? p[0] : p[1];
          p[0] = keep + __shfl_xor_sync(FULL, send, 4);
        }
        p[0] += __shfl_xor_sync(FULL, p[0], 2);
        p[0] += __shfl_xor_sync(FULL, p[0], 1);
        if ((lane & 3) == 0) {
          const int j = j0 + ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
          float x = p[0];
          if (tile == 0) x = fmaf(sruk[s], sdo[s * HD + j], x);
          dvp[at(t0 + s) + j] = x;
        }
      }
    }
    __syncthreads();

    // dr, dk, dw of the sub-chunk's steps and this tile's rows: the warps'
    // column sums in warp order, plus the bonus terms
    for (int e = tid; e < SUB * RT; e += THREADS) {
      const int s = e / RT, x = e % RT;
      if (s >= n) continue;
      float pr = 0.f, pk = 0.f, pw = 0.f;
      for (int y = 0; y < WARPS; ++y) {
        const float* rs = red + (s * WARPS + y) * 32 + x;
        pr += rs[0];
        pk += rs[SUB * WARPS * 32];
        pw += rs[2 * SUB * WARPS * 32];
      }
      const int row = tile * RT + x;
      const float ux = a.u[h * HD + row], vdo = svdo[s];
      const long long off = at(t0 + s) + row;
      st(static_cast<T*>(a.dr) + off, fmaf(ux * sk[s * HD + row], vdo, pr));
      st(static_cast<T*>(a.dk) + off, fmaf(ux * sr[s * HD + row], vdo, pk));
      a.dw[off] = pw;
    }
    if (warp == 0 && row_ok) {
      for (int s = n - 1; s >= 0; --s)
        du_acc = fmaf(sr[s * HD + i] * sk[s * HD + i], svdo[s], du_acc);
    }
  }
  if (row_ok) {
    store8(a.ds0 + head + (long long)i * HD + j0, g);
    if (warp == 0) a.dup[(b * a.h + h) * HD + i] = du_acc;
  }
}

// dv = the row tiles' partials summed in tile order (in r's dtype), and du
// = the batch rows' partials summed in batch order.
template <typename T>
__global__ void __launch_bounds__(256) wkv6_bwd_finish_kernel(Args a, int hd, int tiles) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long n_dv = (long long)a.b * a.t * a.h * hd, n_du = (long long)a.h * hd;
  if (e < n_dv) {
    float x = a.dvp[e];
    for (int y = 1; y < tiles; ++y) x += a.dvp[y * n_dv + e];
    st(static_cast<T*>(a.dv) + e, x);
  } else if (e < n_dv + n_du) {
    const long long f = e - n_dv;
    float x = 0.f;
    for (int y = 0; y < a.b; ++y) x += a.dup[y * n_du + f];
    a.du[f] = x;
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Geo<HD>;
  auto kernel = wkv6_bwd_kernel<T, HD>;
  cudaError_t err = cudaSuccess;
  if (G::SMEM > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.b * a.h, G::TILES), G::THREADS, G::SMEM, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = (long long)a.b * a.t * a.h * HD + (long long)a.h * HD;
  wkv6_bwd_finish_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a, HD, G::TILES);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(a, stream);
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int tiles_of(int hd) { return hd > 32 ? hd / 32 : 1; }

}  // namespace

extern "C" {

// f32 floats of workspace a call needs: the checkpoints (B·H·ceil(T/SUB)·
// hd²), the row tiles' dv partials and the batch rows' du partials.
long long wkv6_bwd_workspace_floats(int batch, int t, int h, int hd) {
  const long long nsc = (t + SUB - 1) / SUB;
  return (long long)batch * h * nsc * hd * hd + (long long)tiles_of(hd) * batch * t * h * hd +
         (long long)batch * h * hd;
}

// dtype of r, k, v, dr, dk, dv: 0 float32, 1 bfloat16; everything else
// float32.  All tensors contiguous: r, k, v, w, dout, dr, dk, dv, dw
// (B, T, H, hd); u, du (H, hd); s0, dsT, ds0 (B, H, hd, hd), s0 and dsT
// may be null (zero).  ws: wkv6_bwd_workspace_floats floats.  Two
// launches; returns the first failed one's error.
int wkv6_bwd_launch(int dtype, const void* r, const void* k, const void* v, const float* w,
                    const float* u, const float* s0, const float* dout, const float* dsT,
                    void* dr, void* dk, void* dv, float* dw, float* du, float* ds0, float* ws,
                    int batch, int t, int h, int hd, void* stream) {
  if (batch <= 0 || t <= 0 || h <= 0 || (long long)batch * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = u; a.s0 = s0; a.dout = dout; a.dsT = dsT;
  a.dr = dr; a.dk = dk; a.dv = dv; a.dw = dw; a.du = du; a.ds0 = ds0;
  a.b = batch; a.t = t; a.h = h; a.nsc = (t + SUB - 1) / SUB;
  a.ckpt = ws;
  a.dvp = ws + (long long)batch * h * a.nsc * hd * hd;
  a.dup = a.dvp + (long long)tiles_of(hd) * batch * t * h * hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_hd<float>(hd, a, s)
                  : dtype == 1 ? dispatch_hd<__nv_bfloat16>(hd, a, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}

// Steps per sub-chunk (the tests cross its boundaries).
int wkv6_bwd_sub_steps() { return SUB; }

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
