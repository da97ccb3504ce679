// Hopper (sm_90a) backward of flash attention (K3): dQ, dK and dV of the
// function that flash_attention_kernel / flash_attention_f32_kernel compute
// (flash_attention.cu): GQA (query head h reads kv head h / (Hq/Hkv)),
// causal or not, a sliding window, a query offset, Tq != Tk, strided views
// with a contiguous head dim, f32 or bf16 in and out, f32 arithmetic.
//
//   attn_bwd_prep_kernel, attn_bwd_dq_kernel, attn_bwd_dkdv_kernel port the
//       gradient of the Pallas kernel `_flash_kernel`
//       (repro/kernels/flash_attention/kernel.py, reached through
//       flash_attention).  The JAX package writes no backward kernel: its
//       trainer differentiates the plain attention with jax.grad, and this
//       is that gradient.  For O = softmax(scale Q K^T + mask) V and dO:
//         P = exp(scale Q K^T - lse)         (lse: each row's log-sum-exp)
//         dV = P^T dO
//         dS = P o (dO V^T - D),  D = rowsum(dO o O)
//         dQ = scale dS K,  dK = scale dS^T Q,
//       dK and dV summed over the query heads of each kv head's group.
//
// What bounds it on an H100.  Operations: five products of (visible query,
// key) pairs by hd (Q K^T and dO V^T recomputed, dV, dK and dQ), 10 hd
// flops a pair (this design does nine: prep and dq recompute both scores
// again).  qwen2-0.5b's training shape (B 8, 14/2 heads of 64, T
// 1024, causal) has 5.9e7 visible pairs a layer, 3.76e10 flops: 38 us at
// 989 TFLOP/s of bf16 tensor cores.  Its bytes (q, k, v, dO read once, dQ,
// dK, dV written once) are about 59 MB, 20 us at 3.35 TB/s.
//
// Design: simple and deterministic first; the tensor cores (wgmma, TMA) are
// later work.  Three kernels, f32 on the SIMT cores for either input type:
//   1. prep, one block per (b, q head, 32-query tile): walking the tile's
//      visible key range in 32-key tiles, each row's log-sum-exp and D.
//      The forward is left untouched (its bits and launch counts stay), so
//      the log-sum-exp is recomputed here, and D = rowsum(dO o O) is taken
//      as rowsum(P o dP) with dP = dO V^T, both in f32: O itself is not
//      read, so a bf16 O's rounding does not enter dS (taken from it, D
//      moved bf16 gradients at hd 256 past 2^-7 |ref| + 2^-8 max |ref|).  A
//      row that sees no key gets lse = +inf, so its P is 0 (its forward
//      output is 0).
//   2. dq, one block per (b, q head, 32-query tile): walks the same key
//      range, recomputes P and dS, and sums dQ in registers.
//   3. dkdv, one block per (b, kv head, 32-key tile): walks the group's
//      query heads in order and, for each, the query tiles that can see the
//      key tile, recomputes P and dS, and sums dK and dV in registers.
//   Every output element is summed by one thread in a fixed order: no
//   atomics, so repeated calls give the same bits.  Tiles sit in shared
//   memory as f32 rows padded to hd + 1 floats, so the 16 keys a half-warp
//   reads at one dim fall in 16 banks; each thread computes a 2 x 2 block
//   of scores (rows ty, ty + 16; keys tx, tx + 16), and the sums over rows
//   or keys read P and dS by broadcast.  Head dims 16, 32, 64, 128 and 256
//   are compiled.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;            // query rows of a tile
constexpr int BKT = 32;           // keys of a tile
constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int PS = BKT + 1;       // padded row of the P and dS tiles

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                     // [batch][hq][tq]
  float* delta;                   // [batch][hq][tq]
  int hq, hkv, tq, tk;
  // element strides of b, h, t
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// the forward's mask: key k is seen by the query at position qpos
__device__ __forceinline__ bool visible(const Args& a, int qpos, int key) {
  if (key >= a.tk) return false;
  if (!a.causal) return true;
  return key <= qpos && (a.window <= 0 || key > qpos - a.window);
}

// The keys any query of rows [t0, t1) can see (may be empty).
__device__ __forceinline__ void key_range(const Args& a, int t0, int t1, int& k_begin,
                                          int& k_end) {
  k_begin = 0;
  k_end = a.tk;
  if (a.causal) {
    k_end = min(a.tk, a.q_offset + t1);
    if (a.window > 0) k_begin = max(0, a.q_offset + t0 - a.window + 1);
  }
}

// rows r0 .. r0 + 31 of one (b, h) plane -> dst[32][HD + 1] in f32, zero
// from row `rows` on
template <int HD, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base, long long stride, int r0,
                                          int rows) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < 32 * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int t = r0 + r;
    dst[r * LD + d] = t < rows ? ld(base + (long long)t * stride + d) : 0.f;
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over two 32-row tiles
template <int HD>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, float (&s)[2][2]) {
  constexpr int LD = HD + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  s[0][0] = s[0][1] = s[1][0] = s[1][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float a0 = A[ty * LD + d], a1 = A[(ty + 16) * LD + d];
    const float b0 = B[tx * LD + d], b1 = B[(tx + 16) * LD + d];
    s[0][0] = fmaf(a0, b0, s[0][0]);
    s[0][1] = fmaf(a0, b1, s[0][1]);
    s[1][0] = fmaf(a1, b0, s[1][0]);
    s[1][1] = fmaf(a1, b1, s[1][1]);
  }
}

// P and dS of one (query tile at t0, key tile at k0) pair into ps / dss
// (ps may be null); rows past tq and keys the mask hides get 0
template <int HD>
__device__ __forceinline__ void p_and_ds(const Args& a, const float* qs, const float* dos,
                                         const float* ks, const float* vs, const float* lse_s,
                                         const float* del_s, int t0, int k0, float* ps,
                                         float* dss) {
  float s[2][2], dp[2][2];
  dot_tile<HD>(qs, ks, s);
  dot_tile<HD>(dos, vs, dp);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const bool ok = t0 + r < a.tq && visible(a, a.q_offset + t0 + r, k0 + c);
      const float p = ok ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
      if (ps) ps[r * PS + c] = p;
      dss[r * PS + c] = p * (dp[i][j] - del_s[r]);
    }
  }
}

// this block's rows' log-sum-exp and D (rows past tq: +inf and 0)
__device__ __forceinline__ void load_row_stats(const Args& a, long long row0, int t0,
                                               float* lse_s, float* del_s) {
  const int r = threadIdx.x;
  if (r < BQ) {
    const bool ok = t0 + r < a.tq;
    lse_s[r] = ok ? a.lse[row0 + r] : INFINITY;
    del_s[r] = ok ? a.delta[row0 + r] : 0.f;
  }
}

// Grid: (ceil(tq / BQ), hq, batch).  Walks the rows' visible keys in
// 32-key tiles; thread r < BQ keeps row r's running max m, its sum l of
// exp(s - m) and its sum u of exp(s - m) dP, rescaled like the forward's.
// Then lse = m + log l and D = u / l = rowsum(P o dP) = rowsum(dO o O).
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS) attn_bwd_prep_kernel(Args a) {
  constexpr int LD = HD + 1;
  extern __shared__ __align__(16) float bwd_smem[];
  float* qs = bwd_smem;            // [BQ][LD]
  float* dos = qs + BQ * LD;       // [BQ][LD]
  float* ks = dos + BQ * LD;       // [BKT][LD]
  float* vs = ks + BKT * LD;       // [BKT][LD]
  float* ss = vs + BKT * LD;       // [BQ][PS] scaled scores, -inf where hidden
  float* dps = ss + BQ * PS;       // [BQ][PS] dO V^T

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BQ;
  const int kvh = h / (a.hq / a.hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  const long long row0 = ((long long)b * a.hq + h) * a.tq + t0;

  load_rows<HD>(qs, q, a.sq[2], t0, a.tq);
  load_rows<HD>(dos, dout, a.sdo[2], t0, a.tq);
  int k_begin, k_end;
  key_range(a, t0, min(a.tq, t0 + BQ), k_begin, k_end);
  const int ty = tid / 16, tx = tid % 16;
  float m = -INFINITY, l = 0.f, u = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += BKT) {
    __syncthreads();               // the previous tile's scores are read
    load_rows<HD>(ks, kp, a.sk[2], k0, a.tk);
    load_rows<HD>(vs, vp, a.sv[2], k0, a.tk);
    __syncthreads();
    float s[2][2], dp[2][2];
    dot_tile<HD>(qs, ks, s);
    dot_tile<HD>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const bool ok = t0 + r < a.tq && visible(a, a.q_offset + t0 + r, k0 + c);
        ss[r * PS + c] = ok ? s[i][j] * a.scale : -INFINITY;
        dps[r * PS + c] = dp[i][j];
      }
    }
    __syncthreads();
    if (tid < BQ) {
      float mx = m;
      for (int c = 0; c < BKT; ++c) mx = fmaxf(mx, ss[tid * PS + c]);
      if (mx != -INFINITY) {
        float sum = 0.f, dsum = 0.f;
        for (int c = 0; c < BKT; ++c) {
          const float e = expf(ss[tid * PS + c] - mx);   // 0 where hidden
          sum += e;
          dsum = fmaf(e, dps[tid * PS + c], dsum);
        }
        const float alpha = expf(m - mx);               // m = -inf: l and u were 0
        l = l * alpha + sum;
        u = u * alpha + dsum;
        m = mx;
      }
    }
  }
  if (tid < BQ && t0 + tid < a.tq) {
    a.lse[row0 + tid] = l > 0.f ? m + logf(l) : INFINITY;
    a.delta[row0 + tid] = l > 0.f ? u / l : 0.f;
  }
}

// Grid: (ceil(tq / BQ), hq, batch).  Thread: rows warp + 8 i (i < 4), dims
// lane + 32 j.
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int DPL = (HD + 31) / 32;
  constexpr int RPW = BQ / WARPS;
  extern __shared__ __align__(16) float bwd_smem[];
  float* qs = bwd_smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BKT * LD;
  float* dss = vs + BKT * LD;      // [BQ][PS]
  float* lse_s = dss + BQ * PS;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BQ;
  const int kvh = h / (a.hq / a.hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* dout = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  T* dq = static_cast<T*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
  const long long row0 = ((long long)b * a.hq + h) * a.tq + t0;

  load_rows<HD>(qs, q, a.sq[2], t0, a.tq);
  load_rows<HD>(dos, dout, a.sdo[2], t0, a.tq);
  load_row_stats(a, row0, t0, lse_s, del_s);

  float acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;

  int k_begin, k_end;
  key_range(a, t0, min(a.tq, t0 + BQ), k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += BKT) {
    __syncthreads();               // the previous tile's dS and K are read
    load_rows<HD>(ks, kp, a.sk[2], k0, a.tk);
    load_rows<HD>(vs, vp, a.sv[2], k0, a.tk);
    __syncthreads();
    p_and_ds<HD>(a, qs, dos, ks, vs, lse_s, del_s, t0, k0, nullptr, dss);
    __syncthreads();
    for (int c = 0; c < BKT; ++c) {
      float kv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        kv[j] = d < HD ? ks[c * LD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float ds = dss[(warp + WARPS * i) * PS + c];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int t = t0 + warp + WARPS * i;
    if (t >= a.tq) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < HD) st(dq + (long long)t * a.sdq[2] + d, acc[i][j] * a.scale);
    }
  }
}

// Grid: (ceil(tk / BKT), hkv, batch).  Thread: keys warp + 8 i (i < 4),
// dims lane + 32 j.
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkdv_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int DPL = (HD + 31) / 32;
  constexpr int KPW = BKT / WARPS;
  extern __shared__ __align__(16) float bwd_smem[];
  float* ks = bwd_smem;
  float* vs = ks + BKT * LD;
  float* qs = vs + BKT * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;       // [BQ][PS]
  float* dss = ps + BQ * PS;       // [BQ][PS]
  float* lse_s = dss + BQ * PS;
  float* del_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BKT;
  const int group = a.hq / a.hkv;
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  T* dk = static_cast<T*>(a.dk) + b * a.sdk[0] + kvh * a.sdk[1];
  T* dv = static_cast<T*>(a.dv) + b * a.sdv[0] + kvh * a.sdv[1];

  // the query rows that can see keys [k0, k1): q_offset + t in [k0, k1 - 1 + window)
  const int k1 = min(a.tk, k0 + BKT);
  int q_lo = 0, q_hi = a.tq;
  if (a.causal) {
    q_lo = max(0, k0 - a.q_offset);
    if (a.window > 0) q_hi = min(a.tq, max(0, k1 - 1 + a.window - a.q_offset));
  }

  load_rows<HD>(ks, kp, a.sk[2], k0, a.tk);
  load_rows<HD>(vs, vp, a.sv[2], k0, a.tk);

  float dk_acc[KPW][DPL], dv_acc[KPW][DPL];
#pragma unroll
  for (int i = 0; i < KPW; ++i)
#pragma unroll
    for (int j = 0; j < DPL; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
    const T* dout = static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
    for (int t0 = (q_lo / BQ) * BQ; t0 < q_hi; t0 += BQ) {
      __syncthreads();             // the previous tile's Q, dO, P and dS are read
      load_rows<HD>(qs, q, a.sq[2], t0, a.tq);
      load_rows<HD>(dos, dout, a.sdo[2], t0, a.tq);
      load_row_stats(a, ((long long)b * a.hq + h) * a.tq + t0, t0, lse_s, del_s);
      __syncthreads();
      p_and_ds<HD>(a, qs, dos, ks, vs, lse_s, del_s, t0, k0, ps, dss);
      __syncthreads();
      const int rows = min(BQ, a.tq - t0);
      for (int r = 0; r < rows; ++r) {
        float dov[DPL], qv[DPL];
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          dov[j] = d < HD ? dos[r * LD + d] : 0.f;
          qv[j] = d < HD ? qs[r * LD + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < KPW; ++i) {
          const int c = warp + WARPS * i;
          const float p = ps[r * PS + c], ds = dss[r * PS + c];
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            dv_acc[i][j] = fmaf(p, dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    const int key = k0 + warp + WARPS * i;
    if (key >= a.tk) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < HD) {
        st(dk + (long long)key * a.sdk[2] + d, dk_acc[i][j] * a.scale);
        st(dv + (long long)key * a.sdv[2] + d, dv_acc[i][j]);
      }
    }
  }
}

template <int HD>
struct Smem {
  static constexpr int LD = HD + 1;
  static constexpr int PREP = (2 * BQ * LD + 2 * BKT * LD + 2 * BQ * PS) * 4;
  static constexpr int DQ = (2 * BQ * LD + 2 * BKT * LD + BQ * PS + 2 * BQ) * 4;
  static constexpr int DKDV = (2 * BQ * LD + 2 * BKT * LD + 2 * BQ * PS + 2 * BQ) * 4;
};

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// prep, then dq and dkdv (both read prep's lse and D), in stream order
template <int HD, typename T>
cudaError_t launch_all(const Args& a, int batch, cudaStream_t stream) {
  using S = Smem<HD>;
  cudaError_t err;
  if ((err = allow_smem(attn_bwd_prep_kernel<HD, T>, S::PREP)) != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_dq_kernel<HD, T>, S::DQ)) != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_dkdv_kernel<HD, T>, S::DKDV)) != cudaSuccess) return err;
  const dim3 qgrid((a.tq + BQ - 1) / BQ, a.hq, batch);
  const dim3 kgrid((a.tk + BKT - 1) / BKT, a.hkv, batch);
  attn_bwd_prep_kernel<HD, T><<<qgrid, THREADS, S::PREP, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dq_kernel<HD, T><<<qgrid, THREADS, S::DQ, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<HD, T><<<kgrid, THREADS, S::DKDV, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const Args& a, int batch, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_all<16, T>(a, batch, stream);
    case 32: return launch_all<32, T>(a, batch, stream);
    case 64: return launch_all<64, T>(a, batch, stream);
    case 128: return launch_all<128, T>(a, batch, stream);
    case 256: return launch_all<256, T>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dq, dk, dv of flash attention for the gradient dout of its output.
// strides: 21 element strides, (b, h, t) of q, k, v, dout, dq, dk, dv in
// that order; the head dim is contiguous in all seven.  lse and delta:
// batch * hq * tq floats of workspace.  dtype 0 float32, 1 bfloat16 (all
// seven tensors).  Launches three kernels; returns the first cudaError_t.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, void* dq, void* dk, void* dv, float* lse,
                               float* delta, int batch, int hq, int hkv, int tq, int tk,
                               int hd, const long long* strides, int causal, int window,
                               int q_offset, float scale, int dtype, void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || hkv <= 0 || hq % hkv || batch > 65535 ||
      hq > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.lse = lse; a.delta = delta;
  a.hq = hq; a.hkv = hkv; a.tq = tq; a.tk = tk;
  long long* dst[7] = {a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int x = 0; x < 7; ++x)
    for (int i = 0; i < 3; ++i) dst[x][i] = strides[3 * x + i];
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? dispatch<__nv_bfloat16>(hd, a, batch, s)
                          : dispatch<float>(hd, a, batch, s));
}

// Dynamic shared memory one block of each kernel uses at head dim hd (prep,
// dq, dkdv in out[0..2]); returns -1 if hd is not compiled.
int flash_attention_bwd_smem_bytes(int hd, int* out) {
  switch (hd) {
#define CASE(H)                  \
  case H:                        \
    out[0] = Smem<H>::PREP;      \
    out[1] = Smem<H>::DQ;        \
    out[2] = Smem<H>::DKDV;      \
    return 0;
    CASE(16) CASE(32) CASE(64) CASE(128) CASE(256)
#undef CASE
    default: return -1;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
