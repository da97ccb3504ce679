// Hopper (sm_90a) backward of flash attention (K3): dQ, dK and dV of the
// function that flash_attention_kernel / flash_attention_f32_kernel compute
// (flash_attention.cu): GQA (query head h reads kv head h / (Hq/Hkv)),
// causal or not, a sliding window, a query offset, Tq != Tk, strided views
// with a contiguous head dim, f32 or bf16 in and out, f32 sums.
//
//   attn_bwd_prep_kernel, attn_bwd_dq_kernel, attn_bwd_dkdv_kernel (f32)
//       port the gradient of the Pallas kernel `_flash_kernel`
//       (repro/kernels/flash_attention/kernel.py, reached through
//       flash_attention).  The JAX package writes no backward kernel: its
//       trainer differentiates the plain attention with jax.grad, and this
//       is that gradient.  attn_bwd_delta_kernel, attn_bwd_dq_tc_kernel and
//       attn_bwd_dkdv_tc_kernel are the same gradient for bf16 inputs, on
//       tensor cores.  For O = softmax(scale Q K^T + mask) V and dO:
//         P = exp(scale Q K^T - lse)         (lse: each row's log-sum-exp)
//         dV = P^T dO
//         dS = P o (dO V^T - D),  D = rowsum(dO o O)
//         dQ = scale dS K,  dK = scale dS^T Q,
//       dK and dV summed over the query heads of each kv head's group.
//
// What bounds it on an H100.  Operations: five products of (visible query,
// key) pairs by hd (Q K^T and dO V^T recomputed, dV, dK and dQ), 10 hd
// flops a pair.  qwen2-0.5b's training shape (B 8, 14/2 heads of 64, T
// 1024, causal) has 5.9e7 visible pairs a layer, 3.76e10 flops: 38 us at
// 989 TFLOP/s of bf16 tensor cores.  Its bytes (q, k, v, dO read once, dQ,
// dK, dV written once) are about 59 MB, 20 us at 3.35 TB/s.
//
// bf16 (the model's path), on tensor cores: three kernels.
//   1. delta, one warp a row: D = rowsum(dO o O) with O the forward's f32
//      output (o32), which K3's forward writes, beside each row's
//      log-sum-exp, only when FlashAttentionFn asks (null pointers in
//      serving, so its bits and launches stay).  D from the bf16 O moved
//      bf16 gradients at hd 256 past 2^-7 |ref| + 2^-8 max |ref| (H100);
//      from the f32 O it costs one pass over dO and O instead of the
//      scores' recompute that rowsum(P o dP) needs.
//   2. dq, one block per (b, q head, 64-query tile), 16 rows a warp: walks
//      the rows' visible keys in 64-key tiles (32 at hd 256) by 16-byte
//      cp.async in a two-stage ring; S = Q K^T and dP = dO V^T as
//      mma.sync m16n8k16 bf16 -> f32 (ldmatrix fragments, K3's forward's
//      helpers), P = exp(scale S - lse) and dS = P o (dP - D) in f32 in
//      the accumulators, then dQ += dS K with dS as a bf16 hi + lo pair
//      (the fragments of two score n-tiles are the A fragment of one step,
//      as P is in the forward).  P or dS rounded once to bf16 errs by up to
//      2^-9 relative, which broke K3's forward limit 34-46x in an
//      emulation at prefill 1024; the pair errs by about 2^-17.
//   3. dkdv, one block per (b, kv head, key tile: 64 keys, 32 at hd 128, 16
//      at hd 256): walks the group's query heads in order and, for each,
//      the 64-query tiles that can see its keys (Q, dO, lse, D staged by
//      cp.async, two stages).  Phase A: each warp scores 16 keys against a
//      share of the tile's queries, S^T = K Q^T and dP^T = V dO^T, and
//      writes P^T and dS^T as hi + lo pairs to shared memory; phase B:
//      each warp owns 16 keys and hd / (4 / (key tile / 16)) columns of dK
//      and dV (at most 64, so the sums fit in registers at hd 256) and adds
//      P^T dO and dS^T Q, hi and lo.
//   Every output element is summed by one warp in a fixed order: no
//   atomics, so repeated calls give the same bits.
//
// f32, on the SIMT cores (the f32 model builds and the tests): three
// kernels, the first design, exact f32 products:
//   1. prep, one block per (b, q head, 32-query tile): walking the tile's
//      visible key range in 32-key tiles, each row's log-sum-exp and D =
//      rowsum(P o dP) with dP = dO V^T, both in f32.  A row that sees no
//      key gets lse = +inf, so its P is 0 (its forward output is 0).
//   2. dq, one block per (b, q head, 32-query tile): walks the same key
//      range, recomputes P and dS, and sums dQ in registers.
//   3. dkdv, one block per (b, kv head, 32-key tile): walks the group's
//      query heads in order and, for each, the query tiles that can see the
//      key tile, recomputes P and dS, and sums dK and dV in registers.
//   Tiles sit in shared memory as f32 rows padded to hd + 1 floats, so the
//   16 keys a half-warp reads at one dim fall in 16 banks; each thread
//   computes a 2 x 2 block of scores (rows ty, ty + 16; keys tx, tx + 16),
//   and the sums over rows or keys read P and dS by broadcast.
// Head dims 16, 32, 64, 128 and 256 are compiled for both.

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
  const float* o32;               // bf16 path: the forward's o in f32
  long long so32[3];              // its element strides of b, h, t
  int batch, hq, hkv, tq, tk;
  // element strides of b, h, t
  long long sq[3], sk[3], sv[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int causal, window, q_offset;
  float scale;
};


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
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long stride, int r0,
                                          int rows) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < 32 * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int t = r0 + r;
    dst[r * LD + d] = t < rows ? base[(long long)t * stride + d] : 0.f;
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
template <int HD>
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
  const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* dout = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
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
template <int HD>
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
  const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const float* dout = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  float* dq = static_cast<float*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
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
      if (d < HD) dq[(long long)t * a.sdq[2] + d] = acc[i][j] * a.scale;
    }
  }
}

// Grid: (ceil(tk / BKT), hkv, batch).  Thread: keys warp + 8 i (i < 4),
// dims lane + 32 j.
template <int HD>
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
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  float* dk = static_cast<float*>(a.dk) + b * a.sdk[0] + kvh * a.sdk[1];
  float* dv = static_cast<float*>(a.dv) + b * a.sdv[0] + kvh * a.sdv[1];

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
    const float* q = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[1];
    const float* dout = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
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
        dk[(long long)key * a.sdk[2] + d] = dk_acc[i][j] * a.scale;
        dv[(long long)key * a.sdv[2] + d] = dv_acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;
constexpr int TC_THREADS = 128;   // 4 warps
constexpr int TC_ROWS = 64;       // query rows of a dq block (16 a warp)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// K3's forward helpers (flash_attention.cu): ldmatrix fragments and the
// m16n8k16 bf16 -> f32 product
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// (x0, x1) as a bf16 pair hi, and the bf16 pair of what rounding left, lo
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// rows r0 .. r0 + n_rows - 1 of one (b, h) plane of bf16 rows into dst
// [n_rows][HD + 8] by 16-byte cp.async, zero from row `rows` on
template <int HD, int NR>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long stride, int r0, int rows) {
  constexpr int CH = HD / 8, LD = HD + 8;
  for (int c = threadIdx.x; c < NR * CH; c += TC_THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(smem_u32(dst + r * LD + col), ok ? base + (r0 + r) * stride + col : base,
               ok ? 16 : 0);
  }
}

// A (16 x 16, rows row0.., k columns k0..) from a row-major bf16 tile
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const __nv_bfloat16* tile, int ld,
                                       int row0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, smem_u32(tile + (row0 + lane % 16) * ld + k0 + (lane / 16) * 8));
}
// B of two n-tiles (n rows n0 .. n0 + 15 of a row-major tile, k columns
// k0 ..): r[0..1] for n0 .., r[2..3] for n0 + 8 ..
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const __nv_bfloat16* tile, int ld,
                                       int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, smem_u32(tile + (n0 + (lane / 16) * 8 + lane % 8) * ld + k0 +
                          ((lane / 8) % 2) * 8));
}
// B of two n-tiles read transposed (k rows k0 .. k0 + 15, n columns n0 ..
// n0 + 15 of a row-major tile): r[0..1] for n0 .., r[2..3] for n0 + 8 ..
__device__ __forceinline__ void frag_bt(uint32_t (&r)[4], const __nv_bfloat16* tile, int ld,
                                        int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(r, smem_u32(tile + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * ld + n0 +
                                (lane / 16) * 8));
}

// D = rowsum(dO o O) from the forward's f32 O (o32), one warp a row: the
// bf16 O's rounding moved dS past the limit at hd 256 (on an H100).
__global__ void __launch_bounds__(256) attn_bwd_delta_kernel(Args a, int hd) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.batch * a.hq * a.tq) return;
  const int t = row % a.tq, h = (row / a.tq) % a.hq, b = row / ((long long)a.tq * a.hq);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo[0] +
                              h * a.sdo[1] + t * a.sdo[2];
  const float* o = a.o32 + b * a.so32[0] + h * a.so32[1] + t * a.so32[2];
  float x = 0.f;
  for (int d = lane; d < hd; d += 32) x = fmaf(__bfloat162float(dout[d]), o[d], x);
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  if (lane == 0) a.delta[row] = x;
}

// P (or its mask) and dS of one score element: key `key` seen from the
// query at position t (query offset added here), with the row's lse and D
__device__ __forceinline__ void p_ds(const Args& a, int t, int key, float s, float dp,
                                     float lse, float del, float& p, float& ds) {
  const bool ok = t < a.tq && visible(a, a.q_offset + t, key);
  p = ok ? expf(s * a.scale - lse) : 0.f;
  ds = p * (dp - del);
}

// dQ.  Grid: (ceil(tq / 64), hq, batch); warp w owns query rows 16 w ..
// 16 w + 15 of the block and all hd columns of dQ, and walks the rows'
// visible keys in BK-key tiles (cp.async, two stages).  S = Q K^T and
// dP = dO V^T on tensor cores; P and dS in f32 from the forward's lse and
// D; dQ += dS K with dS as a bf16 hi + lo pair.
template <int HD, int BK>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_bwd_dq_tc_kernel(Args a) {
  constexpr int LD = HD + 8, NT = BK / 8, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);   // [64][LD]
  __nv_bfloat16* do_s = q_s + TC_ROWS * LD;                          // [64][LD]
  __nv_bfloat16* k_s = do_s + TC_ROWS * LD;                          // [2][BK][LD]
  __nv_bfloat16* v_s = k_s + 2 * BK * LD;                            // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * TC_ROWS;
  const int kvh = h / (a.hq / a.hkv);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq) + b * a.sdq[0] + h * a.sdq[1];
  const long long row0 = ((long long)b * a.hq + h) * a.tq;

  int k_begin, k_end;
  key_range(a, t0, min(a.tq, t0 + TC_ROWS), k_begin, k_end);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  copy_rows<HD, TC_ROWS>(q_s, q, a.sq[2], t0, a.tq);
  copy_rows<HD, TC_ROWS>(do_s, dout, a.sdo[2], t0, a.tq);
  if (ntiles > 0) {
    copy_rows<HD, BK>(k_s, kp, a.sk[2], k_begin, k_end);
    copy_rows<HD, BK>(v_s, vp, a.sv[2], k_begin, k_end);
  }
  cp_async_commit();

  // this thread's two rows, r0 and r0 + 8
  const int r0 = warp * 16 + g, ta = t0 + r0, tb = ta + 8;
  const float lse0 = ta < a.tq ? a.lse[row0 + ta] : INFINITY;
  const float lse1 = tb < a.tq ? a.lse[row0 + tb] : INFINITY;
  const float del0 = ta < a.tq ? a.delta[row0 + ta] : 0.f;
  const float del1 = tb < a.tq ? a.delta[row0 + tb] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int stage = i % 2;
    if (i + 1 < ntiles) {
      const int nxt = (i + 1) % 2;
      copy_rows<HD, BK>(k_s + nxt * BK * LD, kp, a.sk[2], k_begin + (i + 1) * BK, k_end);
      copy_rows<HD, BK>(v_s + nxt * BK * LD, vp, a.sv[2], k_begin + (i + 1) * BK, k_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = k_s + stage * BK * LD;
    const __nv_bfloat16* vt = v_s + stage * BK * LD;
    const int key0 = k_begin + i * BK;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], da[4];
      frag_a(qa, q_s, LD, warp * 16, kk * 16);
      frag_a(da, do_s, LD, warp * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4], vb[4];
        frag_b(kb, kt, LD, np * 16, kk * 16);
        frag_b(vb, vt, LD, np * 16, kk * 16);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * np], da, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }
    // dS in place of s (rows r0: [j][0..1], r0 + 8: [j][2..3])
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + 2 * c + e;
        float p;
        p_ds(a, ta, key, s[j][e], dp[j][e], lse0, del0, p, s[j][e]);
        p_ds(a, tb, key, s[j][2 + e], dp[j][2 + e], lse1, del1, p, s[j][2 + e]);
      }
    }
    // dQ += dS_hi K + dS_lo K, 16 keys a step
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * ks][0], s[2 * ks][1], hi[0], lo[0]);
      split_bf16(s[2 * ks][2], s[2 * ks][3], hi[1], lo[1]);
      split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t kb[4];
        frag_bt(kb, kt, LD, ks * 16, dd * 16);
        mma_bf16(acc[2 * dd], hi, kb[0], kb[1]);
        mma_bf16(acc[2 * dd], lo, kb[0], kb[1]);
        mma_bf16(acc[2 * dd + 1], hi, kb[2], kb[3]);
        mma_bf16(acc[2 * dd + 1], lo, kb[2], kb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = j * 8 + 2 * c;
    if (ta < a.tq) st2(dq + ta * a.sdq[2] + d, acc[j][0] * a.scale, acc[j][1] * a.scale);
    if (tb < a.tq) st2(dq + tb * a.sdq[2] + d, acc[j][2] * a.scale, acc[j][3] * a.scale);
  }
}

// dK and dV.  Grid: (ceil(tk / BKT), hkv, batch).  A block owns BKT keys
// of one kv head and walks the group's query heads in order and, for each,
// the BQ-query tiles that can see its keys (Q, dO, lse and D by cp.async,
// two stages).  Phase A: warp w scores keys 16 (w / QW) .. + 15 against
// BQ / QW of the tile's queries, S^T = K Q^T and dP^T = V dO^T on tensor
// cores, and writes P^T and dS^T as bf16 hi + lo pairs to shared memory.
// Phase B: warp w owns keys 16 (w / CS) .. + 15 and hd / CS columns of dK
// and dV and adds P^T dO and dS^T Q (hi and lo) on tensor cores.  Every
// sum stays in one warp's registers, in the order of the walk: no atomics.
template <int HD, int BKT, int BQ>
struct DkdvShape {
  static constexpr int LD = HD + 8, LDP = BQ + 8;
  static constexpr int KWR = BKT / 16;       // 16-key row groups
  static constexpr int QW = 4 / KWR;         // phase A: query chunks per key group
  static constexpr int CS = QW;              // phase B: column chunks per key group
  static constexpr int QPW = BQ / QW;        // phase A: queries a warp scores
  static constexpr int DW = HD / CS;         // phase B: columns a warp owns
  static constexpr int KV_BYTES = 2 * BKT * LD * 2;
  static constexpr int STAGE_BYTES = 2 * BQ * LD * 2 + 2 * BQ * 4;   // Q, dO, lse, D
  static constexpr int P_BYTES = 4 * BKT * LDP * 2;                  // P, dS hi and lo
  static constexpr int SMEM = KV_BYTES + 2 * STAGE_BYTES + P_BYTES;
  static_assert(KWR * QW == 4 && QPW % 16 == 0 && DW % 16 == 0, "tile shape");
};

template <int HD, int BKT, int BQ>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_bwd_dkdv_tc_kernel(Args a) {
  using Sh = DkdvShape<HD, BKT, BQ>;
  constexpr int LD = Sh::LD, LDP = Sh::LDP, QW = Sh::QW, CS = Sh::CS, QPW = Sh::QPW;
  constexpr int DW = Sh::DW, NQ = QPW / 8, DT = DW / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);    // [BKT][LD]
  __nv_bfloat16* v_s = k_s + BKT * LD;                                // [BKT][LD]
  unsigned char* stages = tc_smem + Sh::KV_BYTES;                     // 2 x STAGE_BYTES
  __nv_bfloat16* p_hi = reinterpret_cast<__nv_bfloat16*>(stages + 2 * Sh::STAGE_BYTES);
  __nv_bfloat16* p_lo = p_hi + BKT * LDP;
  __nv_bfloat16* ds_hi = p_lo + BKT * LDP;
  __nv_bfloat16* ds_lo = ds_hi + BKT * LDP;
  auto q_of = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(stages + st * Sh::STAGE_BYTES);
  };
  auto do_of = [&](int st) { return q_of(st) + BQ * LD; };
  auto lse_of = [&](int st) { return reinterpret_cast<float*>(do_of(st) + BQ * LD); };
  auto del_of = [&](int st) { return lse_of(st) + BQ; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * BKT;
  const int group = a.hq / a.hkv;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(a.dk) + b * a.sdk[0] + kvh * a.sdk[1];
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(a.dv) + b * a.sdv[0] + kvh * a.sdv[1];

  // the query rows that can see keys [k0, k1): q_offset + t in [k0, k1 - 1 + window)
  const int k1 = min(a.tk, k0 + BKT);
  int q_lo = 0, q_hi = a.tq;
  if (a.causal) {
    q_lo = max(0, k0 - a.q_offset);
    if (a.window > 0) q_hi = min(a.tq, max(0, k1 - 1 + a.window - a.q_offset));
  }
  q_lo = (q_lo / BQ) * BQ;
  const int nqt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int steps = group * nqt;

  auto issue = [&](int i) {
    const int st = i % 2, hh = kvh * group + i / nqt, t0 = q_lo + (i % nqt) * BQ;
    const __nv_bfloat16* q =
        static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0] + hh * a.sq[1];
    const __nv_bfloat16* dout =
        static_cast<const __nv_bfloat16*>(a.dout) + b * a.sdo[0] + hh * a.sdo[1];
    copy_rows<HD, BQ>(q_of(st), q, a.sq[2], t0, a.tq);
    copy_rows<HD, BQ>(do_of(st), dout, a.sdo[2], t0, a.tq);
    const long long row0 = ((long long)b * a.hq + hh) * a.tq;
    for (int r = tid; r < BQ; r += TC_THREADS) {
      const bool ok = t0 + r < a.tq;
      lse_of(st)[r] = ok ? a.lse[row0 + t0 + r] : INFINITY;
      del_of(st)[r] = ok ? a.delta[row0 + t0 + r] : 0.f;
    }
  };

  copy_rows<HD, BKT>(k_s, kp, a.sk[2], k0, a.tk);
  copy_rows<HD, BKT>(v_s, vp, a.sv[2], k0, a.tk);
  if (steps > 0) issue(0);
  cp_async_commit();

  const int ka = warp / QW, qa = warp % QW;    // phase A
  const int kb = warp / CS, cc = warp % CS;    // phase B
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int st = i % 2, t0 = q_lo + (i % nqt) * BQ;
    if (i + 1 < steps) {
      issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = q_of(st);
    const __nv_bfloat16* dot = do_of(st);
    const float* lse_s = lse_of(st);
    const float* del_s = del_of(st);

    // phase A: S^T and dP^T of keys 16 ka .. over queries qa * QPW ..
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kf[4], vf[4];
      frag_a(kf, k_s, LD, ka * 16, kk * 16);
      frag_a(vf, v_s, LD, ka * 16, kk * 16);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qb[4], ob[4];
        frag_b(qb, qt, LD, qa * QPW + np * 16, kk * 16);
        frag_b(ob, dot, LD, qa * QPW + np * 16, kk * 16);
        mma_bf16(s[2 * np], kf, qb[0], qb[1]);
        mma_bf16(s[2 * np + 1], kf, qb[2], qb[3]);
        mma_bf16(dp[2 * np], vf, ob[0], ob[1]);
        mma_bf16(dp[2 * np + 1], vf, ob[2], ob[3]);
      }
    }
    const int kr = ka * 16 + g;   // this thread's key rows kr and kr + 8 of the block
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int col = qa * QPW + j * 8 + 2 * c;   // query columns col, col + 1
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p_ds(a, t0 + col + e, k0 + kr, s[j][e], dp[j][e], lse_s[col + e], del_s[col + e],
             p[e], ds[e]);
        p_ds(a, t0 + col + e, k0 + kr + 8, s[j][2 + e], dp[j][2 + e], lse_s[col + e],
             del_s[col + e], p[2 + e], ds[2 + e]);
      }
      uint32_t hi, lo;
      split_bf16(p[0], p[1], hi, lo);
      *reinterpret_cast<uint32_t*>(p_hi + kr * LDP + col) = hi;
      *reinterpret_cast<uint32_t*>(p_lo + kr * LDP + col) = lo;
      split_bf16(p[2], p[3], hi, lo);
      *reinterpret_cast<uint32_t*>(p_hi + (kr + 8) * LDP + col) = hi;
      *reinterpret_cast<uint32_t*>(p_lo + (kr + 8) * LDP + col) = lo;
      split_bf16(ds[0], ds[1], hi, lo);
      *reinterpret_cast<uint32_t*>(ds_hi + kr * LDP + col) = hi;
      *reinterpret_cast<uint32_t*>(ds_lo + kr * LDP + col) = lo;
      split_bf16(ds[2], ds[3], hi, lo);
      *reinterpret_cast<uint32_t*>(ds_hi + (kr + 8) * LDP + col) = hi;
      *reinterpret_cast<uint32_t*>(ds_lo + (kr + 8) * LDP + col) = lo;
    }
    __syncthreads();

    // phase B: dV += P^T dO, dK += dS^T Q over the tile's queries
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      frag_a(ph, p_hi, LDP, kb * 16, ks * 16);
      frag_a(pl, p_lo, LDP, kb * 16, ks * 16);
      frag_a(dh, ds_hi, LDP, kb * 16, ks * 16);
      frag_a(dl, ds_lo, LDP, kb * 16, ks * 16);
#pragma unroll
      for (int dd = 0; dd < DW / 16; ++dd) {
        uint32_t ob[4], qb[4];
        frag_bt(ob, dot, LD, ks * 16, cc * DW + dd * 16);
        frag_bt(qb, qt, LD, ks * 16, cc * DW + dd * 16);
        mma_bf16(dv_acc[2 * dd], ph, ob[0], ob[1]);
        mma_bf16(dv_acc[2 * dd], pl, ob[0], ob[1]);
        mma_bf16(dv_acc[2 * dd + 1], ph, ob[2], ob[3]);
        mma_bf16(dv_acc[2 * dd + 1], pl, ob[2], ob[3]);
        mma_bf16(dk_acc[2 * dd], dh, qb[0], qb[1]);
        mma_bf16(dk_acc[2 * dd], dl, qb[0], qb[1]);
        mma_bf16(dk_acc[2 * dd + 1], dh, qb[2], qb[3]);
        mma_bf16(dk_acc[2 * dd + 1], dl, qb[2], qb[3]);
      }
    }
    __syncthreads();   // P, dS and this stage are read before they are refilled
  }
  cp_async_wait<0>();

  const int key_a = k0 + kb * 16 + g, key_b = key_a + 8;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = cc * DW + j * 8 + 2 * c;
    if (key_a < a.tk) {
      st2(dk + key_a * a.sdk[2] + d, dk_acc[j][0] * a.scale, dk_acc[j][1] * a.scale);
      st2(dv + key_a * a.sdv[2] + d, dv_acc[j][0], dv_acc[j][1]);
    }
    if (key_b < a.tk) {
      st2(dk + key_b * a.sdk[2] + d, dk_acc[j][2] * a.scale, dk_acc[j][3] * a.scale);
      st2(dv + key_b * a.sdv[2] + d, dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

// The bf16 tiles by head dim: dq's key tile; dkdv's key and query tiles
template <int HD>
struct TcTiles {
  static constexpr int DQ_BK = HD > 128 ? 32 : 64;
  static constexpr int BKT = HD > 128 ? 16 : HD > 64 ? 32 : 64;
  static constexpr int BQ = 64;
  static constexpr int DQ_SMEM = (2 * TC_ROWS + 4 * DQ_BK) * (HD + 8) * 2;
  static constexpr int DKDV_SMEM = DkdvShape<HD, BKT, BQ>::SMEM;
};

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
template <int HD>
cudaError_t launch_all(const Args& a, cudaStream_t stream) {
  using S = Smem<HD>;
  cudaError_t err;
  if ((err = allow_smem(attn_bwd_prep_kernel<HD>, S::PREP)) != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_dq_kernel<HD>, S::DQ)) != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_dkdv_kernel<HD>, S::DKDV)) != cudaSuccess) return err;
  const dim3 qgrid((a.tq + BQ - 1) / BQ, a.hq, a.batch);
  const dim3 kgrid((a.tk + BKT - 1) / BKT, a.hkv, a.batch);
  attn_bwd_prep_kernel<HD><<<qgrid, THREADS, S::PREP, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dq_kernel<HD><<<qgrid, THREADS, S::DQ, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<HD><<<kgrid, THREADS, S::DKDV, stream>>>(a);
  return cudaGetLastError();
}

// bf16: D from the forward's f32 o, then dq and dkdv on tensor cores (both
// read the forward's lse and D), in stream order
template <int HD>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  using Tl = TcTiles<HD>;
  auto dq = attn_bwd_dq_tc_kernel<HD, Tl::DQ_BK>;
  auto dkdv = attn_bwd_dkdv_tc_kernel<HD, Tl::BKT, Tl::BQ>;
  cudaError_t err;
  if ((err = allow_smem(dq, Tl::DQ_SMEM)) != cudaSuccess) return err;
  if ((err = allow_smem(dkdv, Tl::DKDV_SMEM)) != cudaSuccess) return err;
  const long long rows = (long long)a.batch * a.hq * a.tq;
  attn_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a, HD);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq<<<dim3((a.tq + TC_ROWS - 1) / TC_ROWS, a.hq, a.batch), TC_THREADS, Tl::DQ_SMEM,
       stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv<<<dim3((a.tk + Tl::BKT - 1) / Tl::BKT, a.hkv, a.batch), TC_THREADS, Tl::DKDV_SMEM,
         stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(int hd, int dtype, const Args& a, cudaStream_t stream) {
  switch (hd) {
#define CASE(H)                                                                  \
  case H:                                                                        \
    return dtype == 1 ? launch_tc<H>(a, stream) : launch_all<H>(a, stream);
    CASE(16) CASE(32) CASE(64) CASE(128) CASE(256)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dq, dk, dv of flash attention for the gradient dout of its output.
// strides: 24 element strides, (b, h, t) of q, k, v, dout, dq, dk, dv and
// o32 in that order; the head dim is contiguous in all eight.  dtype 0
// float32 (all seven tensors): lse and delta are batch * hq * tq floats of
// workspace, o32 is ignored.  dtype 1 bfloat16: lse holds the forward's
// log-sum-exp (flash_attention_bf16_launch), o32 its f32 output (rows
// 16-byte aligned), delta is workspace; every row of q, k, v and dout
// starts 16-byte aligned.  Launches three kernels; returns the first
// cudaError_t.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, void* dq, void* dk, void* dv, float* lse,
                               float* delta, const float* o32, int batch, int hq, int hkv,
                               int tq, int tk, int hd, const long long* strides, int causal,
                               int window, int q_offset, float scale, int dtype,
                               void* stream) {
  if (batch <= 0 || tq <= 0 || tk <= 0 || hkv <= 0 || hq % hkv || batch > 65535 ||
      hq > 65535 || (dtype != 0 && dtype != 1) || (dtype == 1 && o32 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.lse = lse; a.delta = delta; a.o32 = o32;
  a.batch = batch; a.hq = hq; a.hkv = hkv; a.tq = tq; a.tk = tk;
  long long* dst[8] = {a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv, a.so32};
  for (int x = 0; x < 8; ++x)
    for (int i = 0; i < 3; ++i) dst[x][i] = strides[3 * x + i];
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.scale = scale;
  return (int)dispatch(hd, dtype, a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one block of each kernel uses at head dim hd: the
// f32 path's prep, dq, dkdv and the bf16 path's dq, dkdv in out[0..4];
// returns -1 if hd is not compiled.
int flash_attention_bwd_smem_bytes(int hd, int* out) {
  switch (hd) {
#define CASE(H)                       \
  case H:                             \
    out[0] = Smem<H>::PREP;           \
    out[1] = Smem<H>::DQ;             \
    out[2] = Smem<H>::DKDV;           \
    out[3] = TcTiles<H>::DQ_SMEM;     \
    out[4] = TcTiles<H>::DKDV_SMEM;   \
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
